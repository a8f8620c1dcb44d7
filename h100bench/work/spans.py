"""The program's own spans, as ``dasp_tpu_torch.trace.snapshot()`` holds
them: what ran while the traced window's profiler recorded (the program's
spans are off at any other time).

A program without that module, or a run in which a span did not open,
gives None, and the metric is left out of the line.
"""


def spans() -> dict:
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return {}
    return trace.snapshot()["spans"]


def per_call(names, per: str, key: str = "host_ms"):
    """The sum of ``key`` over the spans ``names`` per call of the span
    ``per``; None where any of them is absent or has no ``key``."""
    table = spans()
    calls = table.get(per, {}).get("calls", 0)
    if not calls or any(table.get(n, {}).get(key) is None for n in names):
        return None
    return sum(table[n][key] for n in names) / calls
