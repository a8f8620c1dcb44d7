"""The share of the parametric EQ stream's calls whose designed sections
and coupled operators came from the program's memo: the counters
stream.eq_operators.hit and stream.eq_operators.miss (one of the two on
each call that consults the memo), hits over hits plus misses, in %. The
counters run for the whole process, set-up's warm-up chunks included. A
program without them gives None, and the metric is left out of the line."""


def read(run):
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.snapshot()["counts"]
    hits, misses = counts.get("stream.eq_operators.hit", 0), counts.get("stream.eq_operators.miss", 0)
    if hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
