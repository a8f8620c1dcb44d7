"""The share of the parametric EQ stream's memo-consulting calls that ran
their cascade in one launch of the program's stream step kernel (kernel
D): the counter kernel_d.forward (one a launch) over the counters
stream.eq_operators.hit plus stream.eq_operators.miss (one of the two on
each call that consults the memo), in %. In the stream cells the EQ is the
chain's only coupled cascade, so every launch is one of its calls. The
counters run for the whole process, set-up's warm-up chunks included. A
program without kernel D (no dasp_tpu_torch.ops.iir_stream_kernel) or
without the memo's counters gives None, and the metric is left out of the
line."""

import importlib.util


def read(run):
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return None
    if importlib.util.find_spec("dasp_tpu_torch.ops.iir_stream_kernel") is None:
        return None
    counts = trace.snapshot()["counts"]
    calls = counts.get("stream.eq_operators.hit", 0) + counts.get("stream.eq_operators.miss", 0)
    if calls == 0:
        return None
    return 100.0 * counts.get("kernel_d.forward", 0) / calls
