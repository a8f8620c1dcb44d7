"""The share of the fractional-delay contractions that ran on kernel C's
CUDA forward: the program's counter kernel_c.forward (one a launch) over
frac_delay.call (one a functional._frac_delay_matmul call, on either
adjoint), in %. In the blind-estimation cell the pitch shifter is the only
caller of both. The counters run for the whole process, set-up's steps
included. A program without the call counter gives None, and the metric
is left out of the line."""


def read(run):
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return None
    counts = trace.snapshot()["counts"]
    calls = counts.get("frac_delay.call", 0)
    if calls == 0:
        return None
    return 100.0 * counts.get("kernel_c.forward", 0) / calls
