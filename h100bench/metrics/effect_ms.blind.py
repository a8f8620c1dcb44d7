"""The pitch shifter's two renders in a blind-estimation step (the target's,
no gradient, and the estimate's; kernel C's forward and the taps around
it): device time of the program's spans blind.target and blind.render
(CUDA events), over the calls of blind.step."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.target", "blind.render"], "blind.step", "device_ms")
