"""The host's time to issue one blind-estimation step: the program's span
blind.step (blind_estimation_step, from the target's render to the end of
Adam's update, no synchronize inside), host clock, over its calls in the
traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.step"], "blind.step")
