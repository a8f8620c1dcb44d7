"""Adam's update in a blind-estimation step (torch.optim.Adam.step): the device
time between the CUDA events of the program's span blind.optimizer, over its
calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.optimizer"], "blind.optimizer", "device_ms")
