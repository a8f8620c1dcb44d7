"""Adam's update in a training step (torch.optim.Adam.step), the device
time between the CUDA events of the program's span train.optimizer, over
its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["train.optimizer"], "train.optimizer", "device_ms")
