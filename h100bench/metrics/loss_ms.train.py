"""The MR-STFT loss of a training step (utils/loss.py), the device time
between the CUDA events of the program's span train.loss, over its calls
in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["train.loss"], "train.loss", "device_ms")
