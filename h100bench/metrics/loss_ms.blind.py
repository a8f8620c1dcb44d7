"""The single-resolution STFT loss of a blind-estimation step (utils/loss.py
stft_loss): the device time between the CUDA events of the program's span
blind.loss, over its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.loss"], "blind.loss", "device_ms")
