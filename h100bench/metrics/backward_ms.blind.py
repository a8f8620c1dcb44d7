"""The backward pass of a blind-estimation step (zero_grad and
loss.backward(): the STFT loss, kernel C's backward, the taps' chain and
the net's cuDNN backward and BatchNorm): device time of the program's span
blind.backward (CUDA events), over its calls."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.backward"], "blind.backward", "device_ms")
