"""The estimator's forward pass in a blind-estimation step (models/tcn.py
ParameterNetwork: 5 TCNBlocks in train mode, the time mean, the head): the
device time between the CUDA events of the program's span blind.net, over
its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["blind.net"], "blind.net", "device_ms")
