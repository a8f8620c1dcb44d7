"""The share of the style encoder's layer calls that ran on the program's
kernel E (one eval-mode TCN layer, convolution to BatchNorm, in one
launch): the counter kernel_e.forward (one a launch) over
encoder.conv_layer (one a TCNBlock layer call, on either path), in %. In
the render cell the encoder is the only caller of both. The counters run
for the whole process, set-up's warm-up renders included. A program
without kernel E (no dasp_tpu_torch.ops.tcn_kernel) or without the layer
counter gives None, and the metric is left out of the line."""

import importlib.util


def read(run):
    try:
        from dasp_tpu_torch import trace
    except ImportError:
        return None
    if importlib.util.find_spec("dasp_tpu_torch.ops.tcn_kernel") is None:
        return None
    counts = trace.snapshot()["counts"]
    calls = counts.get("encoder.conv_layer", 0)
    if calls == 0:
        return None
    return 100.0 * counts.get("kernel_e.forward", 0) / calls
