"""StyleTransferNet's forward (both encoder passes and the projectors) in a
render batch, CUDA events around the benchmark's call of the net, mean over
the traced batches."""

from h100bench.work.roofline import mean


def read(run):
    return mean(run.cuda_ms.get("encoder", []))
