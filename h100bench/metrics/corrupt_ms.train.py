"""The corruption chain of a training step (EQ on kernel A, compressor on
kernel B, reverb; no net), CUDA events from the step's start to
train_step's mark "corrupt", mean over the traced steps."""

from h100bench.work.roofline import mean


def read(run):
    return mean(run.cuda_ms.get("corrupt", []))
