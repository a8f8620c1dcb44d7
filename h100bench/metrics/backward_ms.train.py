"""The backward pass of a training step (autograd through the render, A's
adjoint, B-bwd and cuDNN), CUDA events from train_step's mark "forward" to
its mark "backward", mean over the traced steps."""

from h100bench.work.roofline import mean


def read(run):
    return mean(run.cuda_ms.get("backward", []))
