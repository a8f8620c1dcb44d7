"""dasp_tpu_torch: the PyTorch / CUDA port of dasp_tpu.

The JAX package ``dasp_tpu`` stays the reference; this package carries the
same functions over to PyTorch, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``, built with ``nvcc`` at first
use; see ``_build``). So far it covers the style-transfer training step
(``train``): the random corruption, the TCN encoder and parameter
projectors in train or eval mode, the render ParametricEQ -> Compressor ->
NoiseShapedReverb -> Gain, the MR-STFT loss (``utils``), the backward
through the kernels and an Adam update. On CPU tensors the kernels' plain
PyTorch versions run instead, so the package imports and runs without a
GPU.

Layouts at the public functions are the JAX package's: audio is
(bs, ch, T), parameter tensors (bs, n_params).
"""

from . import functional, models, modules, ops, train, utils
from .functional import compressor, gain, noise_shaped_reverberation, parametric_eq
from .modules import Compressor, Gain, NoiseShapedReverb, ParametricEQ, Processor

__all__ = [
    "functional",
    "models",
    "modules",
    "ops",
    "train",
    "utils",
    "gain",
    "parametric_eq",
    "compressor",
    "noise_shaped_reverberation",
    "Processor",
    "Gain",
    "ParametricEQ",
    "Compressor",
    "NoiseShapedReverb",
]
