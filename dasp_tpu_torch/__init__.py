"""dasp_tpu_torch: the PyTorch / CUDA port of dasp_tpu.

The JAX package ``dasp_tpu`` stays the reference; this package carries the
same functions over to PyTorch, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``, built with ``nvcc`` at first
use; see ``_build``). So far it covers the style-transfer training step
(``train``): the random corruption, the TCN encoder and parameter
projectors in train or eval mode, the render ParametricEQ -> Compressor ->
NoiseShapedReverb -> Gain, the MR-STFT loss (``utils``), the backward
through the kernels and an Adam update; blind estimation of the delay
family (``PitchShift``, ``Chorus``, ``Flanger``); the rest of the
reference's effect set (``Distortion``, the stereo effects) and ``Chain``;
and the exact IIR methods ``"exact"`` and ``"block"`` (``ops.iir``). On CPU tensors the
kernels' plain PyTorch versions run instead, so the package imports and
runs without a GPU.

Layouts at the public functions are the JAX package's: audio is
(bs, ch, T), parameter tensors (bs, n_params).
"""

from . import functional, models, modules, ops, train, utils
from .functional import (
    compressor,
    distortion,
    gain,
    modulated_delay,
    noise_shaped_reverberation,
    parametric_eq,
    pitch_shift,
    stereo_bus,
    stereo_panner,
    stereo_widener,
)
from .modules import (
    Chain,
    Chorus,
    Compressor,
    Distortion,
    Flanger,
    Gain,
    NoiseShapedReverb,
    ParametricEQ,
    PitchShift,
    Processor,
    StereoBus,
    StereoPanner,
    StereoWidener,
)

__all__ = [
    "functional",
    "models",
    "modules",
    "ops",
    "train",
    "utils",
    "gain",
    "distortion",
    "stereo_bus",
    "stereo_widener",
    "stereo_panner",
    "parametric_eq",
    "compressor",
    "noise_shaped_reverberation",
    "modulated_delay",
    "pitch_shift",
    "Processor",
    "Chain",
    "Gain",
    "Distortion",
    "StereoWidener",
    "StereoPanner",
    "StereoBus",
    "ParametricEQ",
    "Compressor",
    "NoiseShapedReverb",
    "Chorus",
    "Flanger",
    "PitchShift",
]
