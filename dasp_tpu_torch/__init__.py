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
the dynamics family (expander, sidechain compressor, noise gate, de-esser,
limiter, multiband compressor, transient shaper) and the graphic EQ,
exciter, advanced distortion, bitcrusher and clipper; and the exact IIR
methods ``"exact"``, ``"block"`` and ``"coupled"`` and the scan smoothers
(``ops.iir``). On CPU tensors the
kernels' plain PyTorch versions run instead, so the package imports and
runs without a GPU.

Layouts at the public functions are the JAX package's: audio is
(bs, ch, T), parameter tensors (bs, n_params).
"""

from . import functional, models, modules, ops, train, utils
from .functional import (
    advanced_distortion,
    bitcrusher,
    clipper,
    compressor,
    de_esser,
    distortion,
    exciter,
    expander,
    gain,
    graphic_eq,
    limiter,
    modulated_delay,
    multiband_compressor,
    noise_gate,
    noise_shaped_reverberation,
    parametric_eq,
    pitch_shift,
    sidechain_compressor,
    stereo_bus,
    stereo_panner,
    stereo_widener,
    transient_shaper,
)
from .modules import (
    AdvancedDistortion,
    Bitcrusher,
    Chain,
    Chorus,
    Clipper,
    Compressor,
    DeEsser,
    Distortion,
    Exciter,
    Expander,
    Flanger,
    Gain,
    GraphicEQ,
    Limiter,
    MultibandCompressor,
    NoiseGate,
    NoiseShapedReverb,
    ParametricEQ,
    PitchShift,
    Processor,
    SidechainCompressor,
    StereoBus,
    StereoPanner,
    StereoWidener,
    TransientShaper,
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
    "advanced_distortion",
    "graphic_eq",
    "expander",
    "sidechain_compressor",
    "noise_gate",
    "de_esser",
    "bitcrusher",
    "transient_shaper",
    "exciter",
    "clipper",
    "limiter",
    "multiband_compressor",
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
    "AdvancedDistortion",
    "GraphicEQ",
    "Expander",
    "SidechainCompressor",
    "NoiseGate",
    "DeEsser",
    "Bitcrusher",
    "TransientShaper",
    "Exciter",
    "Clipper",
    "Limiter",
    "MultibandCompressor",
]
