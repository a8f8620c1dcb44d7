"""dasp_tpu_torch: the PyTorch / CUDA port of dasp_tpu.

The JAX package ``dasp_tpu`` stays the reference; this package carries the
same functions over to PyTorch, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``, built with ``nvcc`` at first
use; see ``_build``). Every effect and processor of the JAX package's top
level has its counterpart here. It covers the style-transfer training step
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
(``ops.iir``); the rest of the delay family (delay, ring modulator,
tremolo, stereo imager, convolution reverb, wow and flutter) and the
time-varying WOLA family on ``ops.tv_filter`` (phaser, auto-wah, spectral
gate, dynamic EQ, phase-vocoder time stretch and pitch shift), with the
whole mastering chain's step and the denoising step (``train``); the
serving layer (``streaming``: every effect's chunk-by-chunk step with
carried state, and ``StreamChain``); BS.1770 loudness and presets
(``utils``); the host side of training on wav files (``utils``: wav I/O
on the ``native`` C++ runtime, the input pipeline to the card, metrics,
checkpoints, debug checks, dataset acquisition) and the example
applications (``examples``, each ``python -m
dasp_tpu_torch.examples.<name>``). On CPU tensors the kernels' plain
PyTorch versions run instead, so the package imports and runs without a
GPU.

Layouts at the public functions are the JAX package's: audio is
(bs, ch, T), parameter tensors (bs, n_params).
"""

from . import functional, models, modules, ops, streaming, utils
from .functional import (
    advanced_distortion,
    auto_wah,
    bitcrusher,
    clipper,
    compressor,
    convolution_reverb,
    de_esser,
    delay,
    distortion,
    dynamic_eq,
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
    phaser,
    pitch_shift,
    pitch_shift_pv,
    ring_modulator,
    sidechain_compressor,
    spectral_gate,
    spectral_noise_profile,
    stereo_bus,
    stereo_imager,
    stereo_panner,
    stereo_widener,
    time_stretch,
    transient_shaper,
    tremolo,
    wow_flutter,
)
from .modules import (
    AdvancedDistortion,
    AutoWah,
    Bitcrusher,
    Chain,
    Chorus,
    Clipper,
    Compressor,
    ConvolutionReverb,
    DeEsser,
    Delay,
    Distortion,
    DynamicEQ,
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
    Phaser,
    PitchShift,
    PitchShiftPV,
    Processor,
    RingModulator,
    SidechainCompressor,
    SpectralGate,
    StereoBus,
    StereoImager,
    StereoPanner,
    StereoWidener,
    TimeStretch,
    TransientShaper,
    Tremolo,
    WowFlutter,
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
    "delay",
    "ring_modulator",
    "tremolo",
    "stereo_imager",
    "convolution_reverb",
    "wow_flutter",
    "spectral_gate",
    "spectral_noise_profile",
    "dynamic_eq",
    "phaser",
    "auto_wah",
    "time_stretch",
    "pitch_shift_pv",
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
    "Delay",
    "RingModulator",
    "Tremolo",
    "StereoImager",
    "ConvolutionReverb",
    "WowFlutter",
    "SpectralGate",
    "DynamicEQ",
    "Phaser",
    "AutoWah",
    "TimeStretch",
    "PitchShiftPV",
]


def __getattr__(name):
    # the training steps load at first use, so that serving loads none of them
    if name == "train":
        import importlib

        return importlib.import_module(".train", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
