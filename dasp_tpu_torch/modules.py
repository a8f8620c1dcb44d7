"""Processor layer: normalized-parameter dispatch for neural control.

PyTorch counterpart of ``dasp_tpu/modules.py``: ``Processor``, ``Chain``
and every processor. A ``Processor`` owns a parameter-range table and
turns a ``(batch, num_params)`` tensor of normalized (0, 1) parameters,
e.g. the sigmoid output of a network, into keyword arguments for its
functional effect. Each instance records its constructor arguments in
``_init_spec`` as the JAX package's does.

PyTorch runs every call eagerly, so the out-of-range check of
``process_normalized`` always runs unless ``clip_params=True`` (the JAX
package skips it under tracing). The check reads the values back to the
host, which waits for a GPU; the render path passes ``clip_params=True``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import functional as F

__all__ = [
    "normalize",
    "denormalize",
    "Processor",
    "Chain",
    "Gain",
    "Distortion",
    "AdvancedDistortion",
    "ParametricEQ",
    "GraphicEQ",
    "Compressor",
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
    "NoiseShapedReverb",
    "StereoWidener",
    "StereoPanner",
    "StereoBus",
    "Chorus",
    "Flanger",
    "PitchShift",
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


def denormalize(norm_val, max_val, min_val):
    """Map a normalized (0, 1) value onto [min_val, max_val]."""
    return (norm_val * (max_val - min_val)) + min_val


def normalize(val, min_val, max_val):
    """Map a value from [min_val, max_val] onto (0, 1)."""
    return (val - min_val) / (max_val - min_val)


def _snapshot_arg(v):
    """Freeze a constructor argument for ``_init_spec``: lists and tuples
    become tuples element by element and one-shot iterators are
    materialized, so the spec stays what ``__init__`` consumed; scalars,
    strings, tensors and processors pass by reference."""
    if isinstance(v, (str, bytes)) or hasattr(v, "shape"):
        return v
    if isinstance(v, dict):
        return {k: _snapshot_arg(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_snapshot_arg(x) for x in v)
    if hasattr(v, "__next__"):
        return tuple(v)
    return v


class Processor:
    """Base class: named parameter ranges + normalized-tensor dispatch.

    Subclasses set ``sample_rate``, ``process_fn`` and ``param_ranges``.
    ``stochastic`` marks processors whose effect draws noise (they take
    ``generator=`` or ``noise=``); ``consumes_kwargs`` names the side
    inputs that :class:`Chain` forwards to the processor.
    """

    sample_rate: int
    process_fn: Callable
    param_ranges: Dict[str, Tuple[float, float]]
    stochastic: bool = False
    consumes_kwargs: Tuple[str, ...] = ()

    def __init__(self):
        pass

    def __init_subclass__(cls, **kw):
        """Record each instance's constructor arguments as ``_init_spec =
        (class name, args, kwargs)``. The most-derived ``__init__`` runs
        first and records; a ``super().__init__()`` chain never overwrites
        it."""
        super().__init_subclass__(**kw)
        if "__init__" in cls.__dict__:
            orig = cls.__dict__["__init__"]

            @functools.wraps(orig)
            def wrapped(self, *a, __orig=orig, **k):
                if not hasattr(self, "_init_spec"):
                    a = tuple(_snapshot_arg(v) for v in a)
                    k = {kk: _snapshot_arg(v) for kk, v in k.items()}
                    self._init_spec = (type(self).__name__, a, dict(k))
                __orig(self, *a, **k)

            cls.__init__ = wrapped

    @property
    def num_params(self) -> int:
        return len(self.param_ranges)

    def process_normalized(
        self,
        x: torch.Tensor,
        param_tensor: torch.Tensor,
        clip_params: bool = False,
        **kwargs,
    ) -> torch.Tensor:
        """Run the processor from a (batch, num_params) normalized tensor.

        Parameters occupy columns in ``param_ranges`` declaration order.

        Args:
            x: input audio, (bs, chs, T).
            param_tensor: normalized parameters on (0, 1), (bs, num_params).
            clip_params: clamp parameters into [0, 1] instead of validating.
            **kwargs: forwarded to the functional effect (e.g.
                ``generator=`` or ``noise=`` for :class:`NoiseShapedReverb`).
        """
        if clip_params:
            param_tensor = torch.clamp(param_tensor, 0.0, 1.0)
        param_dict = self.extract_param_dict(param_tensor)
        denorm = self.denormalize_param_dict(param_dict, validate=not clip_params)
        return self.process_fn(x, self.sample_rate, **denorm, **kwargs)

    def process(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        """Raw passthrough to the functional effect (denormalized
        parameters)."""
        return self.process_fn(x, *args, **kwargs)

    def extract_param_dict(self, param_tensor: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Split a (bs, num_params) tensor into named columns."""
        if param_tensor.shape[1] != len(self.param_ranges):
            raise ValueError(
                f"Parameter tensor has {param_tensor.shape[1]} parameters, "
                f"but processor has {len(self.param_ranges)} parameters."
            )
        return {
            name: param_tensor[:, idx]
            for idx, name in enumerate(self.param_ranges.keys())
        }

    def denormalize_param_dict(
        self, param_dict: Dict[str, torch.Tensor], validate: bool = True
    ) -> Dict[str, torch.Tensor]:
        """Map normalized (0, 1) parameters onto their declared ranges,
        raising ``ValueError`` on a value outside [0, 1] when ``validate``."""
        out = {}
        for name, p in param_dict.items():
            if validate and bool((p < 0).any() or (p > 1).any()):
                raise ValueError(f"Parameter {name} is out of range.")
            lo, hi = self.param_ranges[name]
            out[name] = denormalize(p, hi, lo)
        return out


def _with_defaults(fn, **defaults):
    """``fn`` with these keyword defaults (a caller may still pass each);
    positional arguments pass straight through."""
    return lambda x, *a, **kw: fn(x, *a, **{**defaults, **kw})


class Chain(Processor):
    """Serial composition of processors driven by ONE parameter tensor: a
    network emits ``(bs, sum(num_params))`` and the chain gives each
    processor its consecutive group of columns, in order.

    Noise: where the JAX package derives each stochastic member's key by
    ``fold_in(key, i)``, here the stochastic members draw, in chain order,
    from the one ``generator=`` passed in; each advances it by the draws it
    makes, so a call is deterministic for a given generator state, a
    parameter added to or a processor without noise inserted anywhere
    never changes another member's noise, and nothing is read back from
    the device. ``noise=`` (deterministic injection) goes to every member
    that names it in ``consumes_kwargs``, as in the JAX package.

    Example::

        chain = Chain([ParametricEQ(sr), Compressor(sr), NoiseShapedReverb(sr), Gain(sr)])
        y = chain.process_normalized(x, p, clip_params=True, generator=gen)  # p: (bs, 50)
    """

    def __init__(self, processors: Sequence[Processor]):
        super().__init__()
        if not processors:
            raise ValueError("Chain requires at least one processor.")
        self.processors = list(processors)
        self.sample_rate = self.processors[0].sample_rate
        self.stochastic = any(p.stochastic for p in self.processors)
        self.param_ranges = {
            f"p{i}.{name}": rng
            for i, p in enumerate(self.processors)
            for name, rng in p.param_ranges.items()
        }

    def process_normalized(
        self,
        x: torch.Tensor,
        param_tensor: torch.Tensor,
        clip_params: bool = False,
        generator: Optional[torch.Generator] = None,
        **kwargs,
    ) -> torch.Tensor:
        """Run every processor in turn on its columns of ``param_tensor``.
        ``generator`` goes to the stochastic members; each named side input
        in ``kwargs`` (``noise=``) goes to the members that declare it in
        ``consumes_kwargs``, and no other member sees it."""
        if param_tensor.shape[1] != self.num_params:
            raise ValueError(
                f"Parameter tensor has {param_tensor.shape[1]} parameters, "
                f"but processor has {self.num_params} parameters."
            )
        if self.stochastic and generator is None and "noise" not in kwargs:
            raise ValueError("Chain contains a stochastic processor: pass generator= (or noise=).")
        y = x
        col = 0
        for p in self.processors:
            cols = param_tensor[:, col : col + p.num_params]
            col += p.num_params
            kw = {name: kwargs[name] for name in p.consumes_kwargs if name in kwargs}
            if p.stochastic and generator is not None:
                kw["generator"] = generator
            y = p.process_normalized(y, cols, clip_params=clip_params, **kw)
        return y

    def process(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        raise NotImplementedError("Chain has no single functional form; use process_normalized.")


class Gain(Processor):
    """Gain in dB."""

    def __init__(self, sample_rate: int, min_gain_db: float = -24.0, max_gain_db: float = 24.0):
        self.sample_rate = sample_rate
        self.process_fn = F.gain
        self.param_ranges = {"gain_db": (min_gain_db, max_gain_db)}


class Distortion(Processor):
    """Soft-clip distortion, ``drive_db`` in dB."""

    def __init__(self, sample_rate: int, min_drive_db: float = 0.0, max_drive_db: float = 24.0):
        self.sample_rate = sample_rate
        self.process_fn = F.distortion
        self.param_ranges = {"drive_db": (min_drive_db, max_drive_db)}


class AdvancedDistortion(Processor):
    """Distortion with gain staging, tone and dc offset
    (:func:`functional.advanced_distortion`)."""

    def __init__(
        self,
        sample_rate: int,
        min_gain_db: float = 0.0,
        max_gain_db: float = 24.0,
        min_dc_offset: float = -0.1,
        max_dc_offset: float = 0.1,
        filter_method: str = "block",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.advanced_distortion, filter_method=filter_method)
        self.param_ranges = {
            "input_gain_db": (min_gain_db, max_gain_db),
            "output_gain_db": (-max_gain_db, 0.0),
            "tone": (0.0, 1.0),
            "dc_offset": (min_dc_offset, max_dc_offset),
        }


class ParametricEQ(Processor):
    """Six-band parametric EQ (same staggered per-band cutoff ranges as the
    JAX package). ``filter_method`` as in :func:`functional.parametric_eq`:
    "pallas" selects the CUDA biquad-cascade kernel."""

    def __init__(
        self,
        sample_rate: int,
        min_gain_db: float = -20.0,
        max_gain_db: float = 20.0,
        min_q_factor: float = 0.1,
        max_q_factor: float = 6.0,
        filter_method: str = "fsm",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.parametric_eq, filter_method=filter_method)
        self.param_ranges = {
            "low_shelf_gain_db": (min_gain_db, max_gain_db),
            "low_shelf_cutoff_freq": (20, 2000),
            "low_shelf_q_factor": (min_q_factor, max_q_factor),
            "band0_gain_db": (min_gain_db, max_gain_db),
            "band0_cutoff_freq": (80, 2000),
            "band0_q_factor": (min_q_factor, max_q_factor),
            "band1_gain_db": (min_gain_db, max_gain_db),
            "band1_cutoff_freq": (2000, 8000),
            "band1_q_factor": (min_q_factor, max_q_factor),
            "band2_gain_db": (min_gain_db, max_gain_db),
            "band2_cutoff_freq": (8000, 12000),
            "band2_q_factor": (min_q_factor, max_q_factor),
            "band3_gain_db": (min_gain_db, max_gain_db),
            "band3_cutoff_freq": (12000, (sample_rate // 2) - 1000),
            "band3_q_factor": (min_q_factor, max_q_factor),
            "high_shelf_gain_db": (min_gain_db, max_gain_db),
            "high_shelf_cutoff_freq": (4000, (sample_rate // 2) - 1000),
            "high_shelf_q_factor": (min_q_factor, max_q_factor),
        }


class GraphicEQ(Processor):
    """Ten-band octave graphic EQ (:func:`functional.graphic_eq`), one
    parameter ``band{i}_gain_db`` per band. ``process(x, sr, gains)``
    passes a (bs, 10) gain tensor straight through."""

    def __init__(
        self,
        sample_rate: int,
        min_gain_db: float = -12.0,
        max_gain_db: float = 12.0,
        filter_method: str = "coupled",
    ):
        self.sample_rate = sample_rate
        n_bands = len(F.GRAPHIC_EQ_BANDS)
        self.param_ranges = {f"band{i}_gain_db": (min_gain_db, max_gain_db) for i in range(n_bands)}

        def _process(x, sr, *args, **kw):
            fm = kw.pop("filter_method", filter_method)
            if args:  # raw positional passthrough: graphic_eq(x, sr, gains)
                return F.graphic_eq(x, sr, *args, filter_method=fm, **kw)
            gains = torch.stack([kw.pop(f"band{i}_gain_db") for i in range(n_bands)], dim=-1)
            return F.graphic_eq(x, sr, gains, filter_method=fm, **kw)

        self.process_fn = _process


class Compressor(Processor):
    """Feed-forward compressor. ``smoother`` as in
    :func:`functional.compressor`: "exact_pallas" selects the CUDA
    ballistics kernel, "pallas" the CUDA biquad-cascade kernel."""

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_attack_ms: float = 5.0,
        max_attack_ms: float = 100.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 100.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        min_makeup_gain_db: float = 0.0,
        max_makeup_gain_db: float = 12.0,
        smoother: str = "fsm",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.compressor, smoother=smoother)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
            "makeup_gain_db": (min_makeup_gain_db, max_makeup_gain_db),
        }


class Expander(Processor):
    """Downward expander, the compressor's dual (:func:`functional.expander`)."""

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_attack_ms: float = 5.0,
        max_attack_ms: float = 100.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 100.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        min_makeup_gain_db: float = 0.0,
        max_makeup_gain_db: float = 12.0,
        smoother: str = "exact_pallas",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.expander, smoother=smoother)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
            "makeup_gain_db": (min_makeup_gain_db, max_makeup_gain_db),
        }


class SidechainCompressor(Processor):
    """Compressor keyed by an external sidechain, a ducker
    (:func:`functional.sidechain_compressor`). The key signal is not a
    parameter: pass it as ``process_normalized(x, p, sidechain=key)``;
    :class:`Chain` forwards it."""

    consumes_kwargs = ("sidechain",)

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_attack_ms: float = 5.0,
        max_attack_ms: float = 100.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 500.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        min_makeup_gain_db: float = 0.0,
        max_makeup_gain_db: float = 12.0,
        smoother: str = "exact_pallas",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.sidechain_compressor, smoother=smoother)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
            "makeup_gain_db": (min_makeup_gain_db, max_makeup_gain_db),
        }


class NoiseGate(Processor):
    """Noise gate (:func:`functional.noise_gate`); ``hold_ms`` is a
    constructor setting, not a parameter."""

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -80.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_range_db: float = 0.0,
        max_range_db: float = 80.0,
        min_attack_ms: float = 0.05,
        max_attack_ms: float = 20.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 500.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        hold_ms: float = 0.0,
        smoother: str = "exact_pallas",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.noise_gate, smoother=smoother, hold_ms=hold_ms)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "range_db": (min_range_db, max_range_db),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
        }


class DeEsser(Processor):
    """Sibilance compressor (:func:`functional.de_esser`); ``mode``
    ("split" or "wideband") is a constructor setting."""

    def __init__(
        self,
        sample_rate: int,
        min_frequency_hz: float = 2000.0,
        max_frequency_hz: float = 12000.0,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_attack_ms: float = 0.5,
        max_attack_ms: float = 20.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 200.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        mode: str = "split",
        smoother: str = "exact_pallas",
        filter_method: str = "coupled",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.de_esser, mode=mode, smoother=smoother, filter_method=filter_method)
        self.param_ranges = {
            "frequency_hz": (min_frequency_hz, max_frequency_hz),
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
        }


class Limiter(Processor):
    """Feed-forward limiter, the compressor at ratio -> infinity
    (:func:`functional.limiter`), true attack/release ballistics by
    default."""

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -24.0,
        max_threshold_db: float = 0.0,
        min_attack_ms: float = 0.1,
        max_attack_ms: float = 20.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 500.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        min_makeup_gain_db: float = 0.0,
        max_makeup_gain_db: float = 12.0,
        lookahead_samples: int = 0,
        smoother: str = "exact_pallas",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.limiter, smoother=smoother, lookahead_samples=lookahead_samples)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
            "makeup_gain_db": (min_makeup_gain_db, max_makeup_gain_db),
        }


class MultibandCompressor(Processor):
    """Three-band compressor over an LR4 crossover tree
    (:func:`functional.multiband_compressor`)."""

    def __init__(
        self,
        sample_rate: int,
        min_crossover_low_hz: float = 60.0,
        max_crossover_low_hz: float = 1000.0,
        min_crossover_high_hz: float = 1000.0,
        max_crossover_high_hz: float = 12000.0,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 20.0,
        min_attack_ms: float = 5.0,
        max_attack_ms: float = 100.0,
        min_release_ms: float = 5.0,
        max_release_ms: float = 100.0,
        min_makeup_gain_db: float = 0.0,
        max_makeup_gain_db: float = 12.0,
        min_knee_db: float = 0.0,
        max_knee_db: float = 12.0,
        smoother: str = "block",
        filter_method: str = "coupled",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.multiband_compressor, smoother=smoother, filter_method=filter_method)
        ranges = {
            "crossover_low_hz": (min_crossover_low_hz, max_crossover_low_hz),
            "crossover_high_hz": (min_crossover_high_hz, max_crossover_high_hz),
        }
        for band in ("low", "mid", "high"):
            ranges[f"{band}_threshold_db"] = (min_threshold_db, max_threshold_db)
            ranges[f"{band}_ratio"] = (min_ratio, max_ratio)
            ranges[f"{band}_attack_ms"] = (min_attack_ms, max_attack_ms)
            ranges[f"{band}_release_ms"] = (min_release_ms, max_release_ms)
            ranges[f"{band}_makeup_gain_db"] = (min_makeup_gain_db, max_makeup_gain_db)
        ranges["knee_db"] = (min_knee_db, max_knee_db)
        self.param_ranges = ranges


class TransientShaper(Processor):
    """Threshold-free attack and sustain control
    (:func:`functional.transient_shaper`); the smoother is a constructor
    setting."""

    def __init__(
        self,
        sample_rate: int,
        min_attack: float = -1.0,
        max_attack: float = 1.0,
        min_sustain: float = -1.0,
        max_sustain: float = 1.0,
        min_output_gain_db: float = -12.0,
        max_output_gain_db: float = 12.0,
        smoother: str = "parallel",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.transient_shaper, smoother=smoother)
        self.param_ranges = {
            "attack": (min_attack, max_attack),
            "sustain": (min_sustain, max_sustain),
            "output_gain_db": (min_output_gain_db, max_output_gain_db),
        }


class Exciter(Processor):
    """Harmonic exciter (:func:`functional.exciter`)."""

    def __init__(
        self,
        sample_rate: int,
        min_frequency_hz: float = 1000.0,
        max_frequency_hz: float = 10000.0,
        min_drive_db: float = 0.0,
        max_drive_db: float = 24.0,
        min_amount: float = 0.0,
        max_amount: float = 1.0,
        filter_method: str = "coupled",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.exciter, filter_method=filter_method)
        self.param_ranges = {
            "frequency_hz": (min_frequency_hz, max_frequency_hz),
            "drive_db": (min_drive_db, max_drive_db),
            "amount": (min_amount, max_amount),
        }


class Bitcrusher(Processor):
    """Bit-depth and sample-rate reduction (:func:`functional.bitcrusher`)."""

    def __init__(
        self,
        sample_rate: int,
        min_bit_depth: float = 2.0,
        max_bit_depth: float = 16.0,
        min_sample_rate_hz: float = 1000.0,
        max_sample_rate_hz: float = 44100.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = F.bitcrusher
        self.param_ranges = {
            "bit_depth": (min_bit_depth, max_bit_depth),
            "sample_rate_hz": (min_sample_rate_hz, max_sample_rate_hz),
            "mix": (min_mix, max_mix),
        }


class Clipper(Processor):
    """Hard/soft clipper with a ceiling (:func:`functional.clipper`)."""

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = -24.0,
        max_threshold_db: float = 0.0,
        min_hardness: float = 0.0,
        max_hardness: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = F.clipper
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "hardness": (min_hardness, max_hardness),
        }


class NoiseShapedReverb(Processor):
    """Filtered-noise-shaping reverb. ``process_normalized`` needs
    ``generator=`` (a ``torch.Generator`` on the audio's device) or
    ``noise=``, since the effect is stochastic."""

    stochastic = True
    consumes_kwargs = ("noise",)

    def __init__(
        self,
        sample_rate: int,
        min_band_gain: float = 0.0,
        max_band_gain: float = 1.0,
        min_band_decay: float = 0.0,
        max_band_decay: float = 1.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
        num_samples: int = 65536,
        num_bandpass_taps: int = 1023,
        noise_mode: str = "time",
        ir_conv_fn=None,
    ):
        """``ir_conv_fn`` plugs a custom signal-with-IR convolution into the
        effect (e.g. ``parallel.sharded_fft_conv_causal`` bound to a mesh,
        for sequence-parallel rendering)."""
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.noise_shaped_reverberation, num_samples=num_samples,
                                         num_bandpass_taps=num_bandpass_taps, noise_mode=noise_mode,
                                         ir_conv_fn=ir_conv_fn)
        ranges = {f"band{i}_gain": (min_band_gain, max_band_gain) for i in range(12)}
        ranges.update({f"band{i}_decay": (min_band_decay, max_band_decay) for i in range(12)})
        ranges["mix"] = (min_mix, max_mix)
        self.param_ranges = ranges


class StereoWidener(Processor):
    """Mid/side stereo widener (:func:`functional.stereo_widener`)."""

    def __init__(self, sample_rate: int, min_width: float = 0.0, max_width: float = 1.0):
        self.sample_rate = sample_rate
        self.process_fn = F.stereo_widener
        self.param_ranges = {"width": (min_width, max_width)}


class StereoPanner(Processor):
    """Constant-power stereo panner for a single mono track
    (:func:`functional.stereo_panner`)."""

    def __init__(self, sample_rate: int, min_pan: float = 0.0, max_pan: float = 1.0):
        self.sample_rate = sample_rate
        self.process_fn = F.stereo_panner
        self.param_ranges = {"pan": (min_pan, max_pan)}


class StereoBus(Processor):
    """Stereo bus with per-track sends for a fixed number of tracks
    (:func:`functional.stereo_bus`): one parameter ``track{i}_send_db`` per
    track. ``process(x, sr, send_db)`` passes a (bs, tracks) send tensor
    straight through."""

    def __init__(self, sample_rate: int, num_tracks: int, min_send_db: float = -80.0,
                 max_send_db: float = 12.0):
        self.sample_rate = sample_rate
        self.num_tracks = num_tracks
        self.param_ranges = {f"track{i}_send_db": (min_send_db, max_send_db) for i in range(num_tracks)}

        def _process(x, sr, *args, **sends):
            if args:  # raw positional passthrough: stereo_bus(x, sr, send_db)
                return F.stereo_bus(x, sr, *args, **sends)
            send_db = torch.stack([sends[f"track{i}_send_db"] for i in range(num_tracks)], dim=-1)
            return F.stereo_bus(x, sr, send_db)

        self.process_fn = _process


class _ModulatedDelay(Processor):
    """Shared body of Chorus and Flanger: LFO-modulated fractional delay.

    The declared ranges bound the total delay, so the wrapper passes
    ``max_delay_ms = max_base + max_depth`` to
    :func:`functional.modulated_delay` (no read of the parameters to the
    host)."""

    def __init__(
        self,
        sample_rate: int,
        min_rate_hz: float,
        max_rate_hz: float,
        min_depth_ms: float,
        max_depth_ms: float,
        min_base_ms: float,
        max_base_ms: float,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.modulated_delay, max_delay_ms=max_base_ms + max_depth_ms)
        self.param_ranges = {
            "rate_hz": (min_rate_hz, max_rate_hz),
            "depth_ms": (min_depth_ms, max_depth_ms),
            "base_ms": (min_base_ms, max_base_ms),
            "mix": (min_mix, max_mix),
        }


class Chorus(_ModulatedDelay):
    """Chorus: slow LFO, long base delay (~20 ms), moderate depth."""

    def __init__(
        self,
        sample_rate: int,
        min_rate_hz: float = 0.1,
        max_rate_hz: float = 3.0,
        min_depth_ms: float = 1.0,
        max_depth_ms: float = 10.0,
        min_base_ms: float = 15.0,
        max_base_ms: float = 35.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        super().__init__(sample_rate, min_rate_hz, max_rate_hz, min_depth_ms, max_depth_ms,
                         min_base_ms, max_base_ms, min_mix, max_mix)


class Flanger(_ModulatedDelay):
    """Flanger: short base delay (< 5 ms) so the comb notches sweep audibly."""

    def __init__(
        self,
        sample_rate: int,
        min_rate_hz: float = 0.05,
        max_rate_hz: float = 2.0,
        min_depth_ms: float = 0.5,
        max_depth_ms: float = 5.0,
        min_base_ms: float = 0.1,
        max_base_ms: float = 2.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        super().__init__(sample_rate, min_rate_hz, max_rate_hz, min_depth_ms, max_depth_ms,
                         min_base_ms, max_base_ms, min_mix, max_mix)


class PitchShift(Processor):
    """Dual-tap delay-line pitch shifter (:func:`functional.pitch_shift`).

    ``semitones`` and ``mix`` are normalized parameters; ``window_ms`` is a
    constructor setting."""

    def __init__(
        self,
        sample_rate: int,
        min_semitones: float = -12.0,
        max_semitones: float = 12.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
        window_ms: float = 60.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.pitch_shift, window_ms=window_ms)
        self.param_ranges = {
            "semitones": (min_semitones, max_semitones),
            "mix": (min_mix, max_mix),
        }


class Delay(Processor):
    """Feedback delay (echo) with a continuous delay time
    (:func:`functional.delay`)."""

    def __init__(
        self,
        sample_rate: int,
        min_delay_ms: float = 10.0,
        max_delay_ms: float = 1000.0,
        min_feedback: float = 0.0,
        max_feedback: float = 0.9,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = F.delay
        self.param_ranges = {
            "delay_ms": (min_delay_ms, max_delay_ms),
            "feedback": (min_feedback, max_feedback),
            "mix": (min_mix, max_mix),
        }


class RingModulator(Processor):
    """Sinusoidal carrier multiplication (:func:`functional.ring_modulator`)."""

    def __init__(
        self,
        sample_rate: int,
        min_frequency_hz: float = 20.0,
        max_frequency_hz: float = 4000.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = F.ring_modulator
        self.param_ranges = {
            "frequency_hz": (min_frequency_hz, max_frequency_hz),
            "mix": (min_mix, max_mix),
        }


class Tremolo(Processor):
    """Sinusoidal amplitude modulation (:func:`functional.tremolo`)."""

    def __init__(
        self,
        sample_rate: int,
        min_rate_hz: float = 0.1,
        max_rate_hz: float = 10.0,
        min_depth: float = 0.0,
        max_depth: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = F.tremolo
        self.param_ranges = {
            "rate_hz": (min_rate_hz, max_rate_hz),
            "depth": (min_depth, max_depth),
        }


class StereoImager(Processor):
    """Multiband stereo width (:func:`functional.stereo_imager`)."""

    def __init__(
        self,
        sample_rate: int,
        min_crossover_low_hz: float = 80.0,
        max_crossover_low_hz: float = 500.0,
        min_crossover_high_hz: float = 1000.0,
        max_crossover_high_hz: float = 8000.0,
        min_width: float = 0.0,
        max_width: float = 1.0,
        filter_method: str = "coupled",
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.stereo_imager, filter_method=filter_method)
        self.param_ranges = {
            "crossover_low_hz": (min_crossover_low_hz, max_crossover_low_hz),
            "crossover_high_hz": (min_crossover_high_hz, max_crossover_high_hz),
            "low_width": (min_width, max_width),
            "mid_width": (min_width, max_width),
            "high_width": (min_width, max_width),
        }


class ConvolutionReverb(Processor):
    """User-IR convolution reverb (:func:`functional.convolution_reverb`).
    ``mix`` is the parameter; the impulse response (which may itself be a
    trainable tensor) goes in as ``process_normalized(x, p, ir=...)``, and
    :class:`Chain` forwards it."""

    consumes_kwargs = ("ir",)

    def __init__(self, sample_rate: int, min_mix: float = 0.0, max_mix: float = 1.0, block: Optional[int] = None):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.convolution_reverb, block=block)
        self.param_ranges = {"mix": (min_mix, max_mix)}


class WowFlutter(Processor):
    """Tape speed instability (:func:`functional.wow_flutter`). Stochastic:
    ``process_normalized`` needs ``generator=`` or ``noise=``."""

    stochastic = True
    consumes_kwargs = ("noise",)

    def __init__(
        self,
        sample_rate: int,
        min_depth_ms: float = 0.0,
        max_depth_ms: float = 1.5,
        min_rate_hz: float = 0.1,
        max_wow_rate_hz: float = 2.0,
        max_flutter_rate_hz: float = 30.0,
        base_ms: float = 5.0,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.wow_flutter, base_ms=base_ms)
        self.param_ranges = {
            "wow_depth_ms": (min_depth_ms, max_depth_ms),
            "flutter_depth_ms": (min_depth_ms, max_depth_ms),
            "wow_rate_hz": (min_rate_hz, max_wow_rate_hz),
            "flutter_rate_hz": (min_rate_hz, max_flutter_rate_hz),
        }


class SpectralGate(Processor):
    """Spectral noise gate (:func:`functional.spectral_gate`). The
    threshold, range, attack and release are parameters; the frames,
    sharpness and smoother are constructor settings. A measured floor goes
    in as ``process_normalized(x, p, noise_profile_db=...)``, and
    :class:`Chain` forwards it."""

    consumes_kwargs = ("noise_profile_db",)

    def __init__(
        self,
        sample_rate: int,
        min_threshold_db: float = 0.0,
        max_threshold_db: float = 24.0,
        min_range_db: float = 0.0,
        max_range_db: float = 60.0,
        min_attack_ms: float = 1.0,
        max_attack_ms: float = 50.0,
        min_release_ms: float = 20.0,
        max_release_ms: float = 500.0,
        sharpness_db: float = 3.0,
        frame_size: int = 2048,
        hop: int = 512,
        smoother: str = "parallel",
        tv_power_fn=None,
        tv_filter_fn=None,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.spectral_gate, sharpness_db=sharpness_db, frame_size=frame_size, hop=hop,
                                         smoother=smoother, tv_power_fn=tv_power_fn, tv_filter_fn=tv_filter_fn)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "range_db": (min_range_db, max_range_db),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
        }


class DynamicEQ(Processor):
    """N-band dynamic EQ (:func:`functional.dynamic_eq`). ``num_bands`` is a
    constructor setting; the normalized tensor holds ``num_bands * 6``
    columns in band-major order (band0_frequency_hz .. band0_release_ms,
    band1_...), the bands' frequency ranges staggered geometrically from
    40 Hz to Nyquist. ``process(x, sr, frequency_hz, ...)`` passes (bs,
    n_bands) tensors straight through."""

    _NAMES = ("frequency_hz", "q_factor", "threshold_db", "ratio", "attack_ms", "release_ms")

    def __init__(
        self,
        sample_rate: int,
        num_bands: int = 3,
        min_q: float = 0.5,
        max_q: float = 8.0,
        min_threshold_db: float = -60.0,
        max_threshold_db: float = 0.0,
        min_ratio: float = 1.0,
        max_ratio: float = 10.0,
        min_attack_ms: float = 1.0,
        max_attack_ms: float = 100.0,
        min_release_ms: float = 10.0,
        max_release_ms: float = 500.0,
        knee_db: float = 6.0,
        max_cut_db: float = 24.0,
        frame_size: int = 1024,
        hop: int = 256,
        smoother: str = "parallel",
        tv_power_fn=None,
        tv_filter_fn=None,
    ):
        self.sample_rate = sample_rate
        self.num_bands = num_bands
        edges = [40.0 * (0.5 * sample_rate / 40.0) ** (i / num_bands) for i in range(num_bands + 1)]
        ranges = {
            "q_factor": (min_q, max_q),
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
        }
        self.param_ranges = {
            f"band{i}_{name}": (edges[i], edges[i + 1]) if name == "frequency_hz" else ranges[name]
            for i in range(num_bands) for name in self._NAMES
        }
        static = {"knee_db": knee_db, "max_cut_db": max_cut_db, "frame_size": frame_size, "hop": hop,
                  "smoother": smoother, "tv_power_fn": tv_power_fn, "tv_filter_fn": tv_filter_fn}

        def _process(x, sr, *args, **kw):
            if args:  # raw positional passthrough
                return F.dynamic_eq(x, sr, *args, **{**static, **kw})
            stacked = {name: torch.stack([kw.pop(f"band{i}_{name}") for i in range(num_bands)], dim=-1)
                       for name in self._NAMES}
            return F.dynamic_eq(x, sr, **stacked, **{**static, **kw})

        self.process_fn = _process


class Phaser(Processor):
    """LFO-swept allpass-cascade phaser (:func:`functional.phaser`);
    ``stages``, ``frame_size`` and ``hop`` are constructor settings."""

    def __init__(
        self,
        sample_rate: int,
        min_rate_hz: float = 0.05,
        max_rate_hz: float = 5.0,
        min_depth: float = 0.0,
        max_depth: float = 1.0,
        min_centre_frequency_hz: float = 200.0,
        max_centre_frequency_hz: float = 2000.0,
        min_feedback: float = -0.8,
        max_feedback: float = 0.8,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
        stages: int = 6,
        frame_size: int = 512,
        hop: int = 128,
        tv_filter_fn=None,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.phaser, stages=stages, frame_size=frame_size, hop=hop,
                                         tv_filter_fn=tv_filter_fn)
        self.param_ranges = {
            "rate_hz": (min_rate_hz, max_rate_hz),
            "depth": (min_depth, max_depth),
            "centre_frequency_hz": (min_centre_frequency_hz, max_centre_frequency_hz),
            "feedback": (min_feedback, max_feedback),
            "mix": (min_mix, max_mix),
        }


class AutoWah(Processor):
    """Envelope-following resonant band-pass (:func:`functional.auto_wah`);
    ``frame_size`` and ``hop`` are constructor settings. Both ends of the
    sweep are parameters over the whole range (the effect keeps the top at
    least 1.01 x the bottom)."""

    def __init__(
        self,
        sample_rate: int,
        min_sensitivity: float = 0.5,
        max_sensitivity: float = 20.0,
        min_attack_ms: float = 1.0,
        max_attack_ms: float = 50.0,
        min_release_ms: float = 10.0,
        max_release_ms: float = 500.0,
        min_frequency_hz: float = 100.0,
        max_frequency_hz: float = 4000.0,
        min_q_factor: float = 0.707,
        max_q_factor: float = 10.0,
        min_mix: float = 0.0,
        max_mix: float = 1.0,
        frame_size: int = 512,
        hop: int = 128,
        tv_filter_fn=None,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.auto_wah, frame_size=frame_size, hop=hop, tv_filter_fn=tv_filter_fn)
        self.param_ranges = {
            "sensitivity": (min_sensitivity, max_sensitivity),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "min_frequency_hz": (min_frequency_hz, max_frequency_hz),
            "max_frequency_hz": (min_frequency_hz, max_frequency_hz),
            "q_factor": (min_q_factor, max_q_factor),
            "mix": (min_mix, max_mix),
        }


class TimeStretch(Processor):
    """Phase-vocoder time stretch with a learnable rate
    (:func:`functional.time_stretch` in its fixed-length mode): the output
    keeps the input's length, an interior time warp."""

    def __init__(
        self,
        sample_rate: int,
        min_rate: float = 0.5,
        max_rate: float = 2.0,
        frame_size: int = 2048,
        hop: int = 512,
    ):
        self.sample_rate = sample_rate
        self.process_fn = lambda x, *a, **kw: F.time_stretch(
            x, *a, **{"frame_size": frame_size, "hop": hop, "out_len": x.shape[-1], **kw})
        self.param_ranges = {"rate": (min_rate, max_rate)}


class PitchShiftPV(Processor):
    """Phase-vocoder pitch shifter with a learnable shift
    (:func:`functional.pitch_shift_pv` in its bounded mode, sized for
    ``max_semitones``)."""

    def __init__(
        self,
        sample_rate: int,
        min_semitones: float = -12.0,
        max_semitones: float = 12.0,
        frame_size: int = 2048,
        hop: int = 512,
    ):
        self.sample_rate = sample_rate
        self.process_fn = _with_defaults(F.pitch_shift_pv, frame_size=frame_size, hop=hop,
                                         max_semitones=max_semitones)
        self.param_ranges = {"semitones": (min_semitones, max_semitones)}
