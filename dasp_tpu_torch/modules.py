"""Processor layer: normalized-parameter dispatch for neural control.

PyTorch counterpart of the parts of ``dasp_tpu/modules.py`` that the
style-transfer render and blind estimation of the delay family run
through. A ``Processor`` owns a parameter-range table and turns a
``(batch, num_params)`` tensor of normalized (0, 1) parameters, e.g. the
sigmoid output of a network, into keyword arguments for its functional
effect.

PyTorch runs every call eagerly, so the out-of-range check of
``process_normalized`` always runs unless ``clip_params=True`` (the JAX
package skips it under tracing). The check reads the values back to the
host, which waits for a GPU; the render path passes ``clip_params=True``.

``Chain`` and the other processors are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import functional as F

__all__ = [
    "normalize",
    "denormalize",
    "Processor",
    "Gain",
    "ParametricEQ",
    "Compressor",
    "NoiseShapedReverb",
    "Chorus",
    "Flanger",
    "PitchShift",
]


def denormalize(norm_val, max_val, min_val):
    """Map a normalized (0, 1) value onto [min_val, max_val]."""
    return (norm_val * (max_val - min_val)) + min_val


def normalize(val, min_val, max_val):
    """Map a value from [min_val, max_val] onto (0, 1)."""
    return (val - min_val) / (max_val - min_val)


class Processor:
    """Base class: named parameter ranges + normalized-tensor dispatch.

    Subclasses set ``sample_rate``, ``process_fn`` and ``param_ranges``.
    """

    sample_rate: int
    process_fn: Callable
    param_ranges: Dict[str, Tuple[float, float]]

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


def _with_default(fn, key, value):
    """``fn`` with keyword ``key`` defaulting to ``value`` (a caller may
    still pass it); positional arguments pass straight through."""
    return lambda x, *a, **kw: fn(x, *a, **{key: value, **kw})


class Gain(Processor):
    """Gain in dB."""

    def __init__(self, sample_rate: int, min_gain_db: float = -24.0, max_gain_db: float = 24.0):
        self.sample_rate = sample_rate
        self.process_fn = F.gain
        self.param_ranges = {"gain_db": (min_gain_db, max_gain_db)}


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
        self.process_fn = _with_default(F.parametric_eq, "filter_method", filter_method)
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
        self.process_fn = _with_default(F.compressor, "smoother", smoother)
        self.param_ranges = {
            "threshold_db": (min_threshold_db, max_threshold_db),
            "ratio": (min_ratio, max_ratio),
            "attack_ms": (min_attack_ms, max_attack_ms),
            "release_ms": (min_release_ms, max_release_ms),
            "knee_db": (min_knee_db, max_knee_db),
            "makeup_gain_db": (min_makeup_gain_db, max_makeup_gain_db),
        }


class NoiseShapedReverb(Processor):
    """Filtered-noise-shaping reverb. ``process_normalized`` needs
    ``generator=`` (a ``torch.Generator`` on the audio's device) or
    ``noise=``, since the effect is stochastic."""

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
    ):
        self.sample_rate = sample_rate
        defaults = {
            "num_samples": num_samples,
            "num_bandpass_taps": num_bandpass_taps,
            "noise_mode": noise_mode,
        }
        self.process_fn = lambda x, *a, **kw: F.noise_shaped_reverberation(
            x, *a, **{**defaults, **kw}
        )
        ranges = {f"band{i}_gain": (min_band_gain, max_band_gain) for i in range(12)}
        ranges.update({f"band{i}_decay": (min_band_decay, max_band_decay) for i in range(12)})
        ranges["mix"] = (min_mix, max_mix)
        self.param_ranges = ranges


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
        self.process_fn = _with_default(F.modulated_delay, "max_delay_ms", max_base_ms + max_depth_ms)
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
        self.process_fn = _with_default(F.pitch_shift, "window_ms", window_ms)
        self.param_ranges = {
            "semitones": (min_semitones, max_semitones),
            "mix": (min_mix, max_mix),
        }
