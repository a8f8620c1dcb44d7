"""Differentiable audio effects as plain functions on (bs, ch, T) tensors.

PyTorch counterpart of the parts of ``dasp_tpu/functional.py`` that the
style-transfer render runs through: ``gain``, ``parametric_eq``,
``compressor`` and ``noise_shaped_reverberation``. Parameters are tensors of
shape (bs,) (or Python scalars); gradients flow to them and to the audio
by autograd, and through the CUDA kernels by their backward kernels.

Option strings keep the JAX package's spelling so that a configuration
means the same in both packages. ``filter_method="pallas"``,
``smoother="pallas"`` and ``smoother="exact_pallas"`` select the
hand-written CUDA kernels here (on a CPU tensor, their plain PyTorch
versions). ``filter_method="exact"`` and ``smoother="exact"`` run the plain
versions on any device. Other options raise ``ValueError``.
"""

from __future__ import annotations

import math

import torch

from .ops.ballistics_kernel import ballistics_pallas
from .ops.biquad import biquad
from .ops.filterbank import octave_band_filterbank
from .ops.fir import fft_conv_causal, fft_correlate_valid
from .ops.iir import ballistics_smooth, onepole_ba
from .ops.iir_kernel import lfilter1_pallas, sosfilt_pallas, sosfilt_plain

__all__ = [
    "db_to_linear",
    "gain",
    "parametric_eq",
    "parametric_eq_sos",
    "static_gain_computer",
    "compressor",
    "noise_shaped_reverberation",
    "noise_shaped_ir",
    "spectral_band_noise",
]


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP.md Queue 1, {item})")


def _param(p, bs: int, dtype, device) -> torch.Tensor:
    """Canonicalize a parameter (scalar, (bs,), (bs, 1) or (bs, 1, 1)) to
    shape (bs, 1, 1)."""
    p = torch.as_tensor(p, dtype=dtype, device=device)
    if p.ndim == 0:
        return p.expand(bs, 1, 1)
    return p.reshape(bs, 1, 1)


def db_to_linear(db: torch.Tensor) -> torch.Tensor:
    """Convert decibels to linear amplitude: 10 ** (db / 20)."""
    return 10.0 ** (db / 20.0)


def gain(x: torch.Tensor, sample_rate: int, gain_db) -> torch.Tensor:
    """Apply gain in dB, the same on every channel.

    Args:
        x: (bs, chs, T). sample_rate: unused (uniform effect signature).
        gain_db: shape (bs,).
    """
    gain_db = _param(gain_db, x.shape[0], x.dtype, x.device)
    return x * db_to_linear(gain_db)


# ---------------------------------------------------------------------------
# equalization
# ---------------------------------------------------------------------------

_EQ_TYPES = ("low_shelf", "peaking", "peaking", "peaking", "peaking", "high_shelf")


def parametric_eq(
    x: torch.Tensor,
    sample_rate: float,
    low_shelf_gain_db,
    low_shelf_cutoff_freq,
    low_shelf_q_factor,
    band0_gain_db,
    band0_cutoff_freq,
    band0_q_factor,
    band1_gain_db,
    band1_cutoff_freq,
    band1_q_factor,
    band2_gain_db,
    band2_cutoff_freq,
    band2_q_factor,
    band3_gain_db,
    band3_cutoff_freq,
    band3_q_factor,
    high_shelf_gain_db,
    high_shelf_cutoff_freq,
    high_shelf_q_factor,
    filter_method: str = "fsm",
) -> torch.Tensor:
    """Six-band parametric EQ: low shelf, 4 peaking bands, high shelf,
    applied as one biquad cascade.

    Args:
        x: (bs, chs, T).
        sample_rate: audio sample rate (Hz).
        *_gain_db / *_cutoff_freq / *_q_factor: shape (bs,) each.
        filter_method: "pallas" (the CUDA biquad-cascade kernel; its plain
            version on a CPU tensor), "exact" (the plain block-state
            version on any device, differentiable). The JAX package's
            "fsm", "block", "coupled" and callable methods are not ported
            yet and raise.
    """
    bs = x.shape[0]
    sos = parametric_eq_sos(
        bs, x.dtype, sample_rate,
        low_shelf_gain_db, low_shelf_cutoff_freq, low_shelf_q_factor,
        band0_gain_db, band0_cutoff_freq, band0_q_factor,
        band1_gain_db, band1_cutoff_freq, band1_q_factor,
        band2_gain_db, band2_cutoff_freq, band2_q_factor,
        band3_gain_db, band3_cutoff_freq, band3_q_factor,
        high_shelf_gain_db, high_shelf_cutoff_freq, high_shelf_q_factor,
        device=x.device,
    )
    return _apply_sos(sos, x, filter_method)


def parametric_eq_sos(bs, dtype, sample_rate, *params, device=None) -> torch.Tensor:
    """The 6-band parametric EQ cascade as a (bs, 6, 6) SOS tensor from the
    same 18 per-band parameters as :func:`parametric_eq`."""
    if len(params) != 18:
        raise ValueError(f"expected 18 EQ params, got {len(params)}")
    sections = []
    for i, ftype in enumerate(_EQ_TYPES):
        g, f, q = (_param(p, bs, dtype, device).reshape(bs) for p in params[3 * i : 3 * i + 3])
        b, a = biquad(g, f, q, sample_rate, ftype)
        sections.append(torch.cat([b, a], dim=-1))
    return torch.stack(sections, dim=1)


def _apply_sos(sos, x, filter_method):
    if filter_method == "pallas":
        return sosfilt_pallas(sos, x)
    if filter_method == "exact":
        return sosfilt_plain(sos, x)
    if filter_method in ("fsm", "block", "coupled"):
        raise _not_ported(f"filter_method={filter_method!r}", "items 2-3 and 9")
    raise ValueError(
        f"Unknown filter_method: {filter_method!r}. Expected 'pallas' or 'exact'."
    )


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------


def _dynamics_common(x, sample_rate, attack_ms, release_ms, eps):
    """Mono-sum sidechain level in dB and the attack/release coefficients."""
    x_side = torch.sum(x, dim=1, keepdim=True)  # (bs, 1, T)
    ln9 = math.log(9.0)
    alpha_a = torch.exp(-ln9 / (sample_rate * (attack_ms / 1e3)))
    alpha_r = torch.exp(-ln9 / (sample_rate * (release_ms / 1e3)))
    x_db = 20.0 * torch.log10(torch.clamp(torch.abs(x_side), min=eps))
    return x_side, x_db, alpha_a, alpha_r


def static_gain_computer(x_db, threshold_db, ratio, knee_db, mode: str) -> torch.Tensor:
    """Soft-knee static gain curve g_c = x_sc - x_db (dB, <= 0 for
    "compressor" and "limiter"), for ``mode`` "compressor", "expander" or
    "limiter" (the compressor at ratio -> infinity; ``ratio`` unused)."""
    half_knee = knee_db / 2.0
    knee_safe = torch.clamp(torch.as_tensor(knee_db, dtype=x_db.dtype, device=x_db.device), min=1e-6)
    if mode == "limiter":
        x_sc_knee = x_db - ((x_db - threshold_db + half_knee) ** 2) / (2.0 * knee_safe)
        x_sc_out = torch.broadcast_to(torch.as_tensor(threshold_db, dtype=x_db.dtype, device=x_db.device), x_db.shape)
        outside = x_db > threshold_db + half_knee
    elif mode == "compressor":
        x_sc_knee = x_db + ((1.0 / ratio) - 1.0) * (
            (x_db - threshold_db + half_knee) ** 2
        ) / (2.0 * knee_safe)
        x_sc_out = threshold_db + ((x_db - threshold_db) / ratio)
        outside = x_db > threshold_db + half_knee
    elif mode == "expander":
        x_sc_knee = x_db + (1.0 - ratio) * (
            (x_db - threshold_db - half_knee) ** 2
        ) / (2.0 * knee_safe)
        x_sc_out = threshold_db + (x_db - threshold_db) * ratio
        outside = x_db < threshold_db - half_knee
    else:
        raise ValueError(f"Unknown mode: {mode!r}")

    in_knee = (x_db >= threshold_db - half_knee) & (x_db <= threshold_db + half_knee)
    x_sc = torch.where(in_knee, x_sc_knee, x_db)
    x_sc = torch.where(outside, x_sc_out, x_sc)
    return x_sc - x_db


def _smooth_gain(g_c, alpha_a, alpha_r, smoother):
    """Smooth a gain-reduction curve (bs, 1, T) with the selected smoother:
    "exact_pallas" (true attack/release ballistics, CUDA kernel), "pallas"
    (attack-only one-pole through the CUDA biquad-cascade kernel) or "exact"
    (true ballistics, plain loop)."""
    if smoother == "exact_pallas":
        return ballistics_pallas(g_c, alpha_a, alpha_r)
    if smoother == "pallas":
        b, a = onepole_ba(alpha_a.reshape(g_c.shape[0], 1).to(g_c.dtype))
        return lfilter1_pallas(g_c, b, a)
    if smoother == "exact":
        return ballistics_smooth(g_c, alpha_a, alpha_r, mode="exact")
    if smoother in ("fsm", "block", "attack_only", "parallel"):
        raise _not_ported(f"smoother={smoother!r}", "items 2-3 and 9")
    raise ValueError(
        f"Unknown smoother: {smoother!r}. Expected 'exact_pallas', 'pallas' or 'exact'."
    )


def compressor(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    lookahead_samples: int = 0,
    smoother: str = "fsm",
) -> torch.Tensor:
    """Feed-forward compressor: mono-summed sidechain level in dB, soft-knee
    static curve, smoothing, then the time-varying gain (plus makeup) on
    every channel.

    Args:
        x: (bs, chs, T).
        threshold_db, ratio, attack_ms, release_ms, knee_db,
            makeup_gain_db: shape (bs,) each.
        eps: floor of the level detector.
        lookahead_samples: delay the audio against the gain curve.
        smoother: "exact_pallas", "pallas" or "exact" (see
            :func:`_smooth_gain`). The JAX package's "fsm", "block",
            "attack_only", "parallel" and callable smoothers are not
            ported yet and raise.
    """
    bs = x.shape[0]
    dtype, device = x.dtype, x.device
    threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db = (
        _param(p, bs, dtype, device)
        for p in (threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db)
    )
    _, x_db, alpha_a, alpha_r = _dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, ratio, knee_db, "compressor")
    g_smooth = _smooth_gain(g_c, alpha_a, alpha_r, smoother)

    if lookahead_samples > 0:
        # delay the audio relative to the gain curve, zeros shifted in
        la = min(lookahead_samples, x.shape[-1])
        x = torch.cat([torch.zeros_like(x[..., :la]), x[..., : x.shape[-1] - la]], dim=-1)

    return x * db_to_linear(g_smooth + makeup_gain_db)


# ---------------------------------------------------------------------------
# reverb
# ---------------------------------------------------------------------------


def spectral_band_noise(
    generator: torch.Generator,
    num_rows: int,
    filters: torch.Tensor,
    num_samples: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Band-limited Gaussian noise drawn in the spectral domain.

    The rfft of unit white noise has iid N(0, n/2) real and imaginary parts
    on interior bins and a real N(0, n) value at DC (and at Nyquist for even
    n); this draws that directly and applies each band filter with one
    inverse FFT. Draws come from ``generator`` on its own device.

    Args:
        generator: source of the random numbers.
        num_rows: leading batch dimension of the draw.
        filters: band FIR taps, (num_bands, taps), on the generator's device.
        num_samples: output length n.

    Returns:
        Noise of shape (num_rows, num_bands, num_samples).
    """
    n = num_samples
    num_bands = filters.shape[0]
    nb = n // 2 + 1
    shape = (num_rows, num_bands, nb)
    re = torch.randn(shape, generator=generator, dtype=dtype, device=filters.device)
    im = torch.randn(shape, generator=generator, dtype=dtype, device=filters.device)
    scale = math.sqrt(n / 2.0)
    edge = math.sqrt(2.0)  # DC / Nyquist: real, variance n
    # in place on the fresh draws
    re[..., 0] = re[..., 0] * edge
    im[..., 0] = 0.0
    if n % 2 == 0:  # the last bin is a real Nyquist bin only for even n
        re[..., -1] = re[..., -1] * edge
        im[..., -1] = 0.0
    z = torch.complex(re, im) * scale
    F = torch.fft.rfft(filters, n, dim=-1)
    return torch.fft.irfft(z * F, n, dim=-1)


def noise_shaped_reverberation(
    x: torch.Tensor,
    sample_rate: float,
    band0_gain,
    band1_gain,
    band2_gain,
    band3_gain,
    band4_gain,
    band5_gain,
    band6_gain,
    band7_gain,
    band8_gain,
    band9_gain,
    band10_gain,
    band11_gain,
    band0_decay,
    band1_decay,
    band2_decay,
    band3_decay,
    band4_decay,
    band5_decay,
    band6_decay,
    band7_decay,
    band8_decay,
    band9_decay,
    band10_decay,
    band11_decay,
    mix,
    num_samples: int = 65536,
    num_bandpass_taps: int = 1023,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    noise_mode: str = "time",
) -> torch.Tensor:
    """Reverb by filtered-noise shaping: a stereo impulse response is made
    from white noise band-limited into 12 octave bands, shaped by per-band
    exponential decays and gains and averaged; the input is convolved with
    it (FFT convolution) and mixed wet/dry.

    Args:
        x: (bs, chs, T), mono or stereo (mono is duplicated to stereo).
        band{0..11}_gain, band{0..11}_decay, mix: (0, 1) values, (bs,) each.
        num_samples: IR length. num_bandpass_taps: filterbank length (odd).
        generator: ``torch.Generator`` for the noise draw (the JAX package
            takes a PRNG key here). Required unless ``noise`` is given.
        noise: pre-drawn white noise (bs * 2, 12, num_samples +
            num_bandpass_taps - 1); band-limited by FFT correlation.
        noise_mode: "time" (draw white noise and band-limit it) or
            "frequency" (draw band-limited noise in the spectral domain).

    Returns:
        (bs, 2, T).
    """
    if num_bandpass_taps % 2 != 1:
        raise ValueError("num_bandpass_taps must be odd")
    bs, chs, _ = x.shape
    if chs > 2:
        raise ValueError("only mono/stereo signals are supported")
    dtype, device = x.dtype, x.device
    if chs == 1:
        x = x.expand(bs, 2, x.shape[-1])

    def stack(ps):
        return torch.stack([_param(p, bs, dtype, device).reshape(bs) for p in ps], dim=1)

    band_gains = stack((band0_gain, band1_gain, band2_gain, band3_gain,
                        band4_gain, band5_gain, band6_gain, band7_gain,
                        band8_gain, band9_gain, band10_gain, band11_gain))
    band_decays = stack((band0_decay, band1_decay, band2_decay, band3_decay,
                         band4_decay, band5_decay, band6_decay, band7_decay,
                         band8_decay, band9_decay, band10_decay, band11_decay))
    mix = _param(mix, bs, dtype, device)

    ir = noise_shaped_ir(
        sample_rate, band_gains, band_decays,
        num_samples=num_samples, num_bandpass_taps=num_bandpass_taps,
        generator=generator, noise=noise, noise_mode=noise_mode,
    )
    y = fft_conv_causal(x, ir)
    return (1.0 - mix) * x + mix * y


def noise_shaped_ir(
    sample_rate: float,
    band_gains: torch.Tensor,
    band_decays: torch.Tensor,
    *,
    num_samples: int = 65536,
    num_bandpass_taps: int = 1023,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    noise_mode: str = "time",
) -> torch.Tensor:
    """The stereo filtered-noise impulse response, (bs, 2, num_samples), from
    band gains and decays of shape (bs, 12) on (0, 1)."""
    bs = band_gains.shape[0]
    dtype, device = band_gains.dtype, band_gains.device
    filters = octave_band_filterbank(num_bandpass_taps, sample_rate, device=device, dtype=dtype)
    num_bands = filters.shape[0]
    pad_size = num_bandpass_taps - 1

    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
        wn_filt = fft_correlate_valid(noise, filters[:, 0, :])
    elif generator is None:
        raise ValueError("noise_shaped_reverberation requires `generator` (or explicit `noise`).")
    elif noise_mode == "frequency":
        wn_filt = spectral_band_noise(generator, bs * 2, filters[:, 0, :], num_samples, dtype)
    elif noise_mode == "time":
        noise = torch.randn(
            (bs * 2, num_bands, num_samples + pad_size),
            generator=generator, dtype=dtype, device=device,
        )
        wn_filt = fft_correlate_valid(noise, filters[:, 0, :])
    else:
        raise ValueError(
            f"Unknown noise_mode: {noise_mode!r}. Expected 'time' or 'frequency'."
        )

    wn_filt = wn_filt.reshape(bs, 2, num_bands, num_samples)
    t = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=device)
    decays = band_decays.reshape(bs, 1, num_bands, 1) * 10.0 + 1.0
    env = torch.exp(-decays * t.reshape(1, 1, 1, -1))
    wn_filt = wn_filt * env * band_gains.reshape(bs, 1, num_bands, 1)
    return torch.mean(wn_filt, dim=2)
