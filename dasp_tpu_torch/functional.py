"""Differentiable audio effects as plain functions on (bs, ch, T) tensors.

PyTorch counterpart of the parts of ``dasp_tpu/functional.py`` that the
style-transfer render and blind estimation of the delay family run through:
``gain``, ``parametric_eq``, ``compressor``, ``noise_shaped_reverberation``,
``modulated_delay`` and ``pitch_shift``. Parameters are tensors of shape
(bs,) (or Python scalars); gradients flow to them and to the audio by
autograd, and through the CUDA kernels by their backward kernels.

Option strings keep the JAX package's spelling so that a configuration
means the same in both packages. ``filter_method="pallas"``,
``smoother="pallas"``, ``smoother="exact_pallas"`` and ``adjoint="pallas"``
select the hand-written CUDA kernels here (on a CPU tensor, their plain
PyTorch versions). ``filter_method="exact"``, ``smoother="exact"`` and
``adjoint="ad"`` run the plain versions on any device. ``"fsm"``, the
default of ``parametric_eq`` and ``compressor`` as in the JAX package, is
the reference's frequency-sampling approximation on ``torch.fft``. Other
options raise ``ValueError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf
from torch.utils.checkpoint import checkpoint

from .ops.ballistics_kernel import ballistics_pallas
from .ops.biquad import biquad
from .ops.fft_filter import fsm_onepole_step_response, lfilter_via_fsm, sosfilt_via_fsm
from .ops.filterbank import octave_band_filterbank
from .ops.fir import fft_conv_causal, fft_correlate_valid
from .ops.frac_delay_kernel import frac_delay_pallas
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
    "modulated_delay",
    "pitch_shift_window_samples",
    "pitch_shift",
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
        filter_method: "fsm" (the reference's frequency-sampling
            approximation, on torch.fft), "pallas" (the CUDA biquad-cascade
            kernel; its plain version on a CPU tensor) or "exact" (the plain
            block-state version on any device), all differentiable. The JAX
            package's "block", "coupled" and callable methods are not
            ported yet and raise.
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
    if filter_method == "fsm":
        return sosfilt_via_fsm(sos, x)
    if filter_method in ("block", "coupled"):
        raise _not_ported(f"filter_method={filter_method!r}", "items 3 and 5")
    raise ValueError(
        f"Unknown filter_method: {filter_method!r}. Expected 'fsm', 'pallas' or 'exact'."
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
    "fsm" (attack-only one-pole by the reference's frequency-sampling
    approximation), "exact_pallas" (true attack/release ballistics, CUDA
    kernel), "pallas" (attack-only one-pole through the CUDA biquad-cascade
    kernel) or "exact" (true ballistics, plain loop)."""
    if smoother == "exact_pallas":
        return ballistics_pallas(g_c, alpha_a, alpha_r)
    if smoother in ("pallas", "fsm"):
        b, a = onepole_ba(alpha_a.reshape(g_c.shape[0], 1).to(g_c.dtype))
        if smoother == "pallas":
            return lfilter1_pallas(g_c, b, a)
        # DC split: the gain curve's large mean (tens of dB) rounded through
        # the big fp32 FFT would set the error (about 3e-4 against the 1e-4
        # parity bar). FSM is linear, so filter the zero-mean part and add
        # the mean times the closed-form FSM step response back.
        mean = torch.mean(g_c, dim=-1, keepdim=True)
        alpha = alpha_a.reshape(g_c.shape[0], *([1] * (g_c.ndim - 1))).to(g_c.dtype)
        step = fsm_onepole_step_response(alpha, g_c.shape[-1])
        return lfilter_via_fsm(g_c - mean, b, a) + mean * step
    if smoother == "exact":
        return ballistics_smooth(g_c, alpha_a, alpha_r, mode="exact")
    if smoother in ("block", "attack_only", "parallel"):
        raise _not_ported(f"smoother={smoother!r}", "items 3 and 5")
    raise ValueError(
        f"Unknown smoother: {smoother!r}. Expected 'fsm', 'exact_pallas', 'pallas' or 'exact'."
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
        smoother: "fsm", "exact_pallas", "pallas" or "exact" (see
            :func:`_smooth_gain`). The JAX package's "block",
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


# ---------------------------------------------------------------------------
# delay family: modulated delay (chorus, flanger) and pitch shift
# ---------------------------------------------------------------------------


def _host_max(v) -> np.ndarray:
    """The largest value of a parameter, read to the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.max(np.asarray(v))


def modulated_delay(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz,
    depth_ms,
    base_ms,
    mix,
    lfo_phase: float = 0.0,
    max_delay_ms: float | None = None,
    block: int = 512,
    adjoint: str = "auto",
) -> torch.Tensor:
    """LFO-modulated fractional delay, the core of chorus and flanger.

    The wet path reads the input at the time-varying fractional delay
    ``d(n) = base + depth * (1 + sin(2 pi rate n / fs + phase)) / 2`` (in
    samples) with linear interpolation, feedforward only. Gradients flow to
    ``rate_hz``, ``depth_ms``, ``base_ms``, ``mix`` and the audio.

    The delay is evaluated tile by tile (:func:`_frac_delay_matmul`) under
    a static bound ``max_delay_ms``; ``d`` is clamped to it. With
    ``max_delay_ms=None`` the bound is derived from the values of
    ``base_ms`` and ``depth_ms`` as the JAX package derives it for concrete
    ones (their maxima plus 1e-3 ms). That reads them to the host, which
    waits for a GPU; the :class:`~dasp_tpu_torch.modules.Chorus` and
    ``Flanger`` wrappers pass the bound from their parameter ranges instead.

    Args:
        x: input audio, (bs, chs, seq_len).
        sample_rate: audio sample rate (Hz).
        rate_hz, depth_ms, base_ms, mix: LFO rate (Hz), peak-to-peak depth
            and minimum delay (ms), dry/wet mix on [0, 1]; shape (bs,) each.
        lfo_phase: initial LFO phase in radians.
        max_delay_ms: static bound on ``base_ms + depth_ms`` (see above).
        block: output tile length.
        adjoint: "auto" (the CUDA kernel for float32, the dense plain
            version otherwise), "pallas" or "ad" (see
            :func:`_frac_delay_matmul`).

    Returns:
        Output audio, (bs, chs, seq_len). Wet samples before the delayed
        read position exists are zero.
    """
    bs, chs, seq_len = x.shape
    dtype, device = x.dtype, x.device
    if max_delay_ms is None:
        max_delay_ms = float(_host_max(base_ms) + _host_max(depth_ms)) + 1e-3

    rate_hz, depth_ms, base_ms, mix = (
        _param(p, bs, dtype, device) for p in (rate_hz, depth_ms, base_ms, mix)
    )
    d = _modulated_delay_samples(rate_hz, depth_ms, base_ms, seq_len, sample_rate, lfo_phase)
    dmax = float(max_delay_ms) * sample_rate / 1e3
    wet = _frac_delay_matmul(x, [(torch.clamp(d, max=dmax), None)], dmax, block, adjoint=adjoint)
    return (1.0 - mix) * x + mix * wet


def _modulated_delay_samples(rate_hz, depth_ms, base_ms, seq_len, sample_rate, lfo_phase=0.0):
    """The LFO delay curve in samples, (bs, 1, seq_len), from (bs, 1, 1)
    parameters."""
    n = torch.arange(seq_len, dtype=torch.float32, device=rate_hz.device)[None, None, :]
    lfo = 0.5 * (1.0 + torch.sin(2.0 * np.pi * rate_hz * (n / sample_rate) + lfo_phase))
    return (base_ms + depth_ms * lfo) * (sample_rate / 1e3)


def _frac_delay_gather(x, d):
    """Linearly interpolated read of ``x`` at positions ``n - d`` (global
    coordinates; any delay). ``d``: samples, (bs, 1, T). Samples whose read
    position precedes the signal start are zero."""
    bs, chs, seq_len = x.shape
    n = torch.arange(seq_len, dtype=torch.float32, device=x.device)[None, None, :]
    idx = n - d  # fractional read position
    i0 = torch.floor(idx)
    frac = idx - i0  # gradient flows: d(frac)/d(params) = -d(d)/d(params)
    i0i = torch.clamp(i0, 0, seq_len - 1).long().expand(bs, chs, seq_len)
    i1i = torch.clamp(i0 + 1.0, 0, seq_len - 1).long().expand(bs, chs, seq_len)
    x0 = torch.gather(x, -1, i0i)
    x1 = torch.gather(x, -1, i1i)
    wet = x0 * (1.0 - frac) + x1 * frac
    return torch.where(idx >= 0.0, wet, torch.zeros_like(wet))  # before the signal started


def _frac_delay_operands(x, taps, Dm: int, B: int):
    """The left-extended signal and stacked taps of :func:`frac_delay_pallas`:
    x_ext (bs, chs, Dm + nb*B) and d_stk, g_stk (ntaps, bs, nb*B), zero
    padded on the right to whole tiles."""
    bs, chs, T = x.shape
    nb = -(-T // B)
    pad_t = nb * B - T
    x_ext = nnf.pad(x, (Dm, pad_t))  # position t of the signal sits at t + Dm
    d_stk = torch.stack([nnf.pad(d, (0, pad_t))[:, 0, :] for d, _ in taps])
    g_stk = torch.stack([
        torch.ones((bs, nb * B), dtype=x.dtype, device=x.device) if g is None
        else nnf.pad(g, (0, pad_t))[:, 0, :]
        for _, g in taps
    ])
    return x_ext, d_stk, g_stk


def _frac_delay_matmul(x, taps, dmax: float, block: int, chunk: int = 8,
                       adjoint: str = "auto") -> torch.Tensor:
    """Time-varying fractional multi-tap delay, tile by tile.

    ``wet[t] = sum_i g_i[t] ((1-frac) x[floor(t-d_i)] + frac x[floor(t-d_i)+1])``
    for each ``block``-sample output tile, read from the window
    ``[tile_start - Dm, tile_start + block)`` in tile-local coordinates.

    Args:
        x: (bs, chs, T).
        taps: list of ``(d, g)``: delay in samples (bs, 1, T), at most
            ``dmax``, and tap gain (bs, 1, T) or None for unity. Reads that
            precede the signal start contribute zero.
        dmax: static bound on every d (samples). block: tile length.
        chunk: tiles per checkpointed group of the dense version.
        adjoint: "pallas" = :func:`frac_delay_pallas` (the CUDA kernels on
            a CUDA tensor, their plain engine on a CPU tensor); "ad" = the
            dense plain version (:func:`_frac_delay_tiles_ad`, autograd);
            "auto" = "pallas" for float32 and "ad" otherwise. The kernel
            does O(taps) work per sample for any window, where the dense
            version does O(window), so "auto" takes it for every float32
            call; the JAX package's window thresholds were measured on a
            TPU and do not apply. The JAX package's "hybrid" adjoint is not
            ported (ROADMAP.md, "Not to port") and raises.
    """
    bs, chs, T = x.shape
    B = int(block)
    Dm = int(math.ceil(dmax)) + 1  # left history needed by any tile
    if adjoint == "auto":
        adjoint = "pallas" if x.dtype == torch.float32 else "ad"
    if adjoint == "hybrid":
        raise ValueError(
            "adjoint='hybrid' is not ported (ROADMAP.md, 'Not to port'): use 'auto', 'pallas' or 'ad'"
        )
    if adjoint not in ("pallas", "ad"):
        raise ValueError(f"Unknown adjoint: {adjoint!r}. Expected 'auto', 'pallas' or 'ad'.")
    x_ext, d_stk, g_stk = _frac_delay_operands(x, taps, Dm, B)
    if adjoint == "pallas":
        wet = frac_delay_pallas(x_ext, d_stk, g_stk, B, Dm)
    else:
        wet = _frac_delay_tiles_ad(B, Dm, x_ext, d_stk, g_stk, chunk=chunk)
    return wet[..., :T]


def _fdt_interp_matrix(d_k, g_k, t_abs, W: int, Dm: int, dtype):
    """(bs, ..., B, W) interpolation matrix, two nonzeros per row per tap:
    the hat ``max(0, 1 - |w - r|)`` on the window's integer lattice, which
    is ``1 - frac`` at ``floor(r)`` and ``frac`` at ``floor(r) + 1``.

    d_k / g_k: (ntaps, bs, ..., B); t_abs: (..., B) global output time.
    """
    j = torch.arange(d_k.shape[-1], dtype=torch.float32, device=d_k.device)
    iota_w = torch.arange(W, dtype=torch.float32, device=d_k.device)
    m = 0.0
    for ti in range(d_k.shape[0]):
        r = (j + Dm) - d_k[ti]  # fractional read position, window coordinates
        # tap gain, zeroed before the global signal start (t - d < 0)
        gv = (t_abs - d_k[ti] >= 0.0).to(dtype) * g_k[ti]
        # relu: at an exact integer r the hat's kinks give dd = 0, the
        # Pallas kernel's sign(0) = 0 (a clamp would pass both one-sided slopes)
        hat = torch.relu(1.0 - torch.abs(iota_w - r[..., None]))
        m = m + gv[..., None] * hat
    return m.to(dtype)


def _frac_delay_tiles_ad(B: int, Dm: int, x_ext, d_stk, g_stk, chunk: int = 8):
    """The dense plain version of :func:`frac_delay_pallas`: per group of
    ``chunk`` tiles, the (B, W) interpolation matrix of each tile contracted
    with its window (W = Dm + B), differentiated by autograd.

    Each group is checkpointed (``jax.checkpoint`` in the JAX package):
    without it autograd would save every group's matrices for the backward,
    tens of GB at 8 x 2 x 131072 samples; with it the backward rebuilds
    one group's matrices at a time. The work per sample is O(W).

    x_ext: (bs, chs, Dm + nb*B); d_stk / g_stk: (ntaps, bs, nb*B).
    """
    bs, chs, T_ext = x_ext.shape
    nt = d_stk.shape[0]
    W = Dm + B
    nb = (T_ext - Dm) // B
    if nb == 0:
        return x_ext.new_zeros((bs, chs, 0))
    chunk = max(1, min(int(chunk), nb))
    while nb % chunk:  # equal groups: the nearest divisor of nb
        chunk -= 1
    j = torch.arange(B, dtype=torch.float32, device=x_ext.device)
    t_rel = (torch.arange(chunk, dtype=torch.float32, device=x_ext.device) * B)[:, None] + j[None, :]

    def tile_group(k0, x_ext, d_stk, g_stk):  # k0: first tile of the group
        wins = x_ext[..., k0 * B : k0 * B + Dm + chunk * B].unfold(-1, W, B)  # (bs, chs, chunk, W)
        d_k = d_stk[..., k0 * B : (k0 + chunk) * B].reshape(nt, bs, chunk, B)
        g_k = g_stk[..., k0 * B : (k0 + chunk) * B].reshape(nt, bs, chunk, B)
        t_abs = float(k0 * B) + t_rel  # (chunk, B)
        m = _fdt_interp_matrix(d_k, g_k, t_abs, W, Dm, x_ext.dtype)
        return torch.einsum("bkjw,bckw->bckj", m, wins).reshape(bs, chs, chunk * B)

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x_ext, d_stk, g_stk))
    wets = [
        checkpoint(tile_group, k0, x_ext, d_stk, g_stk, use_reentrant=False) if grad
        else tile_group(k0, x_ext, d_stk, g_stk)
        for k0 in range(0, nb, chunk)
    ]
    return torch.cat(wets, dim=-1)


def pitch_shift_window_samples(window_ms: float, sample_rate: float) -> int:
    """The (even) delay-line window length W :func:`pitch_shift` uses."""
    return max(2, 2 * int(round(window_ms * float(sample_rate) / 2e3)))


def _pitch_shift_taps(semitones, seq_len: int, W: int):
    """The two crossfaded taps ``(W p_i, sin(pi p_i))``, each (bs, 1,
    seq_len), from (bs, 1, 1) semitones."""
    n = torch.arange(seq_len, dtype=torch.float32, device=semitones.device)[None, None, :]
    slope = 1.0 - 2.0 ** (semitones / 12.0)  # (bs, 1, 1)
    u = slope * n / W
    taps = []
    for i in (0.0, 0.5):
        p = u + i
        p = p - torch.floor(p)  # sawtooth phase in [0, 1)
        taps.append((W * p, torch.sin(np.pi * p)))
    return taps


def pitch_shift(
    x: torch.Tensor,
    sample_rate: float,
    semitones,
    mix=1.0,
    window_ms: float = 60.0,
    block: int = 256,
    matmul: bool = True,
    compensate_latency: bool = True,
    adjoint: str = "auto",
) -> torch.Tensor:
    """Delay-line pitch shifter, differentiable in the shift amount.

    Two read taps whose delay ramps as a sawtooth with slope ``1 - r``
    (``r = 2**(semitones/12)``), half a window apart, equal-power
    crossfaded so each tap's gain is zero exactly when its delay wraps:

        ``u(n) = (1 - r) n / W``, ``p_i(n) = frac(u(n) + i/2)``,
        ``d_i(n) = W p_i(n)``, ``g_i(n) = sin(pi p_i(n))``, i in {0, 1}.

    The mean ``W/2``-sample latency is compensated (offline form; the last
    ``W/2`` output samples are zeros shifted in), so ``semitones=0`` is the
    identity.

    Args:
        x: input audio, (bs, chs, seq_len).
        sample_rate: audio sample rate (Hz).
        semitones: pitch shift (+12 = one octave up), shape (bs,).
        mix: dry/wet mix on [0, 1] (1 = fully shifted), shape (bs,).
        window_ms: delay-line window length in milliseconds.
        block: tile length of the tiled path.
        matmul: True evaluates both taps tile by tile through
            :func:`_frac_delay_matmul`; False uses the gather path
            (:func:`_frac_delay_gather`, global coordinates).
        compensate_latency: shift the wet path left by W/2 samples.
        adjoint: "auto", "pallas" or "ad" (see :func:`_frac_delay_matmul`).

    Returns:
        Output audio, (bs, chs, seq_len).
    """
    bs, chs, seq_len = x.shape
    dtype, device = x.dtype, x.device
    semitones = _param(semitones, bs, dtype, device)
    mix = _param(mix, bs, dtype, device)

    W = pitch_shift_window_samples(window_ms, sample_rate)
    half = W // 2
    taps = _pitch_shift_taps(semitones, seq_len, W)
    if matmul:
        wet = _frac_delay_matmul(x, taps, float(W), block, adjoint=adjoint)
    else:
        wet = sum(g * _frac_delay_gather(x, d) for d, g in taps)

    if compensate_latency:
        # compensate the mean W/2-sample latency (zeros shift in at the tail)
        wet = nnf.pad(wet, (0, half))[..., half:]
    return (1.0 - mix) * x + mix * wet
