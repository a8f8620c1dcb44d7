"""Differentiable audio effects as plain functions on (bs, ch, T) tensors.

PyTorch counterpart of ``dasp_tpu/functional.py``: ``gain``,
``distortion``, ``advanced_distortion``, ``parametric_eq``,
``graphic_eq``, ``compressor``, the dynamics family (``expander``,
``sidechain_compressor``, ``noise_gate``, ``de_esser``, ``limiter``,
``multiband_compressor``, ``transient_shaper``), ``exciter``,
``bitcrusher``, ``clipper``, ``noise_shaped_reverberation``,
``convolution_reverb``, ``stereo_bus``, ``stereo_widener``,
``stereo_panner``, ``stereo_imager``, the delay family (``delay``,
``modulated_delay``, ``pitch_shift``, ``ring_modulator``, ``tremolo``,
``wow_flutter``) and the time-varying (WOLA) family on
:mod:`~dasp_tpu_torch.ops.tv_filter` (``phaser``, ``auto_wah``,
``spectral_gate``, ``spectral_noise_profile``, ``dynamic_eq``,
``time_stretch``, ``pitch_shift_pv``). Parameters are tensors of shape (bs,) (or Python
scalars); gradients flow to them and to the audio by autograd, and through
the CUDA kernels by their backward kernels.

Option strings keep the JAX package's spelling so that a configuration
means the same in both packages. ``filter_method="pallas"``,
``smoother="pallas"``, ``smoother="exact_pallas"`` and ``adjoint="pallas"``
select the hand-written CUDA kernels here (on a CPU tensor, their plain
PyTorch versions). ``filter_method="exact"`` (an associative scan over
time), ``"block"`` and ``"coupled"`` (the block-state formulations:
batched matmuls, cuBLAS on the card, and a scan over blocks),
``smoother="block"``, ``"parallel"``, ``"attack_only"`` and ``"exact"``, and
``adjoint="ad"`` are plain PyTorch on any device. ``"fsm"``, the default of
``parametric_eq`` and ``compressor`` as in the JAX package, is the
reference's frequency-sampling approximation on ``torch.fft``. A callable
``filter_method`` (``fn(sos, x) -> y``) or ``smoother`` (``fn(g,
alpha_attack, alpha_release) -> y``), the WOLA effects' ``tv_power_fn`` /
``tv_filter_fn`` and the reverb's ``ir_conv_fn`` plug in another
evaluation, as in the JAX package: the injection points of the
sequence-sharded functions of :mod:`dasp_tpu_torch.parallel`, bound to a
mesh. Unknown options raise ``ValueError``.

Each effect opens a span of its own name round its call (``parametric_eq``,
``compressor``, ...; :mod:`~dasp_tpu_torch.trace`), as the JAX package
names its effects' scopes, and ``parametric_eq_sos`` the span ``eq.design``:
on the timeline of any profiled run they read ``dasp.<name>``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as nnf
from torch.utils.checkpoint import checkpoint

from .ops.ballistics_kernel import ballistics_pallas
from .ops.biquad import biquad, one_pole_butter_highpass, one_pole_butter_lowpass
from .ops.fft_filter import (
    fft_freqz,
    fft_sosfreqz,
    fsm_fft_size,
    fsm_onepole_step_response,
    lfilter_via_fsm,
    next_pow2,
    sosfilt_via_fsm,
)
from .ops.filterbank import octave_band_filterbank
from .ops.fir import fft_conv_causal, fft_correlate_valid, ola_conv_causal
from .ops.frac_delay_kernel import frac_delay_pallas
from .ops.iir import (
    ballistics_smooth,
    embed_first_order_sos,
    lfilter1_blockmat,
    lfilter1_exact,
    onepole_ba,
    onepole_exact,
    peak_decay,
    running_max,
    sosfilt_blockmat,
    sosfilt_coupled,
    sosfilt_exact,
)
from .ops.iir_kernel import lfilter1_pallas, sosfilt_pallas
from .ops.tv_filter import tv_analysis_window, tv_frame_centers, tv_frame_count, tv_freq_filter, tv_istft, tv_stft
from .trace import count, span

__all__ = [
    "db_to_linear",
    "gain",
    "stereo_bus",
    "distortion",
    "advanced_distortion",
    "GRAPHIC_EQ_BANDS",
    "graphic_eq",
    "graphic_eq_sos",
    "parametric_eq",
    "parametric_eq_sos",
    "static_gain_computer",
    "compressor",
    "expander",
    "sidechain_compressor",
    "noise_gate",
    "de_esser",
    "transient_shaper",
    "exciter_sos",
    "exciter",
    "bitcrusher",
    "limiter",
    "lr4_crossover_sos",
    "multiband_compressor",
    "clipper",
    "noise_shaped_reverberation",
    "noise_shaped_ir",
    "spectral_band_noise",
    "stereo_widener",
    "stereo_panner",
    "modulated_delay",
    "pitch_shift_window_samples",
    "pitch_shift",
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
]


def _scoped(name: str):
    """Open the span ``name`` (:func:`~dasp_tpu_torch.trace.span`) round
    each call of an effect, as the JAX package's named scopes do."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _param(p, bs: int, dtype, device) -> torch.Tensor:
    """Canonicalize a parameter (scalar, (bs,), (bs, 1) or (bs, 1, 1)) to
    shape (bs, 1, 1)."""
    p = torch.as_tensor(p, dtype=dtype, device=device)
    if p.ndim == 0:
        return p.expand(bs, 1, 1)
    return p.reshape(bs, 1, 1)


def _params(bs: int, dtype, device, *ps):
    """:func:`_param` of each of ``ps``."""
    return tuple(_param(p, bs, dtype, device) for p in ps)


def _entry_device(device) -> torch.device:
    """The device an entry point builds on: the one the caller names, else
    the CUDA card. Never the CPU unless named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name one, or pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def db_to_linear(db: torch.Tensor) -> torch.Tensor:
    """Convert decibels to linear amplitude: 10 ** (db / 20)."""
    return 10.0 ** (db / 20.0)


@_scoped("gain")
def gain(x: torch.Tensor, sample_rate: int, gain_db) -> torch.Tensor:
    """Apply gain in dB, the same on every channel.

    Args:
        x: (bs, chs, T). sample_rate: unused (uniform effect signature).
        gain_db: shape (bs,).
    """
    gain_db = _param(gain_db, x.shape[0], x.dtype, x.device)
    return x * db_to_linear(gain_db)


@_scoped("stereo_bus")
def stereo_bus(x: torch.Tensor, sample_rate: int, send_db) -> torch.Tensor:
    """Sum a stereo multitrack to a stereo bus with per-track send levels.

    Args:
        x: tracks, (bs, 2, tracks, T). sample_rate: unused.
        send_db: per-track send levels in dB, (bs, tracks) or (bs, tracks, 1).

    Returns:
        The stereo bus, (bs, 2, T).
    """
    bs, chs, tracks, _ = x.shape
    if chs != 2:
        raise ValueError(f"stereo_bus needs input of shape (bs, 2, tracks, T), got {tuple(x.shape)}")
    send = torch.as_tensor(send_db, dtype=x.dtype, device=x.device).reshape(bs, 1, tracks, 1)
    return torch.sum(x * db_to_linear(send), dim=2)


@_scoped("distortion")
def distortion(x: torch.Tensor, sample_rate: int, drive_db) -> torch.Tensor:
    """Soft-clipping distortion, tanh(x * 10^(drive / 20)).

    Args:
        x: (bs, chs, T). sample_rate: unused.
        drive_db: drive in dB: a scalar, (bs,) for every channel of an item
            (also on multichannel input), or (bs, chs) per channel.
    """
    bs, chs, _ = x.shape
    drive_db = torch.as_tensor(drive_db, dtype=x.dtype, device=x.device)
    if drive_db.ndim == 0:
        drive_db = drive_db.expand(bs, 1, 1)
    elif drive_db.numel() == bs:
        drive_db = drive_db.reshape(bs, 1, 1)
    else:
        drive_db = drive_db.reshape(bs, chs, 1)
    return torch.tanh(x * db_to_linear(drive_db))


# ---------------------------------------------------------------------------
# equalization
# ---------------------------------------------------------------------------

_EQ_TYPES = ("low_shelf", "peaking", "peaking", "peaking", "peaking", "high_shelf")


@_scoped("parametric_eq")
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
            kernel; its plain version on a CPU tensor), "exact" (an
            associative scan over time), "block" (the block-state
            formulation) or "coupled" (the block-state formulation on the
            coupled realization, :func:`~dasp_tpu_torch.ops.sosfilt_coupled`),
            all differentiable. The JAX package's callable methods are not
            ported and raise.
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


@_scoped("eq.design")
def parametric_eq_sos(bs, dtype, sample_rate, *params, device=None) -> torch.Tensor:
    """The 6-band parametric EQ cascade as a (bs, 6, 6) SOS tensor from the
    same 18 per-band parameters as :func:`parametric_eq`."""
    return _parametric_eq_sections(bs, dtype, sample_rate, *params, device=device)


def _parametric_eq_sections(bs, dtype, sample_rate, *params, device=None) -> torch.Tensor:
    """:func:`parametric_eq_sos` outside its span (for a caller that opens
    ``eq.design`` round more than the design)."""
    if len(params) != 18:
        raise ValueError(f"expected 18 EQ params, got {len(params)}")
    sections = []
    for i, ftype in enumerate(_EQ_TYPES):
        g, f, q = (_param(p, bs, dtype, device).reshape(bs) for p in params[3 * i : 3 * i + 3])
        b, a = biquad(g, f, q, sample_rate, ftype)
        sections.append(torch.cat([b, a], dim=-1))
    return torch.stack(sections, dim=1)


def _apply_sos(sos, x, filter_method):
    if callable(filter_method):
        # a custom cascade fn(sos, x) -> y, e.g. parallel.sharded_sosfilt_coupled
        # bound to a mesh: the exact recurrence with time split over the ranks
        return filter_method(sos, x)
    if filter_method == "pallas":
        return sosfilt_pallas(sos, x)
    if filter_method == "exact":
        return sosfilt_exact(sos, x)
    if filter_method == "block":
        return sosfilt_blockmat(sos, x)
    if filter_method == "coupled":
        return sosfilt_coupled(sos, x)
    if filter_method == "fsm":
        return sosfilt_via_fsm(sos, x)
    raise ValueError(
        f"Unknown filter_method: {filter_method!r}. Expected 'fsm', 'exact', 'block', 'coupled' or 'pallas'."
    )


def _apply_sos_batched(sos_list, x_list, filter_method):
    """Several same-shaped (sos, x) filter jobs as one batched filter call:
    every method is batched over the leading axis, so the legs stacked on
    it share one launch (one scan across blocks for the block-state
    methods)."""
    y = _apply_sos(torch.cat(sos_list, dim=0), torch.cat(x_list, dim=0), filter_method)
    bs = x_list[0].shape[0]
    return [y[i * bs : (i + 1) * bs] for i in range(len(x_list))]


def _apply_first_order(y, b, a, filter_method):
    """A batched first-order IIR (b, a of shape (bs, 2)) over (bs, chs, T)."""
    if callable(filter_method):  # a custom cascade fn(sos, x) -> y
        return filter_method(embed_first_order_sos(b, a)[:, None, :], y)
    if filter_method == "fsm":
        return lfilter_via_fsm(y, b, a)
    if filter_method == "exact":
        return lfilter1_exact(y, b[:, None, :], a[:, None, :])
    if filter_method == "block":
        return lfilter1_blockmat(y, b, a)
    if filter_method == "coupled":
        # one real pole: the coupled cascade takes its controller form
        return sosfilt_coupled(embed_first_order_sos(b, a)[:, None, :], y)
    raise ValueError(
        f"Unknown filter_method: {filter_method!r}. Expected 'fsm', 'exact', 'block' or 'coupled'."
    )


# ---------------------------------------------------------------------------
# graphic EQ
# ---------------------------------------------------------------------------

# the 10-band octave graphic EQ's centre frequencies (Hz)
GRAPHIC_EQ_BANDS = (31.5, 63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)
# one-octave bandwidth: Q = sqrt(2^N) / (2^N - 1) with N = 1
_GRAPHIC_EQ_Q = math.sqrt(2.0)


@_scoped("graphic_eq")
def graphic_eq(x: torch.Tensor, sample_rate: float, band_gains_db, filter_method: str = "coupled") -> torch.Tensor:
    """Ten-band octave graphic equalizer (31.5 Hz to 16 kHz): a cascade of
    10 peaking biquads at the octave centres with one-octave bandwidth.

    Args:
        x: (bs, chs, T).
        sample_rate: audio sample rate (Hz).
        band_gains_db: per-band gains in dB, (bs, 10).
        filter_method: "coupled" (the default: the 31.5 and 63 Hz bands put
            poles about 1e-4 from the unit circle, where the coupled
            realization stays exact), "block", "exact", "pallas" or "fsm",
            as in :func:`parametric_eq`.
    """
    sos = graphic_eq_sos(x.shape[0], x.dtype, sample_rate, band_gains_db, device=x.device)
    return _apply_sos(sos, x, filter_method)


def graphic_eq_sos(bs, dtype, sample_rate, band_gains_db, device=None) -> torch.Tensor:
    """The graphic EQ's cascade as a (bs, 10, 6) SOS tensor. Band centres
    are clamped to 0.999 x Nyquist (below 32 kHz the 16 kHz band would
    otherwise pass it); a clamped band sits at Nyquist, near transparent."""
    band_gains_db = torch.as_tensor(band_gains_db, dtype=dtype, device=device).reshape(bs, len(GRAPHIC_EQ_BANDS))
    device = band_gains_db.device
    f_max = 0.999 * sample_rate / 2.0
    sections = []
    for i, fc in enumerate(GRAPHIC_EQ_BANDS):
        f = torch.full((bs,), min(fc, f_max), dtype=dtype, device=device)
        q = torch.full((bs,), _GRAPHIC_EQ_Q, dtype=dtype, device=device)
        b, a = biquad(band_gains_db[:, i], f, q, sample_rate, "peaking")
        sections.append(torch.cat([b, a], dim=-1))
    return torch.stack(sections, dim=1)


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
    kernel), "block" (attack-only one-pole by the block-state formulation),
    "attack_only" (attack-only one-pole by an associative scan), or
    "parallel" / "exact" (:func:`~dasp_tpu_torch.ops.ballistics_smooth`'s
    two-scan approximation and its plain loop). A callable ``smoother(g_c,
    alpha_attack, alpha_release) -> smoothed`` is the injection point of
    sequence-sharded smoothing (e.g. ``functools.partial(
    parallel.sharded_ballistics_smooth, mesh=mesh)``)."""
    if callable(smoother):
        return smoother(g_c, alpha_a, alpha_r)
    if smoother == "exact_pallas":
        return ballistics_pallas(g_c.contiguous(), alpha_a, alpha_r)
    if smoother in ("pallas", "block", "fsm"):
        b, a = onepole_ba(alpha_a.reshape(g_c.shape[0], 1).to(g_c.dtype))
        if smoother == "block":
            return lfilter1_blockmat(g_c, b, a)
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
    if smoother == "attack_only":
        return onepole_exact(g_c, alpha_a)
    if smoother in ("parallel", "exact"):
        return ballistics_smooth(g_c, alpha_a, alpha_r, mode=smoother)
    raise ValueError(
        f"Unknown smoother: {smoother!r}. Expected 'fsm', 'exact_pallas', 'pallas', 'block', 'attack_only', "
        "'parallel' or 'exact'."
    )


@_scoped("compressor")
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
        smoother: "fsm", "exact_pallas", "pallas", "block", "attack_only",
            "parallel" or "exact" (see :func:`_smooth_gain`). The JAX
            package's callable smoothers are not ported and raise.
    """
    threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db = _params(
        x.shape[0], x.dtype, x.device, threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db)
    _, x_db, alpha_a, alpha_r = _dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, ratio, knee_db, "compressor")
    g_smooth = _smooth_gain(g_c, alpha_a, alpha_r, smoother)

    return _lookahead(x, lookahead_samples) * db_to_linear(g_smooth + makeup_gain_db)


def _lookahead(x, lookahead_samples: int):
    """x delayed by ``lookahead_samples`` against the gain curve, zeros
    shifted in."""
    if lookahead_samples <= 0:
        return x
    la = min(lookahead_samples, x.shape[-1])
    return torch.cat([torch.zeros_like(x[..., :la]), x[..., : x.shape[-1] - la]], dim=-1)


@_scoped("expander")
def expander(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    smoother: str = "exact_pallas",
) -> torch.Tensor:
    """Downward expander, the compressor's dual: the Giannoulis et al.
    (2012) expander curve on the compressor's sidechain, knee and
    ballistics; below the threshold the level falls ``ratio`` dB per dB.

    Args:
        x: (bs, chs, T).
        threshold_db, ratio, attack_ms, release_ms, knee_db,
            makeup_gain_db: shape (bs,) each.
        eps: floor of the level detector.
        smoother: "exact_pallas" (the default: the CUDA ballistics kernel),
            or any other of :func:`_smooth_gain`.
    """
    threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db = _params(
        x.shape[0], x.dtype, x.device, threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db)
    _, x_db, alpha_a, alpha_r = _dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, ratio, knee_db, "expander")
    g_smooth = _smooth_gain(g_c, alpha_a, alpha_r, smoother)
    return x * db_to_linear(g_smooth + makeup_gain_db)


@_scoped("sidechain_compressor")
def sidechain_compressor(
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
    smoother: str = "exact_pallas",
    sidechain: torch.Tensor | None = None,
) -> torch.Tensor:
    """A compressor whose detector listens to an external ``sidechain``
    (a ducker): the compressor's machinery with the detector input
    swapped. Gradients flow to the parameters, the program and the
    sidechain.

    Args:
        x: program audio, (bs, chs, T).
        threshold_db ... makeup_gain_db: as :func:`compressor`, (bs,) each.
        eps: floor of the level detector.
        lookahead_samples: delay the program against the gain curve.
        smoother: "exact_pallas" (the default) or any of :func:`_smooth_gain`.
        sidechain: the key signal, (bs, any chs, T), a required keyword.
    """
    if sidechain is None:
        raise ValueError(
            "sidechain_compressor requires `sidechain` (the key signal the "
            "detector listens to); pass it as a keyword argument."
        )
    bs, _, seq_len = x.shape
    if sidechain.shape[0] != bs or sidechain.shape[-1] != seq_len:
        raise ValueError(
            f"sidechain batch/length {tuple(sidechain.shape)} does not match program audio {tuple(x.shape)} "
            "(channels may differ; batch and seq_len must not)."
        )
    threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db = _params(
        bs, x.dtype, x.device, threshold_db, ratio, attack_ms, release_ms, knee_db, makeup_gain_db)
    _, x_db, alpha_a, alpha_r = _dynamics_common(sidechain, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, ratio, knee_db, "compressor")
    g_smooth = _smooth_gain(g_c, alpha_a, alpha_r, smoother)
    return _lookahead(x, lookahead_samples) * db_to_linear(g_smooth + makeup_gain_db)


def _hold_max(g: torch.Tensor, hold_samples: int) -> torch.Tensor:
    """Causal moving maximum ``out[t] = max(g[t - hold .. t])`` by the van
    Herk decomposition: with blocks of B = hold + 1 samples the window
    spans at most two blocks, so it is the larger of a suffix max and a
    prefix max within blocks, two running maxima (:func:`running_max`,
    a tie's gradient split as in JAX)."""
    if hold_samples <= 0:
        return g
    bs, chs, T = g.shape
    B = hold_samples + 1
    gp = nnf.pad(g, (0, (-T) % B), value=-math.inf)
    blocks = gp.reshape(bs, chs, -1, B)
    pre = running_max(blocks, 3).reshape(bs, chs, -1)[..., :T]
    suf = running_max(blocks, 3, reverse=True).reshape(bs, chs, -1)
    suf_shifted = nnf.pad(suf, (hold_samples, 0), value=-math.inf)[..., :T]
    return torch.maximum(pre, suf_shifted)


@_scoped("noise_gate")
def noise_gate(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    range_db,
    attack_ms,
    release_ms,
    knee_db,
    eps: float = 1e-8,
    hold_ms: float = 0.0,
    smoother: str = "exact_pallas",
) -> torch.Tensor:
    """Noise gate: the expander curve floored at ``-range_db``, with an
    optional hold (a causal moving maximum of ``hold_ms``) and the
    ballistics swapped against the compressor's, so that ``attack_ms`` is
    how fast the gate opens and ``release_ms`` how fast it closes.

    Args:
        x: (bs, chs, T).
        threshold_db, ratio, range_db, attack_ms, release_ms, knee_db:
            shape (bs,) each.
        eps: floor of the level detector.
        hold_ms: static hold time (ms).
        smoother: "exact_pallas" (the default), "exact" or "parallel": an
            attack-only smoother cannot both open and close a gate.
    """
    if smoother not in ("parallel", "exact", "exact_pallas"):
        raise ValueError(f"noise_gate smoother must be 'parallel', 'exact' or 'exact_pallas', got {smoother!r}.")
    threshold_db, ratio, range_db, attack_ms, release_ms, knee_db = _params(
        x.shape[0], x.dtype, x.device, threshold_db, ratio, range_db, attack_ms, release_ms, knee_db)
    _, x_db, alpha_a, alpha_r = _dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, ratio, knee_db, "expander")
    g_c = torch.maximum(g_c, -range_db)
    g_c = _hold_max(g_c, int(round(sample_rate * hold_ms / 1e3)))
    # the smoother's first coefficient acts where the gain falls (the gate
    # closing, its release), the second where it rises (opening, its attack)
    g_smooth = _smooth_gain(g_c, alpha_r, alpha_a, smoother)
    return x * db_to_linear(g_smooth)


@_scoped("de_esser")
def de_esser(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    eps: float = 1e-8,
    mode: str = "split",
    smoother: str = "exact_pallas",
    filter_method: str = "coupled",
) -> torch.Tensor:
    """Frequency-selective compressor for sibilance: the detector listens to
    the program high-passed at ``frequency_hz`` (an LR4 leg), and the gain
    reduction acts on the high band only (``mode="split"``: the program is
    split by the LR4 crossover, whose bands sum to its allpass) or on the
    whole signal (``"wideband"``).

    Args:
        x: (bs, chs, T).
        frequency_hz, threshold_db, ratio, attack_ms, release_ms, knee_db:
            shape (bs,) each.
        eps: floor of the level detector.
        mode: "split" or "wideband".
        smoother: "exact_pallas" (the default) or any of :func:`_smooth_gain`.
        filter_method: the crossover's method, as :func:`parametric_eq`'s.
    """
    if mode not in ("split", "wideband"):
        raise ValueError(f"de_esser mode must be 'split' or 'wideband', got {mode!r}.")
    bs, dtype, device = x.shape[0], x.dtype, x.device
    frequency_hz = _param(frequency_hz, bs, dtype, device).reshape(bs)
    threshold_db, ratio, attack_ms, release_ms, knee_db = _params(
        bs, dtype, device, threshold_db, ratio, attack_ms, release_ms, knee_db)
    sos_lp, sos_hp = lr4_crossover_sos(frequency_hz, sample_rate, bs, dtype)
    if mode == "split":
        low, high = _apply_sos_batched([sos_lp, sos_hp], [x, x], filter_method)
    else:
        high = _apply_sos(sos_hp, x, filter_method)
    _, det_db, alpha_a, alpha_r = _dynamics_common(high, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(det_db, threshold_db, ratio, knee_db, "compressor")
    g_lin = db_to_linear(_smooth_gain(g_c, alpha_a, alpha_r, smoother))
    if mode == "split":
        return low + high * g_lin
    return x * g_lin


def _transient_detectors(
    x, sample_rate, fast_attack_ms, slow_attack_ms, fast_release_ms, slow_release_ms, eps, smoother,
    pre_smooth_ms=5.0, max_det_db=24.0, y0=None, return_yf=False,
):
    """The transient shaper's differential envelope detectors.

    The mono-summed power, pre-smoothed by a one-pole of ``pre_smooth_ms``,
    in dB; then two ballistics followers (in the gain-curve convention, so
    rise and fall times take the release and attack slots), fast rise /
    fast fall and slow rise / fast fall, each starting at the first level
    sample; and two peak-decay followers (:func:`~dasp_tpu_torch.ops.
    peak_decay`, instant rise, 20 dB per release time of fall).
    ``attack = relu(env_ff - env_sf)`` and ``sustain = relu(pd_slow -
    pd_fast)``, each capped at ``max_det_db``.

    Returns ``(att_det, sus_det)``, with ``return_yf`` also the five
    carried states (pre-smoother, two ballistics, two peak-decay).
    """
    bs, dtype, device = x.shape[0], x.dtype, x.device
    x_side = torch.sum(x, dim=1, keepdim=True)
    ln9 = math.log(9.0)
    y0 = y0 or (None, None, None, None, None)

    def coef(ms):
        return torch.exp(-ln9 / (sample_rate * (_param(ms, bs, dtype, device) / 1e3)))

    power = onepole_exact(x_side ** 2, coef(pre_smooth_ms), y0=y0[0])
    level_db = 10.0 * torch.log10(torch.clamp(power, min=eps * eps))
    a_fa, a_sa, a_fr = coef(fast_attack_ms), coef(slow_attack_ms), coef(fast_release_ms)
    # peak-decay slopes in dB a sample: 20 dB per release time
    d_fr = 20e3 / (sample_rate * _param(fast_release_ms, bs, dtype, device))
    d_sr = 20e3 / (sample_rate * _param(slow_release_ms, bs, dtype, device))

    lv0 = level_db[..., 0]
    rest = (lv0, lv0)
    env_ff, s_ff = ballistics_smooth(level_db, a_fr, a_fa, mode=smoother, y0=y0[1] or rest, return_yf=True)
    env_sf, s_sf = ballistics_smooth(level_db, a_fr, a_sa, mode=smoother, y0=y0[2] or rest, return_yf=True)
    pd_fast, s_pf = peak_decay(level_db, d_fr, y0=y0[3], return_yf=True)
    pd_slow, s_ps = peak_decay(level_db, d_sr, y0=y0[4], return_yf=True)
    max_det = _param(max_det_db, bs, dtype, device)
    att_det = torch.minimum(torch.relu(env_ff - env_sf), max_det)
    sus_det = torch.minimum(torch.relu(pd_slow - pd_fast), max_det)
    if return_yf:
        return att_det, sus_det, (power[..., -1], s_ff, s_sf, s_pf, s_ps)
    return att_det, sus_det


@_scoped("transient_shaper")
def transient_shaper(
    x: torch.Tensor,
    sample_rate: float,
    attack,
    sustain,
    output_gain_db=0.0,
    fast_attack_ms=1.0,
    slow_attack_ms=30.0,
    fast_release_ms=50.0,
    slow_release_ms=500.0,
    pre_smooth_ms=5.0,
    max_det_db=24.0,
    eps: float = 1e-8,
    smoother: str = "parallel",
) -> torch.Tensor:
    """Transient shaper: threshold-free attack and sustain control,
    ``gain_db(n) = attack * att_det(n) + sustain * sus_det(n) +
    output_gain_db`` from the detectors of :func:`_transient_detectors`.

    Args:
        x: (bs, chs, T).
        attack, sustain: onset and tail gain scales, about [-1, 1], (bs,).
        output_gain_db: static output gain in dB, (bs,).
        fast_attack_ms / slow_attack_ms, fast_release_ms / slow_release_ms:
            the detectors' rise and fall times (ms).
        pre_smooth_ms: the detector power's one-pole (ms).
        max_det_db: the detectors' cap in dB.
        eps: floor of the level detector.
        smoother: "parallel" (the default) or "exact" (the plain loop),
            :func:`~dasp_tpu_torch.ops.ballistics_smooth`'s modes.
    """
    bs, dtype, device = x.shape[0], x.dtype, x.device
    attack, sustain, output_gain_db = _params(bs, dtype, device, attack, sustain, output_gain_db)
    att_det, sus_det = _transient_detectors(
        x, sample_rate, fast_attack_ms, slow_attack_ms, fast_release_ms, slow_release_ms, eps, smoother,
        pre_smooth_ms, max_det_db,
    )
    gain_db = attack * att_det + sustain * sus_det + output_gain_db
    return (x * db_to_linear(gain_db)).to(dtype)


@_scoped("limiter")
def limiter(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    lookahead_samples: int = 0,
    smoother: str = "exact_pallas",
) -> torch.Tensor:
    """Feed-forward limiter, the compressor at ratio -> infinity: the static
    curve pinned at the threshold above the knee, true attack/release
    ballistics by default.

    Args:
        x: (bs, chs, T).
        threshold_db, attack_ms, release_ms, knee_db, makeup_gain_db:
            shape (bs,) each.
        eps: floor of the level detector.
        lookahead_samples: delay the audio against the gain curve.
        smoother: "exact_pallas" (the default) or any of :func:`_smooth_gain`.
    """
    threshold_db, attack_ms, release_ms, knee_db, makeup_gain_db = _params(
        x.shape[0], x.dtype, x.device, threshold_db, attack_ms, release_ms, knee_db, makeup_gain_db)
    _, x_db, alpha_a, alpha_r = _dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = static_gain_computer(x_db, threshold_db, None, knee_db, "limiter")
    g_smooth = _smooth_gain(g_c, alpha_a, alpha_r, smoother)
    return _lookahead(x, lookahead_samples) * db_to_linear(g_smooth + makeup_gain_db)


# ---------------------------------------------------------------------------
# multiband dynamics
# ---------------------------------------------------------------------------


def lr4_crossover_sos(crossover_hz, sample_rate, bs, dtype):
    """A 4th-order Linkwitz-Riley crossover pair: each leg a squared
    Butterworth (Q = 1/sqrt(2)) biquad, the two legs summing to an allpass.

    Returns:
        (sos_lp, sos_hp): each (bs, 2, 6), a0-normalized.
    """
    crossover_hz = torch.as_tensor(crossover_hz, dtype=dtype)
    device = crossover_hz.device
    zeros = torch.zeros((bs,), dtype=dtype, device=device)
    q = torch.full((bs,), 1.0 / math.sqrt(2.0), dtype=dtype, device=device)
    b_lp, a_lp = biquad(zeros, crossover_hz, q, sample_rate, "low_pass")
    b_hp, a_hp = biquad(zeros, crossover_hz, q, sample_rate, "high_pass")
    sos_lp = torch.stack([torch.cat([b_lp, a_lp], -1)] * 2, dim=1)
    sos_hp = torch.stack([torch.cat([b_hp, a_hp], -1)] * 2, dim=1)
    return sos_lp, sos_hp


@_scoped("multiband_compressor")
def multiband_compressor(
    x: torch.Tensor,
    sample_rate: float,
    crossover_low_hz,
    crossover_high_hz,
    low_threshold_db,
    low_ratio,
    low_attack_ms,
    low_release_ms,
    low_makeup_gain_db,
    mid_threshold_db,
    mid_ratio,
    mid_attack_ms,
    mid_release_ms,
    mid_makeup_gain_db,
    high_threshold_db,
    high_ratio,
    high_attack_ms,
    high_release_ms,
    high_makeup_gain_db,
    knee_db,
    eps: float = 1e-8,
    smoother: str = "block",
    filter_method: str = "coupled",
) -> torch.Tensor:
    """Three-band compressor: a phase-compensated LR4 split
    (:func:`_lr4_three_band_split`), one :func:`compressor` call on the
    bands stacked on the batch axis (3 x bs), the bands summed.

    Args:
        x: (bs, chs, T).
        crossover_low_hz / crossover_high_hz: the band edges (Hz), (bs,);
            the high one floored at 1.01 x the low one.
        {low,mid,high}_threshold_db, _ratio, _attack_ms, _release_ms,
            _makeup_gain_db: per band, (bs,) each.
        knee_db: shared by the bands, (bs,).
        eps: floor of the level detectors.
        smoother: "block" (the default, the attack-only one-pole by the
            block-state formulation) or any of :func:`_smooth_gain`.
        filter_method: the crossovers' method (the default "coupled").
    """
    bs, dtype, device = x.shape[0], x.dtype, x.device
    low, mid, high = _lr4_three_band_split(x, crossover_low_hz, crossover_high_hz, sample_rate, filter_method)

    def cat(*ps):
        return torch.cat([_param(p, bs, dtype, device).reshape(bs) for p in ps], dim=0)

    y = compressor(
        torch.cat([low, mid, high], dim=0),
        sample_rate,
        cat(low_threshold_db, mid_threshold_db, high_threshold_db),
        cat(low_ratio, mid_ratio, high_ratio),
        cat(low_attack_ms, mid_attack_ms, high_attack_ms),
        cat(low_release_ms, mid_release_ms, high_release_ms),
        cat(knee_db, knee_db, knee_db),
        cat(low_makeup_gain_db, mid_makeup_gain_db, high_makeup_gain_db),
        eps=eps,
        smoother=smoother,
    )
    return y[:bs] + y[bs : 2 * bs] + y[2 * bs :]


def _lr4_three_band_split(x, crossover_low_hz, crossover_high_hz, sample_rate, filter_method):
    """The phase-compensated LR4 three-band split: (low, mid, high), each
    shaped like x, summing flat when unprocessed. ``crossover_high_hz`` is
    floored at 1.01 x ``crossover_low_hz``."""
    bs, dtype, device = x.shape[0], x.dtype, x.device
    f_lo = _param(crossover_low_hz, bs, dtype, device).reshape(bs)
    f_hi = torch.maximum(_param(crossover_high_hz, bs, dtype, device).reshape(bs), 1.01 * f_lo)
    sos_lp_lo, sos_hp_lo = lr4_crossover_sos(f_lo, sample_rate, bs, dtype)
    sos_lp_hi, sos_hp_hi = lr4_crossover_sos(f_hi, sample_rate, bs, dtype)
    if filter_method == "fsm":
        # the tree is LTI, so under the FSM its stages compose in frequency:
        # one rfft of x, three band responses (the low band's phase
        # compensation, LP_hi + HP_hi, folds into its product), one batched
        # irfft
        T = x.shape[-1]
        n_fft = fsm_fft_size(T)
        H_lp_lo, H_hp_lo, H_lp_hi, H_hp_hi = (
            fft_sosfreqz(s, n_fft) for s in (sos_lp_lo, sos_hp_lo, sos_lp_hi, sos_hp_hi))
        H = torch.stack([H_lp_lo * (H_lp_hi + H_hp_hi), H_hp_lo * H_lp_hi, H_hp_lo * H_hp_hi])[:, :, None, :]
        X = torch.fft.rfft(x, n_fft, dim=-1)
        bands = torch.fft.irfft(X[None] * H, n_fft, dim=-1)[..., :T]
        return bands[0], bands[1], bands[2]
    # stage 1: both legs of the low split in one call; stage 2: mid and
    # high from the rest, and the low band through the high crossover's
    # allpass (its LP + HP) to stay phase-aligned, four legs in one call
    low_pre, rest = _apply_sos_batched([sos_lp_lo, sos_hp_lo], [x, x], filter_method)
    mid, high, lo_lp, lo_hp = _apply_sos_batched(
        [sos_lp_hi, sos_hp_hi, sos_lp_hi, sos_hp_hi], [rest, rest, low_pre, low_pre], filter_method)
    return lo_lp + lo_hp, mid, high


# ---------------------------------------------------------------------------
# tone and saturation
# ---------------------------------------------------------------------------


@_scoped("advanced_distortion")
def advanced_distortion(
    x: torch.Tensor,
    sample_rate: float,
    input_gain_db,
    output_gain_db,
    tone,
    dc_offset,
    filter_method: str = "block",
) -> torch.Tensor:
    """Distortion with input and output gain, tone and dc offset: input gain
    and dc bias into a tanh waveshaper, then a tone stage blending a
    first-order highpass at 1.16 kHz with a first-order lowpass at 320 Hz,
    then the output gain.

    Args:
        x: (bs, chs, T).
        input_gain_db, output_gain_db: gains in dB, (bs,).
        tone: highpass share on (0, 1), (bs,).
        dc_offset: bias before the shaper, (bs,).
        filter_method: the tone filters' method: "block" (the default),
            "exact", "coupled" or "fsm".
    """
    bs, dtype, device = x.shape[0], x.dtype, x.device
    input_gain_db, output_gain_db, tone, dc_offset = _params(
        bs, dtype, device, input_gain_db, output_gain_db, tone, dc_offset)
    y = torch.tanh(x * db_to_linear(input_gain_db) + dc_offset)
    b_hp, a_hp = one_pole_butter_highpass(torch.full((bs,), 1160.0, dtype=dtype, device=device), sample_rate)
    b_lp, a_lp = one_pole_butter_lowpass(torch.full((bs,), 320.0, dtype=dtype, device=device), sample_rate)
    y_hp = _apply_first_order(y, b_hp, a_hp, filter_method)
    y_lp = _apply_first_order(y, b_lp, a_lp, filter_method)
    y = tone * y_hp + (1.0 - tone) * y_lp
    return y * db_to_linear(output_gain_db)


def exciter_sos(bs, dtype, frequency_hz, sample_rate) -> torch.Tensor:
    """The exciter's second-order high-pass section, (bs, 1, 6)."""
    frequency_hz = torch.as_tensor(frequency_hz, dtype=dtype)
    device = frequency_hz.device
    zeros = torch.zeros((bs,), dtype=dtype, device=device)
    q = torch.full((bs,), 0.7071, dtype=dtype, device=device)
    b, a = biquad(zeros, frequency_hz.reshape(bs), q, sample_rate, "high_pass")
    return torch.cat([b, a], -1)[:, None, :]


@_scoped("exciter")
def exciter(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    drive_db,
    amount,
    filter_method: str = "coupled",
) -> torch.Tensor:
    """Harmonic exciter: ``y = x + amount * tanh(g * highpass(x)) / g`` with
    ``g = 10^(drive / 20)``; the high-pass a second-order Butterworth-Q
    biquad at ``frequency_hz``.

    Args:
        x: (bs, chs, T).
        frequency_hz: the high-pass corner (Hz), (bs,).
        drive_db: the waveshaper's drive (dB), (bs,).
        amount: wet blend on [0, 1], (bs,).
        filter_method: "coupled" (the default) or another of
            :func:`parametric_eq`'s.
    """
    bs, dtype, device = x.shape[0], x.dtype, x.device
    frequency_hz, drive_db, amount = _params(bs, dtype, device, frequency_hz, drive_db, amount)
    high = _apply_sos(exciter_sos(bs, dtype, frequency_hz, sample_rate), x, filter_method)
    g = db_to_linear(drive_db)
    return (x + amount * (torch.tanh(high * g) / g)).to(dtype)


@_scoped("bitcrusher")
def bitcrusher(x: torch.Tensor, sample_rate: float, bit_depth, sample_rate_hz, mix) -> torch.Tensor:
    """Bit-depth and sample-rate reduction with continuous controls.

    * Zero-order hold on the reduced clock: the tick ordinal is
      ``floor(n * r + 1e-6)`` with ``r = sample_rate_hz / sample_rate``
      (multiplies and floors only, no division by r), a sample is a tick
      where the ordinal grows, and each sample holds the latest tick's
      value, found by a running max of the tick indices (integers: no
      gradient flows through it). The gather is differentiable in x;
      ``sample_rate_hz`` gets no gradient through the integer positions.
    * Quantization to ``bit_depth`` bits (may be fractional): the forward
      value is ``round`` (half to even), the backward that of the smooth
      surrogate ``u - sin(2 pi u) / (2 pi)``, so gradients reach
      ``bit_depth`` and x.

    Args:
        x: (bs, chs, T).
        bit_depth: bits (>= 1), (bs,).
        sample_rate_hz: the hold clock (Hz, <= sample_rate), (bs,).
        mix: dry/wet on [0, 1], (bs,).
    """
    bs, chs, seq_len = x.shape
    dtype, device = x.dtype, x.device
    bit_depth, sample_rate_hz, mix = _params(bs, dtype, device, bit_depth, sample_rate_hz, mix)

    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which would move the ticks against the CPU's IEEE division
    r = torch.clamp(sample_rate_hz / torch.full_like(sample_rate_hz, sample_rate), 0.0, 1.0)
    n = torch.arange(seq_len, dtype=torch.float32, device=device)[None, None, :]
    tick = torch.floor(n * r + 1e-6)
    is_tick = torch.cat([torch.ones_like(tick[..., :1], dtype=torch.bool), tick[..., 1:] > tick[..., :-1]], dim=-1)
    n_int = torch.arange(seq_len, dtype=torch.int64, device=device)[None, None, :]
    hold_idx = torch.cummax(torch.where(is_tick, n_int, 0), dim=2).values
    held = torch.gather(x, -1, hold_idx.expand(bs, chs, seq_len))

    scale = 2.0 ** (bit_depth - 1.0)
    u = held * scale
    q_soft = u - torch.sin(2.0 * math.pi * u) / (2.0 * math.pi)
    q = q_soft + (torch.round(u) - q_soft).detach()
    return (1.0 - mix) * x + mix * (q / scale)


@_scoped("clipper")
def clipper(x: torch.Tensor, sample_rate: float, threshold_db, hardness) -> torch.Tensor:
    """Clipper with a ceiling ``c = 10^(threshold_db / 20)`` and a hard/soft
    blend: ``y = (1 - h) c tanh(x / c) + h clip(x, -c, c)``.

    Args:
        x: (bs, chs, T). sample_rate: unused.
        threshold_db: the ceiling in dB, (bs,).
        hardness: the hard share on [0, 1], (bs,).
    """
    threshold_db, hardness = _params(x.shape[0], x.dtype, x.device, threshold_db, hardness)
    c = db_to_linear(threshold_db)
    soft = c * torch.tanh(x / c)
    hard = torch.minimum(torch.maximum(x, -c), c)  # jnp.clip's form: a tie splits the gradient
    return ((1.0 - hardness) * soft + hardness * hard).to(x.dtype)


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


@_scoped("noise_shaped_reverberation")
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
    ir_conv_fn=None,
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
        ir_conv_fn: the signal-with-IR convolution, ``ir_conv_fn(x, ir)``
            with x (bs, 2, T) and ir (bs, 2, num_samples), in place of
            :func:`~dasp_tpu_torch.ops.fft_conv_causal` (e.g.
            ``parallel.sharded_fft_conv_causal`` bound to a mesh, with x this
            rank's time block).

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
        generator=generator, noise=noise, noise_mode=noise_mode, dtype=dtype,
    )
    y = (ir_conv_fn or fft_conv_causal)(x, ir)
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
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The stereo filtered-noise impulse response, (bs, 2, num_samples), from
    band gains and decays of shape (bs, 12) on (0, 1). The filter bank, the
    noise and the envelopes' time axis are computed in ``dtype``; the gains
    and decays keep theirs, so float64 gains with the default float32 give
    a float64 IR over float32 noise, as in the JAX package."""
    bs = band_gains.shape[0]
    device = band_gains.device
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
# stereo field
# ---------------------------------------------------------------------------


@_scoped("stereo_widener")
def stereo_widener(x: torch.Tensor, sample_rate: float, width) -> torch.Tensor:
    """Stereo widener by mid/side processing.

    Args:
        x: stereo audio, (bs, 2, T). sample_rate: unused.
        width: on (0, 1), 0.5 unchanged, 1 side only: a scalar, (bs,) or
            (bs, 1).
    """
    bs, chs, _ = x.shape
    if chs != 2:
        raise ValueError(f"stereo_widener needs input of shape (bs, 2, T), got {tuple(x.shape)}")
    width = torch.as_tensor(width, dtype=x.dtype, device=x.device)
    width = width.expand(bs, 1) if width.ndim == 0 else width.reshape(bs, 1)

    sqrt2 = math.sqrt(2.0)
    mid = (x[..., 0, :] + x[..., 1, :]) / sqrt2
    side = (x[..., 0, :] - x[..., 1, :]) / sqrt2
    mid = mid * (2.0 * (1.0 - width))
    side = side * (2.0 * width)
    return torch.stack(((mid + side) / sqrt2, (mid - side) / sqrt2), dim=-2)


@_scoped("stereo_panner")
def stereo_panner(x: torch.Tensor, sample_rate: float, pan) -> torch.Tensor:
    """Pan mono tracks across the stereo field by the constant-power law.

    Args:
        x: mono tracks, (bs, tracks, T). sample_rate: unused.
        pan: on (0, 1) per track (0 left, 0.5 centre, 1 right),
            (bs, tracks).

    Returns:
        Panned tracks, (bs, 2, tracks, T): the JAX package's layout (the
        reference's code, not its docstring).
    """
    bs, tracks, _ = x.shape
    pan = torch.as_tensor(pan, dtype=x.dtype, device=x.device).reshape(bs, tracks)
    theta = pan * (math.pi / 2.0)
    left = torch.sqrt(((math.pi / 2.0) - theta) * (2.0 / math.pi) * torch.cos(theta))
    right = torch.sqrt(theta * (2.0 / math.pi) * torch.sin(theta))
    gains = torch.stack([left, right], dim=1)[..., None]  # (bs, 2, tracks, 1)
    return x[:, None] * gains


# ---------------------------------------------------------------------------
# delay family: modulated delay (chorus, flanger) and pitch shift
# ---------------------------------------------------------------------------


def _host_max(v) -> np.ndarray:
    """The largest value of a parameter, read to the host."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.max(np.asarray(v))


@_scoped("modulated_delay")
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

    Each call adds one to the always-on counter ``frac_delay.call``
    (:mod:`~dasp_tpu_torch.trace`), on either adjoint, beside the kernel's
    own ``kernel_c.forward`` launch counter.
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
    count("frac_delay.call")
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


@_scoped("pitch_shift")
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


# ---------------------------------------------------------------------------
# the rest of the delay family: feedback delay, carrier and LFO modulation,
# multiband stereo width, user-IR convolution, tape wow and flutter
# ---------------------------------------------------------------------------


def _time_grid(seq_len: int, sample_rate: float, device) -> torch.Tensor:
    """Sample times ``n / sample_rate`` in seconds, (1, 1, seq_len), rounded
    to fp32 on the host as the JAX package's numpy constant is."""
    n = np.arange(seq_len, dtype=np.float32)[None, None, :]
    return torch.from_numpy(n / np.float32(sample_rate)).to(device)


@_scoped("delay")
def delay(x: torch.Tensor, sample_rate: float, delay_ms, feedback, mix) -> torch.Tensor:
    """Feedback delay (echo) with a continuous, differentiable delay time:
    the comb ``H(z) = z^-D / (1 - fb z^-D)`` evaluated in closed form on the
    rFFT bins of a zero-padded spectrum (``D = delay_ms * fs / 1000``
    enters only through ``exp(-j w D)``). Echoes beyond the padded length
    (2 x the signal) wrap around with magnitude ``fb ** (n_fft / D)``.

    Args:
        x: (bs, chs, T).
        delay_ms: delay time (ms), fractional allowed, (bs,).
        feedback: on [0, 1), clamped to <= 0.999, (bs,).
        mix: dry/wet on [0, 1], (bs,).
    """
    bs, _, seq_len = x.shape
    dtype, device = x.dtype, x.device
    delay_ms, mix = _params(bs, dtype, device, delay_ms, mix)
    feedback = torch.clamp(_param(feedback, bs, dtype, device), max=0.999)
    n_fft = next_pow2(2 * seq_len)
    # the response in float64, rounded once: in fp32 the phase w D of a
    # second-long delay is off by up to 1e-2 rad
    d_samples = delay_ms.double() * (sample_rate / 1e3)  # (bs, 1, 1)
    omega = np.arange(n_fft // 2 + 1, dtype=np.float32) * np.float32(2.0 * np.pi / n_fft)
    phase = torch.from_numpy(omega).to(device)[None, None, :] * d_samples  # (bs, 1, F)
    z_d = torch.complex(torch.cos(phase), -torch.sin(phase))  # exp(-j w D)
    mix, feedback = mix.double(), feedback.double()
    h = (1.0 - mix) + mix * (z_d / (1.0 - feedback * z_d))
    X = torch.fft.rfft(x, n_fft, dim=-1)
    return torch.fft.irfft(X * h.to(X.dtype), n_fft, dim=-1)[..., :seq_len].to(dtype)


@_scoped("ring_modulator")
def ring_modulator(x: torch.Tensor, sample_rate: float, frequency_hz, mix, lfo_phase: float = 0.0) -> torch.Tensor:
    """Ring modulator: ``y = (1 - mix) x + mix x sin(2 pi f n / fs + phase)``.

    Args:
        x: (bs, chs, T).
        frequency_hz: carrier frequency (Hz), (bs,).
        mix: dry/wet on [0, 1], (bs,).
        lfo_phase: initial carrier phase (radians).
    """
    bs, _, seq_len = x.shape
    frequency_hz, mix = _params(bs, x.dtype, x.device, frequency_hz, mix)
    # the carrier's phase in float64, rounded once: in fp32, 2 pi f t at
    # kHz over seconds is off by up to 5e-3 rad
    phase = 2.0 * np.pi * frequency_hz.double() * _time_grid(seq_len, sample_rate, x.device) + lfo_phase
    carrier = torch.sin(phase).to(x.dtype)
    return (((1.0 - mix) + mix * carrier) * x).to(x.dtype)


@_scoped("tremolo")
def tremolo(x: torch.Tensor, sample_rate: float, rate_hz, depth, lfo_phase: float = 0.0) -> torch.Tensor:
    """Tremolo: ``y = x (1 - depth (1 + sin(2 pi rate n / fs + phase)) / 2)``,
    unity gain at the LFO's trough, ``1 - depth`` at its peak.

    Args:
        x: (bs, chs, T).
        rate_hz: LFO rate (Hz), (bs,).
        depth: on [0, 1], (bs,).
        lfo_phase: initial LFO phase (radians).
    """
    bs, _, seq_len = x.shape
    rate_hz, depth = _params(bs, x.dtype, x.device, rate_hz, depth)
    lfo = 0.5 * (1.0 + torch.sin(2.0 * np.pi * rate_hz * _time_grid(seq_len, sample_rate, x.device) + lfo_phase))
    return (x * (1.0 - depth * lfo)).to(x.dtype)


@_scoped("stereo_imager")
def stereo_imager(
    x: torch.Tensor,
    sample_rate: float,
    crossover_low_hz,
    crossover_high_hz,
    low_width,
    mid_width,
    high_width,
    filter_method: str = "coupled",
) -> torch.Tensor:
    """Multiband stereo imager: the phase-compensated LR4 three-band split
    (:func:`_lr4_three_band_split`), each band through
    :func:`stereo_widener` (one call on the bands stacked on the batch
    axis), the bands summed.

    Args:
        x: stereo audio, (bs, 2, T).
        crossover_low_hz / crossover_high_hz: the band edges (Hz), (bs,).
        low_width / mid_width / high_width: per-band width on (0, 1), 0.5
            unchanged, (bs,).
        filter_method: the crossovers' method, as :func:`multiband_compressor`'s.
    """
    bs, chs, _ = x.shape
    if chs != 2:
        raise ValueError(f"stereo_imager needs stereo input, got {chs} channels.")
    low, mid, high = _lr4_three_band_split(x, crossover_low_hz, crossover_high_hz, sample_rate, filter_method)
    widths = torch.cat([_param(w, bs, x.dtype, x.device).reshape(bs) for w in (low_width, mid_width, high_width)])
    y = stereo_widener(torch.cat([low, mid, high], dim=0), sample_rate, widths)
    return (y[:bs] + y[bs : 2 * bs] + y[2 * bs :]).to(x.dtype)


@_scoped("convolution_reverb")
def convolution_reverb(x: torch.Tensor, sample_rate: float, mix, ir: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """Convolution reverb with a user impulse response (gradients flow to
    ``x``, ``mix`` and the IR): one batched FFT convolution
    (:func:`~dasp_tpu_torch.ops.fft_conv_causal`), or overlap-save blocks
    of ``block`` samples (:func:`~dasp_tpu_torch.ops.ola_conv_causal`).

    Args:
        x: (bs, chs, T). sample_rate: unused.
        mix: dry/wet on [0, 1], (bs,).
        ir: impulse response, (K,), (bs, K) or (bs, chs, K).
        block: overlap-save block length, or None for one FFT.
    """
    dtype, device = x.dtype, x.device
    mix = _param(mix, x.shape[0], dtype, device)
    ir = torch.as_tensor(ir, dtype=dtype, device=device)
    if ir.ndim == 1:
        ir = ir[None, None, :]
    elif ir.ndim == 2:
        ir = ir[:, None, :]
    wet = fft_conv_causal(x, ir) if block is None else ola_conv_causal(x, ir, block=block)
    return ((1.0 - mix) * x + mix * wet).to(dtype)


@_scoped("wow_flutter")
def wow_flutter(
    x: torch.Tensor,
    sample_rate: float,
    wow_depth_ms,
    flutter_depth_ms,
    wow_rate_hz=0.8,
    flutter_rate_hz=8.0,
    base_ms: float = 5.0,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    block: int = 512,
) -> torch.Tensor:
    """Tape wow and flutter: a fractional delay line around ``base_ms``
    whose read position drifts by two band-limited noise processes (white
    noise one-pole-lowpassed at each rate, :func:`~dasp_tpu_torch.ops.
    onepole_exact`, normalized to unit RMS and scaled by the depths). The
    curve is computed in float64 and rounded once: the noises' poles lie
    within 1e-4 of 1, where fp32's rounding of the pole alone moves the
    curve by about 1e-3 of its depth. The delay runs through
    :func:`_frac_delay_matmul` with the static bound ``2 * base_ms``: the
    fractional-delay kernel on a CUDA float32 tensor.

    Args:
        x: (bs, chs, T).
        wow_depth_ms / flutter_depth_ms: RMS depths (ms), (bs,); keep their
            sum well under ``base_ms``.
        wow_rate_hz / flutter_rate_hz: the noises' bandwidths (Hz), (bs,).
        base_ms: centre delay (ms), the dry latency.
        generator: ``torch.Generator`` for the noise draw (the JAX package
            takes a PRNG key here). Required unless ``noise`` is given.
        noise: a (bs, 2, T) standard normal draw (channel 0 wow, 1 flutter).
        block: output tile length of the delay.
    """
    bs, _, seq_len = x.shape
    dtype, device = x.dtype, x.device
    wow_depth, fl_depth, wow_rate, fl_rate = _params(
        bs, dtype, device, wow_depth_ms, flutter_depth_ms, wow_rate_hz, flutter_rate_hz)
    if noise is None:
        if generator is None:
            raise ValueError("wow_flutter is stochastic: pass generator= (or noise=).")
        noise = torch.randn((bs, 2, seq_len), generator=generator, dtype=dtype, device=device)
    else:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
    ln9 = math.log(9.0)

    def drift(n, rate):
        alpha = torch.exp(-ln9 / (sample_rate / torch.clamp(rate.double(), min=1e-3)))
        d = onepole_exact(n.double(), alpha)
        return d / torch.sqrt(torch.mean(d ** 2, dim=-1, keepdim=True) + 1e-12)

    ms = sample_rate / 1e3
    d = (base_ms * ms + wow_depth.double() * ms * drift(noise[:, 0:1], wow_rate)
         + fl_depth.double() * ms * drift(noise[:, 1:2], fl_rate))
    dmax = 2.0 * base_ms * ms
    d = torch.clamp(d, 0.0, dmax).to(dtype)
    return _frac_delay_matmul(x, [(d, None)], float(dmax), block).to(dtype)


# ---------------------------------------------------------------------------
# the WOLA time-varying family
# ---------------------------------------------------------------------------


def _tv_analysis(x, frame_size: int, hop: int, n_fft: int, tv_power_fn, tv_filter_fn):
    """The analysis of a WOLA effect: ``(X, power)`` with X the spectra
    (bs, chs, n_frames, n_bins) and power their channel mean (bs, n_frames,
    n_bins). With either hook the effect is split as the JAX package's: the
    power from ``tv_power_fn(x, frame_size, hop, n_fft)`` (or its own
    analysis), X None, and the synthesis by :func:`_tv_synthesis`."""
    if tv_power_fn is None and tv_filter_fn is None:
        X = tv_stft(x, frame_size, hop, n_fft)
        return X, _power(X).mean(dim=1)
    if tv_power_fn is not None:
        return None, tv_power_fn(x, frame_size, hop, n_fft)
    return None, _power(tv_stft(x, frame_size, hop, n_fft)).mean(dim=1)


def _tv_synthesis(x, X, H, frame_size: int, hop: int, tv_filter_fn):
    """The per-frame response H applied: to the spectra X where the effect
    computed them, else by ``tv_filter_fn(x, H, frame_size, hop)`` (or
    :func:`~dasp_tpu_torch.ops.tv_freq_filter`)."""
    if X is not None:
        return tv_istft(X * H[:, None], x.shape[-1], frame_size, hop)
    return (tv_filter_fn or tv_freq_filter)(x, H, frame_size, hop)


def _einsum_float64(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` computed in float64 and rounded once to the first
    operand's dtype. The JAX package runs these contractions at
    ``Precision.HIGHEST``; in float64 they are DGEMMs, which TF32 never
    touches, so the result is the same whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says."""
    return torch.einsum(equation, *(o.double() for o in operands)).to(operands[0].dtype)


def _unit_phasors(n_bins: int, device) -> torch.Tensor:
    """``exp(-j w)`` on ``w = linspace(0, pi, n_bins)``, complex64 as the JAX
    package's constant (a float64 operand promotes it)."""
    w = np.linspace(0.0, np.pi, n_bins, dtype=np.float32)
    return torch.from_numpy(np.exp(-1j * w).astype(np.complex64)).to(device)


def _power(X: torch.Tensor) -> torch.Tensor:
    """|X|^2 of complex spectra (its gradient is 0 at X = 0)."""
    return X.real.square() + X.imag.square()


def _smooth_det_power(power, alpha_d, mode="centered", y0=None):
    """Smooth a (bs, n_frames, n_bins) detector power over frames by a
    one-pole: ``"centered"`` (forward and backward: zero phase, so the gate
    opens on time at onsets) or ``"causal"`` (forward only). Returns the
    smoothed power and the forward pass's last frame."""
    p_s = onepole_exact(power.transpose(1, 2), alpha_d, y0=y0)  # (bs, n_bins, n_frames)
    yf = p_s[..., -1]
    if mode == "centered":
        p_s = torch.flip(onepole_exact(torch.flip(p_s, (-1,)), alpha_d), (-1,))
    elif mode != "causal":
        raise ValueError(f"det_smooth_mode must be 'centered' or 'causal', got {mode!r}.")
    return p_s.transpose(1, 2), yf


def _spectral_gate_gain(
    det_db, noise_db, threshold_db, range_db, sharpness_db,
    alpha_a, alpha_r, smoother, freq_smooth_bins=9, y0=None, return_yf=False,
):
    """Per-bin gate gain (linear, (bs, n_frames, n_bins)) from a detector
    spectrogram and a noise floor in dB: a sigmoid above the floor, floored
    at ``-range_db``, smoothed over frames by the ballistics (gate
    convention: the first coefficient acts where the gain falls) and across
    bins by a normalized ``freq_smooth_bins``-wide Hann kernel (edges
    replicated; <= 1 disables)."""
    mask = torch.sigmoid((det_db - noise_db - threshold_db) / torch.clamp(sharpness_db, min=1e-3))
    floor = db_to_linear(-range_db)
    gain = floor + (1.0 - floor) * mask
    out = ballistics_smooth(gain.transpose(1, 2), alpha_r, alpha_a, mode=smoother, y0=y0, return_yf=return_yf)
    gain = (out[0] if return_yf else out).transpose(1, 2)
    W = int(freq_smooth_bins)
    if W > 1:
        w = np.hanning(W + 2)[1:-1].astype(np.float32)
        w = w / w.sum()
        half = W // 2
        gp = nnf.pad(gain, (half, W - 1 - half), mode="replicate")
        n = gain.shape[-1]
        gain = sum(float(w[k]) * gp[..., k : k + n] for k in range(W))
    return (gain, out[1]) if return_yf else gain


@_scoped("spectral_gate")
def spectral_gate(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    range_db,
    attack_ms,
    release_ms,
    sharpness_db=3.0,
    noise_profile_db: torch.Tensor | None = None,
    noise_quantile: float = 0.15,
    det_smooth_ms: float = 40.0,
    det_smooth_mode: str = "centered",
    freq_smooth_bins: int = 9,
    frame_size: int = 2048,
    hop: int = 512,
    eps: float = 1e-8,
    smoother: str = "parallel",
    tv_power_fn=None,
    tv_filter_fn=None,
) -> torch.Tensor:
    """Spectral gate (broadband noise reduction), differentiable throughout.

    One analysis STFT (:func:`~dasp_tpu_torch.ops.tv_stft`) serves detection
    and filtering. The channel-mean power of each (frame, bin), smoothed
    over ``det_smooth_ms`` (:func:`_smooth_det_power`), is compared in dB
    with a noise floor: ``gain = floor + (1 - floor) sigmoid((X_db - N_db -
    threshold_db) / sharpness_db)``, smoothed over frames (``attack_ms``
    opens a bin, ``release_ms`` closes it) and across bins, then applied to
    the spectra and overlap-added. The floor is ``noise_profile_db`` (from
    :func:`spectral_noise_profile` on a noise-only capture), else the
    ``noise_quantile`` quantile of each bin's smoothed detector.

    Args:
        x: (bs, chs, T); the channels share one detector and mask.
        threshold_db: dB above the floor where a bin half-opens, (bs,).
        range_db: maximum attenuation (dB, >= 0), (bs,).
        attack_ms / release_ms: per-bin open and close times (ms), (bs,).
        sharpness_db: the sigmoid's width (dB), (bs,) or scalar.
        noise_profile_db: a measured floor, (bs, frame_size + 1); None
            estimates it.
        noise_quantile: the estimate's quantile.
        det_smooth_ms / det_smooth_mode: the detector's smoothing time and
            mode ("centered" or "causal").
        freq_smooth_bins: the gain's smoothing width across bins.
        frame_size / hop: the analysis frames (n_fft = 2 * frame_size).
        eps: floor of the detector.
        smoother: "parallel" (the default) or "exact" frame ballistics.
        tv_power_fn / tv_filter_fn: plug points of another analysis and
            synthesis: ``tv_power_fn(x, frame_size, hop, n_fft) -> (bs,
            n_frames, n_bins)`` channel-mean power and ``tv_filter_fn(x, H,
            frame_size, hop) -> y`` (e.g. the sequence-sharded
            ``parallel.sharded_tv_power`` / ``sharded_tv_freq_filter``
            bound to a mesh). With either, the effect runs split: detection
            from the power, then one WOLA filter pass.
    """
    bs = x.shape[0]
    dtype, device = x.dtype, x.device
    threshold_db, range_db, attack_ms, release_ms, sharpness_db = _params(
        bs, dtype, device, threshold_db, range_db, attack_ms, release_ms, sharpness_db)
    ln9 = math.log(9.0)
    frame_rate = sample_rate / hop
    X, power = _tv_analysis(x, frame_size, hop, 2 * frame_size, tv_power_fn, tv_filter_fn)
    alpha_d = np.exp(-ln9 / (frame_rate * (det_smooth_ms / 1e3))).astype(np.float32)
    power, _ = _smooth_det_power(power, alpha_d, det_smooth_mode)
    det_db = 10.0 * torch.log10(torch.clamp(power, min=eps * eps))
    if noise_profile_db is None:
        noise_db = torch.quantile(det_db, noise_quantile, dim=1, keepdim=True)
    else:
        noise_db = torch.as_tensor(noise_profile_db, dtype=dtype, device=device)[:, None, :]
    alpha_a = torch.exp(-ln9 / (frame_rate * (attack_ms / 1e3)))
    alpha_r = torch.exp(-ln9 / (frame_rate * (release_ms / 1e3)))
    gain = _spectral_gate_gain(det_db, noise_db, threshold_db, range_db, sharpness_db, alpha_a, alpha_r,
                               smoother, freq_smooth_bins)
    return _tv_synthesis(x, X, gain, frame_size, hop, tv_filter_fn).to(dtype)


def spectral_noise_profile(noise: torch.Tensor, frame_size: int = 2048, hop: int = 512,
                           eps: float = 1e-8) -> torch.Tensor:
    """A noise floor for :func:`spectral_gate` from a noise-only capture
    (bs, chs, T): the per-bin mean power of its short-time spectra in dB,
    (bs, frame_size + 1)."""
    X = tv_stft(noise, frame_size, hop, 2 * frame_size)
    return 10.0 * torch.log10(torch.clamp(_power(X).mean(dim=(1, 2)), min=eps * eps))


def _band_param(p, bs: int, nb: int, dtype, device) -> torch.Tensor:
    """A per-band parameter as (bs, n_bands): scalars and (bs,) tensors
    broadcast across bands."""
    p = torch.as_tensor(p, dtype=dtype, device=device)
    if p.ndim == 0:
        return p.expand(bs, nb)
    if p.ndim == 1:
        return p[:, None].expand(bs, nb)
    return p.reshape(bs, nb)


def _biquad_response(f, q, gain_db, n_bins: int, sample_rate: float, filter_type: str = "peaking"):
    """Closed-form complex response of a cookbook "peaking" or "band_pass"
    biquad on ``w = linspace(0, pi, n_bins)``, batched over any leading
    shape: ``f.shape + (n_bins,)``."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * (f / sample_rate)
    alpha = torch.sin(w0) / (2.0 * q)
    cos_w0 = torch.cos(w0)
    if filter_type == "peaking":
        b0, b1, b2 = 1.0 + alpha * A, -2.0 * cos_w0, 1.0 - alpha * A
        a0, a1, a2 = 1.0 + alpha / A, -2.0 * cos_w0, 1.0 - alpha / A
    elif filter_type == "band_pass":
        b0, b1, b2 = A * alpha, torch.zeros_like(alpha), -A * alpha
        a0, a1, a2 = 1.0 + alpha, -2.0 * cos_w0, 1.0 - alpha
    else:
        raise ValueError(f"Unsupported filter_type: {filter_type!r}")
    e1 = _unit_phasors(n_bins, f.device)
    e2 = e1 * e1
    num = b0[..., None] + b1[..., None] * e1 + b2[..., None] * e2
    den = a0[..., None] + a1[..., None] * e1 + a2[..., None] * e2
    return num / den


def _dynamic_eq_gain(P, band_w, threshold_db, ratio, knee_db, max_cut_db, alpha_a, alpha_r, smoother, eps,
                     y0=None, return_yf=False):
    """Per-band gain reduction (bs, n_bands, n_frames) in dB <= 0 from a
    power spectrogram ``P`` (bs, n_frames, n_bins) and detection weights
    ``band_w`` (bs, n_bands, n_bins): the weighted power in dB through the
    compressor's static curve, capped at ``max_cut_db``, and the frame-rate
    ballistics."""
    level = _einsum_float64("bfk,bnk->bnf", P, band_w)
    L = 10.0 * torch.log10(torch.clamp(level, min=eps * eps))
    g_c = static_gain_computer(L, threshold_db, ratio, knee_db, "compressor")
    g_c = torch.maximum(g_c, g_c.new_tensor(-max_cut_db))
    return ballistics_smooth(g_c, alpha_a, alpha_r, mode=smoother, y0=y0, return_yf=return_yf)


@_scoped("dynamic_eq")
def dynamic_eq(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    q_factor,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db: float = 6.0,
    max_cut_db: float = 24.0,
    frame_size: int = 1024,
    hop: int = 256,
    eps: float = 1e-8,
    smoother: str = "parallel",
    tv_power_fn=None,
    tv_filter_fn=None,
) -> torch.Tensor:
    """Dynamic EQ: peaking bands whose cut follows their own band level.

    One analysis STFT does both jobs: each band's detector is the band-pass
    weighted power of each frame's spectrum (Parseval-calibrated, so a
    sine at a band's centre reads its mean square), through the
    compressor's static curve and frame-rate ballistics; the per-frame
    response is the product of the peaking bells at their current gain
    reductions, applied in the frequency domain (n_fft = 4 * frame_size,
    room for a deep, narrow low band's tail).

    Args:
        x: (bs, chs, T); the channels share each band's detector.
        frequency_hz, q_factor, threshold_db, ratio, attack_ms, release_ms:
            per band, (bs, n_bands) (scalars and (bs,) broadcast across
            bands).
        knee_db: the soft knee (dB). max_cut_db: the cap on each band's cut.
        frame_size / hop: the analysis frames.
        eps: floor of the detector.
        smoother: "parallel" (the default) or "exact" frame ballistics.
        tv_power_fn / tv_filter_fn: plug points of another analysis and
            synthesis, as :func:`spectral_gate`'s.
    """
    bs = x.shape[0]
    dtype, device = x.dtype, x.device
    frequency_hz = torch.as_tensor(frequency_hz, dtype=dtype, device=device)
    if frequency_hz.ndim < 2:
        frequency_hz = frequency_hz.reshape(bs, -1)
    nb = frequency_hz.shape[-1]
    q_factor, threshold_db, ratio, attack_ms, release_ms = (
        _band_param(p, bs, nb, dtype, device) for p in (q_factor, threshold_db, ratio, attack_ms, release_ms))
    n_bins = 2 * frame_size + 1  # n_fft = 4 * frame_size
    X, power = _tv_analysis(x, frame_size, hop, 4 * frame_size, tv_power_fn, tv_filter_fn)
    band_w = _dynamic_eq_band_weights(frequency_hz, q_factor, n_bins, sample_rate, frame_size, hop)
    ln9 = math.log(9.0)
    frame_rate = sample_rate / hop
    alpha_a = torch.exp(-ln9 / (frame_rate * (attack_ms / 1e3)))[..., None]
    alpha_r = torch.exp(-ln9 / (frame_rate * (release_ms / 1e3)))[..., None]
    g = _dynamic_eq_gain(power, band_w, threshold_db[..., None], ratio[..., None], knee_db,
                         max_cut_db, alpha_a, alpha_r, smoother, eps)
    H = _dynamic_eq_response(frequency_hz, q_factor, g, n_bins, sample_rate)
    return _tv_synthesis(x, X, H, frame_size, hop, tv_filter_fn).to(dtype)


def _dynamic_eq_band_weights(frequency_hz, q_factor, n_bins: int, sample_rate: float, frame_size: int, hop: int):
    """Band-pass power weights (bs, n_bands, n_bins), scaled so that the
    weighted sum of a frame's power spectrum is the band-filtered signal's
    mean square."""
    bp = _biquad_response(frequency_hz, q_factor, torch.zeros_like(q_factor), n_bins, sample_rate, "band_pass")
    n_fft = 2 * (n_bins - 1)
    wpow = float(np.sum(tv_analysis_window(frame_size, hop) ** 2))
    return _power(bp) * (2.0 / (n_fft * wpow))


def _dynamic_eq_response(frequency_hz, q_factor, g, n_bins: int, sample_rate: float):
    """The product of the peaking bells at gain reductions ``g`` (bs,
    n_bands, n_frames): (bs, n_frames, n_bins), complex."""
    Hb = _biquad_response(frequency_hz[:, :, None].expand(g.shape), q_factor[:, :, None].expand(g.shape),
                          g, n_bins, sample_rate, "peaking")  # (bs, n_bands, n_frames, n_bins)
    H = Hb[:, 0]
    for i in range(1, Hb.shape[1]):
        H = H * Hb[:, i]
    return H


def _phaser_response(f_break, feedback, mix, n_bins: int, stages: int, sample_rate: float):
    """Per-frame response (bs, n_frames, n_bins) of the phaser core:
    ``stages`` first-order allpasses with break frequency ``f_break`` (bs,
    n_frames), a one-sample feedback path around them and a dry/wet mix,
    ``H = (1 - mix) + mix A^K / (1 - fb e^-jw A^K)``."""
    t = torch.tan(np.pi * f_break / sample_rate)
    c = ((t - 1.0) / (t + 1.0))[..., None]  # (bs, n_frames, 1)
    e = _unit_phasors(n_bins, f_break.device)
    chain = ((c + e) / (1.0 + c * e)) ** stages
    wet = chain / (1.0 - feedback[..., None] * e * chain)
    mix = mix[..., None]
    return (1.0 - mix) + mix * wet


@_scoped("phaser")
def phaser(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz,
    depth,
    centre_frequency_hz,
    feedback,
    mix,
    stages: int = 6,
    lfo_phase: float = 0.0,
    frame_size: int = 512,
    hop: int = 128,
    tv_filter_fn=None,
) -> torch.Tensor:
    """LFO-swept allpass-cascade phaser: the cascade's closed-form response
    at each analysis frame's LFO value (:func:`_phaser_response`), applied
    by the WOLA filter (:func:`~dasp_tpu_torch.ops.tv_freq_filter`,
    n_fft = 4 * frame_size).

    Args:
        x: (bs, chs, T).
        rate_hz: LFO rate (Hz), (bs,).
        depth: sweep width on [0, 1], +-2 depth octaves around the centre, (bs,).
        centre_frequency_hz: sweep centre (Hz), (bs,).
        feedback: around the allpass chain, |fb| < 1, (bs,).
        mix: dry/wet on [0, 1], (bs,).
        stages: first-order allpass stages. lfo_phase: initial LFO phase.
        frame_size / hop: the analysis frames.
        tv_filter_fn: a WOLA filter ``(x, H, frame_size, hop) -> y`` in
            place of :func:`~dasp_tpu_torch.ops.tv_freq_filter` (e.g. the
            sequence-sharded one).
    """
    bs, _, seq_len = x.shape
    dtype, device = x.dtype, x.device
    rate_hz, depth, centre, feedback, mix = (
        _param(p, bs, dtype, device).reshape(bs, 1) for p in (rate_hz, depth, centre_frequency_hz, feedback, mix))
    centers = tv_frame_centers(seq_len, frame_size, hop).astype(np.float32)
    t = torch.from_numpy(centers / np.float32(sample_rate)).to(device)[None, :]  # (1, n_frames)
    lfo = torch.sin(2.0 * np.pi * rate_hz * t + lfo_phase)
    f_break = torch.clamp(centre * 2.0 ** (2.0 * depth * lfo), 1.0, 0.49 * sample_rate)
    H = _phaser_response(f_break, feedback, mix, 2 * frame_size + 1, stages, sample_rate)
    return (tv_filter_fn or tv_freq_filter)(x, H, frame_size, hop).to(dtype)


@_scoped("auto_wah")
def auto_wah(
    x: torch.Tensor,
    sample_rate: float,
    sensitivity,
    attack_ms,
    release_ms,
    min_frequency_hz,
    max_frequency_hz,
    q_factor,
    mix,
    eps: float = 1e-8,
    frame_size: int = 512,
    hop: int = 128,
    tv_filter_fn=None,
) -> torch.Tensor:
    """Envelope-following resonant band-pass (auto-wah): the mono level's
    fast-rise, slow-fall envelope (``"parallel"`` ballistics), sampled at
    the frame centres, steers a band-pass biquad's centre exponentially
    between the two frequencies; the per-frame responses are applied by the
    WOLA filter (n_fft = 4 * frame_size).

    Args:
        x: (bs, chs, T).
        sensitivity: envelope-to-sweep gain (``tanh(sensitivity * env)``), (bs,).
        attack_ms / release_ms: the envelope's rise and fall times (ms), (bs,).
        min_frequency_hz / max_frequency_hz: the sweep range (Hz), (bs,);
            the top floored at 1.01 x the bottom.
        q_factor: resonance, (bs,). mix: dry/wet on [0, 1], (bs,).
        eps: unused (the JAX package's signature).
        frame_size / hop: the analysis frames.
        tv_filter_fn: a WOLA filter in place of ``tv_freq_filter``, as
            :func:`phaser`'s.
    """
    bs, _, seq_len = x.shape
    dtype, device = x.dtype, x.device
    sensitivity, attack_ms, release_ms = _params(bs, dtype, device, sensitivity, attack_ms, release_ms)
    f_min, f_max, q_factor, mix = (
        _param(p, bs, dtype, device).reshape(bs, 1) for p in (min_frequency_hz, max_frequency_hz, q_factor, mix))
    f_max = torch.maximum(f_max, 1.01 * f_min)
    level = torch.mean(torch.abs(x), dim=1, keepdim=True)  # (bs, 1, T)
    ln9 = math.log(9.0)
    alpha_a = torch.exp(-ln9 / (sample_rate * (attack_ms / 1e3)))
    alpha_r = torch.exp(-ln9 / (sample_rate * (release_ms / 1e3)))
    # the smoother's first coefficient acts where the level falls: the release
    env = ballistics_smooth(level, alpha_r, alpha_a, mode="parallel")
    idx = np.clip(np.round(tv_frame_centers(seq_len, frame_size, hop)).astype(np.int64), 0, seq_len - 1)
    env_f = torch.index_select(env[:, 0], -1, torch.from_numpy(idx).to(device))  # (bs, n_frames)
    f_c = f_min * (f_max / f_min) ** torch.tanh(sensitivity.reshape(bs, 1) * env_f)
    n_frames = f_c.shape[1]
    n_fft = 4 * frame_size
    b, a = biquad(torch.zeros((bs * n_frames,), dtype=dtype, device=device), f_c.reshape(bs * n_frames),
                  q_factor.expand(bs, n_frames).reshape(bs * n_frames), sample_rate, "band_pass")
    H_bp = fft_freqz(b, a, n_fft).reshape(bs, n_frames, n_fft // 2 + 1)
    H = (1.0 - mix[..., None]) + mix[..., None] * H_bp
    return (tv_filter_fn or tv_freq_filter)(x, H, frame_size, hop).to(dtype)


# ---------------------------------------------------------------------------
# the phase vocoder: time stretch and pitch shift
# ---------------------------------------------------------------------------


def _pv_bin_advance(n_bins: int, hop: int, n_fft: int, device) -> torch.Tensor:
    """``exp(-j w_bin)`` with ``w_bin = 2 pi k hop / n_fft``, each bin's
    expected phase advance over a hop (complex64, as the JAX package's
    constant)."""
    w_bin = np.float32(2.0 * np.pi) * np.arange(n_bins, dtype=np.float32) * np.float32(hop / n_fft)
    return torch.from_numpy(np.exp(-1j * w_bin).astype(np.complex64)).to(device)


def _phase(z: torch.Tensor) -> torch.Tensor:
    """``angle(z)``, with the phase of an exact zero 0: ``atan2`` of signed
    zeros gives 0 or +-pi by the signs an FFT or a product leaves on them,
    and the phase vocoder sums such phases into every later frame."""
    return torch.angle(z + 0.0)


def _pv_phase_ramp(n_out: int, n_bins: int, hop: int, n_fft: int) -> np.ndarray:
    """The expected synthesis-phase ramp ``(j w_bin) mod 2 pi``, exactly, by
    integer arithmetic: ``2 pi ((j k hop) mod n_fft) / n_fft``; (n_out,
    n_bins) float32 numpy."""
    j = np.arange(n_out, dtype=np.int64)[:, None]
    step = (np.arange(n_bins, dtype=np.int64) * hop) % n_fft
    m = (j * step[None, :]) % n_fft
    return (np.float32(2.0 * np.pi / n_fft) * m).astype(np.float32)


def _pv_synthesize(X, mag, dev, seq_len: int, frame_size: int, hop: int) -> torch.Tensor:
    """Output spectra from magnitudes ``mag`` and per-hop phase deviations
    ``dev`` (bs, chs, n_out, n_bins), overlap-added: the phase starts at the
    first analysis frame's, adds the exact expected ramp and the
    accumulated deviations (only the small ones are summed)."""
    n_out, n_bins = mag.shape[-2:]
    ramp = torch.from_numpy(_pv_phase_ramp(n_out, n_bins, hop, 2 * (n_bins - 1))).to(X.device)
    acc = torch.cat([torch.zeros_like(dev[:, :, :1]), torch.cumsum(dev[:, :, :-1], dim=2)], dim=2)
    phase = _phase(X[:, :, :1]) + ramp + acc
    return tv_istft(torch.complex(mag * torch.cos(phase), mag * torch.sin(phase)), seq_len, frame_size, hop)


@_scoped("time_stretch")
def time_stretch(
    x: torch.Tensor,
    sample_rate: float,
    rate,
    frame_size: int = 2048,
    hop: int = 512,
    out_len: int | None = None,
) -> torch.Tensor:
    """Phase-vocoder time stretch: change duration, keep pitch.

    One analysis STFT; output frame j reads the analysis track at ``j *
    rate``: magnitudes linearly interpolated, phases propagated by the
    instantaneous-frequency estimate, each bin's deviation from its
    expected advance accumulated by one cumulative sum; one synthesis iSTFT
    at the same hop. ``rate > 1`` shortens.

    * ``out_len=None``: ``rate`` is a Python float and the output has
      ``round(T / rate)`` samples (constant-index reads).
    * ``out_len=<int>``: the output has ``out_len`` samples and ``rate`` may
      be a (bs,) tensor, differentiable: an interior time warp, read by
      piecewise-linear hat matrices (:func:`_time_stretch_fixed`), the
      last analysis frame held where the warp runs past it.

    The phase vocoder computes in float64 inside (the analysis STFT
    included) and rounds its output once: its phases are sums over frames
    of ``angle`` of bin products, and a small bin's angle moves by its
    rounding over its magnitude, which fp32 carries into every later frame
    (fp32 evaluations differ by up to 5e-4 of the peak, and its
    differentiable rate's gradient by 2e-2 of its norm, at 2 x 2 x 8192).

    Gradients flow to ``x`` (and ``rate`` with ``out_len``). Where an
    analysis bin is exactly 0 (digital silence), the phase's gradient there
    is 0, where the JAX package's is NaN, and the phase of such a bin is 0,
    where the JAX package's is 0 or +-pi by the signs of its zeros
    (ROADMAP.md Queue 3).

    Args:
        x: (bs, chs, T). sample_rate: unused.
        rate: stretch factor > 0.
        frame_size / hop: the analysis frames (n_fft = 2 * frame_size).
        out_len: fixed output length (the differentiable-rate mode).
    """
    if out_len is not None:
        return _time_stretch_fixed(x, rate, frame_size, hop, int(out_len))
    rate = float(rate)
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0, got {rate}")
    seq_len, device = x.shape[-1], x.device
    n_fft, n_bins = 2 * frame_size, frame_size + 1
    X = tv_stft(x.double(), frame_size, hop, n_fft)
    n_frames = X.shape[2]
    out_len = int(round(seq_len / rate))
    n_out = tv_frame_count(out_len, frame_size, hop)
    tau = np.arange(n_out, dtype=np.float64) * rate
    i0 = np.clip(np.floor(tau).astype(np.int64), 0, n_frames - 1)
    i1 = np.minimum(i0 + 1, n_frames - 1)
    frac = torch.from_numpy((tau - np.floor(tau)).astype(np.float32)).to(device)[:, None]
    X0 = torch.index_select(X, 2, torch.from_numpy(i0).to(device))
    X1 = torch.index_select(X, 2, torch.from_numpy(i1).to(device))
    mag = (1.0 - frac) * X0.abs() + frac * X1.abs()
    dphi = _phase(X1 * torch.conj(X0) * _pv_bin_advance(n_bins, hop, n_fft, device))
    return _pv_synthesize(X, mag, dphi, out_len, frame_size, hop).to(x.dtype)


def _time_stretch_fixed(x, rate, frame_size: int, hop: int, out_len: int):
    """The fixed-length, differentiable-rate phase vocoder: the analysis
    positions ``tau_j = clip(j * rate, last frame)`` are tensors, and the
    magnitudes and per-hop phase deviations are interpolated by hat
    matrices ``W[j, i] = relu(1 - |tau_j - i|)``, so gradients reach
    ``rate`` through the weights. It computes in float64 (see
    :func:`time_stretch`), so the two contractions, which the JAX package
    runs at ``Precision.HIGHEST``, are DGEMMs that TF32 never touches."""
    bs, _, seq_len = x.shape
    dtype, device = torch.float64, x.device
    rate_b = _param(rate, bs, dtype, device).reshape(bs, 1)
    n_fft, n_bins = 2 * frame_size, frame_size + 1
    X = tv_stft(x.double(), frame_size, hop, n_fft)
    n_frames = X.shape[2]
    n_out = tv_frame_count(out_len, frame_size, hop)
    tau = torch.clamp(torch.arange(n_out, dtype=dtype, device=device)[None, :] * rate_b, 0.0, n_frames - 1)

    def hat(tau, n):
        return torch.relu(1.0 - torch.abs(tau[:, :, None] - torch.arange(n, dtype=dtype, device=device)))

    mag = torch.einsum("bof,bcfk->bcok", hat(tau, n_frames), X.abs())
    dev = _phase(X[:, :, 1:] * torch.conj(X[:, :, :-1]) * _pv_bin_advance(n_bins, hop, n_fft, device))
    Wd = hat(torch.clamp(tau, 0.0, max(n_frames - 2, 0)), max(n_frames - 1, 1))
    dev_o = torch.einsum("bof,bcfk->bcok", Wd, dev)
    return _pv_synthesize(X, mag, dev_o, out_len, frame_size, hop).to(x.dtype)


def _warp_resample(s: torch.Tensor, r: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linearly interpolated read ``out[b, c, t] = s[b, c, t r_b]``, the
    positions clipped to ``[0, L - 1.001]``; gradients flow to ``s`` and to
    ``r`` (through the fractional part). A gather: the JAX package's tiled
    hat-matrix contractions (``_warp_resample_tiles``) compute the same
    interpolation, shaped for the TPU's matrix unit. The positions are
    computed in float64 (in fp32 ``t r`` is off by up to 0.016 samples at
    2^18, which moves the output and the gradient of ``r``)."""
    bs, chs, L = s.shape
    t = torch.arange(out_len, dtype=torch.float64, device=s.device)
    pos = torch.clamp(t[None, :] * r.reshape(bs, 1).double(), 0.0, L - 1.001)  # (bs, out_len)
    i0 = torch.floor(pos)
    frac = (pos - i0).to(s.dtype)[:, None, :]
    i0 = i0.long()[:, None, :].expand(bs, chs, out_len)
    s0 = torch.gather(s, -1, i0)
    s1 = torch.gather(s, -1, torch.clamp(i0 + 1, max=L - 1))
    return s0 * (1.0 - frac) + s1 * frac


@_scoped("pitch_shift_pv")
def pitch_shift_pv(
    x: torch.Tensor,
    sample_rate: float,
    semitones,
    frame_size: int = 2048,
    hop: int = 512,
    max_semitones: float | None = None,
) -> torch.Tensor:
    """Phase-vocoder pitch shifter: :func:`time_stretch` by ``r =
    2^(semitones / 12)``, then linear resampling back to the input's length.

    * ``max_semitones=None``: ``semitones`` is a Python float (the stretch
      length follows it; constant-index resampling).
    * ``max_semitones=<float>``: ``semitones`` may be a (bs,) tensor up to
      ``max_semitones``, differentiable: the stretch runs in its fixed-length
      mode sized for the bound, and the resampling reads ``t r`` by a
      linearly interpolated gather (:func:`_warp_resample`).

    Args:
        x: (bs, chs, T). sample_rate: unused.
        semitones: the shift (+12 an octave up).
        frame_size / hop: the analysis frames.
        max_semitones: the bound of the differentiable mode.
    """
    bs, _, seq_len = x.shape
    if max_semitones is not None:
        r_max = 2.0 ** (max(float(max_semitones), 0.0) / 12.0)
        L_s = int(math.ceil(seq_len * r_max))
        # the ratio in float64: its fp32 rounding alone moves the read
        # position t r by up to 0.016 samples at 2^18
        r = 2.0 ** (_param(semitones, bs, torch.float64, x.device).reshape(bs) / 12.0)
        stretched = time_stretch(x, sample_rate, 1.0 / r, frame_size, hop, out_len=L_s)
        return _warp_resample(stretched, r, seq_len).to(x.dtype)
    r = 2.0 ** (float(semitones) / 12.0)
    stretched = time_stretch(x, sample_rate, 1.0 / r, frame_size, hop)
    L = stretched.shape[-1]
    ts = np.arange(seq_len, dtype=np.float64) * (L - 1) / max(seq_len - 1, 1)
    j0 = np.clip(np.floor(ts).astype(np.int64), 0, L - 1)
    j1 = np.minimum(j0 + 1, L - 1)
    fr = torch.from_numpy((ts - np.floor(ts)).astype(np.float32)).to(x.device)
    s0 = torch.index_select(stretched, -1, torch.from_numpy(j0).to(x.device))
    s1 = torch.index_select(stretched, -1, torch.from_numpy(j1).to(x.device))
    return ((1.0 - fr) * s0 + fr * s1).to(x.dtype)
