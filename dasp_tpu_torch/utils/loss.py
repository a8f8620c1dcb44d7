"""Frequency-domain audio losses: the multi-resolution STFT loss.

PyTorch counterpart of ``dasp_tpu/utils/loss.py``: spectral convergence
plus log/linear magnitude terms over one or many STFT resolutions, with
optional A-weighted perceptual weighting, as pure functions over
``(batch, channels, samples)`` tensors. The spectra come from
``torch.fft.rfft`` (cuFFT on a GPU) of reflect-padded, Hann-windowed frames.

``auraloss_compat=True`` gives auraloss's exact semantics, as in the JAX
package: the 101-tap A-weighting FIR prefilter, per-item spectral
convergence, the hard magnitude clamp and the (120, 240, 50) default hops.
The JAX package's DFT-matmul spectral path and its CPU-FFT workaround
(``use_dft``, ``cpu_fft_workaround``) are TPU and XLA:CPU workarounds and
are not ported: every spectrum here is an rfft.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

__all__ = [
    "stft_magnitude",
    "stft_loss",
    "multi_resolution_stft_loss",
    "auto_eq_mrstft",
    "a_weighting",
    "a_weighting_fir_taps",
    "fir_prefilter",
]


def _mag_from_power(power: torch.Tensor, eps: float, smooth_floor: bool) -> torch.Tensor:
    """|S| from |S|^2 with a log-safety floor: sqrt(power + eps) with
    ``smooth_floor`` (continuous, so fp-level input differences give fp-level
    gradient differences), else auraloss's hard clamp sqrt(max(power, eps))."""
    if smooth_floor:
        return torch.sqrt(power + eps)
    return torch.sqrt(torch.clamp(power, min=eps))


def _window(fft_size: int, win_length: int, dtype, device) -> torch.Tensor:
    """Periodic Hann of ``win_length``, zero-padded to ``fft_size`` about its
    centre (cast from float64 once, so float64 losses keep full precision)."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    lpad = (fft_size - win_length) // 2
    w = np.pad(w, (lpad, fft_size - win_length - lpad))
    return torch.as_tensor(w, dtype=dtype, device=device)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., T) reflect-padded by ``pad`` on each side of the last axis, as
    ``jnp.pad(mode="reflect")`` / ``np.pad`` pad it: past T - 1 samples the
    reflection repeats (period 2 (T - 1)), where ``nnf.pad`` refuses."""
    lead, T = x.shape[:-1], x.shape[-1]
    if pad < T:
        return nnf.pad(x.reshape(-1, 1, T), (pad, pad), mode="reflect").reshape(*lead, T + 2 * pad)
    period = 2 * (T - 1)
    idx = torch.arange(-pad, T + pad, device=x.device) % period
    idx = torch.where(idx >= T, period - idx, idx)
    return x.index_select(-1, idx)


def stft_magnitude(
    x: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_length: int,
    eps: float = 1e-8,
    smooth_floor: bool = False,
) -> torch.Tensor:
    """Magnitude STFT of (..., T) along the last axis.

    Centre-padded by fft_size // 2 on each side (reflect), periodic Hann
    window of ``win_length`` centred in ``fft_size``, magnitude floored for
    log safety (see :func:`_mag_from_power`). Returns
    (..., n_frames, fft_size // 2 + 1).
    """
    xp = reflect_pad(x, fft_size // 2)
    frames = xp.unfold(-1, fft_size, hop_size)  # (..., n_frames, fft_size)
    frames = frames * _window(fft_size, win_length, x.dtype, x.device)
    spec = torch.fft.rfft(frames, fft_size, dim=-1)
    return _mag_from_power(spec.real**2 + spec.imag**2, eps, smooth_floor)


def a_weighting_fir_taps(sample_rate: float, ntaps: int = 101) -> np.ndarray:
    """A-weighting FIR prefilter taps, designed the way auraloss designs them:
    the IEC 61672 analog A-weighting transfer function through the bilinear
    transform, its response sampled with freqz at 512 points, and a
    linear-phase ``ntaps``-tap FIR least-squares fit to it (host-side scipy,
    cached per (sample_rate, ntaps)). The taps are symmetric."""
    key = (float(sample_rate), int(ntaps))
    if key not in _AW_TAP_CACHE:
        _AW_TAP_CACHE[key] = _a_weighting_fir_taps_impl(*key)
    return _AW_TAP_CACHE[key]


_AW_TAP_CACHE: dict = {}


def _a_weighting_fir_taps_impl(sample_rate: float, ntaps: int) -> np.ndarray:
    import scipy.signal

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    a1000 = 1.9997
    num = [(2 * np.pi * f4) ** 2 * (10 ** (a1000 / 20)), 0, 0, 0, 0]
    den = np.polymul(
        [1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
        [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2],
    )
    den = np.polymul(np.polymul(den, [1, 2 * np.pi * f3]), [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(num, den, fs=sample_rate)
    w_iir, h_iir = scipy.signal.freqz(b, a, worN=512, fs=sample_rate)
    taps = scipy.signal.firls(ntaps, w_iir, abs(h_iir), fs=sample_rate)
    return taps.astype(np.float32)


def fir_prefilter(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """'Same'-padded FIR prefilter of (..., T) along the last axis: torch
    ``conv1d(padding=ntaps // 2)`` (cross-correlation; the A-weighting taps
    are symmetric, so it equals convolution). Runs without TF32: the
    prefiltered signal feeds 1/mag-amplified log-magnitude terms."""
    ntaps = len(taps)
    lhs = x.reshape(-1, 1, x.shape[-1])
    rhs = torch.as_tensor(np.asarray(taps), dtype=x.dtype, device=x.device).reshape(1, 1, ntaps)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = nnf.conv1d(lhs, rhs, padding=ntaps // 2)
    return out.reshape(x.shape)


def a_weighting(freqs_hz: np.ndarray) -> np.ndarray:
    """A-weighting curve (linear amplitude) per frequency (IEC 61672)."""
    f = np.maximum(np.asarray(freqs_hz, dtype=np.float64), 1e-6)
    f2 = f**2
    ra = (12194.0**2 * f2**2) / (
        (f2 + 20.6**2)
        * np.sqrt((f2 + 107.7**2) * (f2 + 737.9**2))
        * (f2 + 12194.0**2)
    )
    a_db = 20.0 * np.log10(ra) + 2.0
    return (10.0 ** (a_db / 20.0)).astype(np.float32)


def stft_loss(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    fft_size: int = 1024,
    hop_size: int = 256,
    win_length: int = 1024,
    w_sc: float = 1.0,
    w_log_mag: float = 1.0,
    w_lin_mag: float = 0.0,
    perceptual_weighting: bool = False,
    sample_rate: Optional[float] = None,
    eps: float = 1e-8,
    auraloss_compat: bool = False,
) -> torch.Tensor:
    """Single-resolution STFT loss (auraloss ``STFTLoss`` defaults).

    loss = w_sc * spectral_convergence + w_log_mag * L1(log|S|)
         + w_lin_mag * L1(|S|)

    ``auraloss_compat=True`` reproduces auraloss exactly: perceptual
    weighting as the time-domain A-weighting FIR prefilter (not per-bin
    magnitude weighting), spectral convergence per item (Frobenius over the
    last two axes, no denominator eps, mean over items) instead of one
    global norm ratio, and the hard magnitude clamp.
    """
    if perceptual_weighting and sample_rate is None:
        raise ValueError("perceptual_weighting requires sample_rate")
    if perceptual_weighting and auraloss_compat:
        taps = a_weighting_fir_taps(sample_rate)
        y_hat = fir_prefilter(y_hat, taps)
        y = fir_prefilter(y, taps)

    smooth = not auraloss_compat
    mag_hat = stft_magnitude(y_hat, fft_size, hop_size, win_length, eps, smooth_floor=smooth)
    mag = stft_magnitude(y, fft_size, hop_size, win_length, eps, smooth_floor=smooth)

    if perceptual_weighting and not auraloss_compat:
        freqs = np.fft.rfftfreq(fft_size, 1.0 / sample_rate)
        w = torch.as_tensor(a_weighting(freqs), dtype=mag.dtype, device=mag.device)
        mag_hat = mag_hat * w
        mag = mag * w

    loss = y.new_zeros(())
    if w_sc:
        if auraloss_compat:
            num = torch.sqrt(torch.sum((mag - mag_hat) ** 2, dim=(-2, -1)))
            den = torch.sqrt(torch.sum(mag**2, dim=(-2, -1)))
            sc = torch.mean(num / den)
        else:
            sc = torch.sqrt(torch.sum((mag - mag_hat) ** 2)) / (torch.sqrt(torch.sum(mag**2)) + eps)
        loss = loss + w_sc * sc
    if w_log_mag:
        loss = loss + w_log_mag * torch.mean(torch.abs(torch.log(mag) - torch.log(mag_hat)))
    if w_lin_mag:
        loss = loss + w_lin_mag * torch.mean(torch.abs(mag - mag_hat))
    return loss


def multi_resolution_stft_loss(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Optional[Sequence[int]] = None,
    win_lengths: Sequence[int] = (600, 1200, 240),
    w_sc: float = 1.0,
    w_log_mag: float = 1.0,
    w_lin_mag: float = 0.0,
    perceptual_weighting: bool = False,
    sample_rate: Optional[float] = None,
    auraloss_compat: bool = False,
) -> torch.Tensor:
    """Multi-resolution STFT loss: the mean of :func:`stft_loss` over the
    resolutions. Default hops are fft/4; ``auraloss_compat=True`` switches
    them to auraloss's (120, 240, 50) and uses auraloss's exact per-term
    semantics (see :func:`stft_loss`)."""
    if hop_sizes is None:
        hop_sizes = (120, 240, 50) if auraloss_compat else tuple(n // 4 for n in fft_sizes)
    total = y.new_zeros(())
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        total = total + stft_loss(
            y_hat, y, n_fft, hop, win,
            w_sc=w_sc, w_log_mag=w_log_mag, w_lin_mag=w_lin_mag,
            perceptual_weighting=perceptual_weighting, sample_rate=sample_rate,
            auraloss_compat=auraloss_compat,
        )
    return total / len(fft_sizes)


# the configuration of the JAX package's auto_eq and virtual_analog examples
auto_eq_mrstft = partial(
    multi_resolution_stft_loss,
    fft_sizes=(128, 256, 512, 1024, 2048, 4096, 8192),
    hop_sizes=(64, 128, 256, 512, 1024, 2048, 4096),
    win_lengths=(128, 256, 512, 1024, 2048, 4096, 8192),
    w_sc=0.0,
    w_log_mag=1.0,
    w_lin_mag=1.0,
    perceptual_weighting=True,
    sample_rate=44100,
)
