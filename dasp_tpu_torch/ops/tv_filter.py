"""Time-varying linear filtering in the frequency domain (WOLA).

PyTorch counterpart of ``dasp_tpu/ops/tv_filter.py``. The signal is cut
into overlapping frames carrying a COLA-normalized periodic Hann window
(``unfold``), each frame is zero-padded to ``n_fft`` and transformed
(``torch.fft``), multiplied by that frame's complex response, transformed
back and overlap-added at ``hop`` (``fold``). With a constant response this
is time-invariant FIR filtering to roundoff; a per-frame response gives a
smoothly interpolated time-varying filter, the WOLA realization of
LFO-modulated and signal-dependent effects (phaser, auto-wah, spectral
gate, dynamic EQ, phase vocoder).

Framing: frames start at ``i * hop - (frame_size - hop)`` (the first ones
hang off the left edge, so every sample gets full window coverage) and the
last frame reaches the final sample. The JAX package's DFT-matmul branch
(``use_dft``, a workaround for the TPU's FFT) is not ported; cuFFT serves.

Everything is differentiable by autograd, into the responses and the
audio.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

__all__ = [
    "tv_frame_count",
    "tv_frame_centers",
    "tv_freq_filter",
    "tv_stft",
    "tv_istft",
    "tv_analysis_window",
]


def tv_analysis_window(frame_size: int, hop: int) -> np.ndarray:
    """The COLA-normalized periodic Hann window :func:`tv_stft` applies
    (float32 numpy). ``sum(w**2)`` is the Parseval normalizer for power
    measurements on the frame spectra."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_size) / frame_size)
    cola = frame_size / (2.0 * hop)
    return (win / cola).astype(np.float32)


def tv_frame_count(seq_len: int, frame_size: int, hop: int) -> int:
    """Number of frames :func:`tv_freq_filter` uses for a length-T signal."""
    return math.ceil((seq_len + frame_size - hop) / hop)


def tv_frame_centers(seq_len: int, frame_size: int, hop: int) -> np.ndarray:
    """Center time (samples, float64 numpy) of each frame, in the input's
    coordinates (frame 0's is negative when ``frame_size > 2 * hop``): where
    a modulation effect samples its LFO or envelope for each frame."""
    n = tv_frame_count(seq_len, frame_size, hop)
    starts = np.arange(n, dtype=np.float64) * hop - (frame_size - hop)
    return starts + frame_size / 2.0


def tv_freq_filter(x: torch.Tensor, H: torch.Tensor, frame_size: int, hop: int) -> torch.Tensor:
    """Apply a per-frame frequency response to overlapping frames of x.

    Args:
        x: input audio, (bs, chs, T).
        H: complex response per frame, (bs, n_frames, n_bins) with
            ``n_bins = n_fft // 2 + 1`` and ``n_frames = tv_frame_count(T,
            frame_size, hop)``; ``n_fft`` must be a multiple of ``hop`` and
            at least ``2 * frame_size`` (room for the response's impulse
            tail).
        frame_size: analysis frame length, a multiple of ``2 * hop``.
        hop: frame hop.

    Returns:
        Filtered audio, (bs, chs, T).
    """
    n_bins = H.shape[-1]
    n_fft = 2 * (n_bins - 1)
    n_frames = tv_frame_count(x.shape[-1], frame_size, hop)
    if H.shape[0] != x.shape[0] or H.shape[1] != n_frames:
        raise ValueError(
            f"H has shape {tuple(H.shape)}; expected ({x.shape[0]}, {n_frames}, n_bins) for "
            f"seq_len={x.shape[-1]}, frame_size={frame_size}, hop={hop}."
        )
    X = tv_stft(x, frame_size, hop, n_fft)
    return tv_istft(X * H[:, None].to(X.dtype), x.shape[-1], frame_size, hop)


def tv_stft(x: torch.Tensor, frame_size: int, hop: int, n_fft: int) -> torch.Tensor:
    """Windowed analysis frames of ``x``, transformed: the first half of
    :func:`tv_freq_filter` (see its framing rules).

    Args:
        x: input audio, (bs, chs, T).
        frame_size: analysis frame length, a multiple of ``2 * hop``.
        hop: frame hop.
        n_fft: FFT size, at least ``2 * frame_size`` and a multiple of
            ``hop``.

    Returns:
        Complex spectra, (bs, chs, n_frames, n_fft // 2 + 1):
        ``tv_istft(tv_stft(x, ...), T, ...) == x`` to roundoff.
    """
    T = x.shape[-1]
    n_frames = tv_frame_count(T, frame_size, hop)
    if frame_size % (2 * hop) != 0:
        raise ValueError(f"frame_size ({frame_size}) must be a multiple of 2*hop ({2 * hop}) for COLA.")
    if n_fft < 2 * frame_size or n_fft % hop != 0:
        raise ValueError(
            f"n_fft ({n_fft}) must be >= 2*frame_size ({2 * frame_size}) and a multiple of hop ({hop})."
        )
    left = frame_size - hop
    pad_right = (n_frames - 1) * hop + frame_size - (T + left)
    frames = nnf.pad(x, (left, pad_right)).unfold(-1, frame_size, hop)  # (bs, chs, n_frames, frame_size)
    window = torch.from_numpy(tv_analysis_window(frame_size, hop)).to(device=x.device, dtype=x.dtype)
    return torch.fft.rfft(frames * window, n_fft, dim=-1)


def tv_istft(Y: torch.Tensor, seq_len: int, frame_size: int, hop: int) -> torch.Tensor:
    """Inverse of :func:`tv_stft`: irFFT and overlap-add at ``hop``, the
    second half of :func:`tv_freq_filter`.

    Args:
        Y: complex spectra, (bs, chs, n_frames, n_bins).
        seq_len: output length T (the analysis input's length).
        frame_size / hop: as passed to :func:`tv_stft`.

    Returns:
        Audio, (bs, chs, T).
    """
    bs, chs, n_frames, n_bins = Y.shape
    n_fft = 2 * (n_bins - 1)
    yf = torch.fft.irfft(Y, n_fft, dim=-1)  # (bs, chs, n_frames, n_fft)
    out_len = (n_frames - 1) * hop + n_fft
    cols = yf.reshape(bs * chs, n_frames, n_fft).transpose(1, 2)  # (rows, n_fft, n_frames)
    y = nnf.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(bs, chs, out_len)
    left = frame_size - hop
    return y[..., left : left + seq_len]
