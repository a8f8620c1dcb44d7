"""FFT-based FIR convolution on ``torch.fft``.

PyTorch counterpart of ``dasp_tpu/ops/fir.py`` (``fft_conv_causal`` and
``fft_correlate_valid``, ``fft_conv_full`` and ``ola_conv_causal``). The JAX package's four-step matrix FFT for long
transforms is a workaround for the TPU's FFT and is not ported: cuFFT does
that job. Functions work along the last axis and broadcast over leading
axes.
"""

from __future__ import annotations

import torch

from .fft_filter import next_fast_len, next_pow2

__all__ = ["fft_conv_full", "fft_conv_causal", "fft_correlate_valid", "ola_conv_causal"]


def _fft_mul(x: torch.Tensor, h: torch.Tensor, n_fft: int) -> torch.Tensor:
    X = torch.fft.rfft(x, n_fft, dim=-1)
    H = torch.fft.rfft(h, n_fft, dim=-1)
    return torch.fft.irfft(X * H, n_fft, dim=-1)


def fft_conv_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis, length T + K - 1;
    leading axes broadcast (e.g. x (bs, ch, T) with h (ch, K))."""
    T, K = x.shape[-1], h.shape[-1]
    return _fft_mul(x, h, next_fast_len(T + K - 1))[..., : T + K - 1]


def fft_conv_causal(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal convolution y[n] = sum_k h[k] x[n-k], the first T samples of
    the full convolution (e.g. x (bs, ch, T) with h (bs, ch, K))."""
    T = x.shape[-1]
    n_fft = next_fast_len(T + h.shape[-1] - 1)
    return _fft_mul(x, h, n_fft)[..., :T]


def fft_correlate_valid(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """'Valid' cross-correlation y[n] = sum_k h[k] x[n+k] (conv1d with no
    padding), output length T - K + 1."""
    T, K = x.shape[-1], h.shape[-1]
    n_fft = next_fast_len(T + K - 1)
    # correlation with h == convolution with reversed h
    y = _fft_mul(x, torch.flip(h, dims=(-1,)), n_fft)
    return y[..., K - 1 : T]


def ola_conv_causal(x: torch.Tensor, h: torch.Tensor, block: int | None = None) -> torch.Tensor:
    """Overlap-save causal convolution, with an FFT size bounded whatever T.

    Each block of ``block`` samples is convolved with an FFT of
    next_pow2(block + K - 1), with the K - 1 samples before it as history,
    so memory is O(block + K); a Python loop runs the blocks. Equal to
    :func:`fft_conv_causal` to fp32 rounding.

    Args:
        x: signal (..., T), padded up to a multiple of ``block``.
        h: impulse response (..., K), broadcastable against x.
        block: samples per block (default 2 * next_pow2(K)).

    Returns:
        The causal convolution, shape of x.
    """
    T, K = x.shape[-1], h.shape[-1]
    if block is None:
        block = 2 * next_pow2(K)
    n_fft = next_pow2(block + K - 1)
    xp = torch.nn.functional.pad(x, (0, (-T) % block))
    H = torch.fft.rfft(h, n_fft, dim=-1)
    hist = x.new_zeros((*x.shape[:-1], K - 1))
    outs = []
    for blk in xp.split(block, dim=-1):
        seg = torch.cat([hist, blk], dim=-1)  # (..., K - 1 + block)
        y = torch.fft.irfft(torch.fft.rfft(seg, n_fft, dim=-1) * H, n_fft, dim=-1)
        outs.append(y[..., K - 1 : K - 1 + block])
        # an explicit start: -(K - 1) with K == 1 would keep the whole segment
        hist = seg[..., seg.shape[-1] - (K - 1) :]
    return torch.cat(outs, dim=-1)[..., :T]
