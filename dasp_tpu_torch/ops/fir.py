"""FFT-based FIR convolution on ``torch.fft``.

PyTorch counterpart of ``dasp_tpu/ops/fir.py`` (``fft_conv_causal`` and
``fft_correlate_valid``). The JAX package's four-step matrix FFT for long
transforms is a workaround for the TPU's FFT and is not ported: cuFFT does
that job. Functions work along the last axis and broadcast over leading
axes.
"""

from __future__ import annotations

import torch

from .fft_filter import next_fast_len

__all__ = ["fft_conv_causal", "fft_correlate_valid"]


def _fft_mul(x: torch.Tensor, h: torch.Tensor, n_fft: int) -> torch.Tensor:
    X = torch.fft.rfft(x, n_fft, dim=-1)
    H = torch.fft.rfft(h, n_fft, dim=-1)
    return torch.fft.irfft(X * H, n_fft, dim=-1)


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
