"""FFT sizes and frequency-sampling-method (FSM) filters.

PyTorch counterpart of ``dasp_tpu/ops/fft_filter.py``. The FSM approximates
an IIR filter by sampling its rational transfer function on the rFFT grid of
an FFT of ``next_pow2(2 T - 1)`` points and applying it as a long FIR filter
in the frequency domain (cuFFT on the card, pocketfft on the CPU). It is the
reference's parity path and the default of ``parametric_eq`` and
``compressor`` in both packages. The JAX package computes it in XLA outside
any Pallas kernel, so here it stays ``torch.fft`` and has no kernel.

Shapes and FFT sizes are the JAX functions', so the two compare sample for
sample: the sections of a cascade are transformed in one batched rFFT and
multiplied together, and a response ``H`` of shape (bs, bins) is reshaped to
broadcast over the middle axes of ``x`` (bs, ..., T).
"""

from __future__ import annotations

import torch

__all__ = [
    "next_pow2",
    "next_fast_len",
    "fsm_fft_size",
    "fft_freqz",
    "fft_sosfreqz",
    "freqdomain_fir",
    "lfilter_via_fsm",
    "sosfilt_via_fsm",
    "fsm_onepole_step_response",
]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def next_fast_len(n: int) -> int:
    """Smallest 2^k or 3*2^k >= n (the JAX package's FFT length rule)."""
    n = int(n)
    p2 = next_pow2(n)
    p3 = 3 * next_pow2(-(-n // 3))
    return min(p2, p3) if p3 >= n else p2


def fsm_fft_size(seq_len: int) -> int:
    """FFT size of the FSM: 2**ceil(log2(2*T - 1)), the reference's."""
    return next_pow2(2 * int(seq_len) - 1)


def fft_freqz(b: torch.Tensor, a: torch.Tensor, n_fft: int = 512) -> torch.Tensor:
    """Complex response rfft(b) / rfft(a) of a rational filter: (..., N)
    coefficients in, (..., n_fft // 2 + 1) out."""
    return torch.fft.rfft(b, n_fft, dim=-1) / torch.fft.rfft(a, n_fft, dim=-1)


def fft_sosfreqz(sos: torch.Tensor, n_fft: int = 512) -> torch.Tensor:
    """Overall response of a (bs, n_sections, 6) cascade laid out as
    [b0, b1, b2, a0, a1, a2]: one batched rFFT per coefficient half and a
    product over the sections. Returns (bs, n_fft // 2 + 1), complex."""
    if sos.shape[-1] != 6:
        raise ValueError(f"second-order sections must have 6 coefficients, got {sos.shape[-1]}")
    return torch.prod(fft_freqz(sos[..., :3], sos[..., 3:], n_fft), dim=-2)


def freqdomain_fir(x: torch.Tensor, H: torch.Tensor, n_fft: int) -> torch.Tensor:
    """irfft(rfft(x) * H) over the last axis, n_fft points."""
    X = torch.fft.rfft(x, n_fft, dim=-1)
    return torch.fft.irfft(X * H.to(X.dtype), n_fft, dim=-1)


def _apply_response(x: torch.Tensor, H: torch.Tensor, n_fft: int) -> torch.Tensor:
    """H (bs, bins) broadcast over x's middle axes, cropped to x's length."""
    H = H.reshape(H.shape[0], *([1] * (x.ndim - 2)), H.shape[-1])
    return freqdomain_fir(x, H, n_fft)[..., : x.shape[-1]]


def lfilter_via_fsm(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor | None = None) -> torch.Tensor:
    """An IIR filter by the frequency-sampling method, along x's last axis.

    Args:
        x: (bs, ..., T).
        b: numerator coefficients, (bs, N).
        a: denominator coefficients, (bs, N), or None for a pure FIR
            (the numerator's spectrum is used directly).

    Returns:
        The filtered signal, shaped like ``x``.
    """
    n_fft = fsm_fft_size(x.shape[-1])
    b = b.to(x.dtype)
    if a is None:
        H = torch.fft.rfft(b, n_fft, dim=-1)
    else:
        H = fft_freqz(b, a.to(x.dtype), n_fft)
    return _apply_response(x, H, n_fft)


def sosfilt_via_fsm(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A biquad cascade (bs, n_sections, 6) by the frequency-sampling
    method, along the last axis of x (bs, ..., T)."""
    n_fft = fsm_fft_size(x.shape[-1])
    return _apply_response(x, fft_sosfreqz(sos.to(x.dtype), n_fft), n_fft)


def fsm_onepole_step_response(alpha: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Exact FSM response of the one-pole b = [1 - a, 0], a = [1, -a] to a
    block of T ones followed by N - T zeros (N the FSM size for T).

    Frequency sampling is circular convolution with the time-aliased impulse
    response h[n] = (1 - a) a^n / (1 - a^N), so the output has the closed
    form

        y[n] = (1 - a^(n+1) + a^(N-T+1+n) - a^N) / (1 - a^N),  n in [0, T).

    The compressor's FSM smoother filters ``g_c - mean`` through the FFT and
    adds ``mean * step`` back: the same in exact arithmetic, without the
    fp32 rounding of a large DC term through the big FFT.

    Args:
        alpha: the coefficient, any shape with a trailing axis that
            broadcasts against time, e.g. (bs, 1, 1).
        seq_len: T.

    Returns:
        ``alpha.shape[:-1] + (seq_len,)``.
    """
    n_fft = fsm_fft_size(seq_len)
    n = torch.arange(seq_len, dtype=alpha.dtype, device=alpha.device)
    a_n1 = alpha ** (n + 1.0)
    a_tail = alpha ** (n_fft - seq_len + 1.0 + n)
    a_N = alpha ** float(n_fft)
    return (1.0 - a_n1 + a_tail - a_N) / (1.0 - a_N)
