"""FFT sizes shared by the FIR paths.

PyTorch counterpart of the size helpers of ``dasp_tpu/ops/fft_filter.py``.
The frequency-sampling filters of that module are not ported yet (see
ROADMAP.md); the FIR convolutions need the same transform lengths to give
the same numbers, so the two size rules are here.
"""

from __future__ import annotations

__all__ = ["next_pow2", "next_fast_len"]


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
