"""ITU-R BS.1770-4 loudness: differentiable LUFS metering and normalization.

PyTorch counterpart of ``dasp_tpu/utils/loudness.py``. The K-weighting
prefilter is the standard's two-biquad cascade (the Audio-EQ-Cookbook
forms of pyloudnorm's default "K-weighting" class: a +4 dB high shelf at
1500 Hz, Q 0.7071, then a high-pass at 38 Hz, Q 0.5), run through any of
the port's filter methods (``functional._apply_sos``: ``"pallas"`` is the
biquad-cascade kernel on a CUDA tensor). The 400 ms / 75 %-overlap blocks
come from one cumulative sum of the squared signal (each block's mean
square a difference of two of its entries), and the two gates (absolute
-70 LUFS, relative -10 LU) are masked means, so gradients flow through the
blocks that pass them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import functional as F
from ..ops.biquad import biquad

__all__ = ["k_weighting_sos", "integrated_loudness", "loudness_normalize"]

# the cookbook forms' parameters (not the DeMan analog-prototype constants,
# which belong to another parameterization)
_SHELF_G_DB = 4.0
_SHELF_Q = 1.0 / math.sqrt(2.0)
_SHELF_FC = 1500.0
_HP_Q = 0.5
_HP_FC = 38.0

# channel weights: L, R, C, Ls, Rs (BS.1770 Table 3)
_CH_WEIGHTS = np.asarray([1.0, 1.0, 1.0, 1.41, 1.41], np.float32)


def k_weighting_sos(bs: int, dtype, sample_rate: float, device=None) -> torch.Tensor:
    """The K-weighting prefilter as (bs, 2, 6) a0-normalized sections."""

    def full(v):
        return torch.full((bs,), v, dtype=dtype, device=device)

    b1, a1 = biquad(full(_SHELF_G_DB), full(_SHELF_FC), full(_SHELF_Q), sample_rate, "high_shelf")
    b2, a2 = biquad(full(0.0), full(_HP_FC), full(_HP_Q), sample_rate, "high_pass")
    return torch.stack([torch.cat([b1, a1], -1), torch.cat([b2, a2], -1)], dim=1)


def integrated_loudness(
    x: torch.Tensor,
    sample_rate: float,
    filter_method: str = "coupled",
    eps: float = 1e-10,
) -> torch.Tensor:
    """Integrated (gated) loudness in LUFS, shape (bs,).

    A 0 dBFS 997 Hz sine reads -3.01 LUFS; ``L(g x) = L(x) + 20 log10(g)``
    above the gates; appended silence leaves the reading alone (the -70
    LUFS gate drops its blocks).

    Args:
        x: audio, (bs, chs, T), chs <= 5 in L/R/C/Ls/Rs order.
        sample_rate: audio sample rate (Hz).
        filter_method: the K-weighting's method, "coupled" (the default),
            "pallas", "block", "exact" or "fsm" (see
            :func:`~dasp_tpu_torch.functional.parametric_eq`).
        eps: the log's floor.
    """
    bs, chs, T = x.shape
    if chs > 5:
        raise ValueError(f"BS.1770 defines weights for <= 5 channels, got {chs}.")
    dtype, device = x.dtype, x.device
    y = F._apply_sos(k_weighting_sos(bs, dtype, sample_rate, device=device), x, filter_method)

    # 400 ms blocks at 75 % overlap from one cumulative sum of y^2
    block = min(int(round(0.4 * sample_rate)), T)
    hop = max(int(round(0.1 * sample_rate)), 1)
    n_blocks = max((T - block) // hop + 1, 1)
    cs = torch.cumsum(torch.square(y), dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    starts = torch.from_numpy(np.arange(n_blocks, dtype=np.int64) * hop).to(device)
    z = (cs[..., starts + block] - cs[..., starts]) / block  # (bs, chs, n_blocks)
    w = torch.from_numpy(_CH_WEIGHTS[:chs]).to(device=device, dtype=dtype)
    zw = torch.sum(z * w[:, None], dim=1)  # the weighted sum over channels
    l_blocks = -0.691 + 10.0 * torch.log10(torch.clamp(zw, min=eps))

    # the absolute gate at -70 LUFS
    m1 = (l_blocks > -70.0).to(dtype)
    z1 = torch.sum(zw * m1, -1) / torch.clamp(torch.sum(m1, -1), min=1.0)
    # the relative gate 10 LU below the first stage's loudness
    rel = -0.691 + 10.0 * torch.log10(torch.clamp(z1, min=eps)) - 10.0
    m2 = m1 * (l_blocks > rel[:, None]).to(dtype)
    z2 = torch.sum(zw * m2, -1) / torch.clamp(torch.sum(m2, -1), min=1.0)
    return -0.691 + 10.0 * torch.log10(torch.clamp(z2, min=eps))


def loudness_normalize(
    x: torch.Tensor,
    sample_rate: float,
    target_lufs,
    filter_method: str = "coupled",
) -> torch.Tensor:
    """Gain ``x`` (bs, chs, T) so that its integrated loudness is
    ``target_lufs`` ((bs,) or a scalar). Differentiable in both: the
    measurement is inside the graph."""
    bs = x.shape[0]
    target = torch.broadcast_to(torch.as_tensor(target_lufs, dtype=x.dtype, device=x.device), (bs,))
    gain_db = target - integrated_loudness(x, sample_rate, filter_method=filter_method)
    return x * (10.0 ** (gain_db / 20.0))[:, None, None]
