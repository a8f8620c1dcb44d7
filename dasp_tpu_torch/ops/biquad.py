"""Audio-EQ-Cookbook biquad coefficient design, batched.

PyTorch counterpart of ``dasp_tpu/ops/biquad.py``. Pointwise tensor math,
differentiable by autograd, on whatever device the inputs live.
"""

from __future__ import annotations

import math

import torch

__all__ = ["biquad"]

_BIQUAD_TYPES = (
    "high_shelf", "low_shelf", "peaking", "low_pass", "high_pass", "band_pass"
)


def biquad(
    gain_db: torch.Tensor,
    cutoff_freq: torch.Tensor,
    q_factor: torch.Tensor,
    sample_rate: float,
    filter_type: str = "peaking",
):
    """Design an Audio-EQ-Cookbook biquad (dasp_tpu.ops.biquad.biquad).

    A = 10^(g/40), w0 = 2*pi*f/fs, alpha = sin(w0)/(2Q); coefficients are
    normalized by a0.

    Args:
        gain_db, cutoff_freq, q_factor: shape (bs,) or (bs, ...), flattened
            to (bs, 1).
        sample_rate: audio sample rate (Hz).
        filter_type: "high_shelf", "low_shelf", "peaking", "low_pass",
            "high_pass" or "band_pass".

    Returns:
        (b, a): numerator and denominator coefficients, each (bs, 3).
    """
    bs = gain_db.shape[0]
    gain_db = gain_db.reshape(bs, -1)
    cutoff_freq = cutoff_freq.reshape(bs, -1)
    q_factor = q_factor.reshape(bs, -1)

    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * (cutoff_freq / sample_rate)
    alpha = torch.sin(w0) / (2.0 * q_factor)
    cos_w0 = torch.cos(w0)
    sqrt_A = torch.sqrt(A)

    if filter_type == "high_shelf":
        b0 = A * ((A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cos_w0)
        b2 = A * ((A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = 2 * ((A - 1) - (A + 1) * cos_w0)
        a2 = (A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    elif filter_type == "low_shelf":
        b0 = A * ((A + 1) - (A - 1) * cos_w0 + 2 * sqrt_A * alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cos_w0)
        b2 = A * ((A + 1) - (A - 1) * cos_w0 - 2 * sqrt_A * alpha)
        a0 = (A + 1) + (A - 1) * cos_w0 + 2 * sqrt_A * alpha
        a1 = -2 * ((A - 1) + (A + 1) * cos_w0)
        a2 = (A + 1) + (A - 1) * cos_w0 - 2 * sqrt_A * alpha
    elif filter_type == "peaking":
        b0 = 1 + alpha * A
        b1 = -2 * cos_w0
        b2 = 1 - alpha * A
        a0 = 1 + (alpha / A)
        a1 = -2 * cos_w0
        a2 = 1 - (alpha / A)
    elif filter_type == "low_pass":
        b0 = (1 - cos_w0) / 2
        b1 = 1 - cos_w0
        b2 = (1 - cos_w0) / 2
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    elif filter_type == "high_pass":
        b0 = (1 + cos_w0) / 2
        b1 = -(1 + cos_w0)
        b2 = (1 + cos_w0) / 2
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    elif filter_type == "band_pass":
        # constant 0 dB peak gain (cookbook), scaled by gain_db
        b0 = A * alpha
        b1 = torch.zeros_like(alpha)
        b2 = -A * alpha
        a0 = 1 + alpha
        a1 = -2 * cos_w0
        a2 = 1 - alpha
    else:
        raise ValueError(
            f"Invalid filter_type: {filter_type!r}. Expected one of {_BIQUAD_TYPES}."
        )

    b = torch.stack([b0, b1, b2], dim=1).reshape(bs, -1)
    a = torch.stack([a0, a1, a2], dim=1).reshape(bs, -1)
    # normalize so a0 == 1
    b = b.to(gain_db.dtype) / a0
    a = a.to(gain_db.dtype) / a0
    return b, a
