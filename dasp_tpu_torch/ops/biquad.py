"""Audio-EQ-Cookbook biquad coefficient design, batched.

PyTorch counterpart of ``dasp_tpu/ops/biquad.py``. Pointwise tensor math,
differentiable by autograd, on whatever device the inputs live.
"""

from __future__ import annotations

import math

import torch

__all__ = ["biquad", "one_pole_butter_lowpass", "one_pole_butter_highpass", "one_pole_filter"]

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


def one_pole_butter_lowpass(f_c: torch.Tensor, sample_rate: float):
    """Bilinear-transform design of a one-pole Butterworth lowpass.

    Args:
        f_c: cutoff frequency in Hz, shape (bs,) or (bs, 1).
        sample_rate: audio sample rate (Hz).

    Returns:
        (b, a): coefficients, each (bs, 2), normalized so a0 == 1.
    """
    f_c = f_c.reshape(-1, 1)
    w_c = torch.tan(2.0 * math.pi * (f_c / sample_rate) / 2.0)  # pre-warped analog frequency
    a0 = 1.0 + w_c
    b = torch.cat([w_c, w_c], dim=-1)
    a = torch.cat([a0, w_c - 1.0], dim=-1)
    return b / a0, a / a0


def one_pole_butter_highpass(f_c: torch.Tensor, sample_rate: float):
    """Bilinear-transform design of a one-pole Butterworth highpass,
    H(s) = s / (s + wc): b = [1, -1] / (1 + wc), a = [1, (wc - 1) / (1 + wc)].

    Args and returns as :func:`one_pole_butter_lowpass`.
    """
    f_c = f_c.reshape(-1, 1)
    w_c = torch.tan(2.0 * math.pi * (f_c / sample_rate) / 2.0)
    a0 = 1.0 + w_c
    ones = torch.ones_like(w_c)
    b = torch.cat([ones, -ones], dim=-1)
    a = torch.cat([a0, w_c - 1.0], dim=-1)
    return b / a0, a / a0


def one_pole_filter(cutoff_hz: torch.Tensor, filter_type: str, sample_rate: float = 2.0):
    """A simple one-pole highpass or lowpass.

    Args:
        cutoff_hz: cutoff (0..nyquist), shape (bs,).
        filter_type: "highpass" or "lowpass".
        sample_rate: sample rate of the input signal.

    Returns:
        (b, a): coefficients, each (bs, 2).
    """
    bs = cutoff_hz.shape[0]
    cutoff_hz = cutoff_hz.reshape(bs, 1)
    nyquist = sample_rate // 2
    if filter_type == "highpass":
        a1 = cutoff_hz / nyquist
    elif filter_type == "lowpass":
        a1 = -1.0 + (cutoff_hz / nyquist)
    else:
        raise ValueError(f"Invalid filter_type = {filter_type}.")
    b = torch.cat([1.0 - torch.abs(a1), torch.zeros_like(a1)], dim=1)
    a = torch.cat([torch.ones_like(a1), a1], dim=1)
    return b, a
