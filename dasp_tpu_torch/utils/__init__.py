"""Utilities: the MR-STFT loss and synthetic audio. PyTorch counterpart of
the loss part of ``dasp_tpu/utils`` and of its ``synthetic_batch``."""

from .audio import synthetic_batch
from .loss import (
    a_weighting,
    a_weighting_fir_taps,
    auto_eq_mrstft,
    fir_prefilter,
    multi_resolution_stft_loss,
    stft_loss,
    stft_magnitude,
)

__all__ = [
    "a_weighting",
    "a_weighting_fir_taps",
    "auto_eq_mrstft",
    "fir_prefilter",
    "multi_resolution_stft_loss",
    "stft_loss",
    "stft_magnitude",
    "synthetic_batch",
]
