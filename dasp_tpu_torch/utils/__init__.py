"""Utilities: the MR-STFT loss, BS.1770 loudness, presets and synthetic
audio. PyTorch counterpart of the loss, loudness and preset parts of
``dasp_tpu/utils`` and of its ``synthetic_batch``."""

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
from .loudness import integrated_loudness, k_weighting_sos, loudness_normalize
from .presets import load_preset, save_preset

__all__ = [
    "a_weighting",
    "a_weighting_fir_taps",
    "auto_eq_mrstft",
    "fir_prefilter",
    "integrated_loudness",
    "k_weighting_sos",
    "load_preset",
    "loudness_normalize",
    "multi_resolution_stft_loss",
    "save_preset",
    "stft_loss",
    "stft_magnitude",
    "synthetic_batch",
]
