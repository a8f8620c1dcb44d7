"""Utilities: losses, audio I/O, the input pipeline, loudness, presets,
metrics and checkpoints, debug checks and dataset acquisition. PyTorch
counterpart of ``dasp_tpu/utils``, with the same 40 names."""

from .loss import (
    a_weighting,
    a_weighting_fir_taps,
    auto_eq_mrstft,
    fir_prefilter,
    multi_resolution_stft_loss,
    stft_loss,
    stft_magnitude,
)
from .audio import (
    index_wav_dataset,
    load_clip,
    load_clip_batch,
    load_wav,
    save_wav,
    synthetic_batch,
)
from .loudness import integrated_loudness, k_weighting_sos, loudness_normalize
from .logging import MetricsLogger, load_checkpoint, save_checkpoint
from .debug import assert_finite, assert_normalized, checked
from .pipeline import (BatchPacker, device_prefetch, reservoir_put,
                       reservoir_sample, threaded_iterator, wire_decode,
                       wire_encode, wire_i16_parts)
from .presets import load_preset, save_preset
from .datasets import (DATASETS, DatasetSpec, DownloadError, acquire,
                       extract_zip, fetch, sha256_file)
from .datasets import verify as verify_dataset

__all__ = [
    "a_weighting",
    "a_weighting_fir_taps",
    "auto_eq_mrstft",
    "fir_prefilter",
    "multi_resolution_stft_loss",
    "stft_loss",
    "stft_magnitude",
    "index_wav_dataset",
    "load_clip",
    "load_clip_batch",
    "load_preset",
    "save_preset",
    "load_wav",
    "save_wav",
    "synthetic_batch",
    "integrated_loudness",
    "k_weighting_sos",
    "loudness_normalize",
    "MetricsLogger",
    "load_checkpoint",
    "save_checkpoint",
    "assert_finite",
    "assert_normalized",
    "checked",
    "BatchPacker",
    "device_prefetch",
    "reservoir_put",
    "reservoir_sample",
    "threaded_iterator",
    "wire_decode",
    "wire_encode",
    "wire_i16_parts",
    "DATASETS",
    "DatasetSpec",
    "DownloadError",
    "acquire",
    "extract_zip",
    "fetch",
    "sha256_file",
    "verify_dataset",
]
