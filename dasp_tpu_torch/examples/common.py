"""Shared plumbing for the example trainers: flags, data iteration, and the
copy of batches to the device. Every trainer takes argparse flags and falls
back to synthetic audio when no ``--data-dir`` is given."""

from __future__ import annotations

import argparse
from typing import Iterator

import numpy as np
import torch

from ..train import _entry_device
from ..utils.audio import index_wav_dataset, load_clip_batch, synthetic_batch
from ..utils.pipeline import device_prefetch, threaded_iterator


def add_device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; 'cpu' runs on the host)")
    return p


def device_of(args) -> torch.device:
    """The device ``--device`` names, else the CUDA card (raises without one)."""
    return _entry_device(args.device)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory of wav files; omit to train on synthetic audio")
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--steps", type=int, default=1000, help="total optimization steps")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--length", type=int, default=131072, help="clip length in samples")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--sample-rate", type=int, default=44100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes / shallow nets for a fast functional check")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--resume", action="store_true", help="resume from the last checkpoint")
    p.add_argument("--filter-method", default="fsm",
                   choices=["fsm", "exact", "pallas", "block", "coupled"],
                   help="IIR evaluation for EQ-based effects: 'fsm' = reference "
                        "parity (frequency sampling); 'pallas' = the biquad-cascade "
                        "CUDA kernel; 'exact', 'block', 'coupled' = the plain "
                        "PyTorch filters")
    p.add_argument("--auraloss-compat", action="store_true",
                   help="auraloss loss semantics (hops 120/240/50 defaults, "
                        "per-item spectral convergence, time-domain A-weighting "
                        "FIR prefilter) instead of the default loss")
    p.add_argument("--smoother", default=None,
                   choices=["fsm", "parallel", "attack_only", "pallas", "block",
                            "exact_pallas"],
                   help="envelope smoother for dynamics effects: 'fsm' = reference "
                        "parity (attack-only); 'parallel' / 'exact_pallas' = true "
                        "attack/release ballistics ('exact_pallas' on the ballistics "
                        "CUDA kernel). Default: the processor's own default ('fsm' "
                        "for the compressor, 'parallel' for the expander)")
    return add_device_flag(p)


def _batches(args, channels: int, seed: int, examples=None) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    if examples is not None:
        while True:
            idx = rng.choice(len(examples), size=args.batch_size, replace=True)
            # pooled native loader: one contiguous buffer, range reads, C++
            # threads (Python fallback inside); mono files repeat to fill a
            # stereo request
            yield load_clip_batch([examples[i] for i in idx], args.length,
                                  channels=channels, mono_mix=(channels == 1),
                                  pad_mode="repeat")
    else:
        while True:
            b = synthetic_batch(rng, args.batch_size, args.length, args.sample_rate)
            if channels > 1:
                b = np.repeat(b, channels, axis=1)
            yield b


def batch_iterator(args, channels: int = 1, prefetch: int = 4,
                   num_workers: int = 2) -> Iterator[np.ndarray]:
    """Yield (batch, channels, length) float32 numpy batches forever,
    produced by ``num_workers`` background threads up to ``prefetch``
    batches ahead (see :func:`~dasp_tpu_torch.utils.threaded_iterator`)."""
    examples = None
    if args.data_dir:
        examples = index_wav_dataset(args.data_dir, args.length)
        if not examples:
            raise SystemExit(f"no usable wav chunks of length {args.length} in {args.data_dir}")
        print(f"dataset: {len(examples)} chunks from {args.data_dir}")

    return threaded_iterator(
        lambda wid: _batches(args, channels, args.seed + 7919 * wid, examples),
        num_workers=num_workers, prefetch=prefetch,
    )


def device_batches(args, channels: int = 1, prefetch: int = 4,
                   num_workers: int = 2, depth: int = 2,
                   wire: str = "i16") -> Iterator[torch.Tensor]:
    """:func:`batch_iterator` plus staged copies to ``--device``.

    Batches travel over the int16 wire by default: half the fp32 bytes on
    the host-to-device link, and bit-exact for clips read from 16-bit wav
    files (:func:`~dasp_tpu_torch.utils.wire_encode`), with ``depth`` copies
    in flight (:func:`~dasp_tpu_torch.utils.device_prefetch`). Yields
    float32 batches on the device."""
    return device_prefetch(
        batch_iterator(args, channels=channels, prefetch=prefetch, num_workers=num_workers),
        size=depth, device=device_of(args), wire=wire)
