"""Shared plumbing for the example trainers: flags, data iteration, and the
copy of batches to the device. Every trainer takes argparse flags and falls
back to synthetic audio when no ``--data-dir`` is given."""

from __future__ import annotations

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from ..functional import _entry_device
from ..utils.audio import index_wav_dataset, load_clip_batch, synthetic_batch
from ..utils.pipeline import device_prefetch


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


def _batch(args, channels: int, examples, i: int) -> np.ndarray:
    """Batch ``i`` of the stream, from the generator seeded (--seed, i)."""
    rng = np.random.default_rng((args.seed, i))
    if examples is not None:
        idx = rng.choice(len(examples), size=args.batch_size, replace=True)
        # pooled native loader: one contiguous buffer, range reads, C++
        # threads (Python fallback inside); mono files repeat to fill a
        # stereo request
        return load_clip_batch([examples[j] for j in idx], args.length,
                               channels=channels, mono_mix=(channels == 1), pad_mode="repeat")
    b = synthetic_batch(rng, args.batch_size, args.length, args.sample_rate)
    return np.repeat(b, channels, axis=1) if channels > 1 else b


def _in_order(make: Callable[[int], np.ndarray], num_workers: int, prefetch: int) -> Iterator[np.ndarray]:
    """make(0), make(1), ... on ``num_workers`` threads, up to ``prefetch``
    ahead of the consumer, yielded in that order; an exception of ``make``
    is raised at the consumer."""
    pool = ThreadPoolExecutor(num_workers)
    try:
        pending = deque(pool.submit(make, i) for i in range(prefetch))
        i = prefetch
        while True:
            b = pending.popleft().result()
            pending.append(pool.submit(make, i))
            i += 1
            yield b
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def batch_iterator(args, channels: int = 1, prefetch: int = 4,
                   num_workers: int = 2) -> Iterator[np.ndarray]:
    """Yield (batch, channels, length) float32 numpy batches forever,
    produced by ``num_workers`` background threads up to ``prefetch``
    batches ahead. Batch i comes from the generator seeded (--seed, i) and
    they come out in order, so one seed gives one stream whatever the
    number of threads: every run, and every rank of a multi-rank run,
    draws the same batches."""
    examples = None
    if args.data_dir:
        examples = index_wav_dataset(args.data_dir, args.length)
        if not examples:
            raise SystemExit(f"no usable wav chunks of length {args.length} in {args.data_dir}")
        print(f"dataset: {len(examples)} chunks from {args.data_dir}")
    return _in_order(partial(_batch, args, channels, examples), num_workers, max(1, prefetch))


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


# ---------------------------------------------------------------------------
# multi-rank runs (--dp / --sp)


def add_world_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start when not under torchrun (default: one per visible CUDA card; "
                        "1 on the CPU)")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default: nccl on the card, gloo on the CPU; several "
                        "ranks on one card need gloo)")
    return p


def _backend(args) -> str:
    if args.backend:
        return args.backend
    return "gloo" if (args.device or "cuda").startswith("cpu") else "nccl"


def _rank_device(args, rank: int) -> torch.device:
    device = device_of(args)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _example_rank(rank: int, fn: Callable, args):
    device = _rank_device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return fn(args, device)


def run_ranks(fn: Callable, args):
    """``fn(args, device)`` on every rank of a ``torch.distributed`` world,
    returning rank 0's result. Under torchrun the world is torchrun's (its
    environment names rank and size). Otherwise this starts ``--ranks``
    ranks (default: one per visible CUDA card, as the JAX examples take
    ``jax.devices()``; 1 on the CPU) by :func:`~dasp_tpu_torch.parallel.spawn`:
    a world of one runs in this process, a larger one in spawned processes.
    ``fn`` lays the world out with ``parallel.make_mesh``."""
    import torch.distributed as dist

    from ..parallel import spawn

    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(args))
        try:
            device = device_of(args)
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
                torch.cuda.set_device(device)
            return fn(args, device)
        finally:
            dist.destroy_process_group()
    n = args.ranks
    if n is None:
        n = torch.cuda.device_count() if device_of(args).type == "cuda" else 1
    return spawn(n, _example_rank, (fn, args), backend=_backend(args))[0]
