"""Demo: a fixed-parameter mastering chain rendered on the card.

EQ -> compressor -> distortion -> EQ -> reverb on a guitar-like pluck, the
reverb's noise drawn from a seeded ``torch.Generator`` (the JAX package's
demo takes a PRNG key).

    python -m dasp_tpu_torch.examples.demo [--wav input.wav]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import functional as F
from ..utils.audio import load_wav, save_wav, synthetic_batch
from .common import add_device_flag, device_of


def render(x, sample_rate, generator=None, noise=None):
    """The chain on ``x`` (bs, 1, T); the reverb's noise from ``generator``,
    or the pre-drawn ``noise`` (bs * 2, 12, 65536 + 1022)."""
    bs = x.shape[0]
    f = lambda v: torch.full((bs,), v, dtype=x.dtype, device=x.device)  # noqa: E731

    # bass cut + presence EQ
    x = F.parametric_eq(
        x, sample_rate,
        f(-8.0), f(100.0), f(0.9),       # low shelf down
        f(2.0), f(400.0), f(1.2),        # low-mid bump
        f(3.0), f(2500.0), f(1.5),       # presence
        f(-2.0), f(9000.0), f(1.0),
        f(1.0), f(14000.0), f(0.8),
        f(4.0), f(8000.0), f(0.7),       # high shelf up
    )
    # glue compression
    x = F.compressor(
        x, sample_rate,
        threshold_db=f(-24.0), ratio=f(4.0), attack_ms=f(10.0),
        release_ms=f(80.0), knee_db=f(6.0), makeup_gain_db=f(4.0),
    )
    # drive
    x = F.distortion(x, sample_rate, f(10.0))
    # post-drive tone shaping
    x = F.parametric_eq(
        x, sample_rate,
        f(2.0), f(120.0), f(0.7),
        f(-3.0), f(700.0), f(1.0),
        f(2.0), f(3000.0), f(1.5),
        f(0.0), f(9000.0), f(1.0),
        f(0.0), f(13000.0), f(1.0),
        f(-4.0), f(9000.0), f(0.7),
    )
    # space
    gains = [f(v) for v in (0.9, 0.9, 0.8, 0.8, 0.7, 0.7, 0.6, 0.6, 0.5, 0.5, 0.4, 0.4)]
    decays = [f(v) for v in (0.2, 0.25, 0.3, 0.35, 0.4, 0.45, 0.5, 0.5, 0.45, 0.4, 0.35, 0.3)]
    return F.noise_shaped_reverberation(x, sample_rate, *gains, *decays, f(0.25),
                                        generator=generator, noise=noise)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--wav", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="outputs/demo")
    args = add_device_flag(p).parse_args(argv)
    device = device_of(args)

    sample_rate = 44100
    if args.wav:
        audio, sample_rate = load_wav(args.wav)
        x = torch.as_tensor(audio[None, :1, :], device=device)
    else:
        x = torch.as_tensor(
            synthetic_batch(np.random.default_rng(0), 1, 131072, sample_rate, kind="pluck"), device=device)

    with torch.no_grad():
        y = render(x, sample_rate, torch.Generator(device=device).manual_seed(0))
    y = y[0].cpu().numpy()
    y = 0.9 * y / (np.abs(y).max() + 1e-9)

    os.makedirs(args.out_dir, exist_ok=True)
    save_wav(os.path.join(args.out_dir, "dry.wav"), x[0].cpu().numpy(), sample_rate)
    save_wav(os.path.join(args.out_dir, "wet.wav"), y, sample_rate)
    print(f"wrote {args.out_dir}/dry.wav and wet.wav ({y.shape[-1]} samples, "
          f"{y.shape[0]} channels) on {device}")
    return {"wet": y}


if __name__ == "__main__":
    main()
