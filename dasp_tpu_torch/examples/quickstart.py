"""Quickstart: reverse-engineer an effect parameter by gradient descent.

A distortion is applied with an unknown drive; Adam recovers the drive by
minimizing the MSE *through the effect*.

    python -m dasp_tpu_torch.examples.quickstart [--wav input.wav] [--drive-db 16]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import functional as F
from ..utils.audio import load_wav, save_wav, synthetic_batch
from .common import add_device_flag, device_of


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--wav", type=str, default=None, help="input wav (default: synthetic pluck)")
    p.add_argument("--drive-db", type=float, default=16.0, help="true drive to recover")
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--out-dir", type=str, default="outputs/quickstart")
    args = add_device_flag(p).parse_args(argv)
    device = device_of(args)

    sample_rate = 44100
    if args.wav:
        audio, sample_rate = load_wav(args.wav)
        x = torch.as_tensor(audio[None, :1, :], device=device)  # (1, 1, T)
    else:
        x = torch.as_tensor(synthetic_batch(np.random.default_rng(0), 1, 65536, sample_rate), device=device)

    # render the target with the "unknown" drive
    target = F.distortion(x, sample_rate, torch.tensor([args.drive_db], device=device))

    def loss_fn(drive):
        return torch.mean((F.distortion(x, sample_rate, drive) - target) ** 2)

    drive = torch.zeros(1, device=device, requires_grad=True)
    opt = torch.optim.Adam([drive], lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.no_grad():
        loss0 = float(loss_fn(drive))

    t0 = time.time()
    for it in range(args.iters):
        opt.zero_grad(set_to_none=True)
        loss_fn(drive).backward()
        opt.step()
        if it % 250 == 0 or it == args.iters - 1:
            with torch.no_grad():
                print(f"iter {it:5d}  loss {float(loss_fn(drive)):.3e}  drive {float(drive.detach()[0]):7.3f} dB")

    with torch.no_grad():
        loss = float(loss_fn(drive))
        y = F.distortion(x, sample_rate, drive)
    print(f"recovered drive: {float(drive.detach()[0]):.3f} dB (true {args.drive_db}) "
          f"in {time.time() - t0:.1f}s")

    os.makedirs(args.out_dir, exist_ok=True)
    save_wav(os.path.join(args.out_dir, "recovered.wav"), y[0].cpu().numpy(), sample_rate)
    save_wav(os.path.join(args.out_dir, "target.wav"), target[0].cpu().numpy(), sample_rate)
    return {"drive": float(drive.detach()[0]), "loss0": loss0, "loss": loss}


if __name__ == "__main__":
    main()
