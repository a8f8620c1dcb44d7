"""Mastering chain: match a reference master by gradient descent.

A differentiable mastering chain

    transient shaper -> dynamic EQ -> multiband compressor -> exciter
    -> limiter

driven by ONE flat normalized parameter tensor through ``modules.Chain``
(:func:`~dasp_tpu_torch.train.make_mastering`), optimized so that the
processed mix matches a reference master: the same mix rendered through
hidden chain settings ("reverse the mastering"). Each step renders,
differentiates and updates (:func:`~dasp_tpu_torch.train.mastering_step`).

``--sp N`` splits the time axis over N ranks for the dynamic EQ's WOLA
transforms and the loss (the ranks lay out as (ranks / N) dp x N sp; every
dp row runs the same program): the long-audio path for mastering-length
programs. The rest of the chain runs on the whole signal on every rank.

    python -m dasp_tpu_torch.examples.mastering [--steps 300] [--smoke] [--sp N]
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np
import torch

from ..train import make_mastering, mastering_step
from ..utils import synthetic_batch
from ..utils.audio import save_wav
from .common import add_device_flag, add_world_flags, device_of, run_ranks

SR = 44100


def sharded_objective(mesh):
    """examples/mastering.py's loss with the time axis split over the sp
    ranks: the sharded MR-STFT loss of this rank's blocks plus 10 x the MSE,
    whose sum of squares is summed over the ranks."""
    from ..parallel import Sharding, psum, sharded_multi_resolution_stft_loss

    def loss(y, target):
        spec = Sharding(mesh, (None,) * (y.ndim - 1) + ("sp",))
        yb, tb = spec.block(y), spec.block(target)
        mse = psum(torch.sum((yb - tb) ** 2), mesh.group("sp")) / y.numel()
        return sharded_multi_resolution_stft_loss(yb, tb, mesh) + 10.0 * mse

    return loss


def run(args, device, mesh=None) -> dict:
    rank0 = mesh is None or mesh.rank == 0
    bs = 1
    rng = np.random.default_rng(args.seed)
    mix = torch.as_tensor(np.repeat(synthetic_batch(rng, bs, args.length, SR), 2, axis=1), device=device)
    hooks, loss_fn, group = {}, None, None
    if mesh is not None and mesh.shape["sp"] > 1:
        from ..parallel import sharded_tv_freq_filter, sharded_tv_power
        from ..parallel.sharded import whole_signal

        hooks = {"tv_power_fn": whole_signal(partial(sharded_tv_power, mesh=mesh), mesh, gather=False),
                 "tv_filter_fn": whole_signal(partial(sharded_tv_freq_filter, mesh=mesh), mesh)}
        loss_fn, group = sharded_objective(mesh), mesh.group("sp")
    chain, z, opt = make_mastering(SR, bs=bs, device=device, lr=args.lr, **hooks)
    if rank0:
        print(f"mastering chain: {chain.num_params} parameters "
              f"({', '.join(type(p).__name__ for p in chain.processors)})")
    # the reference master: hidden settings, mild deviations from centre
    p_true = torch.as_tensor(np.clip(0.5 + 0.25 * rng.standard_normal((bs, chain.num_params)), 0.05, 0.95)
                             .astype(np.float32), device=device)
    with torch.no_grad():
        target = chain.process_normalized(mix, p_true, clip_params=True)
    losses = []
    for i in range(args.steps):
        loss = float(mastering_step(chain, z, opt, mix, p_true, loss_fn=loss_fn, grad_group=group,
                                    target=target))
        losses.append(loss)
        if rank0 and (i % 50 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {loss:.4f}")
    with torch.no_grad():  # every rank: the chain's hooks are collectives
        y = chain.process_normalized(mix, torch.sigmoid(z), clip_params=True)
    if rank0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        os.makedirs(args.out_dir, exist_ok=True)
        save_wav(os.path.join(args.out_dir, "master.wav"), y[0].cpu().numpy(), SR)
        save_wav(os.path.join(args.out_dir, "target.wav"), target[0].cpu().numpy(), SR)
        save_wav(os.path.join(args.out_dir, "input.wav"), mix[0].cpu().numpy(), SR)
        print(f"wrote {args.out_dir}/master.wav, target.wav, input.wav")
    return {"losses": losses}


def _run_on_mesh(args, device):
    import torch.distributed as dist

    from ..parallel import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh((n // args.sp, args.sp), device=device)
    if mesh.rank == 0:
        print(f"mesh: dp={n // args.sp} sp={args.sp} ({dist.get_backend()}, {device})")
    return run(args, device, mesh)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--length", type=int, default=65536)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", type=str, default="outputs/mastering")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel factor: split the dynamic EQ's WOLA transforms and the "
                         "MR-STFT loss over an (n/sp) dp x sp layout of the ranks")
    args = add_world_flags(add_device_flag(ap)).parse_args(argv)
    if args.smoke:
        args.length, args.steps = 16384, min(args.steps, 50)
    if args.sp > 1:
        return run_ranks(_run_on_mesh, args)
    return run(args, device_of(args))


if __name__ == "__main__":
    main()
