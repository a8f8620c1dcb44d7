"""Self-supervised audio production style transfer.

Corrupt the input with a randomly parameterized EQ -> compressor -> reverb
chain to make a "reference" recording, split input and reference into A/B
halves, let a shared TCN encoder and four projectors predict the chain's
parameters from (input A, reference B), render input A through the chain,
and match reference A with a multi-resolution STFT loss; Adam with a
cosine-decayed step. One step (:func:`make_step`) covers the corruption,
two encoder passes, the four projectors, the four-effect render, the loss,
the backward and the update.

Multi-rank: ``--dp`` splits the batch over the ranks (data parallelism),
``--sp N`` splits the time axis over N ranks (sequence parallelism; the
ranks lay out as (ranks / N) dp x N sp). Under sp the EQ runs the exact
coupled cascade sharded, the reverb's IR convolution takes a halo from its
left neighbour, the compressor's smoother runs its sequence-sharded form
and the loss shares its frames out. The world is torchrun's where its
environment says so; otherwise this starts one rank per visible card
(``--ranks`` to choose; ``--backend gloo`` for several ranks on one card
or on the CPU).

    python -m dasp_tpu_torch.examples.style_transfer [--data-dir wavs/] [--steps N] [--smoke] [--dp] [--sp N]
"""

from __future__ import annotations

import copy
import math
import os
import sys
from functools import partial

import numpy as np
import torch

from ..models import StyleTransferNet, apply_style_chain, make_style_processors
from ..models.tcn import sync_batch_norm
from ..utils import MetricsLogger, load_checkpoint, multi_resolution_stft_loss, save_checkpoint
from .common import add_world_flags, base_parser, device_batches, device_of, run_ranks

# the single-card --smoother and its sequence-sharded equivalent: the
# attack-only one-poles ("fsm" samples it in frequency, "pallas" and "block"
# evaluate it exactly) become the sharded one-pole
SP_SMOOTHER = {"exact_pallas": "exact_pallas", "exact": "exact", "parallel": "parallel",
               "attack_only": "attack_only", "fsm": "attack_only", "pallas": "attack_only",
               "block": "attack_only"}


def build(args, mesh=None, device=None):
    """The processors and the net (train mode, on ``device``). Under a mesh
    with sp > 1 the EQ, the reverb's convolution and the compressor's
    smoother are the sequence-sharded functions bound to it."""
    from ..parallel import sharded_ballistics_smooth, sharded_fft_conv_causal, sharded_sosfilt_coupled

    smoother = args.smoother or "fsm"
    kw = dict(eq_filter_method=args.filter_method, compressor_smoother=smoother)
    ir_conv = None
    if mesh is not None and mesh.shape["sp"] > 1:
        mode = SP_SMOOTHER[smoother]
        if smoother == "fsm" and mesh.rank == 0:
            print("sp: the compressor's frequency-sampled one-pole ('fsm') becomes the time-domain one "
                  "(sequence-sharded 'attack_only')")
        ir_conv = partial(sharded_fft_conv_causal, mesh=mesh)
        kw["eq_filter_method"] = partial(sharded_sosfilt_coupled, mesh=mesh)
        kw["compressor_smoother"] = partial(sharded_ballistics_smooth, mesh=mesh, mode=mode)
    processors = make_style_processors(args.sample_rate, reverb_num_samples=2048 if args.smoke else 65536,
                                       reverb_ir_conv_fn=ir_conv, **kw)
    torch.manual_seed(args.seed)
    net = StyleTransferNet(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4)) if args.smoke else StyleTransferNet()
    net = net.to(device).train()
    if mesh is not None:
        from ..parallel import replicate

        replicate(net, mesh)  # every rank starts from rank 0's weights
        sync_batch_norm(net, mesh.group("dp"))
    return processors, net


def make_optimizer(args, net):
    """Adam at ``--lr`` (optax.adam's defaults) whose step decays by a cosine
    over ``--steps`` (optax.cosine_decay_schedule(1.0, steps), applied to
    the update)."""
    opt = torch.optim.Adam(net.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    steps = max(1, args.steps)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps)))
    return opt, sched


def random_corruption(nprng, bs, processors, device=None):
    """The corruption's normalized parameters and gains, drawn from the numpy
    generator in the JAX example's order: EQ, compressor and reverb
    parameters on (0, 1), the reference's and the input's gains on (0, 24)
    dB, (bs, 1, 1)."""
    def u(shape, high=1.0):
        return torch.as_tensor(nprng.uniform(0, high, shape).astype(np.float32), device=device)

    return {
        "eq": u((bs, processors["equalizer"].num_params)),
        "comp": u((bs, processors["compressor"].num_params)),
        "reverb": u((bs, processors["reverb"].num_params)),
        "ref_gain_db": u((bs, 1, 1), 24.0),
        "in_gain_db": u((bs, 1, 1), 24.0),
    }


def _layout(mesh):
    """(block, gather): this rank's time block of a whole signal, and the
    whole signal from the sp ranks' blocks (both the identity without sp)."""
    if mesh is None or mesh.shape["sp"] == 1:
        return (lambda t: t), (lambda t: t)
    from ..parallel import Sharding, all_gather

    def block(t):
        return Sharding(mesh, (None,) * (t.ndim - 1) + ("sp",)).block(t).contiguous()

    return block, (lambda t: all_gather(t, mesh.group("sp"), dim=-1, tiled=True))


def style_loss(net, processors, input_a, ref_a, ref_b, mesh=None, generator=None, noise=None,
               auraloss_compat: bool = False):
    """The net (its mode is the caller's) on the whole (input A, channel mean
    of reference B), the render of input A and the MR-STFT loss against
    reference A. Under a mesh the render and the loss take this rank's time
    block, and the loss is the whole batch's (summed over sp and dp)."""
    block, _ = _layout(mesh)
    p = net(input_a, ref_b.mean(dim=1, keepdim=True))
    out_a = apply_style_chain(processors, block(input_a), p, generator=generator, noise=noise)
    if mesh is None:
        return multi_resolution_stft_loss(out_a, ref_a, auraloss_compat=auraloss_compat)
    from ..parallel import sharded_multi_resolution_stft_loss

    return sharded_multi_resolution_stft_loss(out_a, block(ref_a), mesh, batch_axis_name="dp",
                                              auraloss_compat=auraloss_compat)


def make_step(args, processors, net, opt, sched=None, mesh=None):
    """One optimization step ``step(x, rand, generator=None, noise=None) ->
    loss``: x (bs, 1, 2 * half) clean clips (this rank's dp slice under a
    mesh, the whole time axis), ``rand`` from :func:`random_corruption`,
    the reverb's noise from ``generator`` (corruption, then render) or
    ``noise=(corruption_noise, render_noise)``. Under a mesh the
    parameters' gradients are summed over the world before the update."""
    block, gather = _layout(mesh)

    def step(x, rand, generator=None, noise=None):
        noise_ref, noise_out = (None, None) if noise is None else noise
        with torch.no_grad():
            # the pseudo-reference by random corruption, on this rank's block
            ref = processors["equalizer"].process_normalized(block(x), rand["eq"], clip_params=True)
            ref = processors["compressor"].process_normalized(ref, rand["comp"], clip_params=True)
            ref = processors["reverb"].process_normalized(ref, rand["reverb"], clip_params=True,
                                                          generator=generator, noise=noise_ref)
            ref = gather(ref)
            peak = torch.amax(torch.abs(ref), dim=-1, keepdim=True)
            ref = ref / (peak + 1e-9) * 10.0 ** (-rand["ref_gain_db"] / 20.0)
            x = x * 10.0 ** (-rand["in_gain_db"] / 20.0)
        input_a = x.chunk(2, dim=-1)[0].contiguous()
        ref_a, ref_b = (h.contiguous() for h in ref.chunk(2, dim=-1))
        net.train()
        loss = style_loss(net, processors, input_a, ref_a, ref_b, mesh, generator, noise_out,
                          args.auraloss_compat)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            from ..parallel import sum_gradients

            sum_gradients(net)
        opt.step()
        if sched is not None:
            sched.step()
        return loss.detach()

    return step


def _reservoir(args, device):
    """The device-resident clip reservoir: R int16 clips (with their inverse
    scales) on ``device``, refilled by ``fresh_n`` streamed clips a step;
    returns ``next_batch()``."""
    from ..utils import device_prefetch, reservoir_put, reservoir_sample, wire_i16_parts
    from .common import batch_iterator

    fresh_n = max(1, args.batch_size // 2)
    R = max(args.reservoir, 2 * fresh_n)
    R -= R % fresh_n  # a multiple of fresh_n: the write window never wraps
    fargs = copy.copy(args)
    fargs.batch_size = fresh_n
    data = device_prefetch(batch_iterator(fargs), size=2, device=device, wire="i16",
                           decode_on_yield=False)
    parts = [wire_i16_parts(next(data)) for _ in range(R // fresh_n)]
    store = torch.cat([q for q, _ in parts])
    store_inv = torch.cat([torch.as_tensor(i, device=device).reshape(1).expand(fresh_n) for _, i in parts])
    gen = torch.Generator(device=device).manual_seed(args.seed + 3)
    ptr = [0]
    print(f"reservoir: {R} resident clips (int16), {fresh_n} fresh/step "
          f"(reuse ~{args.batch_size / fresh_n:.0f}x)")

    def next_batch():
        fq, finv = wire_i16_parts(next(data))
        reservoir_put(store_inv, torch.as_tensor(finv, device=device).reshape(1).expand(fq.shape[0]), ptr[0])
        _, ptr[0] = reservoir_put(store, fq, ptr[0])
        # one draw of rows for the clips and their scales
        g_state = gen.get_state()
        q = reservoir_sample(store, gen, args.batch_size)
        gen.set_state(g_state)
        inv = reservoir_sample(store_inv, gen, args.batch_size)
        return q.float() / inv[:, None, None]

    return next_batch


def train(args, device, mesh=None) -> dict:
    """The training loop on this rank (under a mesh, every rank runs it)."""
    rank0 = mesh is None or mesh.rank == 0
    log_dir = args.log_dir or "outputs/style_transfer"
    os.makedirs(log_dir, exist_ok=True)
    ckpt = os.path.join(log_dir, "ckpt.pkl")
    processors, net = build(args, mesh, device)
    if rank0:
        print(f"model: {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M params")
    opt, sched = make_optimizer(args, net)
    step_fn = make_step(args, processors, net, opt, sched, mesh)

    state = load_checkpoint(ckpt) if args.resume else None
    start = 0
    if state:
        net.load_state_dict(state["net"])
        opt.load_state_dict(state["opt"])
        sched.load_state_dict(state["sched"])
        start = state["step"]
        if rank0:
            print(f"resumed from step {start}")

    logger = MetricsLogger(log_dir) if rank0 else None
    nprng = np.random.default_rng(args.seed + 1)
    dp_index = mesh.index("dp") if mesh is not None else 0
    # the reverb's noise: one stream per dp rank (the sp ranks of a dp row
    # draw alike, so their IRs agree)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2 + 1_000_003 * dp_index)
    data = _reservoir(args, device) if args.reservoir else device_batches(args).__next__
    losses = []
    for step in range(start, args.steps):
        x = data()  # the whole batch on every rank, from the same seed
        rand = random_corruption(nprng, args.batch_size, processors, device)
        if mesh is not None:
            from ..parallel import shard_batch

            x = shard_batch(x, mesh)
            rand = {k: shard_batch(v, mesh) for k, v in rand.items()}
        loss = step_fn(x, rand, generator=gen)
        losses.append(float(loss))
        if rank0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d}  mrstft {float(loss):.4f}")
            logger.log(step, loss=loss)
        if rank0 and ((step + 1) % args.checkpoint_every == 0 or step == args.steps - 1):
            save_checkpoint(ckpt, {"net": net.state_dict(), "opt": opt.state_dict(),
                                   "sched": sched.state_dict(), "step": step + 1})
    if rank0:
        print(f"done; metrics at {logger.path}")
    return {"losses": losses, "start": start}


def _train_on_mesh(args, device):
    from ..parallel import make_mesh

    import torch.distributed as dist

    n = dist.get_world_size()
    mesh = make_mesh((n // args.sp, args.sp), device=device)
    dp = mesh.shape["dp"]
    if mesh.rank == 0:
        print(f"mesh: dp={dp} sp={args.sp} ({dist.get_backend()}, {device})")
    if args.batch_size % dp:
        if args.batch_size_given:
            raise SystemExit(f"--batch-size {args.batch_size} not divisible by dp={dp}")
        args.batch_size = dp * max(1, args.batch_size // dp)
        if mesh.rank == 0:
            print(f"batch size rounded to {args.batch_size} (divisible by dp)")
    return train(args, device, mesh)


def parse(argv=None):
    p = add_world_flags(base_parser(__doc__.splitlines()[0]))
    p.add_argument("--dp", action="store_true", help="data-parallel over the ranks")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel factor (ranks split as (n/sp) dp x sp)")
    p.add_argument("--reservoir", type=int, default=0, metavar="R",
                   help="device-resident clip reservoir: keep R int16 clips on the device, stream only "
                        "batch_size/2 fresh clips a step and gather each batch from random reservoir rows "
                        "(utils.reservoir_put / reservoir_sample); 0 streams every clip")
    args = p.parse_args(argv)
    args.batch_size_given = "--batch-size" in (argv if argv is not None else sys.argv)
    if args.smoke:
        args.length = 16384
        if not args.batch_size_given:
            args.batch_size = 2
    elif args.length == 131072:
        args.length = 262144  # the reference's clips: two halves of 131072
    return args


def main(argv=None) -> dict:
    args = parse(argv)
    if args.dp or args.sp > 1:
        return run_ranks(_train_on_mesh, args)
    return train(args, device_of(args))


if __name__ == "__main__":
    main()
