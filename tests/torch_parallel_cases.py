"""The rank side of tests/test_torch_parallel*.py: gloo CPU ranks that run
dasp_tpu_torch.parallel's functions on their blocks of inputs made from
numpy seeds, and save what they got for the pytest process to hold
against JAX's.

This module imports no JAX: a spawned rank imports the module that defines
its target. ``spawn_world`` starts one world of dp * sp ranks through
``dasp_tpu_torch.parallel.spawn`` (``spawn`` start method, a ``file://``
rendezvous in a test's temporary directory, one intra-op thread each),
runs every named case in it, and returns each rank's results.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

SR = 44100
FS, HOP, TW = 512, 128, 8192  # the WOLA cases: frame, hop, length


# ---------------------------------------------------------------------------
# inputs (global arrays, alike in the pytest process and every rank)


def curve(bs=2, T=8192):
    """A gain-reduction-like curve (mostly 0 with negative dips) and its
    per-item coefficients, as tests/test_parallel.py's."""
    rng = np.random.default_rng(11)
    g = -np.abs(rng.standard_normal((bs, 1, T))).astype(np.float32) * 6.0
    aa = np.tile(np.float32([0.93, 0.999]), bs // 2).reshape(bs, 1, 1)
    ar = np.tile(np.float32([0.9995, 0.99]), bs // 2).reshape(bs, 1, 1)
    return g, aa, ar


def conv_inputs(bs):
    rng = np.random.default_rng(12)
    return (rng.standard_normal((bs, 2, 4096)).astype(np.float32),
            rng.standard_normal((bs, 2, 256)).astype(np.float32) * 0.1)


SOS_BANDS = [(4.0, 200.0, 0.7, "low_shelf"), (6.0, 40.0, 2.0, "peaking"),
             (-6.0, 1000.0, 2.0, "peaking"), (3.0, 8000.0, 0.7, "high_shelf")]


def coupled_inputs(bs, T):
    rng = np.random.default_rng(13)
    return rng.standard_normal((bs, 1, T)).astype(np.float32) * 0.3


def wola_inputs(bs=2, chs=2):
    from dasp_tpu_torch.ops.tv_filter import tv_frame_count

    rng = np.random.default_rng(911)
    n_bins = 2 * FS + 1
    n_frames = tv_frame_count(TW, FS, HOP)
    x = rng.standard_normal((bs, chs, TW)).astype(np.float32)
    H = (rng.standard_normal((bs, n_frames, n_bins)) * 0.3
         + 1j * rng.standard_normal((bs, n_frames, n_bins)) * 0.3).astype(np.complex64)
    return x, H


def loss_inputs(bs):
    rng = np.random.default_rng(14)
    return (rng.standard_normal((bs, 2, TW)).astype(np.float32),
            rng.standard_normal((bs, 2, TW)).astype(np.float32))


def effect_call(effect, F, x, **kw):
    """tests/test_parallel.py's WOLA effect cases, on either package's
    functional module (``F``) with its tensors built by ``t``."""
    t = kw.pop("t")
    half = t([0.5, 0.5])
    if effect == "phaser":
        return F.phaser(x, SR, t([1.0, 2.0]), half, t([800.0, 1200.0]), t([0.4, 0.2]), half, **kw)
    if effect == "auto_wah":
        return F.auto_wah(x, SR, t([5.0, 8.0]), t([10.0, 20.0]), t([80.0, 120.0]), t([300.0, 400.0]),
                          t([2000.0, 3000.0]), t([2.0, 4.0]), half, **kw)
    if effect == "spectral_gate":
        return F.spectral_gate(x, SR, t([6.0, 8.0]), t([24.0, 18.0]), t([5.0, 10.0]), t([80.0, 120.0]),
                               frame_size=1024, hop=256, **kw)
    return F.dynamic_eq(x, SR, t([[300.0, 2000.0], [500.0, 4000.0]]), 2.0, -30.0, 4.0, 5.0, 80.0,
                        frame_size=512, hop=128, **kw)


def effect_input():
    return np.random.default_rng(15).standard_normal((2, 2, TW)).astype(np.float32) * 0.3


EFFECTS = ("phaser", "auto_wah", "spectral_gate", "dynamic_eq")


# ---------------------------------------------------------------------------
# the rank side


def _seq(mesh, x):
    from dasp_tpu_torch.parallel import Sharding

    return Sharding(mesh, (None,) * (x.ndim - 1) + ("sp",)).block(x)


def _batch(mesh, x):
    from dasp_tpu_torch.parallel import shard_batch

    return shard_batch(x, mesh)


def _local(mesh, a, split_batch):
    t = torch.tensor(a)
    return _seq(mesh, _batch(mesh, t) if split_batch else t)


def _np(t):
    return t.detach().numpy().copy()


def _grad_of(loss, *leaves):
    return torch.autograd.grad(loss, leaves)


def _sum_sp(mesh, g):
    """The whole gradient of a tensor that the sp ranks hold alike."""
    from dasp_tpu_torch.parallel.mesh import _all_reduce_raw

    return _all_reduce_raw(g, mesh.group("sp"))


def _local_loss(mesh, y, fn=lambda v: torch.sum(v ** 2)):
    from dasp_tpu_torch.parallel import psum

    return psum(fn(y), mesh.group("sp"))


def case_conv(mesh):
    from dasp_tpu_torch.parallel import sharded_fft_conv_causal

    dp = mesh.shape["dp"]
    x, h = conv_inputs(2 * dp)
    xb = _local(mesh, x, True).requires_grad_()
    hb = _batch(mesh, torch.tensor(h)).requires_grad_()
    out = {}
    for method in ("direct", "fft"):
        y = sharded_fft_conv_causal(xb, hb, mesh, method=method)
        gx, gh = _grad_of(_local_loss(mesh, y), xb, hb)
        out[method] = dict(y=_np(y), gx=_np(gx), gh=_np(_sum_sp(mesh, gh)))
    # a one-tap IR: pointwise, no halo
    out["one_tap"] = _np(sharded_fft_conv_causal(xb.detach(), torch.full((2 * dp, 2, 1), 0.25)[:xb.shape[0]], mesh))
    try:
        sharded_fft_conv_causal(xb.detach()[..., :64], hb.detach(), mesh)
        out["short_block_error"] = ""
    except ValueError as e:
        out["short_block_error"] = str(e)
    return out


def case_coupled(mesh):
    from dasp_tpu_torch.ops.biquad import biquad
    from dasp_tpu_torch.parallel import sharded_sosfilt_coupled

    def sos_of(bs):
        secs = []
        for g, fc, q, ft in SOS_BANDS:
            b, a = biquad(torch.full((bs,), g), torch.full((bs,), fc), torch.full((bs,), q), SR, ft)
            secs.append(torch.cat([b, a], dim=-1))
        return torch.stack(secs, dim=1)

    dp = mesh.shape["dp"]
    out = {}
    sos = _batch(mesh, sos_of(2 * dp))
    y = sharded_sosfilt_coupled(sos, _local(mesh, coupled_inputs(2 * dp, 8192), True), mesh)
    out["y"] = _np(y)
    xb = _local(mesh, coupled_inputs(2 * dp, 2048), True).requires_grad_()
    sb = sos.clone().requires_grad_()
    yb = sharded_sosfilt_coupled(sb, xb, mesh)
    gs, gx = _grad_of(_local_loss(mesh, yb, lambda v: torch.sum(v ** 2) / (2 * dp * 2048)), sb, xb)
    out["gx"], out["gs"] = _np(gx), _np(_sum_sp(mesh, gs))
    try:
        sharded_sosfilt_coupled(sos, torch.zeros(sos.shape[0], 1, 1000), mesh)
        out["unaligned_error"] = ""
    except ValueError as e:
        out["unaligned_error"] = str(e)
    return out


def case_smoothers(mesh):
    from dasp_tpu_torch.parallel import sharded_ballistics_smooth, sharded_onepole

    dp = mesh.shape["dp"]
    out = {}
    g, aa, ar = curve(2 * dp, 8192)
    gb = _local(mesh, g, True)
    aab, arb = _batch(mesh, torch.tensor(aa)), _batch(mesh, torch.tensor(ar))
    out["onepole"] = _np(sharded_onepole(gb, aab, mesh))
    out["attack_only"] = _np(sharded_ballistics_smooth(gb, aab, arb, mesh, mode="attack_only"))
    out["parallel"] = _np(sharded_ballistics_smooth(gb, aab, arb, mesh, mode="parallel"))
    g2, aa2, ar2 = curve(2 * dp, 2048)
    for mode in ("parallel", "exact_pallas", "exact"):
        if mode == "exact":
            g2, aa2, ar2 = curve(2 * dp, 512)
        gb = _local(mesh, g2, True).requires_grad_()
        a1 = _batch(mesh, torch.tensor(aa2)).requires_grad_()
        a2 = _batch(mesh, torch.tensor(ar2)).requires_grad_()
        y = sharded_ballistics_smooth(gb, a1, a2, mesh, mode=mode)
        grads = _grad_of(_local_loss(mesh, y, lambda v: torch.sum(v ** 2) / v.numel() / mesh.shape["sp"]
                                     / mesh.shape["dp"]), gb, a1, a2)
        out[f"{mode} grad"] = dict(y=_np(y), dg=_np(grads[0]), daa=_np(_sum_sp(mesh, grads[1])),
                                   dar=_np(_sum_sp(mesh, grads[2])))
    # the relay through the kernel's wrapper: on the CPU its plain engine,
    # counted here as the CUDA engine counts its launches
    from dasp_tpu_torch.ops import ballistics_kernel as BK

    calls = {"forward": 0, "backward": 0}

    def counted(name):
        fn = getattr(BK._PlainEngine, name)

        def wrapper(*a):
            calls[name] += 1
            return fn(*a)

        return staticmethod(wrapper)

    plain = (BK._PlainEngine.forward, BK._PlainEngine.backward)
    BK._PlainEngine.forward, BK._PlainEngine.backward = counted("forward"), counted("backward")
    try:
        g3, aa3, ar3 = curve(2 * dp, 4096)
        gb = _local(mesh, g3, True).requires_grad_()
        y3 = sharded_ballistics_smooth(gb, _batch(mesh, torch.tensor(aa3)), _batch(mesh, torch.tensor(ar3)), mesh)
        _grad_of(_local_loss(mesh, y3), gb)
    finally:
        BK._PlainEngine.forward, BK._PlainEngine.backward = (staticmethod(f) for f in plain)
    out["relay"] = _np(y3)
    out["relay calls"] = dict(calls)
    return out


def case_wola(mesh):
    from dasp_tpu_torch.ops.tv_filter import tv_frame_count
    from dasp_tpu_torch.parallel import sharded_tv_freq_filter, sharded_tv_power

    dp = mesh.shape["dp"]
    x, H = wola_inputs(bs=2 * dp)
    xb = _local(mesh, x, True).requires_grad_()
    Hb = _batch(mesh, torch.tensor(H)).requires_grad_()
    y = sharded_tv_freq_filter(xb, Hb, FS, HOP, mesh)
    gx, gH = _grad_of(_local_loss(mesh, y), xb, Hb)
    P = sharded_tv_power(xb.detach(), FS, HOP, 4 * FS, mesh)
    out = dict(y=_np(y), gx=_np(gx), gH=_np(_sum_sp(mesh, gH)), P=_np(P))
    try:
        short = tv_frame_count(1024 * mesh.shape["sp"], FS, HOP)
        sharded_tv_freq_filter(xb.detach()[..., :1024], Hb.detach()[:, :short], FS, HOP, mesh)
        out["halo_error"] = ""
    except ValueError as e:
        out["halo_error"] = str(e)
    return out


def case_effects(mesh):
    import dasp_tpu_torch.functional as F
    from dasp_tpu_torch.parallel import sharded_tv_freq_filter, sharded_tv_power
    from dasp_tpu_torch.parallel.sharded import whole_signal

    filt = whole_signal(partial(sharded_tv_freq_filter, mesh=mesh), mesh)
    powf = whole_signal(partial(sharded_tv_power, mesh=mesh), mesh, gather=False)
    out = {}
    for effect in EFFECTS:
        kw = {"tv_filter_fn": filt}
        if effect in ("spectral_gate", "dynamic_eq"):
            kw["tv_power_fn"] = powf
        x = torch.tensor(effect_input()).requires_grad_()
        y = effect_call(effect, F, x, t=torch.tensor, **kw)
        # the loss of this rank's block, summed over sp; x is whole on every
        # rank, so its gradient is the sum of the ranks' parts
        (gx,) = _grad_of(_local_loss(mesh, _seq(mesh, y)), x)
        out[effect] = dict(y=_np(y), gx=_np(_sum_sp(mesh, gx)))
    # on blocks: the detectors consume only the hooks' frames
    xb = _seq(mesh, torch.tensor(effect_input()))
    out["dynamic_eq blocks"] = _np(effect_call(
        "dynamic_eq", F, xb, t=torch.tensor, tv_power_fn=partial(sharded_tv_power, mesh=mesh),
        tv_filter_fn=partial(sharded_tv_freq_filter, mesh=mesh)))
    return out


def case_loss(mesh):
    from dasp_tpu_torch.parallel import sharded_multi_resolution_stft_loss

    dp = mesh.shape["dp"]
    b = "dp" if dp > 1 else None
    a, y = loss_inputs(2 * dp)
    ab = _local(mesh, a, True).requires_grad_()
    yb = _local(mesh, y, True)
    out = {}
    for name, kw in (("default", {}), ("auraloss", dict(auraloss_compat=True)),
                     ("perceptual", dict(perceptual_weighting=True, sample_rate=SR, w_lin_mag=1.0))):
        loss = sharded_multi_resolution_stft_loss(ab, yb, mesh, batch_axis_name=b, **kw)
        (g,) = _grad_of(loss, ab)
        out[name] = dict(loss=float(loss.detach()), g=_np(g))
    # in float64, where the log-magnitude terms' 1/|S| does not amplify fp32
    # rounding into the gradient
    ab64 = ab.detach().double().requires_grad_()
    loss = sharded_multi_resolution_stft_loss(ab64, yb.double(), mesh, batch_axis_name=b)
    (g,) = _grad_of(loss, ab64)
    out["float64"] = dict(loss=float(loss.detach()), g=_np(g))
    return out


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_cases(rank, mesh, names):
    return {name: CASES[name](mesh) for name in names}


def _in_mesh(rank, dp, sp, target, args):
    from dasp_tpu_torch.parallel import make_mesh

    return target(rank, make_mesh((dp, sp)), *args)


def spawn_world(dp, sp, tmp_dir, names=tuple(CASES), target=run_cases, args=None):
    """``target(rank, mesh, *args)`` (default: the cases ``names``) on a new
    gloo world of dp * sp CPU ranks, one intra-op thread each, with its
    rendezvous under ``tmp_dir``; returns the ranks' results in rank order."""
    from dasp_tpu_torch.parallel import spawn

    return spawn(dp * sp, _in_mesh, (dp, sp, target, (names,) if args is None else args), threads=1,
                 tmp_dir=tmp_dir)


# ---------------------------------------------------------------------------
# training steps: data parallelism and the dp x sp style step


def dp_distortion_run(x, y_target, mesh=None, steps=5):
    """tests/test_parallel.py's dp step: Adam at 0.05 on one distortion
    drive from 0, the MSE over the whole batch; under a mesh each rank holds
    its dp slice, the loss's sum is taken over dp and the drive's gradient
    summed over the ranks. Returns the drive and the losses."""
    import dasp_tpu_torch.functional as F
    from dasp_tpu_torch.parallel import psum, shard_batch, sum_gradients

    x, y_target = torch.tensor(x), torch.tensor(y_target)
    n = y_target.numel()
    if mesh is not None:
        x, y_target = shard_batch(x, mesh), shard_batch(y_target, mesh)
    drive = torch.zeros((), requires_grad=True)
    opt = torch.optim.Adam([drive], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        # the squares summed in float64: the ranks' and one rank's sums then
        # differ by far less than the bar whatever their order
        sq = torch.sum((F.distortion(x, SR, drive.expand(x.shape[0])) - y_target) ** 2, dtype=torch.float64)
        loss = (psum(sq, mesh.group("dp")) if mesh is not None else sq) / n
        opt.zero_grad()
        loss.backward()
        if mesh is not None:
            sum_gradients([drive])
        opt.step()
        losses.append(float(loss.detach()))
    return float(drive.detach()), losses


STYLE = dict(bs=4, half=1024, ir=256)  # tests/test_parallel.py's dp x sp step


def style_processors(mesh=None):
    """test_dpsp_step_matches_dp_only's processors: coupled EQ, "parallel"
    smoother, time-domain reverb noise, a direct IR convolution; under a
    mesh with sp > 1 their sequence-sharded forms."""
    from dasp_tpu_torch.models import make_style_processors
    from dasp_tpu_torch.parallel import sharded_ballistics_smooth, sharded_fft_conv_causal, sharded_sosfilt_coupled
    from dasp_tpu_torch.parallel.sharded import _direct_causal_conv

    kw = dict(reverb_num_samples=STYLE["ir"], reverb_noise_mode="time")
    if mesh is not None and mesh.shape["sp"] > 1:
        kw.update(eq_filter_method=partial(sharded_sosfilt_coupled, mesh=mesh),
                  compressor_smoother=partial(sharded_ballistics_smooth, mesh=mesh, mode="parallel"),
                  reverb_ir_conv_fn=partial(sharded_fft_conv_causal, mesh=mesh, method="direct"))
    else:
        kw.update(eq_filter_method="coupled", compressor_smoother="parallel", reverb_ir_conv_fn=_direct_causal_conv)
    return make_style_processors(SR, **kw)


def style_net(state):
    from dasp_tpu_torch.models import StyleTransferNet

    net = StyleTransferNet(embed_dim=8, ch_dim=4, encoder_dilations=(1, 2))
    net.load_state_dict(state)
    return net.train()


def style_grads(state, x, ref, noise, mesh=None, dtype=torch.float32):
    """The dp x sp style render's loss, its parameters' gradients (summed
    over the ranks) and the BatchNorm statistics after the forward, on
    this rank (the whole batch without a mesh), in ``dtype``."""
    from dasp_tpu_torch.examples.style_transfer import style_loss
    from dasp_tpu_torch.models.tcn import sync_batch_norm
    from dasp_tpu_torch.parallel import shard_batch, sum_gradients

    net = style_net(state).to(dtype)
    x, ref, noise = (torch.tensor(a, dtype=dtype) for a in (x, ref, noise))
    if mesh is not None:
        sync_batch_norm(net, mesh.group("dp"))
        x, ref = shard_batch(x, mesh), shard_batch(ref, mesh)
        rows = noise.shape[0] // mesh.shape["dp"]
        noise = noise[mesh.index("dp") * rows: (mesh.index("dp") + 1) * rows]
    loss = style_loss(net, style_processors(mesh), x, ref.expand(-1, 2, -1).contiguous(), ref, mesh, noise=noise)
    loss.backward()
    if mesh is not None:
        sum_gradients(net)
    grads = {k: _np(p.grad) for k, p in net.named_parameters()}
    stats = {k: _np(v) for k, v in net.state_dict().items() if "running" in k}
    return float(loss.detach()), grads, stats


def step_target(rank, mesh, x_d, y_d, state, x, ref, noise):
    """The (2, 2) world's work: the dp step on a (4, 1) layout of the same
    ranks, then the dp x sp style step."""
    from dasp_tpu_torch.parallel import make_mesh

    return {"dp": dp_distortion_run(x_d, y_d, make_mesh((4, 1))),
            "style": style_grads(state, x, ref, noise, mesh),
            "style float64": style_grads(state, x, ref, noise, mesh, torch.float64)}


def fails_on_rank_one(rank, mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails")
    dist.barrier()
