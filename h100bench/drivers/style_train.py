"""The style-transfer training step, ``dasp_tpu_torch.train.train_step`` on
``make_style_training()``, one trainer in a closed loop.

Set-up builds the net, the processors and Adam once, loads the weights the
benchmark made from the seed, and runs the first ``checked_steps`` steps
through the window's own call on the pool's first batches: they warm up
every shape, and they are the steps the reference follows. The window goes
on with the same objects over the rest of the pool, in order and round
again; each step ends in a synchronize.

``check`` compares with the reference started from the same weights on
the same batches, in the precision the configuration states. Held to the
cell's limits: the first step's loss (relative gap); the median leaf's gap
between the norms of its first gradient as Adam got it (its first moment
after one step over 1 - beta1); the median leaf's gap between the norms of
its change over the checked steps; the median gap between the norms of
BatchNorm's running statistics' change over the checked steps (averages
over the whole batch: a step that leaves part of the batch out moves them
by several times the rounding). A leaf's gap is taken over the larger of
the reference's norm and the median leaf's, and a leaf whose reference
gradient is under a thousandth of the median leaf's moves under Adam by
rounding alone and is left out of the change. Reported beside them, not
held: the largest loss gap over the checked steps, the worst leaf's
gradient and change, the gaps of all the leaves together, and the worst
statistic. The later steps' losses and the worst leaves (the one-element
PReLU slopes, biases) move by rounding far beyond the rest: two bfloat16
computations that differ in the last bit of their inputs part there by as
much as the control does (PERF.md).
"""

import math
import time

import numpy as np
import torch

from h100bench.reference import style as ref
from h100bench.work import audio
from h100bench.work.device import sync
from h100bench.work.weights import make_weights

# the gradient of a leaf under this share of the median leaf's is rounding
QUIET_LEAF = 1e-3


def _make_pool(cfg, mix, seed, device):
    """``mix["pool"]`` batches: clean clips (host generator, then one copy),
    corruption parameters as ``random_corruption`` draws them, and the two
    reverb noises of each step, from the seed."""
    bs, n, pool = mix["batch"], mix["clip_samples"], mix["pool"]
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(audio.synthetic_batch(rng, bs * pool, n, cfg["sample_rate"], mix["kind"]))
    clips = clips.to(device).view(pool, bs, 1, n)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = 2 * bs
    taps = cfg["chain"]["reverb_bandpass_taps"]
    noise_shape = (pool, 2, rows, 12, cfg["chain"]["reverb_num_samples"] + taps - 1)
    noise = torch.randn(noise_shape, generator=gen, device=device)
    counts = dict(zip(("eq", "comp", "reverb"), cfg["net"]["num_params"][:3]))
    u = {k: torch.rand((pool, bs, c), generator=gen, device=device) for k, c in counts.items()}
    g = 24.0 * torch.rand((pool, 2, bs, 1, 1), generator=gen, device=device)
    return [{"x": clips[i], "rand": {"eq": u["eq"][i], "comp": u["comp"][i], "reverb": u["reverb"][i],
                                     "g1": g[i, 0], "g2": g[i, 1]},
             "noise_ref": noise[i, 0], "noise_out": noise[i, 1]} for i in range(pool)]


def setup(cfg, cell, seed, device, program=None):
    from dasp_tpu_torch import train as T

    program = program or T
    mix = cell["mix"]
    build = dict(cfg["build"])
    dtype = getattr(torch, build.pop("dtype"))
    net, procs, opt = T.make_style_training(cfg["sample_rate"], dtype=dtype, device=device, **build)
    shapes = ref.param_shapes(cfg["net"])
    weights = make_weights(shapes, torch.Generator(device=device).manual_seed(seed + 1), device)
    missing, unexpected = net.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in missing):
        raise RuntimeError(f"the net's weights differ from the configuration: {missing} {unexpected}")
    pool = _make_pool(cfg, mix, seed, device)
    state = {"net": net, "procs": procs, "opt": opt, "pool": pool, "cfg": cfg, "mix": mix, "step": program.train_step,
             "weights0": {k: v.clone() for k, v in weights.items()}}
    beta1 = opt.param_groups[0]["betas"][0]
    names = [k for k, _ in net.named_parameters()]
    losses = []
    for i in range(mix["checked_steps"]):
        b = pool[i]
        losses.append(float(state["step"](net, procs, opt, b["x"], b["rand"], noise=(b["noise_ref"], b["noise_out"]))))
        if i == 0:  # the gradient as Adam got it: its first moment over 1 - beta1
            grad_norms = {k: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"])) / (1 - beta1)
                          for k, p in zip(names, net.parameters())}
    change_norms = {k: float(torch.linalg.vector_norm(p.detach() - state["weights0"][k]))
                    for k, p in zip(names, net.parameters())}
    state["readings"] = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms,
                         "stats_norms": _stats_change(dict(net.named_buffers()))}
    state["next"] = mix["checked_steps"]
    return state


def window(state, seconds, tracer=None):
    net, procs, opt, pool, step = state["net"], state["procs"], state["opt"], state["pool"], state["step"]
    i, losses, steps = state["next"], [], 0
    device = pool[0]["x"].device

    mark = None
    if tracer is not None:
        evs = {}

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            evs[name] = e

    t0 = time.perf_counter()
    while True:
        b = pool[i % len(pool)]
        if mark is not None:
            mark("start")
        losses.append(step(net, procs, opt, b["x"], b["rand"], noise=(b["noise_ref"], b["noise_out"]), mark=mark))
        sync(device)
        steps, i = steps + 1, i + 1
        if mark is not None:
            for a, z in (("start", "corrupt"), ("corrupt", "forward"), ("forward", "backward"),
                         ("backward", "optimizer")):
                tracer.event_pair(z, evs[a], evs[z])
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"steps": steps, "window_s": elapsed, "attempted": steps, "failed": failed}


def _gaps(prog: dict, refs: dict, keep) -> list:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's, worst first."""
    med = float(np.median([refs[k] for k in keep]))
    return sorted(((abs(prog[k] - refs[k]) / max(refs[k], med), k) for k in keep), reverse=True)


def readings(losses, grads1, P, stats, w0) -> dict:
    """What is compared of a run: each step's loss, the first gradient's
    norm and the change's norm of each leaf, and the change's norm of each
    of BatchNorm's running statistics (from mean 0 and variance 1)."""
    return {"losses": list(losses),
            "grad_norms": {k: float(torch.linalg.vector_norm(g)) for k, g in grads1.items()},
            "change_norms": {k: float(torch.linalg.vector_norm(P[k] - w0[k])) for k in P},
            "stats_norms": _stats_change(stats)}


def _stats_change(stats: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v - (1.0 if k.endswith("running_var") else 0.0)))
            for k, v in stats.items() if k.endswith(("running_mean", "running_var"))}


def compare(prog: dict, ref_run: dict) -> dict:
    """Every number of the module docstring: ``prog`` a run's readings,
    ``ref_run`` the reference's. Those the cell gives a limit are held to
    it; the rest are reported."""
    g_ref, d_ref = ref_run["grad_norms"], ref_run["change_norms"]
    med_g = float(np.median(list(g_ref.values())))
    moving = [k for k in g_ref if g_ref[k] >= QUIET_LEAF * med_g]
    grad, change = _gaps(prog["grad_norms"], g_ref, list(g_ref)), _gaps(prog["change_norms"], d_ref, moving)
    s_ref = ref_run["stats_norms"]
    stats = _gaps(prog["stats_norms"], s_ref, list(s_ref))
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_run["losses"])]
    return {
        "loss": loss[0], "loss_steps": max(loss),
        "grad": _median(grad), "grad_total": _total_gap(prog["grad_norms"], g_ref, list(g_ref)),
        "grad_worst_leaf": grad[0][0],
        "change": _median(change), "change_total": _total_gap(prog["change_norms"], d_ref, moving),
        "change_worst_leaf": change[0][0],
        "stats": _median(stats), "stats_worst": stats[0][0],
        "info": {"loss_each_step": loss, "grad_worst": grad[:3], "change_worst": change[:3],
                 "quiet_leaves": len(g_ref) - len(moving), "losses": prog["losses"], "ref_losses": ref_run["losses"]},
    }


def _total_gap(prog: dict, refs: dict, keep) -> float:
    """The gap between the norms of all the leaves together."""
    p = math.sqrt(sum(prog[k] ** 2 for k in keep))
    r = math.sqrt(sum(refs[k] ** 2 for k in keep))
    return abs(p - r) / r


def _median(gaps) -> float:
    return float(np.median([g for g, _ in gaps]))


def reference(state, prec=None) -> dict:
    """The reference's readings over the checked steps, in the precision the
    configuration states (``prec``: another, such as the control's)."""
    cfg, mix = state["cfg"], state["mix"]
    prec = prec or ref.stated(cfg)
    dev = state["pool"][0]["x"].device
    out = ref.train_steps(state["weights0"], ref.bn_stats(cfg["net"], dev), cfg["net"],
                          state["pool"][:mix["checked_steps"]], cfg["optimizer"]["lr"], prec)
    return readings(*out, state["weights0"])


def free_program(state):
    for k in ("net", "procs", "opt", "step"):
        state.pop(k, None)


def check(state, record, limits):
    free_program(state)
    if state["pool"][0]["x"].is_cuda:
        torch.cuda.empty_cache()
    got = compare(state["readings"], reference(state))
    numbers = {k: (got[k], lim) for k, lim in limits.items()}
    return numbers, {**got.pop("info"), "not_held": {k: v for k, v in got.items() if k not in limits}}


def _half_step(train_step):
    """The fault "half of the batch left out": the step on the first half
    of each batch, the mean taken over it."""
    def step(net, procs, opt, x, rand, noise=None, mark=None):
        h = x.shape[0] // 2
        rand = {k: v[:h] for k, v in rand.items()}
        noise = tuple(n[:2 * h] for n in noise)
        return train_step(net, procs, opt, x[:h], rand, noise=noise, mark=mark)
    return step


def calibrate(kind, cfg, cell, seed, device, seconds):
    """One reading of ``kind`` (see ``h100bench/calibrate.py``)."""
    from types import SimpleNamespace

    from dasp_tpu_torch import train as T

    program = SimpleNamespace(train_step=_half_step(T.train_step)) if kind == "fault_half" else None
    state = setup(cfg, cell, seed, device, program)
    prog = state["readings"]
    free_program(state)
    torch.cuda.empty_cache()
    r = reference(state)
    if kind == "control":
        prog = reference(state, ref.CONTROL)
    got = compare(prog, r)
    info = got.pop("info")
    return got, info
