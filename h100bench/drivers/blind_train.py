"""Blind estimation of a pitch shifter, ``dasp_tpu_torch.train.
blind_estimation_step`` on ``make_blind_estimation(PitchShift)``, one
trainer in a closed loop.

Set-up builds the net, the processor and Adam once, loads the weights the
benchmark made from the seed, makes the pool's clips, and runs the first
``checked_steps`` steps through the window's own call on the pool's first
batches: they warm up every shape, and they are the steps the reference
follows (their target renders are kept). Each step draws its clips' target
parameters uniform on (0, 1) from one generator on the device, seeded; the
window goes on with it and with the same objects over the rest of the
pool, in order and round again; each step ends in a synchronize. A traced
window also opens a span round each call of kernel C's backward engine
(``kernel_c_bwd_span``).

``check`` compares with the reference started from the same weights on the
same clips and parameters, each of its steps taking the effect and the loss
at the program's estimate (``reference/blind.py`` ``train_steps`` says
why). Held to the cell's limits: the target renders' largest gap over their
peak (kernel C's forward); the first estimate's largest gap (the net's
forward); the first step's loss (relative gap); the largest gap of the
loss's gradient in the estimate over the checked steps (kernel C's
backward); the median leaf's gap between the norms of its first gradient
as Adam got it (the net's backward); the median leaf's gap between the
norms of its change over the checked steps (Adam); the median gap between
the norms of BatchNorm's running statistics' change (``style_train.
compare``, which reports the rest beside them).
"""

import contextlib
import time

import numpy as np
import torch

from h100bench.drivers.style_train import _stats_change, compare, free_program, readings
from h100bench.reference import blind as ref
from h100bench.work import audio
from h100bench.work.blind import frac_delay_bwd_work
from h100bench.work.device import sync
from h100bench.work.trace import PREFIX
from h100bench.work.weights import make_weights

# the names make_weights draws a dense layer's and a convolution's scales by
NET = "net."


def _make_pool(cfg, mix, seed, device):
    """``mix["pool"]`` batches of clean clips (host generator, then one
    copy), (pool, bs, 1, T) on the device."""
    bs, n, pool = mix["batch"], mix["clip_samples"], mix["pool"]
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(audio.synthetic_batch(rng, bs * pool, n, cfg["sample_rate"], mix["kind"]))
    return clips.to(device).view(pool, bs, 1, n)


def make_net_weights(cfg, seed, device):
    """The net's weights from the seed (He-normal convolutions, a LeCun-normal
    head, small biases, BatchNorm scales near 1), keyed as its state dict."""
    shapes = {NET + k: s for k, s in ref.param_shapes(cfg["net"]).items()}
    w = make_weights(shapes, torch.Generator(device=device).manual_seed(seed + 1), device)
    return {k[len(NET):]: v for k, v in w.items()}


class _Recorder:
    """The processor, keeping of each call made without a gradient its
    output (a step's target render), and of each call on an estimate that
    needs one the estimate and the loss's gradient in it as the step's
    backward gives it."""

    def __init__(self, proc):
        self.proc, self.targets, self.estimates, self.grads = proc, [], [], []

    def process_normalized(self, x, params, **kwargs):
        y = self.proc.process_normalized(x, params, **kwargs)
        if not torch.is_grad_enabled():
            self.targets.append(y.detach().clone())
        elif params.requires_grad:
            self.estimates.append(params.detach().clone())
            params.register_hook(lambda g: self.grads.append(g.detach().clone()))
        return y


def _processor(cfg):
    from dasp_tpu_torch import modules as M

    p = cfg["processor"]
    return M.PitchShift(cfg["sample_rate"], p["semitones"][0], p["semitones"][1], p["mix"][0], p["mix"][1],
                        window_ms=p["window_ms"])


def setup(cfg, cell, seed, device, program=None):
    from dasp_tpu_torch import train as T

    program = program or T
    mix = cell["mix"]
    proc = _processor(cfg)
    net, opt = T.make_blind_estimation(proc, device=device)
    weights = make_net_weights(cfg, seed, device)
    missing, unexpected = net.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in missing):
        raise RuntimeError(f"the net's weights differ from the configuration: {missing} {unexpected}")
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    state = {"net": net, "proc": proc, "opt": opt, "pool": _make_pool(cfg, mix, seed, device), "gen": gen,
             "cfg": cfg, "mix": mix, "step": program.blind_estimation_step,
             "weights0": {k: v.clone() for k, v in weights.items()}, "rand": []}
    beta1 = opt.param_groups[0]["betas"][0]
    names = [k for k, _ in net.named_parameters()]
    rec = _Recorder(proc)
    losses = []
    for i in range(mix["checked_steps"]):
        rand = _draw(state)
        state["rand"].append(rand.clone())
        losses.append(float(state["step"](net, rec, opt, state["pool"][i], rand)[0]))
        if i == 0:  # the gradient as Adam got it: its first moment over 1 - beta1
            grad_norms = {k: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"])) / (1 - beta1)
                          for k, p in zip(names, net.parameters())}
    change_norms = {k: float(torch.linalg.vector_norm(p.detach() - state["weights0"][k]))
                    for k, p in zip(names, net.parameters())}
    state["readings"] = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms,
                         "stats_norms": _stats_change(dict(net.named_buffers())), "targets": rec.targets,
                         "estimates": rec.estimates, "effect_grads": rec.grads}
    state["next"] = mix["checked_steps"]
    return state


def _draw(state):
    """One step's target parameters, (bs, num_params) uniform on (0, 1)."""
    bs = state["mix"]["batch"]
    return torch.rand((bs, state["cfg"]["net"]["num_params"]), generator=state["gen"], device=state["gen"].device)


@contextlib.contextmanager
def _wrapped_backward(wrap):
    """Inside the block, each of kernel C's backward engines (plain and
    CUDA) runs ``wrap(backward)`` in place of its ``backward``."""
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    engines = (FK._PlainEngine, FK._CudaEngine)
    saved = [E.backward for E in engines]
    for E, bwd in zip(engines, saved):
        E.backward = staticmethod(wrap(bwd))
    try:
        yield
    finally:
        for E, bwd in zip(engines, saved):
            E.backward = staticmethod(bwd)


def kernel_c_bwd_span(tracer):
    """In a traced window, each call of kernel C's backward engine opens
    the span ``kernel_c_bwd`` on the thread that makes it, the autograd
    engine's on the card, and adds its work to the tracer's counts; so the
    trace gives the device time launched inside (``kernel_c_bwd_roofline.
    blind``). Nothing is wrapped where the program has no such engines,
    and the metric is then left out."""
    try:
        from dasp_tpu_torch.ops.frac_delay_kernel import _CudaEngine, _PlainEngine  # noqa: F401
    except ImportError:
        return contextlib.nullcontext()
    counts = tracer.work["kernel_c_bwd"]

    def spanned(bwd):
        def backward(x_ext, d_stk, g_stk, ct, B, Dm, need_dx=True):
            nbytes, ops = frac_delay_bwd_work(tuple(x_ext.shape), tuple(d_stk.shape), need_dx=bool(need_dx))
            counts[0] += 1
            counts[1] += nbytes
            counts[2] += ops
            with torch.profiler.record_function(PREFIX + "kernel_c_bwd"):
                return bwd(x_ext, d_stk, g_stk, ct, B, Dm, need_dx)
        return backward

    return _wrapped_backward(spanned)


def window(state, seconds, tracer=None):
    net, proc, opt, pool, step = state["net"], state["proc"], state["opt"], state["pool"], state["step"]
    i, losses, steps = state["next"], [], 0
    device = pool.device
    with kernel_c_bwd_span(tracer) if tracer is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            loss, _ = step(net, proc, opt, pool[i % len(pool)], _draw(state))
            losses.append(loss)
            sync(device)
            steps, i = steps + 1, i + 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"steps": steps, "window_s": elapsed, "attempted": steps, "failed": failed}


def reference(state, prec=None, fed=True) -> dict:
    """The reference's readings over the checked steps, each step's effect
    and loss taken at the program's estimate (``ref.train_steps``; with
    ``fed`` false at the reference's own), with its target renders,
    estimates and the loss's gradients in the estimate (``prec``: another
    precision than the reference's own, such as the control's)."""
    cfg, mix = state["cfg"], state["mix"]
    dev = state["pool"].device
    batches = [{"x": state["pool"][i], "rand": state["rand"][i]} for i in range(mix["checked_steps"])]
    out = ref.train_steps(state["weights0"], ref.bn_stats(cfg["net"], dev), cfg, batches, prec or ref.REFERENCE,
                          estimates=state["readings"]["estimates"] if fed else None)
    return {**readings(out["losses"], out["grads1"], out["P"], out["stats"], state["weights0"]),
            **{k: out[k] for k in ("targets", "estimates", "effect_grads")}}


def target_gap(prog, refs) -> float:
    """The largest gap between the program's target renders and the
    reference's, over the reference's peak."""
    return max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(prog, refs))


def effect_grad_gap(prog, refs) -> float:
    """The distance between the program's and the reference's gradient of
    the loss in the estimate over the reference's norm, for each parameter
    (a column over the batch) and step; the largest."""
    return max(float((a[:, k].double() - b[:, k].double()).norm() / b[:, k].double().norm())
               for a, b in zip(prog, refs) for k in range(b.shape[1]))


def _compare(prog, ref_run):
    """``style_train.compare`` of the readings, with the target renders'
    gap, the first estimate's largest gap (the estimates lie on (0, 1)) and
    the gap of the loss's gradient in the estimate."""
    got = compare(prog, ref_run)
    got["target"] = target_gap(prog["targets"], ref_run["targets"])
    gaps = [float((a.double() - b.double()).abs().max()) for a, b in zip(prog["estimates"], ref_run["estimates"])]
    got["estimate"], got["estimate_steps"] = gaps[0], max(gaps)
    got["effect_grad"] = effect_grad_gap(prog["effect_grads"], ref_run["effect_grads"])
    return got


def _free(state):
    free_program(state)
    for k in ("proc", "gen"):
        state.pop(k, None)
    if state["pool"].is_cuda:
        torch.cuda.empty_cache()


def check(state, record, limits):
    _free(state)
    got = _compare(state["readings"], reference(state))
    numbers = {k: (got[k], lim) for k, lim in limits.items()}
    return numbers, {**got.pop("info"), "not_held": {k: v for k, v in got.items() if k not in limits}}


# ---------------------------------------------------------------- faults


def unchanged_step(step):
    """The fault "a step that leaves its state unchanged": the loss and the
    gradient, then the parameters put back."""
    def broken(net, proc, opt, x, rand, **kwargs):
        saved = [p.detach().clone() for p in net.parameters()]
        out = step(net, proc, opt, x, rand, **kwargs)
        with torch.no_grad():
            for p, s in zip(net.parameters(), saved):
                p.copy_(s)
        return out
    return broken


@contextlib.contextmanager
def kernel_fault(kind: str):
    """Break kernel C inside the block, on both engines: ``"frac"``: its
    forward reads each tap at the whole part of its delay (the fractional
    part dropped; the delay's gradient passes unchanged); ``"dd"``: its
    backward's delay gradient dd scaled by 0.8."""
    from dasp_tpu_torch import functional as F

    if kind == "frac":
        orig = F.frac_delay_pallas

        def floored(x_ext, d_stk, g_stk, B, Dm, **kwargs):
            return orig(x_ext, d_stk - (d_stk - torch.floor(d_stk)).detach(), g_stk, B, Dm, **kwargs)

        F.frac_delay_pallas = floored
        try:
            yield
        finally:
            F.frac_delay_pallas = orig
    elif kind == "dd":
        def scaled(bwd):
            def backward(*args, **kwargs):
                dx, dd, dg = bwd(*args, **kwargs)
                return dx, 0.8 * dd, dg
            return backward

        with _wrapped_backward(scaled):
            yield
    else:
        raise ValueError(f"unknown kernel fault {kind!r}")


def calibrate(kind, cfg, cell, seed, device, seconds):
    """One reading of ``kind`` (see ``h100bench/calibrate.py``): "program",
    "control", "fault_unchanged", "fault_frac", "fault_dd"; and
    "program_free": the program against a reference free to make its own
    estimates, to show what feeding it the program's hides (never held)."""
    from types import SimpleNamespace

    from dasp_tpu_torch import train as T

    program = None
    if kind == "fault_unchanged":
        program = SimpleNamespace(blind_estimation_step=unchanged_step(T.blind_estimation_step))
    broken = kernel_fault(kind[len("fault_"):]) if kind in ("fault_frac", "fault_dd") else contextlib.nullcontext()
    with broken:
        state = setup(cfg, cell, seed, device, program)
    _free(state)
    r = reference(state, fed=kind != "program_free")
    got = _compare(reference(state, ref.CONTROL) if kind == "control" else state["readings"], r)
    info = got.pop("info")
    return got, info
