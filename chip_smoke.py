#!/usr/bin/env python3
"""Smoke run of dasp_tpu_torch on one CUDA GPU.

Builds the hand-written CUDA kernels from ``dasp_tpu_torch/csrc`` and drives
the port's style-transfer render and training step at full width:

  phase 0  the card: name and power limit (nvidia-smi); fails without CUDA
  phase 1  build (nvcc, sm_90a) and load the kernels; build time
  phase 2  biquad-cascade kernel (A) on the EQ's shapes (8 rows x 131072,
           6 sections) and the one-pole case (1 section), against float64
           scipy and against its plain PyTorch version
  phase 3  ballistics kernel (B) on a compressor gain curve (8 x 1 x 131072):
           bitwise equal to the plain loop, chunk-chained == one pass
  phase 4  the slice: full-width StyleTransferNet (bf16 encoder convolutions,
           eval mode) then EQ("pallas") -> Compressor("exact_pallas") ->
           NoiseShapedReverb(65536-tap IR) -> Gain on 3 batches of 8
           (input, reference) pairs of 131072 samples; launch counts, output
           checks, agreement with the plain path, per-batch latencies
  phase 5  kernel A's gradient (save-all forward + adjoint cascade) at the
           EQ's shapes (6 sections, 7 in the adjoint) and the one-pole's:
           dsos and dx against float64 autograd and the plain fp32 adjoint
  phase 6  the ballistics backward kernel (B-bwd) on a compressor gain curve:
           bitwise equal to the plain reverse loop; the gradient through
           chunk-chained evaluation against the one-pass gradient
  phase 7  the training slice: full-width StyleTransferNet (bf16 encoder,
           train mode) at bs 8 on 262144-sample clips (131072-sample halves),
           65536-tap IR: 1 warm-up and 3 timed train_step calls (corruption,
           forward + loss, backward, Adam, by CUDA events); exact launch
           counts, finite loss and gradients, parameters changed; one step's
           gradients again on the plain path (EQ "exact", compressor
           "exact") from the same weights, batch and noise

Prints one JSON line of per-kernel results, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SR = 44100
BS = 8
T = 131072
IR = 65536
BATCHES = 3
# kernel A's bound against float64 (tests/test_pallas_iir.py's bound for the
# TPU kernel), and the most it may exceed the plain version's own error by
A_BOUND = 2e-3
A_PLAIN_FACTOR = 2.0
# kernel A's gradient against float64, relative to the largest float64
# gradient (tests/test_torch_kernels.py's bounds: the gradient with respect
# to denominator coefficients is ill-conditioned in fp32)
A_GRAD_BOUND = {"dsos": 1e-2, "dx": 1e-3}
TRAIN_STEPS = 3
FULL_WIDTH_PARAMS = 10_322_246
# launches per training step: A forward in the corruption, save-all in the
# render, adjoint in the backward; B forward in the corruption and the
# render, backward once
STEP_LAUNCHES = {"sosfilt_cascade": 1, "sosfilt_cascade_save_all": 1,
                 "sosfilt_cascade_adjoint": 1, "ballistics": 2, "ballistics_bwd": 1}
# chunk-chained ballistics gradients: daa and dar are serial fp32 sums of T
# terms, which chunking re-associates; relative to sum |terms| (a few 1e-6
# measured at 131072 samples on the CPU)
CHAIN_SUM_TOL = 1e-5
# the plain-path step against the kernel path (relative)
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_TOL = 1e-2


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas

    return {
        "sosfilt_cascade": sosfilt_pallas.launches,
        "sosfilt_cascade_save_all": sosfilt_pallas.save_all_launches,
        "sosfilt_cascade_adjoint": sosfilt_pallas.adjoint_launches,
        "ballistics": ballistics_pallas.launches,
        "ballistics_bwd": ballistics_pallas.bwd_launches,
    }


def reset_launch_counts() -> None:
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas

    sosfilt_pallas.launches = sosfilt_pallas.save_all_launches = sosfilt_pallas.adjoint_launches = 0
    ballistics_pallas.launches = ballistics_pallas.bwd_launches = 0


def host_ms(fn) -> float:
    """One call of ``fn`` by the host clock, synchronized (for the plain
    loops, which launch a few small kernels per sample)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_params(proc, rng, bs, device):
    """Denormalized parameters of ``proc`` from uniform (0, 1) draws."""
    import torch

    p = torch.tensor(rng.uniform(size=(bs, proc.num_params)).astype("float32"), device=device)
    return proc.denormalize_param_dict(proc.extract_param_dict(p))


def phase_kernel_a(rng, device):
    """Kernel A against float64 scipy and the plain version, S = 6 and S = 1."""
    import numpy as np
    import scipy.signal
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import embed_first_order_sos, onepole_ba, stabilize_sos
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas, sosfilt_plain

    eq = random_params(ParametricEQ(SR), rng, BS, device)
    sos6 = stabilize_sos(F.parametric_eq_sos(BS, torch.float32, SR, *eq.values(), device=device))
    comp = random_params(Compressor(SR), rng, BS, device)
    alpha = torch.exp(-math.log(9.0) / (SR * comp["attack_ms"] / 1e3))
    sos1 = embed_first_order_sos(*onepole_ba(alpha))[:, None, :]
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)

    results = {}
    for name, sos in (("S=6 (EQ)", sos6), ("S=1 (one-pole)", sos1)):
        y_k = sosfilt_pallas(sos, x)
        y_p = sosfilt_plain(sos, x)
        torch.cuda.synchronize()
        sos64 = sos.double().cpu().numpy()
        x64 = x.double().cpu().numpy()[:, 0]
        ref = np.stack([scipy.signal.sosfilt(sos64[i], x64[i]) for i in range(BS)])
        err_k = float(np.abs(y_k.double().cpu().numpy()[:, 0] - ref).max())
        err_p = float(np.abs(y_p.double().cpu().numpy()[:, 0] - ref).max())
        diff = float((y_k - y_p).abs().max())
        ms = cuda_ms(lambda: sosfilt_pallas(sos, x), 20)
        plain_ms = cuda_ms(lambda: sosfilt_plain(sos, x), 2)
        print(f"[A {name}] kernel vs float64 {err_k:.3e} | plain vs float64 {err_p:.3e} | "
              f"kernel vs plain {diff:.3e} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(err_k <= A_BOUND, f"kernel A {name}: error {err_k:.3e} > {A_BOUND}")
        require(err_k <= A_PLAIN_FACTOR * err_p,
                f"kernel A {name}: error {err_k:.3e} > {A_PLAIN_FACTOR} x plain {err_p:.3e}")
        results[name] = {"err": err_k, "ms": ms, "plain_ms": plain_ms}
    return results


def phase_kernel_b(rng, device):
    """Kernel B on a compressor gain curve: bitwise equal to the plain loop
    (run on a CPU copy), and chunk-chained evaluation equal to one pass."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas, ballistics_plain

    comp = random_params(Compressor(SR), rng, BS, device)
    p = {k: F._param(v, BS, torch.float32, device) for k, v in comp.items()}
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    _, x_db, aa, ar = F._dynamics_common(x, SR, p["attack_ms"], p["release_ms"], 1e-8)
    g = F.static_gain_computer(x_db, p["threshold_db"], p["ratio"], p["knee_db"], "compressor").contiguous()

    y_k = ballistics_pallas(g, aa, ar)
    y_p = ballistics_plain(g.cpu(), aa.cpu(), ar.cpu())
    bitwise = torch.equal(y_k.cpu(), y_p)
    diff = float((y_k.cpu() - y_p).abs().max())

    cuts = [0, T // 3, T // 3 + T // 4 + 17, T]
    y0, parts = None, []
    for a, b in zip(cuts[:-1], cuts[1:]):
        part, (y0, _) = ballistics_pallas(g[..., a:b].contiguous(), aa, ar, y0=y0, return_yf=True)
        parts.append(part)
    chained = torch.equal(torch.cat(parts, dim=-1), y_k)

    ms = cuda_ms(lambda: ballistics_pallas(g, aa, ar), 20)
    # the plain loop launches ~5 tiny kernels per sample: one run, host clock
    plain_ms = host_ms(lambda: ballistics_plain(g, aa, ar))
    print(f"[B] kernel == plain loop bitwise: {bitwise} (max diff {diff:.3e}) | "
          f"chunk-chained == one pass bitwise: {chained} | kernel {ms:.4f} ms, "
          f"plain loop on the card {plain_ms:.1f} ms (one run, host clock)")
    require(bitwise, f"kernel B differs from the plain loop by {diff:.3e}")
    require(chained, "kernel B chunk-chained evaluation differs from one pass")
    return {"err": diff, "ms": ms, "plain_ms": plain_ms}


def phase_slice(seed, device, card):
    """The style-transfer render at full width through kernels A and B."""
    import torch

    from dasp_tpu_torch.models import StyleTransferNet, apply_style_chain, make_style_processors

    torch.manual_seed(seed)
    net = StyleTransferNet(dtype=torch.bfloat16).to(device).eval()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[slice] StyleTransferNet: {n_params} parameters, bf16 encoder convolutions, eval mode")
    procs = make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="pallas",
        compressor_smoother="exact_pallas", reverb_noise_mode="frequency",
    )
    plain = make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="exact",
        compressor_smoother="exact", reverb_noise_mode="frequency",
    )
    data_gen = torch.Generator(device=device).manual_seed(seed)
    batches_in = [
        (0.1 * torch.randn((BS, 1, T), generator=data_gen, device=device),
         0.1 * torch.randn((BS, 1, T), generator=data_gen, device=device))
        for _ in range(BATCHES)
    ]
    noise_gen = torch.Generator(device=device).manual_seed(seed + 1)

    def render(x, ref, processors, gen, marks=None):
        def mark():
            if marks is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)

        mark()
        params = net(x, ref)
        mark()
        y = processors["equalizer"].process_normalized(x, params["equalizer"], clip_params=True)
        mark()
        y = processors["compressor"].process_normalized(y, params["compressor"], clip_params=True)
        mark()
        y = processors["reverb"].process_normalized(y, params["reverb"], clip_params=True, generator=gen)
        mark()
        y = processors["gain"].process_normalized(y, params["gain"], clip_params=True)
        mark()
        return params, y

    names = ("encoder", "eq", "compressor", "reverb", "gain")
    with torch.inference_mode():
        # warm-up: cuDNN/cuFFT plans and kernel load (not counted)
        render(*batches_in[0], procs, torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()

        reset_launch_counts()
        outs, states = [], []
        for i, (x, ref) in enumerate(batches_in):
            states.append(noise_gen.get_state())
            marks = []
            params, y = render(x, ref, procs, noise_gen, marks)
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
            total = marks[0].elapsed_time(marks[-1])
            outs.append((params, y))
            print(f"[slice] batch {i}: " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
                  + f", render {total:.3f} ms | {card}")
        launches = launch_counts()

        print(f"[slice] launches during the {BATCHES} batches: {launches}")
        want = {k: BATCHES if k in ("sosfilt_cascade", "ballistics") else 0 for k in launches}
        require(launches == want, f"render launches {launches}, expected {want}")
        for params, y in outs:
            require(tuple(y.shape) == (BS, 2, T), f"output shape {tuple(y.shape)}")
            require(bool(torch.isfinite(y).all()), "non-finite output")

        # the last batch again through the plain versions, same noise
        params, y_k = outs[-1]
        x, _ = batches_in[-1]
        gen = torch.Generator(device=device)
        gen.set_state(states[-1])
        y_p = apply_style_chain(plain, x, params, generator=gen)
        torch.cuda.synchronize()
        peak = float(y_p.abs().max())
        diff = float((y_k - y_p).abs().max())
        # tolerance: kernel A's float64 bound, for each of kernel and plain,
        # relative to the signal's peak; the chain is linear in the EQ output
        # apart from the compressor's smooth gain (kernel B adds nothing:
        # it is bitwise equal to its plain loop)
        tol = 2 * A_BOUND * peak
        print(f"[slice] kernel path vs plain path: max abs diff {diff:.3e} "
              f"(tolerance {tol:.3e} = 2 x {A_BOUND} x output peak {peak:.3f})")
        require(diff <= tol, f"slice differs from the plain path by {diff:.3e} > {tol:.3e}")


def grad_errors(got, truth):
    """Max abs error of each gradient against float64, and relative to the
    largest float64 value."""
    out = {}
    for name in truth:
        err = float((got[name].double() - truth[name]).abs().max())
        out[name] = (err, err / float(truth[name].abs().max()))
    return out


def phase_adjoint_a(rng, device):
    """Kernel A's gradient: the save-all forward and the adjoint cascade."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import adjoint_sos, embed_first_order_sos, onepole_ba, stabilize_sos
    from dasp_tpu_torch.ops import iir_kernel as IK

    eq = random_params(ParametricEQ(SR), rng, BS, device)
    sos6 = stabilize_sos(F.parametric_eq_sos(BS, torch.float32, SR, *eq.values(), device=device))
    comp = random_params(Compressor(SR), rng, BS, device)
    alpha = torch.exp(-math.log(9.0) / (SR * comp["attack_ms"] / 1e3))
    sos1 = embed_first_order_sos(*onepole_ba(alpha))[:, None, :]
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    w = torch.tensor(rng.standard_normal((BS, 1, T)).astype(np.float32), device=device)

    results = {}
    for name, sos in (("S=6 (EQ)", sos6), ("S=1 (one-pole)", sos1)):
        S = sos.shape[1]
        sos = sos.contiguous()
        rows_x, rows_w = x.reshape(BS, T), w.reshape(BS, T)

        def kernel_grads():
            s_, x_ = sos.clone().requires_grad_(), x.clone().requires_grad_()
            (IK.sosfilt_pallas(s_, x_) * w).sum().backward()
            return {"dsos": s_.grad, "dx": x_.grad.reshape(BS, T)}

        before = launch_counts()
        got = kernel_grads()
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(used == {"sosfilt_cascade_save_all": 1, "sosfilt_cascade_adjoint": 1},
                f"kernel A gradient {name} launched {used}")
        dsos_p, dx_p = IK.sosfilt_rows_grad_plain(sos, rows_x, rows_w)
        plain = {"dsos": dsos_p, "dx": dx_p}
        s64, x64 = sos.double().requires_grad_(), rows_x.double().requires_grad_()
        (IK.sosfilt_rows_plain(s64, x64) * rows_w.double()).sum().backward()
        truth = {"dsos": s64.grad, "dx": x64.grad}
        e_k, e_p = grad_errors(got, truth), grad_errors(plain, truth)
        for g in truth:
            require(bool(torch.isfinite(got[g]).all()), f"kernel A gradient {name}: non-finite {g}")
            print(f"[A-adjoint {name}] {g}: kernel vs float64 {e_k[g][0]:.3e} ({e_k[g][1]:.3e} of max) | "
                  f"plain adjoint vs float64 {e_p[g][0]:.3e} ({e_p[g][1]:.3e} of max)")
            require(e_k[g][1] <= A_GRAD_BOUND[g],
                    f"kernel A gradient {name}: {g} error {e_k[g][1]:.3e} of max > {A_GRAD_BOUND[g]}")
            require(e_k[g][0] <= A_PLAIN_FACTOR * e_p[g][0],
                    f"kernel A gradient {name}: {g} error {e_k[g][0]:.3e} > {A_PLAIN_FACTOR} x plain {e_p[g][0]:.3e}")

        # the two launches alone, at the path's shapes
        inters = IK._CudaEngine.save_all(sos, rows_x)
        inters64 = IK.sosfilt_rows_plain(sos.double(), rows_x.double(), save_all=True)
        save_err = float((inters.double() - inters64).abs().max())
        adj = adjoint_sos(sos).contiguous()
        ms_save = cuda_ms(lambda: IK._CudaEngine.save_all(sos, rows_x), 20)
        ms_adj = cuda_ms(lambda: IK._CudaEngine.adjoint(adj, rows_w), 20)
        plain_save = cuda_ms(lambda: IK._PlainEngine.save_all(sos, rows_x), 2)
        plain_adj = cuda_ms(lambda: IK._PlainEngine.adjoint(adj, rows_w), 2)
        print(f"[A-adjoint {name}] save-all ({S} sections) {ms_save:.4f} ms, plain {plain_save:.4f} ms, "
              f"every section vs float64 {save_err:.3e} | adjoint ({S + 1} sections) {ms_adj:.4f} ms, "
              f"plain {plain_adj:.4f} ms")
        results[name] = {"save_all": {"err": save_err, "ms": ms_save, "plain_ms": plain_save},
                         "adjoint": {"err": e_k["dx"][0], "ms": ms_adj, "plain_ms": plain_adj}}
    return results


def phase_ballistics_bwd(rng, device):
    """Kernel B-bwd on a compressor gain curve: bitwise equal to the plain
    reverse loop (run on a CPU copy); chunk-chained gradient vs one pass."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor
    from dasp_tpu_torch.ops import ballistics_kernel as BK

    comp = random_params(Compressor(SR), rng, BS, device)
    p = {k: F._param(v, BS, torch.float32, device) for k, v in comp.items()}
    x = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    _, x_db, aa, ar = F._dynamics_common(x, SR, p["attack_ms"], p["release_ms"], 1e-8)
    g = F.static_gain_computer(x_db, p["threshold_db"], p["ratio"], p["knee_db"], "compressor").contiguous()
    aa, ar = aa.reshape(BS), ar.reshape(BS)
    y0 = -torch.rand((BS, 1), device=device)
    ct = torch.tensor(rng.standard_normal((BS, 1, T)).astype(np.float32), device=device)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (g, aa, ar, y0)]
        (fn(*leaves) * ct).sum().backward()
        return [t.grad for t in leaves]

    names = ("dg", "daa", "dar", "dy0")
    before = launch_counts()
    got = grads(lambda g_, a_, r_, y_: BK.ballistics_pallas(g_, a_, r_, y0=y_))
    after = launch_counts()
    used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    require(used == {"ballistics": 1, "ballistics_bwd": 1}, f"kernel B gradient launched {used}")

    # the plain reverse loop on a CPU copy, from the plain forward's output
    rows = [t.cpu() for t in (g.reshape(BS, T), aa, ar, y0.reshape(BS))]
    y_cpu = BK.ballistics_rows_plain(*rows)
    ref = BK.ballistics_bwd_rows_plain(y_cpu, *rows, ct.cpu().reshape(BS, T))
    ref = [ref[0].reshape(BS, 1, T), ref[1], ref[2], ref[3].reshape(BS, 1)]
    bitwise = {n: torch.equal(a.cpu(), b) for n, a, b in zip(names, got, ref)}
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, ref))
    print(f"[B-bwd] kernel == plain reverse loop bitwise: {bitwise} (max diff {diff:.3e})")
    require(all(bitwise.values()), f"kernel B-bwd differs from the plain loop: {bitwise}")

    cuts = [0, T // 3, T // 3 + T // 4 + 17, T]

    def chained(g_, a_, r_, y_):
        parts, state = [], y_
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            part, (state, _) = BK.ballistics_pallas(g_[..., lo:hi].contiguous(), a_, r_, y0=state,
                                                    return_yf=True)
            parts.append(part)
        return torch.cat(parts, dim=-1)

    chain = grads(chained)
    chain_bitwise = {n: torch.equal(a, b) for n, a, b in zip(names, chain, got)}
    chain_diff = {n: float((a - b).abs().max() / b.abs().max()) for n, a, b in zip(names, chain, got)}
    # daa and dar are serial fp32 sums of T terms, and chunking re-associates
    # them: measure against the scale of such a sum's rounding, sum |terms|
    g_rows, ct_rows, y0_rows = g.reshape(BS, T), ct.reshape(BS, T), y0.reshape(BS)
    y_rows = BK._CudaEngine.forward(g_rows, aa, ar, y0_rows)
    y_prev = torch.cat([y0_rows[:, None], y_rows[:, :-1]], dim=1).double()
    attack = g_rows < y_prev
    alpha = torch.where(attack, aa[:, None], ar[:, None]).double()
    terms = (got[0].reshape(BS, T).double() / (1.0 - alpha) * (y_prev - g_rows.double())).abs()
    sum_diff = {
        n: float(((chain[i] - got[i]).double().abs() / (terms * mask).sum(-1)).max())
        for i, n, mask in ((1, "daa", attack), (2, "dar", ~attack))
    }
    print(f"[B-bwd] chunk-chained gradient == one pass bitwise: {chain_bitwise}; "
          f"max diff relative to the peak: " + ", ".join(f"{n} {v:.3e}" for n, v in chain_diff.items())
          + "; daa, dar relative to sum |terms|: " + ", ".join(f"{n} {v:.3e}" for n, v in sum_diff.items()))
    require(chain_bitwise["dg"] and chain_bitwise["dy0"], f"chunk-chained dg / dy0 not bitwise: {chain_bitwise}")
    require(all(v <= CHAIN_SUM_TOL for v in sum_diff.values()),
            f"chunk-chained daa / dar differ by {sum_diff} of sum |terms| > {CHAIN_SUM_TOL}")

    ms = cuda_ms(lambda: BK._CudaEngine.backward(y_rows, g_rows, aa, ar, y0_rows, ct_rows), 20)
    plain_ms = host_ms(lambda: BK.ballistics_bwd_rows_plain(y_rows, g_rows, aa, ar, y0_rows, ct_rows))
    print(f"[B-bwd] kernel {ms:.4f} ms, plain reverse loop on the card {plain_ms:.1f} ms "
          f"(one run, host clock)")
    return {"err": diff, "ms": ms, "plain_ms": plain_ms}


def phase_training(seed, device, card):
    """The training slice at full width through all kernel uses."""
    import torch

    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.models import make_style_processors

    torch.manual_seed(seed)
    net, procs, opt = TR.make_style_training(SR, device=device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[train] StyleTransferNet: {n_params} parameters, bf16 encoder, train mode; "
          f"bs {BS}, clips {2 * T}, IR {IR}, Adam lr 1e-4")
    require(n_params == FULL_WIDTH_PARAMS, f"{n_params} parameters, expected {FULL_WIDTH_PARAMS}")
    plain = make_style_processors(SR, reverb_num_samples=IR, eq_filter_method="exact",
                                  compressor_smoother="exact", reverb_noise_mode="frequency")
    data_gen = torch.Generator(device=device).manual_seed(seed + 3)
    batches = [(0.25 * torch.randn((BS, 1, 2 * T), generator=data_gen, device=device),
                TR.random_corruption(data_gen, BS, procs, device)) for _ in range(TRAIN_STEPS + 2)]
    noise_gen = torch.Generator(device=device).manual_seed(seed + 4)

    loss = TR.train_step(net, procs, opt, *batches[0], generator=noise_gen)  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"warm-up loss {float(loss)}")
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}

    names = ("corrupt", "forward", "backward", "optimizer")
    reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark(_name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

        t0 = time.perf_counter()
        loss = TR.train_step(net, procs, opt, *batches[1 + i], generator=noise_gen, mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
        print(f"[train] step {i}: loss {float(loss):.6f} | " + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"step {i}: loss {float(loss)}")
        require(finite, f"step {i}: non-finite gradients")
        steps.append(total)
    launches = launch_counts()
    want = {k: TRAIN_STEPS * n for k, n in STEP_LAUNCHES.items()}
    print(f"[train] launches during the {TRAIN_STEPS} steps: {launches}")
    require(launches == want, f"training launches {launches}, expected {want}")
    changed = sum(not torch.equal(start[k], v) for k, v in net.state_dict().items() if v.is_floating_point())
    print(f"[train] {changed} of {sum(v.is_floating_point() for v in start.values())} "
          f"floating-point tensors of the state changed")
    require(changed > 0 and all(not torch.equal(start[k], p) for k, p in net.named_parameters()),
            "parameters did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    print(f"[train] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps "
          f"{mean_ms:.3f} ms) | {card}")

    # one step's gradients again, on the plain path: same weights, batch,
    # corruption output and render noise
    x, rand = batches[-1]
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    batch = TR.corrupt(procs, x, rand, generator=noise_gen)
    render_state = noise_gen.get_state()

    def grads(processors):
        net.load_state_dict(state)
        net.zero_grad(set_to_none=True)
        noise_gen.set_state(render_state)
        loss = TR.render_loss(net, processors, *batch, generator=noise_gen)
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().clone() for k, p in net.named_parameters()}

    loss_k, g_k = grads(procs)
    t0 = time.perf_counter()
    loss_p, g_p = grads(plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    net.load_state_dict(state)
    norm = lambda g: math.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))  # noqa: E731
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    gn_k, gn_p = norm(g_k), norm(g_p)
    gn_rel = abs(gn_k - gn_p) / gn_p
    leaf = max(float((g_k[k] - g_p[k]).abs().max()) for k in g_p) / gn_p
    print(f"[train] kernel path vs plain path (EQ 'exact', compressor 'exact'; plain step "
          f"{plain_s:.1f} s host clock): loss {loss_k:.6f} vs {loss_p:.6f}, rel err {loss_rel:.2e}; "
          f"grad-norm {gn_k:.6f} vs {gn_p:.6f}, rel err {gn_rel:.2e}; max grad-leaf err "
          f"{leaf:.2e} of grad-norm")
    require(loss_rel <= TRAIN_LOSS_TOL, f"loss rel err {loss_rel:.3e} > {TRAIN_LOSS_TOL}")
    require(gn_rel <= TRAIN_GRAD_NORM_TOL, f"grad-norm rel err {gn_rel:.3e} > {TRAIN_GRAD_NORM_TOL}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from dasp_tpu_torch import _build

    # fp32 DSP and fp32 references: no TF32 in matmuls or convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    log = _build.build_log()
    if log:  # ptxas -v: per kernel instantiation
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
              f"registers per thread, {spills} bytes of spills")

    rng = np.random.default_rng(args.seed)
    res_a = phase_kernel_a(rng, device)
    res_b = phase_kernel_b(rng, device)
    phase_slice(args.seed, device, card)
    res_adj = phase_adjoint_a(rng, device)
    res_bb = phase_ballistics_bwd(rng, device)
    launches = phase_training(args.seed, device, card)

    a, adj = res_a["S=6 (EQ)"], res_adj["S=6 (EQ)"]
    rows = [
        ("sosfilt_cascade", "sosfilt_cascade.cu", "dasp_tpu/ops/pallas_iir.py:84", a),
        ("sosfilt_cascade_save_all", "sosfilt_cascade_save_all.cu", "dasp_tpu/ops/pallas_iir.py:254",
         adj["save_all"]),
        ("sosfilt_cascade_adjoint", "sosfilt_cascade_adjoint.cu", "dasp_tpu/ops/pallas_iir.py:259",
         adj["adjoint"]),
        ("ballistics", "ballistics.cu", "dasp_tpu/ops/pallas_ballistics.py:48", res_b),
        ("ballistics_bwd", "ballistics_bwd.cu", "dasp_tpu/ops/pallas_ballistics.py:69", res_bb),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"dasp_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, src, tpu, r in rows
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
