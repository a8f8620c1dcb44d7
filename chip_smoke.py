#!/usr/bin/env python3
"""Smoke run of dasp_tpu_torch on one CUDA GPU.

Builds the hand-written CUDA kernels from ``dasp_tpu_torch/csrc`` and drives
the port's style-transfer render and training step and its blind estimation
of the pitch shifter and chorus at full width:

  phase 0  the card: name and power limit (nvidia-smi); fails without CUDA
  phase 1  build (nvcc, sm_90a) and load the kernels; build time
  phase 2  biquad-cascade kernel (A, a time-parallel chunked scan) on the
           EQ's shapes (8 rows x 131072, 6 sections), at a ragged T, on the
           one-pole case (1 section) and on the EQ's hardest corner (a 20 Hz /
           Q 6 low shelf), against float64 scipy and against its plain
           PyTorch version; wrapper and kernel-only device times
  phase 3  ballistics kernel (B-fwd, speculate and verify) at 8 x 1 x 131072
           on compressor gain curves (with and without y0), the 100 / 100,
           5 / 100 and 20 / 20 ms time constants, a constant g, a step, ties
           g == y, the corruption's 262144 samples and a ragged T: bitwise
           equal to the plain loop, chunk-chained == one pass; the rounds'
           work, a call's and the kernel's device time for each
  phase 4  the slice: full-width StyleTransferNet (bf16 encoder convolutions,
           eval mode) then EQ("pallas") -> Compressor("exact_pallas") ->
           NoiseShapedReverb(65536-tap IR) -> Gain on 3 batches of 8
           (input, reference) pairs of 131072 samples; launch counts, output
           checks, agreement with the plain path, per-batch latencies
  phase 5  kernel A's gradient (save-all forward + adjoint cascade) at the
           EQ's shapes (6 sections, 7 in the adjoint), at a ragged T, the
           one-pole's and the 20 Hz / Q 6 shelf's: dsos and dx against
           float64 autograd and the plain fp32 adjoint; times of the two
           launches and of the gradient's correlations
  phase 6  the ballistics backward kernel (B-bwd, a float64 chunked scan) on
           compressor gain curves at 131072 and 262144 samples: against the
           plain reverse loop in float64 (B_BWD_TOL, and at most 2 x the
           plain fp32 loop's distance plus it), bitwise from run to run; the
           gradient through chunk-chained evaluation against float64 too
  phase 7  the training slice: full-width StyleTransferNet (bf16 encoder,
           train mode) at bs 8 on 262144-sample clips (131072-sample halves),
           65536-tap IR: 1 warm-up and 3 timed train_step calls (corruption,
           forward + loss, backward, Adam, by CUDA events); exact launch
           counts, finite loss and gradients, parameters changed; one step's
           gradients again on the plain path (EQ "exact", compressor
           "exact") from the same weights, batch and noise
  phase 8  fractional-delay kernel (C-fwd) at 8 x 131072: the blind path's
           mono pitch shifter, and at 8 x 2 x 131072 the pitch shifter
           (two wrapping taps, 60 ms window, B 256) and an LFO modulated
           delay (22 ms bound, B 512): against a float64 two-point
           reference, bitwise against its plain engine, against the dense
           plain version; ms a call and of the kernel alone, and of the
           whole effects' forward and gradient on the kernel and on the
           dense path
  phase 9  its backward (C-bwd) at the same shapes: dx, dd, dg against
           float64, the plain engine and the dense version's autograd; dd
           and dg bitwise from run to run; dx's global atomics; ms a call
           and alone, with and without dx; the reference kernel's fault
           case (a ramp with dr/dt = 20, wraps=False) against float64
  phase 10 the blind-estimation slice: the 198,354-parameter
           ParameterNetwork preset with PitchShift at bs 8 on 131072-sample
           mono clips: 1 warm-up and 3 timed steps (target render, forward
           + loss, backward, Adam, by CUDA events), exact launch counts,
           finite loss and gradients, parameters changed; one Chorus step;
           the effect's gradient with respect to a fixed p_hat three ways
           (kernel fp32, dense plain fp32, dense float64) held to bounds,
           and the net's gradients the same three ways, printed
  phase 11 the "fsm" defaults: ParametricEQ(SR) and Compressor(SR) with no
           option given (frequency sampling on cuFFT) at 8 x 2 x 131072,
           output and the gradient of mean(y ** 2) with respect to the
           normalized parameters against the same in float64 on the card:
           the compressor within 1e-4 of max(1, peak); the EQ's FIR
           application on a fixed response within it, its whole distance
           printed beside the CPU's (see phase_fsm); ms of each

Prints one JSON line of per-kernel results (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its fp32 operations over 67 TFLOP/s,
an H100 SXM's published peaks; no single PyTorch call computes any of these
functions, so ``library_ms`` is null), then as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
``python3 chip_smoke.py --time-ballistics-of DIR`` only times kernel B's two
launches of the package in the checkout DIR (see :func:`time_ballistics`),
``--time-frac-delay-of DIR`` kernel C's (see :func:`time_frac_delay`).
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
# the ragged case of kernel A: T - RAGGED samples, no multiple of the
# kernel's 32-sample chunk or 8192-sample tile
RAGGED = 1234
TRAIN_STEPS = 3
FULL_WIDTH_PARAMS = 10_322_246
# launches per training step: A forward in the corruption, save-all in the
# render, adjoint in the backward; B forward in the corruption and the
# render, backward once
STEP_LAUNCHES = {"sosfilt_cascade": 1, "sosfilt_cascade_save_all": 1,
                 "sosfilt_cascade_adjoint": 1, "ballistics": 2, "ballistics_bwd": 1}
# B-bwd (a float64 scan, each result rounded to fp32 once) against the plain
# reverse loop in float64: dg and dy0 relative to their largest value, daa
# and dar to the sum of |terms| of their branch; at most this, and at most
# 2 x the plain fp32 loop's own distance plus this. Rounding a float64 value
# to fp32 once moves it by at most 6e-8 of itself; measured on an H100 at
# 8 x 131072 and 262144: the kernel at most 5.1e-8, the plain fp32 loop
# 6.4e-7 to 1.8e-6
B_BWD_TOL = 2e-7
# the plain-path step against the kernel path (relative)
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_TOL = 1e-2
# kernel C against float64: at most 2 x the dense plain version's error plus
# these floors (forward: absolute; backward: of the largest float64 value;
# dd also off the fp32 kinks, where every fp32 version takes dd = 0).
# Measured on an H100 at 8 x 2 x 131072: forward 1.300e-4 (kernel, plain
# engine and dense alike); backward of each largest value dx 1.036e-4, dd
# 3.627e-1 at the fp32 kinks (8.3e-8 off them), dg 1.477e-4, the dense
# version within a factor 1.4 of the kernel either way
C_FWD_FLOOR = 1e-6
C_BWD_FLOOR = 1e-6
# C-bwd against its plain engine: dd and dg bitwise; dx summed by atomics
# in another order, within this fraction of dx's largest float64 value
C_BWD_DX_ENGINE_TOL = 1e-6
# the reference kernel's fault case: relative to the float64 peak
RAMP_TOL = 1e-5
# the "fsm" defaults in fp32 against float64 on the card, of max(1, peak)
# (tests/test_parity.py's bar for the reference's fixtures)
FSM_TOL = 1e-4
BLIND_PARAMS = {"PitchShift": 198_354, "Chorus": 198_612}
BLIND_STATS = 1_472
# launches per blind-estimation step: C-fwd in the target render and the
# re-render, C-bwd once; no A, no B
BLIND_STEP_LAUNCHES = {"frac_delay": 2, "frac_delay_bwd": 1}
# the effect's gradient d(stft_loss)/d(p_hat) at a fixed p_hat, for each
# parameter, relative to its float64 norm: the kernel's distance from float64
# at most 2 x the dense plain path's plus this floor, and its distance from
# the dense fp32 path at most EFFECT_GRAD_FP32_TOL. Measured on an H100 at
# full width in two runs: from float64 semitones 0.575-0.887 (kernel and
# dense alike: a sum of ~1e6 cancelling terms, each moved by the fp32 render
# error, so the float64 rule cannot tell a wrong kernel there) and mix
# 8.7e-3-7.05e-2; kernel vs dense fp32 at most 7.5e-4 and 1.2e-4, against
# 8.3e-2 and 1.2e-1 for C-bwd kernels with dd zeroed or scaled by 0.8. The net's gradient is printed only: both fp32
# paths sit one to four norms from float64 there.
EFFECT_GRAD_FLOOR = 1e-2
EFFECT_GRAD_FP32_TOL = 1e-2


# an H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes
# and fp32 operations outside the tensor cores, per second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per sample of a biquad section (5 multiplies, 4 adds)
SECTION_OPS = 9


class PhaseError(RuntimeError):
    pass


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM's rate, or operations over the
    fp32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    from dasp_tpu_torch.ops.frac_delay_kernel import frac_delay_pallas
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas

    return {
        "sosfilt_cascade": sosfilt_pallas.launches,
        "sosfilt_cascade_save_all": sosfilt_pallas.save_all_launches,
        "sosfilt_cascade_adjoint": sosfilt_pallas.adjoint_launches,
        "ballistics": ballistics_pallas.launches,
        "ballistics_bwd": ballistics_pallas.bwd_launches,
        "frac_delay": frac_delay_pallas.launches,
        "frac_delay_bwd": frac_delay_pallas.bwd_launches,
    }


def reset_launch_counts() -> None:
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas
    from dasp_tpu_torch.ops.frac_delay_kernel import frac_delay_pallas
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas

    sosfilt_pallas.launches = sosfilt_pallas.save_all_launches = sosfilt_pallas.adjoint_launches = 0
    ballistics_pallas.launches = ballistics_pallas.bwd_launches = 0
    frac_delay_pallas.launches = frac_delay_pallas.bwd_launches = 0


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


def device_ms_by_kernel(fn, kernels, reps: int, per_launch: bool = False) -> dict:
    """Device time per call of ``fn``, from a CUDA-only torch.profiler trace
    of ``reps`` calls after a warm-up: of the CUDA kernels whose name holds
    each of ``kernels`` (with ``per_launch``, per launch the trace recorded
    instead), and of all device work ("all"); None where the trace shows
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in (*kernels, "all"):
        hits = [e for e in events if name == "all" or name in e.key]
        us = sum(getattr(e, "device_time_total", 0) for e in hits)
        n = sum(e.count for e in hits) if per_launch and name != "all" else reps
        out[name] = us / n / 1e3 if us > 0 else None
        if per_launch and name != "all" and n != reps:
            print(f"[profiler] recorded {n} launches of {name} in {reps} calls")
    return out


def kernel_device_ms(fn, kernel: str, reps: int):
    """Device time of one launch of the CUDA kernel whose name holds
    ``kernel`` (``fn`` launches it once a call), the mean over the launches
    the trace recorded (see :func:`device_ms_by_kernel`)."""
    return device_ms_by_kernel(fn, (kernel,), reps, per_launch=True)[kernel]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def shelf_sos(bs, device):
    """The EQ's hardest corner (ParametricEQ's low shelf at its 20 Hz and
    Q 6 limits, +12 dB): one section whose poles lie about 2.5e-4 from the
    unit circle."""
    import torch

    from dasp_tpu_torch.ops import biquad

    b, a = biquad(*(torch.full((bs,), v, device=device) for v in (12.0, 20.0, 6.0)), SR, "low_shelf")
    return torch.cat([b, a], dim=-1)[:, None, :]


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
    ragged = x[..., : T - RAGGED].contiguous()

    results = {}
    # (name, sections, signal, time the plain version too)
    for name, sos, sig, plain_time in (("S=6 (EQ)", sos6, x, True), ("S=6 (EQ), ragged T", sos6, ragged, False),
                                       ("S=1 (one-pole)", sos1, x, True),
                                       ("S=1 (20 Hz / Q 6 shelf)", shelf_sos(BS, device), x, False)):
        n = sig.shape[-1]
        y_k = sosfilt_pallas(sos, sig)
        y_p = sosfilt_plain(sos, sig)
        torch.cuda.synchronize()
        sos64 = stabilize_sos(sos).double().cpu().numpy()
        x64 = sig.double().cpu().numpy()[:, 0]
        ref = np.stack([scipy.signal.sosfilt(sos64[i], x64[i]) for i in range(BS)])
        err_k = float(np.abs(y_k.double().cpu().numpy()[:, 0] - ref).max())
        err_p = float(np.abs(y_p.double().cpu().numpy()[:, 0] - ref).max())
        diff = float((y_k - y_p).abs().max())
        ms = cuda_ms(lambda: sosfilt_pallas(sos, sig), 20)
        dev_ms = kernel_device_ms(lambda: sosfilt_pallas(sos, sig), "sosfilt_cascade_kernel", 20)
        plain_ms = cuda_ms(lambda: sosfilt_plain(sos, sig), 2) if plain_time else None
        S = sos.shape[1]
        b = bound(2 * BS * n * 4 + sos.numel() * 4, SECTION_OPS * BS * n * S)
        print(f"[A {name}] T {n} | kernel vs float64 {err_k:.3e} | plain vs float64 {err_p:.3e} | "
              f"kernel vs plain {diff:.3e} | kernel {ms:.4f} ms a call (kernel alone {fmt_ms(dev_ms)} on the "
              f"device; bound {b['bound_ms']:.5f} ms by {b['bound_by']}), plain {fmt_ms(plain_ms)}")
        require(err_k <= A_BOUND, f"kernel A {name}: error {err_k:.3e} > {A_BOUND}")
        require(err_k <= A_PLAIN_FACTOR * err_p,
                f"kernel A {name}: error {err_k:.3e} > {A_PLAIN_FACTOR} x plain {err_p:.3e}")
        results[name] = {"err": err_k, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, **b}
    return results


def alpha_ms(ms, device):
    """The (BS,) smoothing coefficient of a time constant in ms
    (functional._dynamics_common)."""
    import torch

    return torch.exp(torch.full((BS,), -math.log(9.0) / (SR * ms / 1e3), device=device))


def compressor_curve(rng, n, device):
    """A Compressor's gain curve (BS, 1, n) and its (BS,) attack and release
    coefficients, from random parameters on 0.25 * randn."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor

    comp = random_params(Compressor(SR), rng, BS, device)
    p = {k: F._param(v, BS, torch.float32, device) for k, v in comp.items()}
    x = torch.tensor((rng.standard_normal((BS, 1, n)) * 0.25).astype(np.float32), device=device)
    _, x_db, aa, ar = F._dynamics_common(x, SR, p["attack_ms"], p["release_ms"], 1e-8)
    g = F.static_gain_computer(x_db, p["threshold_db"], p["ratio"], p["knee_db"], "compressor").contiguous()
    return g, aa.reshape(BS), ar.reshape(BS)


def with_ties(g, aa, ar):
    """g with g[n] set to y[n-1] of the plain loop (from rest) on every 7th
    sample, so the kernel's branch compares equal values there."""
    import torch

    g = g[:, 0].cpu().clone()
    aa, ar = aa.cpu(), ar.cpu()
    y_prev = torch.zeros(g.shape[0])
    for n in range(g.shape[-1]):
        if n % 7 == 3:
            g[:, n] = y_prev
        alpha = torch.where(g[:, n] < y_prev, aa, ar)
        y_prev = (1.0 - alpha) * g[:, n] + alpha * y_prev
    return g[:, None]


def work_line(work) -> str:
    """The forward's verify work, from ``ballistics_pallas.last_work``."""
    rounds, passes, rewalked = (work[..., i] for i in range(3))
    n_tiles = work.shape[0] * work.shape[1]
    return (f"rounds per tile max {int(rounds.max())} mean {float(rounds.double().mean()):.1f}, passes max "
            f"{int(passes.max())}, samples walked again {int(rewalked.sum())} ({n_tiles} tiles)")


def phase_kernel_b(rng, device):
    """Kernel B-fwd, the speculate-and-verify kernel: bitwise equal to the
    plain loop (run on a CPU copy) and chunk-chained evaluation equal to one
    pass, on compressor curves, the time-constant corners, a constant g, a
    step, ties, the corruption's length and a ragged T; the rounds' work and
    the time of each."""
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    g, aa, ar = compressor_curve(rng, T, device)
    a5, a20, a100 = (alpha_ms(v, device) for v in (5.0, 20.0, 100.0))
    const = torch.full_like(g, -6.0)
    step = torch.zeros_like(g)
    step[..., T // 3 : 2 * T // 3] = -12.0
    g2, aa2, ar2 = compressor_curve(rng, 2 * T, device)
    y0 = -12.0 * torch.rand((BS, 1), device=device)
    cases = [  # name, g, attack, release, y0
        ("compressor curve", g, aa, ar, None),
        ("compressor curve, y0", g, aa, ar, y0),
        ("100 / 100 ms", g, a100, a100, None),
        ("5 / 100 ms", g, a5, a100, None),
        ("attack = release = 20 ms", g, a20, a20, None),
        ("constant g = -6 dB", const, a5, a100, None),
        ("step 0 / -12 / 0 dB", step, a5, a100, None),
        ("ties g == y every 7th sample", with_ties(g, a5, a100).to(device), a5, a100, None),
        (f"T = {2 * T}, compressor curve", g2, aa2, ar2, None),
        (f"T = {2 * T}, 100 / 100 ms", g2, a100, a100, None),
        (f"ragged T = {T - RAGGED}", g[..., : T - RAGGED].contiguous(), aa, ar, None),
    ]
    results = {}
    for name, gc, ac, rc, y0c in cases:
        n = gc.shape[-1]
        y_k = BK.ballistics_pallas(gc, ac, rc, y0=y0c)
        work = BK.ballistics_pallas.last_work.cpu()
        rows = [t.cpu() for t in (gc, ac, rc)]
        y_p = BK.ballistics_plain(*rows, y0=None if y0c is None else y0c.cpu())
        bitwise = torch.equal(y_k.cpu(), y_p)
        diff = float((y_k.cpu() - y_p).abs().max())
        y_prev = torch.cat([torch.zeros(BS, 1, 1) if y0c is None else y0c.cpu()[..., None], y_p[..., :-1]], -1)
        ties = int((rows[0] == y_prev).sum())

        cuts = [0, n // 3, n // 3 + n // 4 + 17, n]
        state, parts = y0c, []
        for a, b in zip(cuts[:-1], cuts[1:]):
            part, (state, _) = BK.ballistics_pallas(gc[..., a:b].contiguous(), ac, rc, y0=state, return_yf=True)
            parts.append(part)
        chained = torch.equal(torch.cat(parts, dim=-1), y_k)

        call = lambda: BK.ballistics_pallas(gc, ac, rc, y0=y0c)  # noqa: E731
        ms = cuda_ms(call, 10)
        dev_ms = kernel_device_ms(call, "ballistics_kernel", 10)
        # g read, y written (the coefficients are 8 numbers each); a compare,
        # a select and one multiply-add pair per sample
        b = bound(2 * BS * n * 4, 4 * BS * n)
        print(f"[B {name}] T {n} | == plain loop bitwise: {bitwise} (max diff {diff:.3e}); chunk-chained == one "
              f"pass bitwise: {chained}; {ties} ties | {work_line(work)} | {ms:.4f} ms a call (kernel alone "
              f"{fmt_ms(dev_ms)}; bound {b['bound_ms']:.5f} ms by {b['bound_by']})")
        require(bitwise, f"kernel B {name}: differs from the plain loop by {diff:.3e}")
        require(chained, f"kernel B {name}: chunk-chained evaluation differs from one pass")
        results[name] = {"err": diff, "ms": ms, "device_ms": dev_ms, **b}

    # the plain loop launches ~5 tiny kernels per sample: one run, host clock
    plain_ms = host_ms(lambda: BK.ballistics_plain(g, aa, ar))
    print(f"[B] plain loop on the card at T {T}: {plain_ms:.1f} ms (one run, host clock)")
    results["compressor curve"]["plain_ms"] = plain_ms
    return results


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
    x_full = torch.tensor((rng.standard_normal((BS, 1, T)) * 0.25).astype(np.float32), device=device)
    w_full = torch.tensor(rng.standard_normal((BS, 1, T)).astype(np.float32), device=device)

    results = {}
    # (name, sections, samples, time the launches)
    for name, sos, n, timed in (("S=6 (EQ)", sos6, T, True), ("S=6 (EQ), ragged T", sos6, T - RAGGED, False),
                                ("S=1 (one-pole)", sos1, T, True),
                                ("S=1 (20 Hz / Q 6 shelf)", shelf_sos(BS, device), T, False)):
        S = sos.shape[1]
        sos = sos.contiguous()
        x, w = x_full[..., :n].contiguous(), w_full[..., :n].contiguous()
        rows_x, rows_w = x.reshape(BS, n), w.reshape(BS, n)

        def kernel_grads():
            s_, x_ = sos.clone().requires_grad_(), x.clone().requires_grad_()
            (IK.sosfilt_pallas(s_, x_) * w).sum().backward()
            return {"dsos": s_.grad, "dx": x_.grad.reshape(BS, n)}

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
            print(f"[A-adjoint {name}] T {n} | {g}: kernel vs float64 {e_k[g][0]:.3e} ({e_k[g][1]:.3e} of max) | "
                  f"plain adjoint vs float64 {e_p[g][0]:.3e} ({e_p[g][1]:.3e} of max)")
            require(e_k[g][1] <= A_GRAD_BOUND[g],
                    f"kernel A gradient {name}: {g} error {e_k[g][1]:.3e} of max > {A_GRAD_BOUND[g]}")
            require(e_k[g][0] <= A_PLAIN_FACTOR * e_p[g][0],
                    f"kernel A gradient {name}: {g} error {e_k[g][0]:.3e} > {A_PLAIN_FACTOR} x plain {e_p[g][0]:.3e}")

        if not timed:
            continue
        # the two launches alone, at the path's shapes
        inters = IK._CudaEngine.save_all(sos, rows_x)
        inters64 = IK.sosfilt_rows_plain(sos.double(), rows_x.double(), save_all=True)
        save_err = float((inters.double() - inters64).abs().max())
        adj = adjoint_sos(sos).contiguous()
        outs = IK._CudaEngine.adjoint(adj, rows_w)
        ms_save = cuda_ms(lambda: IK._CudaEngine.save_all(sos, rows_x), 20)
        ms_adj = cuda_ms(lambda: IK._CudaEngine.adjoint(adj, rows_w), 20)
        dev_save = kernel_device_ms(lambda: IK._CudaEngine.save_all(sos, rows_x), "sosfilt_cascade_kernel", 20)
        dev_adj = kernel_device_ms(lambda: IK._CudaEngine.adjoint(adj, rows_w), "sosfilt_cascade_kernel", 20)
        # the rest of the backward: adjoint sections, section inputs and the
        # coefficient correlations, PyTorch ops over (S, R, T)
        ms_corr = cuda_ms(lambda: IK._vjp(sos, rows_x, inters, rows_w, lambda *_: outs), 20)
        plain_save = cuda_ms(lambda: IK._PlainEngine.save_all(sos, rows_x), 2)
        plain_adj = cuda_ms(lambda: IK._PlainEngine.adjoint(adj, rows_w), 2)
        plane = BS * n * 4
        b_save = bound(plane * (1 + S) + sos.numel() * 4, SECTION_OPS * BS * n * S)
        b_adj = bound(plane * (2 + S) + adj.numel() * 4, SECTION_OPS * BS * n * (S + 1))
        print(f"[A-adjoint {name}] save-all ({S} sections) {ms_save:.4f} ms a call (kernel alone "
              f"{fmt_ms(dev_save)}; bound {b_save['bound_ms']:.5f} ms by {b_save['bound_by']}), plain "
              f"{plain_save:.4f} ms, every section vs float64 {save_err:.3e} | adjoint ({S + 1} sections) "
              f"{ms_adj:.4f} ms a call (kernel alone {fmt_ms(dev_adj)}; bound {b_adj['bound_ms']:.5f} ms by "
              f"{b_adj['bound_by']}), plain {plain_adj:.4f} ms | the gradient's correlations "
              f"(_vjp without the adjoint launch) {ms_corr:.4f} ms")
        results[name] = {"save_all": {"err": save_err, "ms": ms_save, "plain_ms": plain_save, **b_save},
                         "adjoint": {"err": e_k["dx"][0], "ms": ms_adj, "plain_ms": plain_adj, **b_adj}}
    return results


def b_bwd_errors(got, y, g, aa, ar, y0, ct):
    """B-bwd's (dg, daa, dar, dy0) on (BS, n) rows against the plain reverse
    loop run in float64 on float64 copies of the same fp32 inputs (so its
    branches are the kernel's), on CPU copies: {name: (distance of ``got``,
    distance of the plain fp32 loop, largest abs difference of ``got``)},
    the distances relative to the largest float64 value (dg, dy0) or to the
    sum of |terms| of the branch (daa, dar)."""
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    y, g, aa, ar, y0, ct = (t.cpu() for t in (y, g, aa, ar, y0, ct))
    ref = BK.ballistics_bwd_rows_plain(*(t.double() for t in (y, g, aa, ar, y0, ct)))
    plain = BK.ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct)
    y_prev = torch.cat([y0[:, None], y[:, :-1]], dim=1).double()
    attack = g.double() < y_prev
    alpha = torch.where(attack, aa[:, None], ar[:, None]).double()
    terms = (ref[0] / (1.0 - alpha) * (y_prev - g.double())).abs()
    scales = (ref[0].abs().max(), (terms * attack).sum(-1), (terms * ~attack).sum(-1), ref[3].abs().max())
    out = {}
    for i, name in enumerate(("dg", "daa", "dar", "dy0")):
        s = torch.clamp(scales[i], min=1e-300)  # a branch never taken sums nothing, exactly
        diffs = [(v[i].cpu().reshape(ref[i].shape).double() - ref[i]).abs() for v in (got, plain)]
        out[name] = (*(float((d / s).max()) for d in diffs), float(diffs[0].max()))
    return out


def check_b_bwd(what, errors):
    for name, (k, p, _) in errors.items():
        require(k <= B_BWD_TOL and k <= 2 * p + B_BWD_TOL,
                f"kernel B-bwd {what}: {name} {k:.3e} from float64 (plain fp32 loop {p:.3e}), bound {B_BWD_TOL} "
                f"and 2 x plain + {B_BWD_TOL}")


def phase_ballistics_bwd(rng, device):
    """Kernel B-bwd, the float64 chunked adjoint, on compressor gain curves
    at T and 2 T: against the plain reverse loop in float64 beside the plain
    fp32 loop's own distance; bitwise from run to run; the gradient through
    chunk-chained evaluation against the one-pass float64 gradient."""
    import numpy as np
    import torch

    from dasp_tpu_torch.ops import ballistics_kernel as BK

    names = ("dg", "daa", "dar", "dy0")
    results = {}
    for n in (T, 2 * T):
        g, aa, ar = compressor_curve(rng, n, device)
        y0 = -torch.rand((BS, 1), device=device)
        ct = torch.tensor(rng.standard_normal((BS, 1, n)).astype(np.float32), device=device)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (g, aa, ar, y0)]
            (fn(*leaves) * ct).sum().backward()
            return [t.grad for t in leaves]

        before = launch_counts()
        got = grads(lambda g_, a_, r_, y_: BK.ballistics_pallas(g_, a_, r_, y0=y_))
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(used == {"ballistics": 1, "ballistics_bwd": 1}, f"kernel B gradient launched {used}")

        rows = (g.reshape(BS, n), aa, ar, y0.reshape(BS))
        ct_rows = ct.reshape(BS, n)
        y_rows = BK._CudaEngine.forward(*rows)
        err = b_bwd_errors(got, y_rows, *rows, ct_rows)
        print(f"[B-bwd T {n}] from float64 (dg, dy0 of the largest value; daa, dar of the branch's sum |terms|): "
              + ", ".join(f"{k} kernel {v[0]:.3e} / plain fp32 loop {v[1]:.3e}" for k, v in err.items()))
        check_b_bwd(f"T {n}", err)

        runs = [BK._CudaEngine.backward(y_rows, *rows, ct_rows) for _ in range(2)]
        again = {k: torch.equal(a, b) for k, a, b in zip(names, *runs)}
        print(f"[B-bwd T {n}] run to run bitwise: {again}")
        require(all(again.values()), f"kernel B-bwd T {n}: not bitwise from run to run: {again}")

        if n == T:
            cuts = [0, n // 3, n // 3 + n // 4 + 17, n]

            def chained(g_, a_, r_, y_):
                parts, state = [], y_
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    part, (state, _) = BK.ballistics_pallas(g_[..., lo:hi].contiguous(), a_, r_, y0=state,
                                                            return_yf=True)
                    parts.append(part)
                return torch.cat(parts, dim=-1)

            chain_err = b_bwd_errors(grads(chained), y_rows, *rows, ct_rows)
            print(f"[B-bwd T {n}] chunk-chained gradient from float64: "
                  + ", ".join(f"{k} {v[0]:.3e}" for k, v in chain_err.items()))
            check_b_bwd("chunk-chained", chain_err)

        call = lambda: BK._CudaEngine.backward(y_rows, *rows, ct_rows)  # noqa: E731
        ms = cuda_ms(call, 20)
        dev_ms = kernel_device_ms(call, "ballistics_bwd_kernel", 20)
        # y, g and the cotangent read, dg written; about 6 operations a sample
        b = bound(4 * BS * n * 4, 6 * BS * n)
        print(f"[B-bwd T {n}] {ms:.4f} ms a call (kernel alone {fmt_ms(dev_ms)}; bound {b['bound_ms']:.5f} ms "
              f"by {b['bound_by']})")
        results[n] = {"err": max(v[2] for v in err.values()), "ms": ms, "device_ms": dev_ms, **b}
        if n == T:
            results[n]["plain_ms"] = host_ms(lambda: BK.ballistics_bwd_rows_plain(y_rows, *rows, ct_rows))
            print(f"[B-bwd T {n}] plain reverse loop on the card {results[n]['plain_ms']:.1f} ms "
                  f"(one run, host clock)")
    return results


def time_ballistics(tree, seed, device, card):
    """B-fwd and B-bwd of the package imported from ``tree`` (a checkout of
    this commit or of another) on inputs made from ``seed``: a call by CUDA
    events, and the kernel alone (profiler) with its data in L2 and after a
    256 MB write has evicted it, at T and 2 T, on compressor curves (attack
    and release drawn from 5-100 ms per row) and at the 100 / 100 ms corner.
    Prints one JSON line. Run two trees in turns in one chip call (parent,
    change, change, parent) to compare them on one card."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import ballistics_kernel as BK

    rng = np.random.default_rng(seed)
    flush = torch.empty(64 << 20, device=device)
    out = {}
    for n in (T, 2 * T):
        x = torch.tensor((rng.standard_normal((BS, n)) * 0.25).astype(np.float32), device=device)
        g = F.static_gain_computer(20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8)), -20.0, 4.0, 6.0,
                                   "compressor").contiguous()
        ms_drawn = torch.tensor(rng.uniform(5.0, 100.0, (2, BS)).astype(np.float32), device=device)
        ct = torch.tensor(rng.standard_normal((BS, n)).astype(np.float32), device=device)
        y0 = torch.zeros(BS, device=device)
        for case, (aa, ar) in (("curve", torch.exp(-math.log(9.0) / (SR * ms_drawn / 1e3))),
                               ("100 / 100 ms", (alpha_ms(100.0, device),) * 2)):
            y = BK._CudaEngine.forward(g, aa, ar, y0)
            row = {}
            for use, fn, name in (("fwd", lambda: BK._CudaEngine.forward(g, aa, ar, y0), "ballistics_kernel"),
                                  ("bwd", lambda: BK._CudaEngine.backward(y, g, aa, ar, y0, ct),
                                   "ballistics_bwd_kernel")):
                row[use] = {"ms": cuda_ms(fn, 5), "kernel_ms": kernel_device_ms(fn, name, 5),
                            "kernel_cold_ms": kernel_device_ms(lambda: (flush.zero_(), fn()), name, 5)}
            out[f"{case}, T {n}"] = row
            print(f"[time {tree}] {case}, T {n}: " + "; ".join(
                f"{use} {v['ms']:.4f} ms a call, kernel alone {fmt_ms(v['kernel_ms'])} (L2 warm), "
                f"{fmt_ms(v['kernel_cold_ms'])} (cold)" for use, v in row.items()) + f" | {card}")
    print(json.dumps({"tree": tree, "card": card, "ballistics": out}))


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
    want = {k: TRAIN_STEPS * STEP_LAUNCHES.get(k, 0) for k in launches}
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
    split = device_ms_by_kernel(lambda: TR.train_step(net, procs, opt, *batches[1], generator=noise_gen),
                                ("sosfilt_cascade_kernel", "ballistics_kernel", "ballistics_bwd_kernel"), 1)
    print(f"[train] device time of one step (CUDA-only profiler trace): all device work {fmt_ms(split['all'])}, "
          f"kernel A (3 uses) {fmt_ms(split['sosfilt_cascade_kernel'])}, B-fwd (2 launches) "
          f"{fmt_ms(split['ballistics_kernel'])}, B-bwd {fmt_ms(split['ballistics_bwd_kernel'])} | {card}")

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


def frac_delay_configs(rng, device):
    """The kernel's operands at the phases' shapes: (name, x_ext, d_stk,
    g_stk, B, Dm), built as pitch_shift and modulated_delay build them."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F

    x2 = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    W = F.pitch_shift_window_samples(60.0, SR)
    semitones = torch.linspace(-7.0, 7.0, BS, device=device).reshape(BS, 1, 1)
    taps = F._pitch_shift_taps(semitones, T, W)
    Dm = math.ceil(W) + 1
    configs = [
        (name, *F._frac_delay_operands(x, taps, Dm, 256), 256, Dm)
        for name, x in (("pitch shift 8x1 (blind path)", x2[:, :1].contiguous()), ("pitch shift 8x2", x2))
    ]
    rate, depth, base = (torch.full((BS, 1, 1), v, device=device) for v in (0.8, 12.0, 8.0))
    d = F._modulated_delay_samples(rate, depth, base, T, SR)
    dmax = 22.0 * SR / 1e3
    Dm = math.ceil(dmax) + 1
    configs.append(("modulated delay 8x2", *F._frac_delay_operands(x2, [(torch.clamp(d, max=dmax), None)], Dm, 512),
                    512, Dm))
    return configs


def two_point_ref64(x_ext, d_stk, g_stk, B, Dm, ct=None):
    """Linear interpolation in float64 with tile-local coordinates: output
    sample t of tile k reads x_ext[k*B + i0] and x_ext[k*B + i0 + 1] with
    r = (t - k*B + Dm) - d, i0 = floor(r), f = r - i0; lattice points
    outside the window [0, Dm + B) read zero; gain g once t - d >= 0. With
    a cotangent ``ct`` also returns (dx, dd, dg), dd = 0 where r is an
    integer (the kernels' convention at the interpolation kink)."""
    import torch

    x, d, g = (a.double() for a in (x_ext, d_stk, g_stk))
    bs, chs, _ = x.shape
    nt, _, Tp = d.shape
    W = Dm + B
    t = torch.arange(Tp, device=x.device, dtype=torch.float64)
    j = torch.remainder(t, B)
    start = t - j
    wet = x.new_zeros((bs, chs, Tp))
    grads = None if ct is None else (torch.zeros_like(x), [], [])
    for i in range(nt):
        r = (j + Dm) - d[i]
        i0 = torch.floor(r)
        f = r - i0
        mask = (t - d[i] >= 0).double()
        gv = mask * g[i]
        pts = []
        for k, w in ((i0, 1.0 - f), (i0 + 1.0, f)):
            ok = (k >= 0) & (k < W)
            pos = (start + torch.where(ok, k, torch.zeros_like(k))).long()[:, None, :].expand(bs, chs, Tp)
            pts.append((torch.gather(x, 2, pos) * ok[:, None, :], w * ok, pos))
        (x0, w0, p0), (x1, w1, p1) = pts
        interp = w0[:, None, :] * x0 + w1[:, None, :] * x1
        wet += gv[:, None, :] * interp
        if ct is not None:
            c = ct.double()
            grads[1].append(torch.where(f == 0, 0.0, -(c * gv[:, None, :] * (x1 - x0)).sum(1)))
            grads[2].append((c * mask[:, None, :] * interp).sum(1))
            for pos, w in ((p0, w0), (p1, w1)):
                grads[0].scatter_add_(2, pos, c * (gv * w)[:, None, :])
    if ct is None:
        return wet
    return wet, (grads[0], torch.stack(grads[1]), torch.stack(grads[2]))


def phase_frac_delay_fwd(configs, device, card):
    """Kernel C-fwd against float64, its plain engine and the dense plain
    version; then the whole effects on the kernel and on the dense path."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    results = {}
    with torch.no_grad():
        for name, x_ext, d, g, B, Dm in configs:
            wet_k = FK.frac_delay_pallas(x_ext, d, g, B, Dm)
            wet_e = FK.frac_delay_plain(x_ext, d, g, B, Dm)
            wet_d = F._frac_delay_tiles_ad(B, Dm, x_ext, d, g)
            ref = two_point_ref64(x_ext, d, g, B, Dm)
            torch.cuda.synchronize()
            err = {k: float((v.double() - ref).abs().max()) for k, v in
                   (("kernel", wet_k), ("engine", wet_e), ("dense", wet_d))}
            bitwise = torch.equal(wet_k, wet_e)
            call = lambda: FK.frac_delay_pallas(x_ext, d, g, B, Dm)  # noqa: E731
            ms = cuda_ms(call, 50)
            dev_ms = kernel_device_ms(call, "frac_delay_kernel", 50)
            ms_e = cuda_ms(lambda: FK.frac_delay_plain(x_ext, d, g, B, Dm), 10)
            ms_d = cuda_ms(lambda: F._frac_delay_tiles_ad(B, Dm, x_ext, d, g), 2)
            # x_ext, delays and gains read, wet written; per tap and output
            # sample about 10 operations (read position, two weights, two
            # multiply-adds, the gain)
            nbytes = 4 * (x_ext.numel() + d.numel() + g.numel() + wet_k.numel())
            b = bound(nbytes, 10 * d.shape[0] * wet_k.numel())
            print(f"[C-fwd {name}] taps {d.shape[0]}, B {B}, Dm {Dm} | vs float64: kernel {err['kernel']:.3e}, "
                  f"plain engine {err['engine']:.3e}, dense {err['dense']:.3e} (peak {float(ref.abs().max()):.3f}) | "
                  f"kernel == plain engine bitwise: {bitwise} | kernel {ms:.4f} ms a call (alone {fmt_ms(dev_ms)}; "
                  f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}), plain engine {ms_e:.4f} ms, dense {ms_d:.3f} ms "
                  f"| {card}")
            require(bitwise, f"C-fwd {name}: kernel differs from its plain engine")
            require(bool(torch.isfinite(wet_k).all()), f"C-fwd {name}: non-finite output")
            require(err["kernel"] <= 2 * err["dense"] + C_FWD_FLOOR,
                    f"C-fwd {name}: error {err['kernel']:.3e} > 2 x dense {err['dense']:.3e} + {C_FWD_FLOOR}")
            results[name] = {"err": err["kernel"], "ms": ms, "device_ms": dev_ms, "plain_ms": ms_e, "dense_ms": ms_d,
                             **b}

    # the whole effects at fdt_ab scale: forward, and the gradient of
    # mean(y ** 2) with respect to the audio and every parameter
    rng = np.random.default_rng(1)
    x = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    full = lambda v: torch.full((BS,), v, device=device)  # noqa: E731
    effects = {
        "pitch_shift": (lambda x_, st, mix, adj: F.pitch_shift(x_, SR, st, mix, adjoint=adj),
                        [torch.linspace(-7.0, 7.0, BS, device=device), full(0.7)]),
        "modulated_delay": (lambda x_, r, dp, b, m, adj: F.modulated_delay(
            x_, SR, r, dp, b, m, max_delay_ms=22.0, block=512, adjoint=adj),
            [full(0.8), full(12.0), full(8.0), full(0.7)]),
    }
    for name, (fn, params) in effects.items():
        def grad_call(adj):
            leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
            torch.mean(fn(*leaves, adj) ** 2).backward()

        times = {}
        for adj, reps in (("pallas", 20), ("ad", 2)):
            with torch.no_grad():
                fwd = cuda_ms(lambda: fn(x, *params, adj), reps)
            times[adj] = (fwd, cuda_ms(lambda: grad_call(adj), reps))
        print(f"[C effect {name} 8x2x{T}] forward: kernel path {times['pallas'][0]:.3f} ms, dense path "
              f"{times['ad'][0]:.3f} ms | gradient: kernel path {times['pallas'][1]:.3f} ms, dense path "
              f"{times['ad'][1]:.3f} ms | {card}")
    return results


def phase_frac_delay_bwd(configs, device, card):
    """Kernel C-bwd against float64, its plain engine and autograd through
    the dense plain version; dd and dg run to run; the steep ramp."""
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    gen = torch.Generator(device=device).manual_seed(11)
    results = {}
    for name, x_ext, d, g, B, Dm in configs:
        ct = torch.randn((x_ext.shape[0], x_ext.shape[1], d.shape[-1]), generator=gen, device=device)

        def autograd(fn):
            leaves = [a.clone().requires_grad_() for a in (x_ext, d, g)]
            (fn(*leaves) * ct).sum().backward()
            return [a.grad for a in leaves]

        got = autograd(lambda *a: FK.frac_delay_pallas(*a, B, Dm))
        again = autograd(lambda *a: FK.frac_delay_pallas(*a, B, Dm))
        engine = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm)
        dense = autograd(lambda *a: F._frac_delay_tiles_ad(B, Dm, *a))
        _, truth = two_point_ref64(x_ext, d, g, B, Dm, ct)
        torch.cuda.synchronize()
        # read positions that fp32 rounds onto an integer: there every fp32
        # version takes dd = 0 (the kink) where float64 may not
        t = torch.arange(d.shape[-1], device=device)
        r32 = (torch.remainder(t, B).float() + Dm) - d
        kinks = int((r32 == torch.floor(r32)).sum())
        off_kink = r32 != torch.floor(r32)
        line = []
        for i, gname in enumerate(("dx", "dd", "dg")):
            scale = float(truth[i].abs().max())
            # dd off the kinks too: there every fp32 version takes 0, which
            # sets the all-sample error of each and would hide a wrong dd
            diffs = {k: v[i].double() - truth[i] for k, v in (("kernel", got), ("engine", engine), ("dense", dense))}
            e = {k: float(v.abs().max()) / scale for k, v in diffs.items()}
            e_off = {k: float(torch.where(off_kink, v, 0.0).abs().max()) / scale if gname == "dd" else e[k]
                     for k, v in diffs.items()}
            res = float((got[i] - engine[i]).abs().max())
            run = (torch.equal(got[i], again[i]) if i else float((got[i] - again[i]).abs().max()) / scale)
            line.append(f"{gname}: kernel {e['kernel']:.3e} (off the kinks {e_off['kernel']:.3e}), plain engine "
                        f"{e['engine']:.3e}, dense {e['dense']:.3e} (off the kinks {e_off['dense']:.3e}); kernel vs "
                        f"plain engine {res:.3e} abs; run to run " + (f"bitwise {run}" if i else f"{run:.3e}"))
            require(bool(torch.isfinite(got[i]).all()), f"C-bwd {name}: non-finite {gname}")
            for what, err in (("", e), (" off the kinks", e_off)):
                require(err["kernel"] <= 2 * err["dense"] + C_BWD_FLOOR,
                        f"C-bwd {name}: {gname} error{what} {err['kernel']:.3e} > 2 x dense {err['dense']:.3e} "
                        f"+ {C_BWD_FLOOR}")
            if i:
                require(run, f"C-bwd {name}: {gname} differs from run to run")
                require(res == 0, f"C-bwd {name}: {gname} differs from the plain engine by {res:.3e}")
            else:
                require(res <= C_BWD_DX_ENGINE_TOL * scale,
                        f"C-bwd {name}: dx differs from the plain engine by {res / scale:.3e} of its largest "
                        f"value > {C_BWD_DX_ENGINE_TOL}")
        # the blind path asks for no dx: its row reports that launch, both
        # its time and its largest difference from the plain engine's dd, dg
        _, dd_k, dg_k = FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False)
        _, dd_e, dg_e = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm, need_dx=False)
        res_nodx = max(float((a - b).abs().max()) for a, b in ((dd_k, dd_e), (dg_k, dg_e)))
        require(res_nodx == 0, f"C-bwd {name}: without dx, dd/dg differ from the plain engine by {res_nodx:.3e}")
        # dx's global atomics: one per valid lattice point, tap and channel
        _, _, _, _, valid0, valid1 = FK._coords(d, B, Dm)
        atomics = int(valid0.sum() + valid1.sum()) * x_ext.shape[1]
        with_dx = lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm)  # noqa: E731
        no_dx = lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False)  # noqa: E731
        ms, ms_nodx = cuda_ms(with_dx, 50), cuda_ms(no_dx, 50)
        dev = kernel_device_ms(with_dx, "frac_delay_bwd_dx_kernel", 50)
        dev_nodx = kernel_device_ms(no_dx, "frac_delay_bwd_kernel", 50)
        ms_e = cuda_ms(lambda: FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm), 10)
        ms_e_nodx = cuda_ms(lambda: FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm, need_dx=False), 10)
        ms_d = cuda_ms(lambda: autograd(lambda *a: F._frac_delay_tiles_ad(B, Dm, *a)), 2)
        print(f"[C-bwd {name}] vs float64, of each largest value ({kinks} kinks): " + " | ".join(line))
        # without dx: x_ext, delays, gains and the cotangent read, dd and dg
        # written; about 12 operations per tap and output sample; with dx,
        # dx written too and 4 more operations
        nbytes = 4 * (x_ext.numel() + d.numel() + g.numel() + ct.numel() + dd_k.numel() + dg_k.numel())
        b_nodx = bound(nbytes, 12 * d.shape[0] * ct.numel())
        b_dx = bound(nbytes + 4 * x_ext.numel(), 16 * d.shape[0] * ct.numel())
        print(f"[C-bwd {name}] without dx: dd, dg vs plain engine {res_nodx:.3e} abs | kernel with dx ({atomics} "
              f"global atomics) {ms:.4f} ms a call (alone {fmt_ms(dev)}; bound {b_dx['bound_ms']:.5f} ms by "
              f"{b_dx['bound_by']}), without {ms_nodx:.4f} ms a call (alone {fmt_ms(dev_nodx)}; bound "
              f"{b_nodx['bound_ms']:.5f} ms by {b_nodx['bound_by']}) | plain engine {ms_e:.4f} ms with dx, "
              f"{ms_e_nodx:.4f} ms without | dense forward + autograd {ms_d:.3f} ms | {card}")
        results[name] = {"err": res_nodx, "ms": ms_nodx, "device_ms": dev_nodx, "plain_ms": ms_e_nodx, **b_nodx}

    # the reference kernel's fault: a ramp with dr/dt = 20, smooth within
    # each tile, on a quarter-sample grid (exact fp32 read positions)
    B, Dm = 128, 2560
    x = torch.randn((BS, 2, T), generator=gen, device=device) * 0.25
    j = torch.remainder(torch.arange(T, device=device), B).float()
    d = (Dm - 100.25 - 19.0 * j).expand(BS, 1, T)
    x_ext, d_stk, g_stk = F._frac_delay_operands(x, [(d, None)], Dm, B)
    wet = FK.frac_delay_pallas(x_ext, d_stk, g_stk, B, Dm, wraps=False)
    ref = two_point_ref64(x_ext, d_stk, g_stk, B, Dm)
    err = float((wet.double() - ref).abs().max() / ref.abs().max())
    print(f"[C ramp dr/dt = 20, wraps=False] kernel vs float64 {err:.3e} of the peak (bound {RAMP_TOL})")
    require(err <= RAMP_TOL, f"ramp: error {err:.3e} of the peak > {RAMP_TOL}")
    return results


def phase_blind(seed, device, card):
    """Blind estimation of the pitch shifter (and one chorus step) at full
    width through kernel C."""
    import copy

    import torch

    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.modules import Chorus, PitchShift
    from dasp_tpu_torch.utils.loss import stft_loss

    def counted(net):
        return (sum(p.numel() for p in net.parameters()),
                sum(b.numel() for n, b in net.named_buffers() if "running" in n))

    proc = PitchShift(SR)
    torch.manual_seed(seed)
    net, opt = TR.make_blind_estimation(proc, device=device)
    print(f"[blind] ParameterNetwork.blind_estimation(2): {counted(net)[0]} parameters, {counted(net)[1]} "
          f"BatchNorm statistics, train mode; PitchShift(60 ms); bs {BS} x 1 x {T}; Adam lr 1e-4")
    require(counted(net) == (BLIND_PARAMS["PitchShift"], BLIND_STATS), f"counts {counted(net)}")
    gen = torch.Generator(device=device).manual_seed(seed + 5)

    def batch(p):
        return (0.25 * torch.randn((BS, 1, T), generator=gen, device=device),
                torch.rand((BS, p.num_params), generator=gen, device=device))

    batches = [batch(proc) for _ in range(TRAIN_STEPS + 2)]
    loss, _ = TR.blind_estimation_step(net, proc, opt, *batches[0])  # warm-up
    torch.cuda.synchronize()
    require(bool(torch.isfinite(loss)), f"warm-up loss {float(loss)}")
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}

    names = ("target", "forward", "backward", "optimizer")
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
        loss, param_l1 = TR.blind_estimation_step(net, proc, opt, *batches[1 + i], mark=mark)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
        total = marks[0].elapsed_time(marks[-1])
        finite = all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
        print(f"[blind] step {i}: loss {float(loss):.6f}, param_l1 {float(param_l1):.4f} | "
              + ", ".join(f"{n} {m:.3f} ms" for n, m in zip(names, ms))
              + f", step {total:.3f} ms (host {wall:.3f} ms) | {card}")
        require(bool(torch.isfinite(loss)), f"step {i}: loss {float(loss)}")
        require(finite, f"step {i}: non-finite gradients")
        steps.append(total)
    launches = launch_counts()
    want = {k: TRAIN_STEPS * BLIND_STEP_LAUNCHES.get(k, 0) for k in launches}
    print(f"[blind] launches during the {TRAIN_STEPS} steps: {launches}")
    require(launches == want, f"blind-estimation launches {launches}, expected {want}")
    require(all(not torch.equal(start[k], p) for k, p in net.named_parameters()), "parameters did not change")
    mean_ms = sum(steps) / TRAIN_STEPS
    print(f"[blind] {1e3 / mean_ms:.4f} steps/s (CUDA events, mean of {TRAIN_STEPS} steps {mean_ms:.3f} ms) | {card}")

    # one Chorus step
    chorus = Chorus(SR)
    cnet, copt = TR.make_blind_estimation(chorus, device=device)
    require(counted(cnet) == (BLIND_PARAMS["Chorus"], BLIND_STATS), f"Chorus counts {counted(cnet)}")
    cstart = {k: p.detach().clone() for k, p in cnet.named_parameters()}
    x_c, rp_c = batch(chorus)
    reset_launch_counts()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    loss_c, _ = TR.blind_estimation_step(cnet, chorus, copt, x_c, rp_c)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[1].record()
    torch.cuda.synchronize()
    used = {k: v for k, v in launch_counts().items() if v}
    print(f"[blind] Chorus(45 ms bound) step: loss {float(loss_c):.6f}, {counted(cnet)[0]} parameters, launches "
          f"{used}, {marks[0].elapsed_time(marks[1]):.3f} ms (first step, CUDA events) | {card}")
    require(used == BLIND_STEP_LAUNCHES, f"Chorus step launches {used}")
    require(bool(torch.isfinite(loss_c)), f"Chorus loss {float(loss_c)}")
    require(all(bool(torch.isfinite(p.grad).all()) for p in cnet.parameters()), "Chorus: non-finite gradients")
    require(all(not torch.equal(cstart[k], p) for k, p in cnet.named_parameters()), "Chorus parameters did not move")

    # one step's gradients three ways, same weights and batch: kernel fp32,
    # dense plain fp32 and dense float64 (net and effect). First the
    # effect's own gradient at a fixed p_hat, which is held to bounds; then
    # the net's, which is printed only (see EFFECT_GRAD_FLOOR)
    x, rp = batches[-1]
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    # p_hat drawn from the seed, not the trained net's estimate: the net's
    # weights after the steps differ from run to run (atomics in cuDNN and in
    # C-bwd's dx), and the semitones gradient, a sum of ~1e6 cancelling
    # terms, moved with them: kernel vs dense fp32 6.2e-5 to 3.6e-2 of its
    # float64 norm over four runs on an H100
    p_hat = torch.rand((BS, proc.num_params), generator=torch.Generator(device=device).manual_seed(seed + 6),
                       device=device)

    def effect_grad(dtype, adjoint):
        xx, rr, p = x.to(dtype), rp.to(dtype), p_hat.to(dtype, copy=True).requires_grad_()
        with torch.no_grad():
            y = proc.process_normalized(xx, rr, clip_params=True, adjoint=adjoint)
        loss = stft_loss(proc.process_normalized(xx, p, clip_params=True, adjoint=adjoint), y)
        loss.backward()
        return float(loss.detach()), p.grad.double()

    def grads(dtype, adjoint):
        m = copy.deepcopy(net)
        m.load_state_dict(state)
        m.to(dtype).zero_grad(set_to_none=True)
        xx, rr = x.to(dtype), rp.to(dtype)
        with torch.no_grad():
            y = proc.process_normalized(xx, rr, clip_params=True, adjoint=adjoint)
        loss, _ = TR.blind_estimation_loss(m, proc, xx, y, adjoint=adjoint)
        loss.backward()
        return float(loss.detach()), {k: p.grad.double() for k, p in m.named_parameters()}

    for kind, fn in (("effect", effect_grad), ("net", grads)):
        before = launch_counts()
        loss_k, g_k = fn(torch.float32, "auto")
        after = launch_counts()
        require({k: after[k] - before[k] for k in after if after[k] != before[k]} == BLIND_STEP_LAUNCHES,
                f"the kernel {kind} gradient did not run through kernel C")
        loss_p, g_p = fn(torch.float32, "ad")
        loss_64, g_64 = fn(torch.float64, "ad")
        require(launch_counts() == after, "the plain paths launched a kernel")
        lerr = {k: abs(v - loss_64) / loss_64 for k, v in (("kernel", loss_k), ("plain", loss_p))}
        require(all(math.isfinite(v) for v in (loss_k, loss_p, loss_64)), f"{kind}: non-finite loss")
        if kind == "effect":
            # per parameter (column of p_hat), relative to its float64 norm
            for c, pname in enumerate(proc.param_ranges):
                n64 = float(g_64[:, c].norm())
                dist = {k: float((g[:, c] - g_64[:, c]).norm()) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
                fp32 = float((g_k[:, c] - g_p[:, c]).norm()) / n64
                print(f"[blind] d(stft_loss)/d({pname}) at a fixed p_hat, bs {BS} (float64 norm {n64:.6e}): "
                      f"distance from float64 kernel {dist['kernel']:.3e}, dense plain {dist['plain']:.3e}; "
                      f"kernel vs dense plain fp32 {fp32:.3e}")
                require(bool(torch.isfinite(g_k[:, c]).all()), f"effect gradient {pname}: non-finite")
                require(dist["kernel"] <= 2 * dist["plain"] + EFFECT_GRAD_FLOOR,
                        f"effect gradient {pname}: distance {dist['kernel']:.3e} > 2 x plain {dist['plain']:.3e} "
                        f"+ {EFFECT_GRAD_FLOOR}")
                require(fp32 <= EFFECT_GRAD_FP32_TOL,
                        f"effect gradient {pname}: kernel vs dense fp32 {fp32:.3e} > {EFFECT_GRAD_FP32_TOL}")
            print(f"[blind] effect loss {loss_k:.7f} / {loss_p:.7f} / {loss_64:.7f}, rel err kernel "
                  f"{lerr['kernel']:.3e}, plain {lerr['plain']:.3e}")
            continue
        norm = lambda g: math.sqrt(sum(float((v ** 2).sum()) for v in g.values()))  # noqa: E731
        n64 = norm(g_64)
        dist = {k: norm({n: g[n] - g_64[n] for n in g_64}) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
        nerr = {k: abs(norm(g) - n64) / n64 for k, g in (("kernel", g_k), ("plain", g_p))}
        print(f"[blind] net gradients against float64 (norm {n64:.6f}; printed only): distance kernel "
              f"{dist['kernel']:.3e}, dense plain {dist['plain']:.3e}; norm error kernel {nerr['kernel']:.3e}, "
              f"dense plain {nerr['plain']:.3e}; kernel vs dense plain fp32 "
              f"{norm({n: g_k[n] - g_p[n] for n in g_p}) / norm(g_p):.3e} of the plain norm; loss "
              f"{loss_k:.7f} / {loss_p:.7f} / {loss_64:.7f}, rel err kernel {lerr['kernel']:.3e}, "
              f"plain {lerr['plain']:.3e}")
    return launches


def phase_fsm(rng, device, card):
    """The "fsm" defaults on the card: ParametricEQ(SR) and Compressor(SR)
    with no option given, output and the gradient of mean(y ** 2) with
    respect to the normalized parameters, fp32 against float64.

    The compressor is held to FSM_TOL whole. The EQ's whole distance is
    printed beside the same fp32 function's on CPU copies (the reference's
    algorithm with another FFT library), and held to FSM_TOL where the
    rounding is the card's own: the FIR application of a fixed response H
    (the FFTs of the signal) and its gradient with respect to the signal.
    The EQ's response H = prod(rfft(b) / rfft(a)) over 262144 points, which
    the JAX package forms the same way, is ill-conditioned in fp32 near its
    resonances (a 20 Hz shelf's poles lie about 2.5e-4 from the unit
    circle): its fp32 error is printed beside the rest."""
    import numpy as np
    import torch

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import Compressor, ParametricEQ
    from dasp_tpu_torch.ops import fft_filter as FF

    def rel(a, b):
        return float((a.to(b.dtype) - b).abs().max()) / max(1.0, float(b.abs().max()))

    x = torch.tensor((rng.standard_normal((BS, 2, T)) * 0.25).astype(np.float32), device=device)
    for proc in (ParametricEQ(SR), Compressor(SR)):
        name = type(proc).__name__
        p = torch.tensor(rng.uniform(0.05, 0.95, (BS, proc.num_params)).astype(np.float32), device=device)

        def run(dtype, dev=device):
            q = p.to(dev, dtype, copy=True).requires_grad_()
            y = proc.process_normalized(x.to(dev, dtype), q, clip_params=True)
            (y ** 2).mean().backward()
            return y.detach(), q.grad

        reset_launch_counts()
        y32, g32 = run(torch.float32)
        torch.cuda.synchronize()
        used = {k: v for k, v in launch_counts().items() if v}
        y64, g64 = run(torch.float64)
        err = {"output": rel(y32, y64), "gradient": rel(g32, g64)}
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: proc.process_normalized(x, p, clip_params=True), 10)
        grad_ms = cuda_ms(lambda: run(torch.float32), 10)
        line = (f"[fsm {name}] default options, {BS}x2x{T}: fp32 vs float64 on the card, of max(1, peak): output "
                f"{err['output']:.3e}, gradient of mean(y ** 2) w.r.t. the normalized parameters "
                f"{err['gradient']:.3e}")
        require(not used, f"fsm {name}: the FSM path launched {used}")
        require(bool(torch.isfinite(y32).all()) and bool(torch.isfinite(g32).all()), f"fsm {name}: non-finite")
        gated = err
        if isinstance(proc, ParametricEQ):
            y_cpu, g_cpu = run(torch.float32, "cpu")
            d = proc.denormalize_param_dict(proc.extract_param_dict(p))
            sos = F.parametric_eq_sos(BS, torch.float32, SR, *d.values(), device=device)
            n = FF.fsm_fft_size(T)
            H = FF.fft_sosfreqz(sos, n)

            def fir(dtype):
                xx = x.to(dtype, copy=True).requires_grad_()
                y = FF.freqdomain_fir(xx, H[:, None, :].to(xx.dtype.to_complex()), n)[..., :T]
                (y ** 2).sum().backward()  # a gradient of the signal's scale
                return y.detach(), xx.grad

            (f32, dx32), (f64, dx64) = fir(torch.float32), fir(torch.float64)
            gated = {"FIR output": rel(f32, f64), "FIR gradient w.r.t. x": rel(dx32, dx64)}
            line += (f" (printed only; the same fp32 function on CPU copies: output {rel(y_cpu, y64.cpu()):.3e}, "
                     f"gradient {rel(g_cpu, g64.cpu()):.3e}; H in fp32 vs float64 of the same coefficients "
                     f"{rel(H, FF.fft_sosfreqz(sos.double(), n)):.3e} of its peak) | on a fixed H: FIR output "
                     f"{gated['FIR output']:.3e}, the gradient of sum(y ** 2) w.r.t. x {gated['FIR gradient w.r.t. x']:.3e}")
        print(line + f" (bound {FSM_TOL}) | forward {fwd_ms:.3f} ms, forward + gradient {grad_ms:.3f} ms | kernels "
              f"launched {used} | {card}")
        for what, e in gated.items():
            require(e <= FSM_TOL, f"fsm {name}: {what} {e:.3e} of max(1, peak) from float64 > {FSM_TOL}")


def time_frac_delay(tree, seed, device, card):
    """C-fwd and C-bwd (without and with dx) of the package imported from
    ``tree`` on phases 8-9's operands made from ``seed``: a call by CUDA
    events, and the kernel alone (profiler) with its data in L2 and after a
    256 MB write has evicted it. Prints one JSON line. Run two trees in
    turns in one chip call (parent, change, change, parent)."""
    import numpy as np
    import torch

    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    rng = np.random.default_rng(seed)
    flush = torch.empty(64 << 20, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, x_ext, d, g, B, Dm in frac_delay_configs(rng, device):
        ct = torch.randn((*x_ext.shape[:2], d.shape[-1]), generator=gen, device=device)
        row = {}
        for use, fn, kernel in (
                ("fwd", lambda: FK._CudaEngine.forward(x_ext, d, g, B, Dm), "frac_delay_kernel"),
                ("bwd", lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False), "frac_delay_bwd"),
                ("bwd with dx", lambda: FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm), "frac_delay_bwd")):
            row[use] = {"ms": cuda_ms(fn, 20), "kernel_ms": kernel_device_ms(fn, kernel, 20),
                        "kernel_cold_ms": kernel_device_ms(lambda: (flush.zero_(), fn()), kernel, 20)}
        out[name] = row
        print(f"[time {tree}] {name}: " + "; ".join(
            f"{use} {v['ms']:.4f} ms a call, kernel alone {fmt_ms(v['kernel_ms'])} (L2 warm), "
            f"{fmt_ms(v['kernel_cold_ms'])} (cold)" for use, v in row.items()) + f" | {card}")
    print(json.dumps({"tree": tree, "card": card, "frac_delay": out}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-ballistics-of", metavar="DIR",
                    help="only time kernel B's two launches of the package in the checkout DIR (see "
                         "time_ballistics)")
    ap.add_argument("--time-frac-delay-of", metavar="DIR",
                    help="only time kernel C's launches of the package in the checkout DIR (see time_frac_delay)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    tree = args.time_ballistics_of or args.time_frac_delay_of
    sys.path.insert(0, str(Path(tree or Path(__file__).parent).resolve()))
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
    if tree:
        timer = time_ballistics if args.time_ballistics_of else time_frac_delay
        timer(tree, args.seed, device, card)
        return 0
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
    configs = frac_delay_configs(rng, device)
    res_c = phase_frac_delay_fwd(configs, device, card)
    res_cb = phase_frac_delay_bwd(configs, device, card)
    launches.update({k: v for k, v in phase_blind(args.seed, device, card).items() if k.startswith("frac_delay")})
    phase_fsm(rng, device, card)

    a, adj = res_a["S=6 (EQ)"], res_adj["S=6 (EQ)"]
    rows = [
        ("sosfilt_cascade", "sosfilt_cascade.cu", "dasp_tpu/ops/pallas_iir.py:84", a),
        ("sosfilt_cascade_save_all", "sosfilt_cascade_save_all.cu", "dasp_tpu/ops/pallas_iir.py:254",
         adj["save_all"]),
        ("sosfilt_cascade_adjoint", "sosfilt_cascade_adjoint.cu", "dasp_tpu/ops/pallas_iir.py:259",
         adj["adjoint"]),
        ("ballistics", "ballistics.cu", "dasp_tpu/ops/pallas_ballistics.py:48", res_b["compressor curve"]),
        ("ballistics_bwd", "ballistics_bwd.cu", "dasp_tpu/ops/pallas_ballistics.py:69", res_bb[T]),
        ("frac_delay", "frac_delay.cu", "dasp_tpu/ops/pallas_interp.py:96", res_c[configs[0][0]]),
        ("frac_delay_bwd", "frac_delay_bwd.cu", "dasp_tpu/ops/pallas_interp.py:135", res_cb[configs[0][0]]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"dasp_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
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
