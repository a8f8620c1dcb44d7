#!/usr/bin/env python3
"""Smoke run of dasp_tpu_torch on one CUDA GPU.

Builds the hand-written CUDA kernels from ``dasp_tpu_torch/csrc`` and drives
the port's style-transfer render at full width:

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ballistics_plain(g, aa, ar)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
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
    from dasp_tpu_torch.ops.ballistics_kernel import ballistics_pallas
    from dasp_tpu_torch.ops.iir_kernel import sosfilt_pallas

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

        sosfilt_pallas.launches = 0
        ballistics_pallas.launches = 0
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
        launches = {"A": sosfilt_pallas.launches, "B": ballistics_pallas.launches}

        print(f"[slice] launches during the {BATCHES} batches: A {launches['A']}, B {launches['B']}")
        require(launches["A"] == BATCHES, f"kernel A launched {launches['A']} times, expected {BATCHES}")
        require(launches["B"] == BATCHES, f"kernel B launched {launches['B']} times, expected {BATCHES}")
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
    launches = phase_slice(args.seed, device, card)

    a = res_a["S=6 (EQ)"]
    print(json.dumps({"kernels": [
        {"name": "sosfilt_cascade", "route": "cuda",
         "source": "dasp_tpu_torch/csrc/sosfilt_cascade.cu",
         "replaces": "dasp_tpu/ops/pallas_iir.py:84",
         "launches": launches["A"], "max_abs_err": a["err"],
         "ms": a["ms"], "plain_ms": a["plain_ms"]},
        {"name": "ballistics", "route": "cuda",
         "source": "dasp_tpu_torch/csrc/ballistics.cu",
         "replaces": "dasp_tpu/ops/pallas_ballistics.py:48",
         "launches": launches["B"], "max_abs_err": res_b["err"],
         "ms": res_b["ms"], "plain_ms": res_b["plain_ms"]},
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
