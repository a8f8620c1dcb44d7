"""Blind estimation of a pitch shifter, the port against the benchmark's
plain reference (``h100bench/reference/blind.py``), on the CPU.

The net at its published widths (16-32-64-128-128 channels, kernel 3,
dilations 1-16, a linear head to 2 parameters) on seeded weights, two
batches of 2 x 1 x 16384 synthetic clips, ``PitchShift(44100)`` on kernel
C's plain engine (float32), the default STFT loss and Adam at 1e-4. The
reference runs the net in float32, the pitch shifter's coordinates in
float32 as the kernel forms them and its reads, the wet path, the mix and
the loss in float64.

Tolerances, each from its reason (measured at these seeds in brackets):

- the target render, 1e-6 of its peak: the same coordinates, the reads
  and the mix in float32 against float64 (7.5e-8);
- the loss, 1e-5 relative: float32 against float64 sums over the STFT's
  bins (1.6e-7);
- each leaf's gradient, 0.1 of its norm as a distance: the float32 loss
  rounds its quietest bins, which the log-magnitude term weights by 1 /
  |Y|, and that moves the loss's gradient in the semitones by up to about
  4 % of its norm (1.1-2.0 % here, 7.6 % at another seed); a C-bwd with
  its delay gradient scaled by 0.8 moves them 20 %;
- BatchNorm's running statistics after one forward, 1e-5 of their largest
  value (the same float32 operations; 1.7e-7), after two steps 5e-4 (the
  second batch passes weights that the two gradients' rounding has moved
  apart; 3.6e-6 here, 4.8e-5 at another seed);
- the parameters after two Adam steps: every element within 5 x lr of the
  reference (Adam moves an element by at most about lr a step, exactly lr
  at the first, whatever its gradient, so one whose gradient is mostly
  rounding may go the other way; 2.0 x lr), and the median leaf's change
  within 0.2 of the reference's norm (0.02; a step that changes nothing
  reads 1).
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dasp_tpu_torch import functional as F  # noqa: E402
from dasp_tpu_torch import modules as M  # noqa: E402
from dasp_tpu_torch import trace  # noqa: E402
from dasp_tpu_torch import train as TR  # noqa: E402
from h100bench.reference import blind as ref  # noqa: E402
from h100bench.work import audio  # noqa: E402

with open(ROOT / "h100bench" / "configs" / "blind_pitchshift.json") as _f:
    CFG = json.load(_f)
SR, BS, T = CFG["sample_rate"], 2, 16384
LR = CFG["optimizer"]["lr"]
LEAVES = list(ref.param_shapes(CFG["net"]))
BLIND_SPANS = ("blind.step", "blind.target", "blind.net", "blind.render", "blind.loss", "blind.backward",
               "blind.optimizer")


def weights(seed: int = 7) -> dict:
    """He-normal convolutions, a LeCun-normal head, BatchNorm scales near 1,
    small shifts and biases."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, s in ref.param_shapes(CFG["net"]).items():
        z = torch.randn(s, generator=g)
        if k.endswith("weight") and "conv" in k:
            out[k] = z * math.sqrt(2.0 / (s[1] * s[2]))
        elif k.endswith("weight") and "dense" in k:
            out[k] = z * math.sqrt(1.0 / s[1])
        elif k.endswith("weight"):
            out[k] = 1.0 + 0.1 * z
        else:
            out[k] = 0.1 * z
    return out


def program(W):
    proc = M.PitchShift(SR)
    net, opt = TR.make_blind_estimation(proc, device="cpu")
    missing, unexpected = net.load_state_dict(W, strict=False)
    assert not unexpected and all(k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in missing)
    return net, proc, opt


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        W = weights()
        g = torch.Generator().manual_seed(11)
        batches = [{"x": torch.from_numpy(audio.synthetic_batch(np.random.default_rng(s), BS, T, SR)),
                    "rand": torch.rand((BS, 2), generator=g)} for s in (1, 2)]
        x, rand = batches[0]["x"], batches[0]["rand"]
        # one loss and gradient (the reference's from its first step)
        net, proc, _ = program(W)
        with torch.no_grad():
            y = proc.process_normalized(x, rand, clip_params=True)
        loss, _ = TR.blind_estimation_loss(net, proc, x, y)
        loss.backward()
        prog = {"target": y, "loss": float(loss.detach()), "grads": {k: p.grad for k, p in net.named_parameters()},
                "stats": {k: v.clone() for k, v in net.named_buffers() if not k.endswith("num_batches_tracked")}}
        one = ref.train_steps(W, ref.bn_stats(CFG["net"], "cpu"), CFG, batches[:1])
        reference = {"target": one["targets"][0], "loss": one["losses"][0], "grads": one["grads1"],
                     "stats": one["stats"]}
        # two steps
        net, proc, opt = program(W)
        for b in batches:
            TR.blind_estimation_step(net, proc, opt, b["x"], b["rand"])
        prog["P2"] = {k: p.detach() for k, p in net.named_parameters()}
        prog["stats2"] = {k: v for k, v in net.named_buffers() if not k.endswith("num_batches_tracked")}
        two = ref.train_steps(W, ref.bn_stats(CFG["net"], "cpu"), CFG, batches)
        reference["P2"], reference["stats2"] = two["P"], two["stats"]
        yield {"W": W, "prog": prog, "ref": reference, "batches": batches}
    finally:
        torch.set_num_threads(threads)


def test_target_render(runs):
    y, r = runs["prog"]["target"].double(), runs["ref"]["target"]
    assert float((y - r).abs().max()) <= 1e-6 * float(r.abs().max())


def test_loss(runs):
    a, b = runs["prog"]["loss"], runs["ref"]["loss"]
    assert abs(a - b) <= 1e-5 * abs(b), (a, b)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_of_each_leaf(runs, leaf):
    g, r = runs["prog"]["grads"][leaf].double(), runs["ref"]["grads"][leaf].double()
    assert float((g - r).norm()) <= 0.1 * float(r.norm()), leaf


@pytest.mark.parametrize("when", ["one forward", "two steps"])
def test_batch_norm_statistics(runs, when):
    key, tol = ("stats", 1e-5) if when == "one forward" else ("stats2", 5e-4)
    prog, reference = runs["prog"][key], runs["ref"][key]
    assert set(prog) == set(reference)
    for k, r in reference.items():
        assert float((prog[k] - r).abs().max()) <= tol * float(r.abs().max()), k


def test_parameters_after_two_adam_steps(runs):
    W, P, R = runs["W"], runs["prog"]["P2"], runs["ref"]["P2"]
    gaps = []
    for k, r in R.items():
        assert float((P[k] - r).abs().max()) <= 5 * LR, k
        change = float((r - W[k]).norm())
        gaps.append(abs(float((P[k] - W[k]).norm()) - change) / change)
    assert float(np.median(gaps)) <= 0.2, sorted(gaps)[-3:]


def test_blind_spans_open_once_a_step(runs):
    W, batches = runs["W"], runs["batches"]
    net, proc, opt = program(W)
    trace.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for b in batches:
                TR.blind_estimation_step(net, proc, opt, b["x"], b["rand"])
        spans = trace.snapshot()["spans"]
        assert {n: spans[n]["calls"] for n in BLIND_SPANS} == dict.fromkeys(BLIND_SPANS, 2)
        assert spans["blind.step"]["parents"] == []
        for n in BLIND_SPANS[1:]:
            assert spans[n]["parents"] == ["blind.step"], n
        assert spans["pitch_shift"]["parents"] == ["blind.render", "blind.target"]
        assert {trace.PREFIX + n for n in BLIND_SPANS} <= {e.name for e in prof.events()}
    finally:
        trace.reset()


def test_frac_delay_call_counts_each_contraction_on_either_adjoint():
    x = torch.randn((1, 1, 1024), generator=torch.Generator().manual_seed(3))
    d = torch.full((1, 1, 1024), 10.5)
    trace.reset()
    try:
        F._frac_delay_matmul(x, [(d, None)], 16.0, 256, adjoint="pallas")
        F._frac_delay_matmul(x, [(d, None)], 16.0, 256, adjoint="ad")
        assert trace.snapshot()["counts"] == {"frac_delay.call": 2}  # the plain engine launches nothing
        F.pitch_shift(x, SR, torch.tensor([3.0]), torch.tensor([0.5]))
        F.pitch_shift(x.double(), SR, torch.tensor([3.0]), torch.tensor([0.5]))  # float64: the dense adjoint
        assert trace.snapshot()["counts"] == {"frac_delay.call": 4}
    finally:
        trace.reset()
