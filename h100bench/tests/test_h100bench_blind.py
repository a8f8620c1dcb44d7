"""The blind-estimation cell (``blind_pitchshift.train``, run by
``drivers/blind_train.py``) on the CPU at a tiny size, through the harness's whole run
but the look for a card: sound, it compares within the cell's limits; with
kernel C or the step broken underneath (each fault the cell names), and
with the reference in the precision below the configuration's put in the
program's place (the control), ``correct`` comes out false. Then its
metrics' readers on hand-made runs and snapshots, and what loading the new
files loads."""

import copy
import sys
import types

import pytest
import torch

import dasp_tpu_torch.trace as T
from conftest import BENCH, load
from h100bench.drivers import blind_train
from h100bench.run import ROOT, load_json, run_cell
from h100bench.work.blind import (blind_forward_flops, frac_delay_bwd_work, frac_delay_work,
                                  pitch_shift_operands)
from h100bench.work.peaks import bound
from test_h100bench_imports import FORBIDDEN, loaded_after
from test_h100bench_manifest import bench, metric_module

CELL = "blind_pitchshift.train"
CPU = torch.device("cpu")
SEED = 2**31 + 24680  # larger than 32 signed bits hold
METRICS = ("mfu.blind", "idle_share.blind", "host_ms.blind", "effect_ms.blind", "backward_ms.blind",
           "kernel_c_roofline.blind", "kernel_c_bwd_roofline.blind", "kernel_c_share.blind", "net_ms.blind",
           "loss_ms.blind", "optimizer_ms.blind")


def tiny():
    """(cfg, cell) of the cell at a size the CPU runs in seconds: the net at
    its published widths, two clips of 16384 samples, a pool of 3."""
    cell = copy.deepcopy(load(f"workloads/{CELL}.json"))
    cell["mix"].update(batch=2, clip_samples=16384, pool=3)
    return copy.deepcopy(load(f"configs/{cell['config']}.json")), cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(program=None):
    cfg, cell = tiny()
    return run_cell(CELL, SEED, 1.0, False, CPU, bench=load_json(ROOT / "BENCHMARK.json"), cell=cell, cfg=cfg,
                    program=program)


# ---------------------------------------------------------------- the run


def test_the_cell_is_correct_and_reports_its_metrics():
    out = run()
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"setup_s", "train_steps_per_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["compared"]) == {"target", "estimate", "loss", "effect_grad", "grad", "change", "stats"}


def test_a_step_that_leaves_its_state_unchanged_is_not_correct():
    from dasp_tpu_torch import train as TR

    out = run(types.SimpleNamespace(blind_estimation_step=blind_train.unchanged_step(TR.blind_estimation_step)))
    assert not out["correct"], out["compared"]
    assert out["compared"]["change"]["value"] > out["compared"]["change"]["limit"], out["compared"]


@pytest.mark.parametrize("kind,caught_by", [("frac", "target"), ("dd", "effect_grad")])
def test_kernel_c_faults_are_not_correct(kind, caught_by):
    with blind_train.kernel_fault(kind):
        out = run()
    assert not out["correct"], out["compared"]
    assert out["compared"][caught_by]["value"] > out["compared"][caught_by]["limit"], out["compared"]


def test_kernel_faults_are_undone():
    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    before = F.frac_delay_pallas, FK._PlainEngine.backward, FK._CudaEngine.backward
    for kind in ("frac", "dd"):
        with blind_train.kernel_fault(kind):
            pass
    assert (F.frac_delay_pallas, FK._PlainEngine.backward, FK._CudaEngine.backward) == before
    with pytest.raises(ValueError):
        with blind_train.kernel_fault("other"):
            pass


def test_the_control_is_not_correct():
    cfg, cell = tiny()
    numbers, _ = blind_train.calibrate("control", cfg, cell, SEED, CPU, 1.0)
    assert any(numbers[k] > lim for k, lim in cell["limits"].items()), numbers


def test_the_free_reference_reads_the_same_numbers():
    """The reading beside the held one: the reference making its own
    estimates. Its targets and first estimate are the fed reference's (a
    step's target render and first forward do not depend on what is fed)."""
    cfg, cell = tiny()
    free, _ = blind_train.calibrate("program_free", cfg, cell, SEED, CPU, 1.0)
    fed, _ = blind_train.calibrate("program", cfg, cell, SEED, CPU, 1.0)
    assert set(cell["limits"]) <= set(free)
    assert free["target"] == fed["target"] and free["estimate"] == fed["estimate"]


# ---------------------------------------------------------------- the counts


def test_the_nets_flops_and_parameters():
    cfg = load("configs/blind_pitchshift.json")
    from h100bench.reference.blind import param_shapes

    assert sum(torch.Size(s).numel() for s in param_shapes(cfg["net"]).values()) == cfg["parameters"]
    # block 1 by hand at 16384 samples: conv0 1 -> 16 (8191 outputs), conv1 16 -> 16 (8189)
    n = 16384
    one_block = dict(cfg["net"], channels=[16], dilations=[1])
    assert blind_forward_flops(one_block, n) == 2 * 16 * 3 * 8191 + 2 * 16 * 16 * 3 * 8189 + 2 * 16 * 2


def test_kernel_c_work_at_the_cells_shapes():
    cfg, cell = load("configs/blind_pitchshift.json"), load(f"workloads/{CELL}.json")
    x_shape, d_shape = pitch_shift_operands(cfg["processor"], 16, 131072)
    assert x_shape == (16, 1, 2647 + 131072) and d_shape == (2, 16, 131072)
    assert cell["mix"]["batch"] == 16 and cell["mix"]["clip_samples"] == 131072
    fwd_bytes, fwd_ops = frac_delay_work(x_shape, d_shape)
    assert fwd_bytes == 4 * (16 * 133719 + 4 * 16 * 131072 + 16 * 131072)
    assert fwd_ops == 2 * 16 * 131072 * 11
    bwd_bytes, _ = frac_delay_bwd_work(x_shape, d_shape)
    assert bwd_bytes == fwd_bytes + 4 * 4 * 16 * 131072  # dd, dg written
    assert bound(fwd_bytes, fwd_ops)["bound_by"] == "bytes"


def test_the_operands_are_the_programs():
    """The shapes the counts assume are those pitch_shift hands the entry."""
    from dasp_tpu_torch import functional as F

    cfg = load("configs/blind_pitchshift.json")
    seen = []
    orig = F.frac_delay_pallas

    def spy(x_ext, d_stk, g_stk, B, Dm, **kw):
        seen.append((tuple(x_ext.shape), tuple(d_stk.shape), B, Dm))
        return orig(x_ext, d_stk, g_stk, B, Dm, **kw)

    F.frac_delay_pallas = spy
    try:
        F.pitch_shift(torch.zeros((3, 1, 1000)), cfg["sample_rate"], torch.zeros(3), torch.ones(3),
                      window_ms=cfg["processor"]["window_ms"])
    finally:
        F.frac_delay_pallas = orig
    x_shape, d_shape = pitch_shift_operands(cfg["processor"], 3, 1000)
    assert seen == [(x_shape, d_shape, cfg["processor"]["block"], cfg["processor"]["window_samples"] + 1)]


# ---------------------------------------------------------------- the readers


class FakeRun:
    def __init__(self, steps=40, window_s=10.0, busy_s=6.0, kernel_c_s=2e-3, calls=80):
        self.cfg, self.cell = load("configs/blind_pitchshift.json"), load(f"workloads/{CELL}.json")
        self.record = {"steps": steps, "window_s": window_s}
        self.trace = {"window_s": window_s, "busy_s": busy_s,
                      "device_s_by_span": {"kernel_c": kernel_c_s, "kernel_c_bwd": kernel_c_s}}
        # 10 us of bytes a forward call, 20 us of operations a backward call
        self.work = {"kernel_c": (calls, calls * 3.35e12 * 1e-5, 0.0),
                     "kernel_c_bwd": (calls // 2, 0.0, calls // 2 * 67e12 * 2e-5)}


def snapshot(spans=None, counts=None):
    return lambda: {"spans": spans or {}, "counts": counts or {}}


def span(calls, host_ms=None, device_ms=None):
    return {"calls": calls, "host_ms": host_ms, "host_self_ms": 0.0, "device_ms": device_ms, "parents": []}


def test_declared_for_the_new_cell_only():
    entries = {m["name"]: m for m in bench()["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "train_steps_per_s", name
        assert (BENCH / "metrics" / f"{name}.py").is_file()
    e2e = {m["name"]: m for m in bench()["end_to_end"]}
    assert e2e["train_steps_per_s"]["workloads"] == ["style_train.bs8", CELL]


def test_device_trace_readers():
    run = FakeRun()
    assert metric_module("idle_share.blind").read(run) == pytest.approx(40.0)
    assert metric_module("kernel_c_roofline.blind").read(run) == pytest.approx(100.0 * 80 * 1e-5 / 2e-3)
    flops = 3 * 16 * blind_forward_flops(run.cfg["net"], 131072)
    assert metric_module("mfu.blind").read(run) == pytest.approx(100.0 * flops * 40 / 10.0 / 495e12)
    assert metric_module("kernel_c_bwd_roofline.blind").read(run) == pytest.approx(100.0 * 40 * 2e-5 / 2e-3)
    run.trace["device_s_by_span"] = {}
    assert metric_module("kernel_c_roofline.blind").read(run) is None
    assert metric_module("kernel_c_bwd_roofline.blind").read(run) is None


def test_kernel_c_roofline_wraps_the_programs_entry():
    (mod, attr, name, work), = metric_module("kernel_c_roofline.blind").ENTRIES
    assert (mod, attr, name) == ("dasp_tpu_torch.functional", "frac_delay_pallas", "kernel_c")
    x_ext, d = torch.zeros((2, 1, 300)), torch.zeros((2, 2, 256))
    assert work(x_ext, d, d, 256, 44) == frac_delay_work((2, 1, 300), (2, 2, 256))


@pytest.mark.parametrize("name,spans,want", [
    ("host_ms.blind", {"blind.step": span(4, host_ms=100.0)}, 25.0),
    ("effect_ms.blind", {"blind.step": span(4, host_ms=100.0), "blind.target": span(4, device_ms=8.0),
                         "blind.render": span(4, device_ms=12.0)}, 5.0),
    ("backward_ms.blind", {"blind.backward": span(4, device_ms=40.0)}, 10.0),
    ("net_ms.blind", {"blind.net": span(4, device_ms=16.0)}, 4.0),
    ("loss_ms.blind", {"blind.loss": span(4, device_ms=6.0)}, 1.5),
    ("optimizer_ms.blind", {"blind.optimizer": span(4, device_ms=2.0)}, 0.5),
])
def test_span_readers_divide_by_the_calls(name, spans, want, monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot(spans))
    assert metric_module(name).read(None) == pytest.approx(want)
    for absent in spans:
        monkeypatch.setattr(T, "snapshot", snapshot({k: v for k, v in spans.items() if k != absent}))
        assert metric_module(name).read(None) is None, absent
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)  # a program without spans
    assert metric_module(name).read(None) is None


def test_kernel_c_bwd_span_wraps_the_backward_engines():
    """The traced window's span round each backward engine call: it opens
    under a profiler, counts each call's work at its shapes, passes the
    gradient through unchanged and is undone after."""
    from collections import defaultdict

    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    cfg = load("configs/blind_pitchshift.json")

    def grad():
        x = torch.linspace(-1.0, 1.0, 3000).reshape(2, 1, 1500)
        st = torch.tensor([3.0, -5.0], requires_grad=True)
        y = F.pitch_shift(x, cfg["sample_rate"], st, torch.ones(2), window_ms=cfg["processor"]["window_ms"])
        y.sum().backward()
        return st.grad

    before = FK._PlainEngine.backward, FK._CudaEngine.backward
    plain = grad()
    tracer = types.SimpleNamespace(work=defaultdict(lambda: [0, 0.0, 0.0]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with blind_train.kernel_c_bwd_span(tracer):
            spanned = grad()
    assert torch.equal(plain, spanned)
    assert (FK._PlainEngine.backward, FK._CudaEngine.backward) == before
    x_shape, d_shape = pitch_shift_operands(cfg["processor"], 2, 1500)
    assert tracer.work["kernel_c_bwd"] == [1, *frac_delay_bwd_work(x_shape, d_shape)]
    assert sum(e.name == "h100bench.kernel_c_bwd" for e in prof.events()) == 1


def test_kernel_c_bwd_work_counts_dx_where_asked():
    x_shape, d_shape = (2, 1, 300), (2, 2, 256)
    without, ops = frac_delay_bwd_work(x_shape, d_shape)
    assert frac_delay_bwd_work(x_shape, d_shape, need_dx=True) == (without + 4 * 2 * 300, ops)


@pytest.mark.parametrize("counts,want", [
    ({"frac_delay.call": 40, "kernel_c.forward": 40}, 100.0),
    ({"frac_delay.call": 40, "kernel_c.forward": 10, "kernel_c.backward": 20}, 25.0),
    ({"frac_delay.call": 40}, 0.0),
    ({"kernel_c.forward": 40}, None),  # a program without the call counter
    ({}, None),
])
def test_kernel_c_share(counts, want, monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot(counts=counts))
    got = metric_module("kernel_c_share.blind").read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_kernel_c_share_reads_the_programs_counters():
    """On the CPU the pitch shifter runs kernel C's plain engine: no launch
    of 2 contractions a step."""
    from dasp_tpu_torch import functional as F

    T.reset()
    try:
        F.pitch_shift(torch.zeros((1, 1, 512)), 44100, torch.zeros(1), torch.ones(1))
        F.pitch_shift(torch.zeros((1, 1, 512)), 44100, torch.zeros(1), torch.ones(1))
        assert metric_module("kernel_c_share.blind").read(None) == 0.0
    finally:
        T.reset()


# ---------------------------------------------------------------- imports


def test_the_new_files_load_no_jax():
    code = ("from h100bench.run import load_module, HERE\n"
            "load_module(HERE / 'drivers' / 'blind_train.py', 'd_blind')\n"
            f"for n in {METRICS!r}:\n"
            "    load_module(HERE / 'metrics' / f'{n}.py', 'm_' + n.replace('.', '_'))\n"
            "import h100bench.work.blind, dasp_tpu_torch.train")
    found = loaded_after(code)
    assert "dasp_tpu_torch" in found and not found & FORBIDDEN, found & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    found = loaded_after("import h100bench.reference.blind")
    assert not found & (FORBIDDEN | {"dasp_tpu_torch"}), found & (FORBIDDEN | {"dasp_tpu_torch"})


def test_the_configuration_states_what_the_reference_reads():
    cfg = load("configs/blind_pitchshift.json")
    from h100bench.reference.blind import CONTROL, REFERENCE, window_samples

    assert window_samples(cfg["processor"], cfg["sample_rate"]) == cfg["processor"]["window_samples"]
    # the control is one step below what the configuration states
    assert cfg["precision"]["convolutions"] == "tfloat32" and CONTROL.conv == "bf16"
    assert cfg["precision"]["effect"] == cfg["precision"]["loss"] == "float32" and CONTROL.dsp_bf16
    assert REFERENCE.conv == "fp32" and not REFERENCE.dsp_bf16
    assert cfg["reduced"] == []
