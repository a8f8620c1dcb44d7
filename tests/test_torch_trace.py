"""The port's spans and counters (``dasp_tpu_torch.trace``) on the CPU.

Off (no profiler recording) a span is one shared no-op that never enters
``record_function``; on, under ``torch.profiler.profile``, each span shows
on the profiler's events as ``dasp.<name>``, and the table of
:func:`trace.snapshot` holds its calls, host time, self time and the spans
it was opened inside. The training step, a three-stage ``StreamChain`` and
the backward of kernels A and B on their plain engines are checked against
the nesting the spans are placed for.
"""

import re
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from dasp_tpu_torch import functional as F
from dasp_tpu_torch import streaming as S
from dasp_tpu_torch import trace
from dasp_tpu_torch.ops import ballistics_kernel as BK
from dasp_tpu_torch.ops import iir_kernel as IK
from dasp_tpu_torch.train import make_style_training, random_corruption, train_step

ROOT = Path(__file__).resolve().parents[1]
SR = 44100
CPU = [torch.profiler.ProfilerActivity.CPU]
TRAIN_SPANS = ("train.step", "train.corrupt", "train.loss", "train.backward", "train.optimizer")
# span -> the spans it is opened inside, in a training step on the CPU
# (where the backward runs on the calling thread)
TRAIN_NESTING = {
    "train.corrupt": {"train.step"},
    "train.loss": {"train.step"},
    "train.backward": {"train.step"},
    "train.optimizer": {"train.step"},
    "style.net": {"train.step"},
    "style.chain": {"train.step"},
    "parametric_eq": {"train.corrupt", "style.chain"},
    "compressor": {"train.corrupt", "style.chain"},
    "noise_shaped_reverberation": {"train.corrupt", "style.chain"},
    "gain": {"style.chain"},
    "eq.design": {"parametric_eq"},
    "kernel_a.forward": {"parametric_eq"},
    "kernel_a.save_all": {"parametric_eq"},
    "kernel_b.forward": {"compressor"},
    "kernel_a.adjoint": {"train.backward"},
    "kernel_b.backward": {"train.backward"},
}


@pytest.fixture(autouse=True)
def clean_tables():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def training():
    torch.manual_seed(0)
    net, procs, opt = make_style_training(smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def step():
        x = 0.1 * torch.randn((2, 1, 2 * 1024), generator=gen)
        return train_step(net, procs, opt, x, random_corruption(gen, 2, procs), generator=gen)

    return step


def test_off_no_span_enters_record_function(training, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    loss = training()
    assert bool(torch.isfinite(loss))
    assert trace.snapshot()["spans"] == {}
    assert trace.span("a") is trace.span("b")  # one shared no-op


def test_on_the_steps_spans_reach_the_profiler_and_nest(training):
    with torch.profiler.profile(activities=CPU) as prof:
        training()
        training()
    spans = trace.snapshot()["spans"]
    for name in TRAIN_SPANS:
        assert spans[name]["calls"] == 2, name
    assert spans["train.step"]["parents"] == []
    for name, parents in TRAIN_NESTING.items():
        assert set(spans[name]["parents"]) == parents, name
    for name, s in spans.items():
        assert 0 <= s["host_self_ms"] <= s["host_ms"], name
        assert s["device_ms"] is None, name  # no CUDA on the CPU
    step = spans["train.step"]["host_ms"]
    assert sum(spans[n]["host_ms"] for n in TRAIN_SPANS[1:]) <= step
    events = {e.name: e for e in prof.events() if e.name.startswith(trace.PREFIX)}
    assert set(events) == {trace.PREFIX + n for n in spans}
    corrupt = events["dasp.train.corrupt"]
    assert corrupt.cpu_parent is not None and corrupt.cpu_parent.name == "dasp.train.step"


def test_a_stream_chain_counts_each_stage_once_a_chunk():
    bs, chunk, n = 1, 512, 3
    g = torch.Generator().manual_seed(3)
    eq = [torch.full((bs,), v) for v in (3.0, 80.0, 0.7) + (-2.0, 400.0, 1.0) * 4 + (2.0, 8000.0, 0.7)]
    comp = dict(threshold_db=-24.0, ratio=4.0, attack_ms=10.0, release_ms=60.0, knee_db=6.0, makeup_gain_db=1.0)
    rev0 = S.reverb_stream_init(SR, torch.full((bs, 12), 0.6), torch.full((bs, 12), 0.4), 0.3, g,
                                num_samples=2048, chunk_len=chunk, device="cpu")
    chain = S.StreamChain([
        ("eq", lambda c, s: S.parametric_eq_stream(c, SR, *eq, zi=s)),
        ("comp", lambda c, s: S.compressor_stream(c, SR, **comp, zi=s, smoother="exact")),
        ("rev", lambda c, s: S.reverb_stream(c, rev0 if s is None else s)),
    ])
    x = 0.1 * torch.randn((bs, 2, n * chunk), generator=g)
    st = None
    with torch.profiler.profile(activities=CPU):
        for c in x.split(chunk, dim=-1):
            _, st = chain(c.contiguous(), st)
    spans = trace.snapshot()["spans"]
    for name in ("stream.chunk", "stream.parametric_eq", "stream.compressor", "stream.reverb",
                 "eq.design", "iir.coupled.operators", "kernel_b.forward"):
        assert spans[name]["calls"] == n, name
    for stage in ("stream.parametric_eq", "stream.compressor", "stream.reverb"):
        assert spans[stage]["parents"] == ["stream.chunk"], stage
    assert spans["eq.design"]["parents"] == ["stream.parametric_eq"]
    assert spans["iir.coupled.operators"]["parents"] == ["stream.parametric_eq"]
    assert spans["kernel_b.forward"]["parents"] == ["stream.compressor"]
    rebuild = spans["eq.design"]["host_ms"] + spans["iir.coupled.operators"]["host_ms"]
    assert rebuild <= spans["stream.parametric_eq"]["host_ms"] <= spans["stream.chunk"]["host_ms"]


def test_kernel_backward_spans_on_the_plain_engines():
    g = torch.Generator().manual_seed(5)
    x = (0.25 * torch.randn((2, 1, 512), generator=g)).requires_grad_()
    sos = torch.tensor([[0.2, 0.1, 0.05, 1.0, -0.6, 0.2]]).repeat(2, 1, 1).requires_grad_()
    curve = -torch.rand((2, 1, 512), generator=g).requires_grad_()
    aa = torch.full((2,), 0.9, requires_grad=True)
    with torch.profiler.profile(activities=CPU) as prof:
        y = IK.sosfilt_pallas(sos, x)
        z = BK.ballistics_pallas(curve, aa, torch.full((2,), 0.99))
        (y.square().sum() + z.square().sum()).backward()
    spans = trace.snapshot()["spans"]
    assert {n: spans[n]["calls"] for n in ("kernel_a.save_all", "kernel_a.adjoint", "kernel_b.forward",
                                            "kernel_b.backward")} == dict.fromkeys(
        ("kernel_a.save_all", "kernel_a.adjoint", "kernel_b.forward", "kernel_b.backward"), 1)
    assert "kernel_a.forward" not in spans  # the save-all form runs when a gradient is needed
    names = {e.name for e in prof.events()}
    assert {"dasp.kernel_a.adjoint", "dasp.kernel_b.backward"} <= names
    assert trace.snapshot()["counts"] == {}  # the plain engines launch nothing


def test_count_and_reset():
    trace.count("kernel_a.forward")
    trace.count("kernel_a.forward", 2)
    trace.count("kernel_b.backward", 0)
    assert trace.snapshot()["counts"] == {"kernel_a.forward": 3, "kernel_b.backward": 0}
    with torch.profiler.profile(activities=CPU):
        with trace.span("outer"):
            pass
    assert trace.snapshot()["spans"]["outer"]["calls"] == 1
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counts": {}}
    trace.count("kernel_a.forward")  # counters count with no profiler too
    assert trace.snapshot()["counts"] == {"kernel_a.forward": 1}


def test_self_time_and_threads_keep_their_own_stacks():
    def inner():
        with trace.span("inner"):
            time.sleep(0.02)

    with torch.profiler.profile(activities=CPU):
        with trace.span("outer"):
            inner()
            worker = threading.Thread(target=inner)
            worker.start()
            worker.join()
            time.sleep(0.01)
    spans = trace.snapshot()["spans"]
    assert spans["inner"]["calls"] == 2
    assert spans["inner"]["parents"] == ["outer"]  # the worker's span opened at the root of its stack
    outer = spans["outer"]
    # outer's self time leaves out only its own thread's inner span
    assert outer["host_self_ms"] == pytest.approx(outer["host_ms"] - spans["inner"]["host_ms"] / 2, abs=8.0)
    assert outer["host_self_ms"] >= 28.0


def test_every_effect_the_jax_package_scopes_opens_a_span_of_its_name():
    jax_names = re.findall(r'@_scoped\("dasp\.(\w+)"\)', (ROOT / "dasp_tpu" / "functional.py").read_text())
    port_names = re.findall(r'@_scoped\("([\w.]+)"\)\ndef (\w+)\(', (ROOT / "dasp_tpu_torch" / "functional.py")
                            .read_text())
    assert len(jax_names) == 34
    assert all(span == fn for span, fn in port_names if span != "eq.design")
    assert {fn for _, fn in port_names} == set(jax_names) | {"parametric_eq_sos"}
    x = 0.1 * torch.randn((2, 1, 256))
    with torch.profiler.profile(activities=CPU) as prof:
        F.gain(F.distortion(x, SR, 6.0), SR, -3.0)
    assert {"dasp.gain", "dasp.distortion"} <= {e.name for e in prof.events()}
    assert trace.snapshot()["spans"]["gain"]["calls"] == 1


def test_counts_and_spans_from_many_threads_lose_no_update():
    n_threads, n = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                trace.count("kernel_b.forward")
                with trace.span("stream.chunk"):
                    pass

        with torch.profiler.profile(activities=CPU):
            workers = [threading.Thread(target=work) for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    snap = trace.snapshot()
    assert snap["counts"]["kernel_b.forward"] == n_threads * n
    assert snap["spans"]["stream.chunk"]["calls"] == n_threads * n


def test_device_time_from_event_pairs_with_events_reused(monkeypatch):
    """On the card each span records a CUDA event pair; stood in for here by
    events whose clock is a counter. Pairs resolve in order once enough are
    pending, their events are recorded again by later spans, and
    snapshot() resolves the rest."""
    made, clock = [], [0.0]

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            clock[0] += 1.0
            self.t = clock[0]

        def query(self):
            return True

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    n = 3 * trace._RESOLVE_AT + 5
    with torch.profiler.profile(activities=CPU):
        for _ in range(n):
            with trace.span("outer"):  # its pair spans the inner pair: 3 ticks
                with trace.span("inner"):  # 1 tick
                    pass
        assert len(trace._pending) < trace._RESOLVE_AT
    spans = trace.snapshot()["spans"]
    assert spans["inner"]["device_ms"] == n and spans["outer"]["device_ms"] == 3 * n
    assert len(made) <= 4 * trace._RESOLVE_AT + 4  # reused, not one pair a span
    assert trace._pending == []
