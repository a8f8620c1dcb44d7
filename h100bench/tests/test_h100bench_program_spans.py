"""The metrics that read the program's own spans
(``dasp_tpu_torch.trace.snapshot()``), on hand-made snapshots, and the
trace's reduction naming an idle gap after the program's span."""

import sys

import pytest
import torch

import dasp_tpu_torch.trace as T
from conftest import BENCH
from h100bench.work.trace import reduce_events
from test_h100bench_manifest import bench, metric_module
from test_h100bench_trace import CUDA, Ev

# metric -> (spans summed, the span whose calls divide, the number read)
READS = {
    "host_ms.train": (["train.step"], "train.step", "host_ms"),
    "loss_ms.train": (["train.loss"], "train.loss", "device_ms"),
    "optimizer_ms.train": (["train.optimizer"], "train.optimizer", "device_ms"),
    "eq_host_ms.stream": (["stream.parametric_eq"], "stream.parametric_eq", "host_ms"),
    "eq_rebuild_host_ms.stream": (["eq.design", "iir.coupled.operators"], "stream.parametric_eq", "host_ms"),
    "comp_host_ms.stream": (["stream.compressor"], "stream.compressor", "host_ms"),
    "reverb_host_ms.stream": (["stream.reverb"], "stream.reverb", "host_ms"),
}


def table(names, per, calls=4):
    spans = {n: {"calls": 2 * calls, "host_ms": 10.0 * (i + 1), "host_self_ms": 1.0, "device_ms": 3.0 * (i + 1),
                 "parents": []} for i, n in enumerate(names)}
    spans.setdefault(per, {"calls": calls, "host_ms": 100.0, "host_self_ms": 1.0, "device_ms": 30.0,
                           "parents": []})["calls"] = calls
    return {"spans": spans, "counts": {}}


def test_the_seven_readers_are_declared_for_the_cells_that_run_their_spans():
    entries = {m["name"]: m for m in bench()["per_layer"]}
    for name in READS:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        cells = {"style_train.bs8"} if name.endswith(".train") else {"stream_classic.chunk512",
                                                                      "stream_classic.bs8_chunk512"}
        assert set(m["workloads"]) == cells, name
        assert (BENCH / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_divides_by_the_calls(name, monkeypatch):
    names, per, key = READS[name]
    snap = table(names, per)
    monkeypatch.setattr(T, "snapshot", lambda: snap)
    want = sum(snap["spans"][n][key] for n in names) / 4
    assert metric_module(name).read(None) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_none_without_its_spans(name, monkeypatch):
    names, per, key = READS[name]
    reader = metric_module(name)
    for absent in set(names) | {per}:
        snap = table(names, per)
        del snap["spans"][absent]
        monkeypatch.setattr(T, "snapshot", lambda: snap)
        assert reader.read(None) is None, absent
    if key == "device_ms":  # a run with no CUDA events
        snap = table(names, per)
        for n in names:
            snap["spans"][n]["device_ms"] = None
        monkeypatch.setattr(T, "snapshot", lambda: snap)
        assert reader.read(None) is None
    monkeypatch.setattr(T, "snapshot", lambda: {"spans": {}, "counts": {}})
    assert reader.read(None) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_none_on_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)  # its import raises ImportError
    assert metric_module(name).read(None) is None


def test_a_gap_inside_a_program_span_is_named_after_it():
    # thread 1: an aten op (20-60) launches at 30 (correlation 1) a kernel
    # running 50-100; the span dasp.stream.parametric_eq (100-600) holds the
    # host; its shadow on the device timeline (100-600) is no work; a second
    # kernel (700-800, launched at 650) ends the gap
    events = [
        Ev("h100bench.window", 0, 1000),
        Ev("aten::mm", 20, 40, corr=91),
        Ev("cudaLaunchKernel", 30, 5, corr=1),
        Ev("dasp.stream.parametric_eq", 100, 500),
        Ev("cudaLaunchKernel", 650, 5, corr=2),
        Ev("gemm", 50, 50, dev=CUDA, corr=1),
        Ev("dasp.stream.parametric_eq", 100, 500, dev=CUDA, annotation=True),
        Ev("elementwise", 700, 100, dev=CUDA, corr=2),
    ]
    out = reduce_events(events)
    assert out["busy_s"] == pytest.approx(150e-9)
    assert [n for n, _ in out["device_ops"]] == ["elementwise", "gemm"]
    assert out["idle_gaps"][0] == ["dasp.stream.parametric_eq", pytest.approx(600e-9)]


def test_the_program_snapshot_feeds_a_reader(monkeypatch):
    """The readers against the program's own table: a span opened under the
    profiler, read back per call."""
    T.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                with T.span("stream.compressor"):
                    pass
        got = metric_module("comp_host_ms.stream").read(None)
        spans = T.snapshot()["spans"]
        assert got == pytest.approx(spans["stream.compressor"]["host_ms"] / 3) and got > 0
        assert metric_module("reverb_host_ms.stream").read(None) is None
    finally:
        T.reset()
