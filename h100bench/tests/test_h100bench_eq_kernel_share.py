"""The reader of eq_kernel_share.stream: the program's counter
kernel_d.forward over stream.eq_operators.hit plus .miss, on hand-made
snapshots and on the program's own counters; None where the program has
no kernel D or no memo counters."""

import importlib.util
import sys

import pytest
import torch

import dasp_tpu_torch.trace as T
from test_h100bench_manifest import bench, metric_module

NAME = "eq_kernel_share.stream"
HIT, MISS, LAUNCH = "stream.eq_operators.hit", "stream.eq_operators.miss", "kernel_d.forward"


def snapshot(counts):
    return lambda: {"spans": {}, "counts": counts}


def test_declared_for_both_stream_cells():
    m = {e["name"]: e for e in bench()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == ("%", "higher", "program_counter", "chunk_ms_p95")
    assert m["layer"] == "serving: streaming.py"
    assert m["workloads"] == ["stream_classic.chunk512", "stream_classic.bs8_chunk512"]


@pytest.mark.parametrize("counts,want", [
    ({HIT: 199, MISS: 1, LAUNCH: 200}, 100.0),
    ({HIT: 3, MISS: 1, LAUNCH: 2}, 50.0),
    ({HIT: 5}, 0.0),
    ({MISS: 2, LAUNCH: 2, "kernel_b.forward": 40}, 100.0),
])
def test_launches_over_memo_calls(counts, want, monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot(counts))
    assert metric_module(NAME).read(None) == pytest.approx(want)


def test_none_without_the_counters_or_the_kernel(monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot({LAUNCH: 40}))
    assert metric_module(NAME).read(None) is None
    monkeypatch.setattr(T, "snapshot", snapshot({HIT: 9, LAUNCH: 9}))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("iir_stream_kernel") else find_spec(name, *a))
    assert metric_module(NAME).read(None) is None  # a program from before kernel D
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)  # its import raises ImportError
    assert metric_module(NAME).read(None) is None


def test_reads_the_programs_counters():
    """On the CPU the stream keeps the block-state path: 0 launches of 4 calls."""
    from dasp_tpu_torch import streaming as S

    eq = [torch.full((1,), v) for v in (2.0, 200.0, 0.7) * 6]
    x = torch.zeros((1, 2, 4 * 128))
    S._EQ_MEMO.clear()
    T.reset()
    try:
        zi = None
        for c in x.split(128, dim=-1):
            _, zi = S.parametric_eq_stream(c.contiguous(), 44100, *eq, zi=zi)
        assert metric_module(NAME).read(None) == 0.0
    finally:
        S._EQ_MEMO.clear()
        T.reset()
