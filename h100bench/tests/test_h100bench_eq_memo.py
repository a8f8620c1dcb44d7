"""The reader of eq_memo_hit_share.stream: the program's counters
stream.eq_operators.hit and .miss, hits over both, on hand-made snapshots
and on the program's own counters; None where the program has none."""

import sys

import pytest
import torch

import dasp_tpu_torch.trace as T
from test_h100bench_manifest import bench, metric_module

NAME = "eq_memo_hit_share.stream"
HIT, MISS = "stream.eq_operators.hit", "stream.eq_operators.miss"


def snapshot(counts):
    return lambda: {"spans": {}, "counts": counts}


def test_declared_for_both_stream_cells():
    m = {e["name"]: e for e in bench()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == ("%", "higher", "program_counter", "chunk_ms_p95")
    assert m["layer"] == "serving: streaming.py"
    assert m["workloads"] == ["stream_classic.chunk512", "stream_classic.bs8_chunk512"]


@pytest.mark.parametrize("counts,want", [
    ({HIT: 199, MISS: 1}, 99.5),
    ({HIT: 0, MISS: 3}, 0.0),
    ({HIT: 5}, 100.0),
    ({MISS: 2, "kernel_b.forward": 40}, 0.0),
])
def test_hits_over_hits_and_misses(counts, want, monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot(counts))
    assert metric_module(NAME).read(None) == pytest.approx(want)


def test_none_without_the_counters(monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot({"kernel_b.forward": 40}))
    assert metric_module(NAME).read(None) is None
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch.trace", None)  # its import raises ImportError
    assert metric_module(NAME).read(None) is None


def test_reads_the_programs_counters():
    from dasp_tpu_torch import streaming as S

    eq = [torch.full((1,), v) for v in (2.0, 200.0, 0.7) * 6]
    x = torch.zeros((1, 2, 4 * 128))
    S._EQ_MEMO.clear()
    T.reset()
    try:
        zi = None
        for c in x.split(128, dim=-1):
            _, zi = S.parametric_eq_stream(c.contiguous(), 44100, *eq, zi=zi)
        assert metric_module(NAME).read(None) == pytest.approx(75.0)
    finally:
        S._EQ_MEMO.clear()
        T.reset()
