"""The reader of encoder_kernel_share.render: the program's counter
kernel_e.forward over encoder.conv_layer, on hand-made snapshots and on the
program's own counters; None where the program has no kernel E or no layer
counter."""

import importlib.util
import sys

import pytest
import torch

import dasp_tpu_torch.trace as T
from test_h100bench_manifest import bench, metric_module

NAME = "encoder_kernel_share.render"
LAYER, LAUNCH = "encoder.conv_layer", "kernel_e.forward"


def snapshot(counts):
    return lambda: {"spans": {}, "counts": counts}


def test_declared_for_the_render_cell():
    m = {e["name"]: e for e in bench()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == ("%", "higher", "program_counter", "render_ms_p95")
    assert m["layer"] == "encoder: models/style.py and models/tcn.py"
    assert m["workloads"] == ["style_render.bs8"]


@pytest.mark.parametrize("counts,want", [
    ({LAYER: 400, LAUNCH: 400}, 100.0),
    ({LAYER: 40, LAUNCH: 10}, 25.0),
    ({LAYER: 40}, 0.0),
    ({LAYER: 20, LAUNCH: 20, "kernel_a.forward": 3}, 100.0),
])
def test_launches_over_layer_calls(counts, want, monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot(counts))
    assert metric_module(NAME).read(None) == pytest.approx(want)


def test_none_without_the_counter_or_the_kernel(monkeypatch):
    monkeypatch.setattr(T, "snapshot", snapshot({LAUNCH: 40}))
    assert metric_module(NAME).read(None) is None
    monkeypatch.setattr(T, "snapshot", snapshot({LAYER: 20, LAUNCH: 20}))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("tcn_kernel") else find_spec(name, *a))
    assert metric_module(NAME).read(None) is None  # a program from before kernel E
    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    monkeypatch.setitem(sys.modules, "dasp_tpu_torch", None)  # the program's import raises ImportError
    assert metric_module(NAME).read(None) is None


def test_reads_the_programs_counters():
    """On the CPU the encoder keeps the module's path: 0 launches of 4 layer calls."""
    from dasp_tpu_torch.models.tcn import TCNBlock

    blk = TCNBlock(1, 256, 7, 2, "prelu", dtype=torch.bfloat16).eval()
    T.reset()
    try:
        with torch.no_grad():
            blk(torch.zeros((1, 1, 200)))
            blk(torch.zeros((1, 1, 200)))
        assert metric_module(NAME).read(None) == 0.0
    finally:
        T.reset()
