"""One short run of every cell on a CUDA card (``pytest -m gpu
h100bench/tests`` on the card); skips where there is none."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_and_is_correct_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(ROOT / "BENCHMARK.json") as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for i, cell in enumerate(cells):
        out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell, "--seed", str(2**31 + 77 + i),
                              "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu", line["compared"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", "stream_classic.chunk512", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
