"""Shared pieces of the benchmark's own tests: tiny cells of each driver
that run on the CPU, and the repository's root on ``sys.path``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "h100bench"


def load(rel: str) -> dict:
    with open(BENCH / rel) as f:
        return json.load(f)


def tiny(cell_name: str):
    """(cfg, cell) of a committed cell cut to a size the CPU runs in
    seconds: the smoke net (3 blocks of 8 channels, embedding 32), a 2048-tap
    IR, two clips of 16384 samples, a 8192-sample stream loop."""
    cell = copy.deepcopy(load(f"workloads/{cell_name}.json"))
    cfg = copy.deepcopy(load(f"configs/{cell['config']}.json"))
    if cell["driver"] in ("style_train", "style_render"):
        cfg["net"].update(embed_dim=32, ch_dim=8, encoder_dilations=[1, 2, 4])
        cfg["chain"]["reverb_num_samples"] = 2048
        cfg["build"] = dict(cfg["build"], smoke=True)
        cell["mix"].update(batch=2, clip_samples=16384, pool=4)
        if cell["driver"] == "style_render":
            cell["mix"].update(sample=2, sample_range=3)
    else:
        cell["mix"].update(batch=min(cell["mix"]["batch"], 2), loop_samples=8192, warmup_chunks=2)
    return cfg, cell


@pytest.fixture
def small_net(monkeypatch):
    """StyleTransferNet at the smoke widths, for the render driver (which
    builds the net itself)."""
    import dasp_tpu_torch.models as M

    full = M.StyleTransferNet
    monkeypatch.setattr(M, "StyleTransferNet",
                        lambda dtype=None: full(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4), dtype=dtype))
