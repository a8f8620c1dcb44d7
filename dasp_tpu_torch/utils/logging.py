"""Metrics logging and checkpoints.

PyTorch counterpart of ``dasp_tpu/utils/logging.py``: every example trainer
writes JSONL metrics and can checkpoint and restore its state (the net's and
the optimizer's ``state_dict`` and the step), with the same record keys and
file layout as the JAX package's.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["MetricsLogger", "save_checkpoint", "load_checkpoint"]


class MetricsLogger:
    """Append-only JSONL metrics log with wall-clock stamps: one record a
    call, ``{"step": ..., "time_s": ..., <metric>: float, ...}``."""

    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Pickle a tree (dicts, lists, tuples) of tensors and values. Tensors
    on a device are copied to the CPU first, as the JAX package pulls device
    arrays to the host; the file is written to ``path + ".tmp"`` and then
    renamed over ``path``, so a crash mid-write leaves the last checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    host_state = _to_host(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host_state, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """Load a checkpoint if it exists, else None. Unpickling runs code: load
    only checkpoints this program wrote."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
