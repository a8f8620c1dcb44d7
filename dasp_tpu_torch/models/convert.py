"""Carry flax weights and BatchNorm statistics over to the PyTorch modules.

``style_net_from_flax`` maps the ``{"params", "batch_stats"}`` tree of the
JAX package's ``StyleTransferNet`` (nested dicts of numpy arrays) onto the
``state_dict`` of :class:`~dasp_tpu_torch.models.style.StyleTransferNet`:

* Conv kernels (k, in, out) -> (out, in, k); Dense kernels (in, out) ->
  (out, in);
* BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (``num_batches_tracked`` starts at 0);
* PReLU ``negative_slope`` () -> ``weight`` (1,).

Every flax leaf is used exactly once; a leaf left over, or a torch key that
gets no value, raises ``ValueError``. Any tree of the same layout converts
the same way: the tests map flax gradients, Adam-updated parameters and new
``batch_stats`` onto torch names to compare a training step leaf by leaf.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from .style import PROJECTOR_NAMES

__all__ = ["style_net_from_flax"]


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _torch_key(path: tuple) -> str:
    """Map one flax leaf path (*modules, leaf) to a torch key."""
    try:
        return _torch_key_or_raise(path)
    except (KeyError, ValueError) as e:
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}") from e


def _torch_key_or_raise(path: tuple) -> str:
    top, rest = path[0], path[1:]
    if top == "Encoder_0":
        prefix = "encoder"
    else:
        m = re.fullmatch(r"ParameterProjector_(\d+)", top)
        if m is None or int(m.group(1)) >= len(PROJECTOR_NAMES):
            raise ValueError(f"unexpected flax module {top!r}")
        prefix = f"projectors.{PROJECTOR_NAMES[int(m.group(1))]}"
    parts = [prefix]
    m = re.fullmatch(r"TCNBlock_(\d+)", rest[0])
    if m is not None:
        parts.append(f"blocks.{m.group(1)}")
        rest = rest[1:]
    layer, leaf = rest
    kind, idx = layer.rsplit("_", 1)
    name = {"Conv": "conv", "Dense": "dense", "BatchNorm": "bn", "PReLU": "prelu"}[kind] + idx
    if kind == "BatchNorm":
        leaf = _BN[leaf]
    elif kind == "PReLU":
        leaf = "weight"
    elif leaf == "kernel":
        leaf = "weight"
    return ".".join(parts + [name, leaf])


def _torch_value(path: tuple, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    layer, leaf = path[-2], path[-1]
    if leaf == "kernel" and layer.startswith("Conv"):
        arr = arr.transpose(2, 1, 0)  # (k, in, out) -> (out, in, k)
    elif leaf == "kernel" and layer.startswith("Dense"):
        arr = arr.T  # (in, out) -> (out, in)
    elif layer.startswith("PReLU"):
        arr = arr.reshape(1)
    return torch.tensor(np.ascontiguousarray(arr), dtype=dtype)


def style_net_from_flax(
    variables, net: torch.nn.Module | None = None, dtype: torch.dtype = torch.float32
) -> "OrderedDict[str, torch.Tensor]":
    """Convert flax ``StyleTransferNet`` variables into a torch state_dict.

    Args:
        variables: ``{"params": ..., "batch_stats": ...}`` as nested dicts of
            arrays (e.g. ``jax.device_get(net.init(...))``).
        net: optional torch ``StyleTransferNet`` to check against: its
            state_dict keys and shapes must match exactly.
        dtype: of the floating-point tensors (float32 for a net's weights;
            float64 to compare float64 trees, e.g. gradients or
            Adam-updated parameters).

    Returns:
        An ``OrderedDict`` ready for ``net.load_state_dict(..., strict=True)``.
    """
    leaves = {}
    for col in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(col, {})).items():
            leaves[(col,) + path] = arr
    extra_cols = set(variables) - {"params", "batch_stats"}
    if extra_cols:
        raise ValueError(f"unexpected flax collections {sorted(extra_cols)}")

    state = OrderedDict()
    for (_, *path), arr in leaves.items():
        key = _torch_key(tuple(path))
        if key in state:
            raise ValueError(f"two flax leaves map to {key!r}")
        state[key] = _torch_value(tuple(path), arr, dtype)
    bns = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    for bn in sorted(bns):
        state[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    if net is not None:
        want = net.state_dict()
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise ValueError(f"state_dict mismatch: missing {missing}, left over {extra}")
        bad = [k for k in want if tuple(want[k].shape) != tuple(state[k].shape)]
        if bad:
            raise ValueError(
                "shape mismatch: "
                + ", ".join(f"{k} {tuple(state[k].shape)} vs {tuple(want[k].shape)}" for k in bad)
            )
    return state
