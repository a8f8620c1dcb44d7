"""Preset serialization: save and load configured processors with their
parameters.

PyTorch counterpart of ``dasp_tpu/utils/presets.py``, in the same JSON
format (tag ``"dasp_tpu.preset.v1"``), so that a file written by either
package loads in the other. A configured
:class:`~dasp_tpu_torch.modules.Processor` (a whole
:class:`~dasp_tpu_torch.modules.Chain` too) and its normalized parameters
round-trip through one human-readable file::

    chain = Chain([ParametricEQ(sr), Compressor(sr), Gain(sr)])
    save_preset("mastering.json", chain, params)     # params: (bs, N) or (N,)
    chain2, params2 = load_preset("mastering.json")
    y = chain2.process_normalized(x, params2.to(x.device), clip_params=True)

The file holds each processor's constructor spec (``Processor._init_spec``),
the normalized parameter matrix and, for people to read, the denormalized
values by name. Loading rebuilds from the spec, so ranges, filter methods
and smoothers survive. Only JSON-able constructor arguments serialize: a
callable, a ``torch.Generator`` or a tensor raises, naming the argument.
Processor classes defined outside :mod:`dasp_tpu_torch.modules` load with
``extra_types=[MyProcessor]``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["save_preset", "load_preset", "processor_to_config", "processor_from_config"]

_FORMAT = "dasp_tpu.preset.v1"


def _serialize_value(v, where: str):
    from ..modules import Processor

    if isinstance(v, Processor):
        return {"__processor__": processor_to_config(v)}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_serialize_value(x, where) for x in v]
    if isinstance(v, dict):
        return {str(k): _serialize_value(x, where) for k, x in v.items()}
    raise TypeError(
        f"preset cannot serialize constructor argument {where}={v!r} (type {type(v).__name__}); rebuild this "
        "processor in code and apply the preset's parameters instead"
    )


def _deserialize_value(v, registry: Dict[str, type]):
    if isinstance(v, dict):
        if "__processor__" in v:
            return processor_from_config(v["__processor__"], registry=registry)
        return {k: _deserialize_value(x, registry) for k, x in v.items()}
    if isinstance(v, list):
        return [_deserialize_value(x, registry) for x in v]
    return v


def processor_to_config(proc) -> dict:
    """A configured processor as a JSON-able constructor spec."""
    spec = getattr(proc, "_init_spec", None)
    if spec is None:
        raise TypeError(
            f"{type(proc).__name__} records no constructor spec (is it a dasp_tpu_torch.modules.Processor subclass?)"
        )
    name, args, kwargs = spec
    return {
        "type": name,
        "args": [_serialize_value(a, f"{name}(arg {i})") for i, a in enumerate(args)],
        "kwargs": {k: _serialize_value(v, f"{name}({k}=)") for k, v in kwargs.items()},
    }


def _default_registry(extra_types: Optional[Sequence[type]] = None) -> Dict[str, type]:
    from .. import modules

    reg = {
        name: obj for name, obj in vars(modules).items()
        if isinstance(obj, type) and issubclass(obj, modules.Processor)
    }
    for t in extra_types or ():
        reg[t.__name__] = t
    return reg


def processor_from_config(cfg: dict, registry: Optional[Dict[str, type]] = None,
                          extra_types: Optional[Sequence[type]] = None):
    """A constructor spec as a live processor."""
    if registry is None:
        registry = _default_registry(extra_types)
    cls = registry.get(cfg["type"])
    if cls is None:
        raise KeyError(
            f"unknown processor type {cfg['type']!r}; pass extra_types=[...] for processor classes defined "
            "outside dasp_tpu_torch.modules"
        )
    args = [_deserialize_value(a, registry) for a in cfg.get("args", [])]
    kwargs = {k: _deserialize_value(v, registry) for k, v in cfg.get("kwargs", {}).items()}
    return cls(*args, **kwargs)


def _denormalized_view(proc, params: np.ndarray) -> List[Dict[str, float]]:
    """Each batch item's {parameter name: denormalized value}, for people."""
    return [
        {name: float(lo + (hi - lo) * float(params[b, i])) for i, (name, (lo, hi)) in enumerate(proc.param_ranges.items())}
        for b in range(params.shape[0])
    ]


def save_preset(path: str, processor, params=None, metadata: Optional[dict] = None) -> None:
    """Write a processor (or chain) and optional parameters to JSON.

    Args:
        path: the output file.
        processor: any configured Processor or Chain.
        params: normalized parameters on (0, 1), (num_params,) or (bs,
            num_params); a tensor on any device or an array.
        metadata: a free-form JSON-able dict.
    """
    doc = {
        "format": _FORMAT,
        "processor": processor_to_config(processor),
        "sample_rate": int(processor.sample_rate),
        "param_names": list(processor.param_ranges.keys()),
    }
    if params is not None:
        if isinstance(params, torch.Tensor):
            params = params.detach().cpu().double().numpy()
        p = np.asarray(params, dtype=np.float64)
        if p.ndim == 1:
            p = p[None, :]
        if p.ndim != 2 or p.shape[1] != processor.num_params:
            raise ValueError(
                f"params must have {processor.num_params} columns for this processor, got shape "
                f"{tuple(np.asarray(params).shape)}"
            )
        doc["params_normalized"] = p.tolist()
        doc["params_denormalized"] = _denormalized_view(processor, p)
    if metadata is not None:
        doc["metadata"] = metadata
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_preset(path: str, extra_types: Optional[Sequence[type]] = None) -> Tuple[object, Optional[torch.Tensor]]:
    """Read a preset: ``(processor, normalized parameters)``, the
    parameters a float32 CPU tensor (bs, num_params), or None if the file
    has none."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a dasp_tpu preset (format={doc.get('format')!r})")
    proc = processor_from_config(doc["processor"], extra_types=extra_types)
    params = None
    if "params_normalized" in doc:
        params = torch.tensor(doc["params_normalized"], dtype=torch.float32)
        if params.shape[1] != proc.num_params:
            raise ValueError(
                f"preset carries {params.shape[1]} parameters but the reconstructed processor expects "
                f"{proc.num_params}"
            )
    return proc, params
