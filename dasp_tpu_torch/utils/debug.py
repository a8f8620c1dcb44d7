"""Debug-mode numerical validation.

PyTorch counterpart of ``dasp_tpu/utils/debug.py``. JAX needs ``checkify``
to validate data inside ``jit``; PyTorch runs eagerly, so the checks here
read the tensors directly (one host sync each) and raise
:class:`NumericsError` with the JAX package's messages.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

__all__ = ["NumericsError", "checked", "assert_finite", "assert_normalized"]


class NumericsError(ValueError):
    """A tensor held NaN/Inf, or normalized parameters left [0, 1]."""


def assert_finite(x: torch.Tensor, name: str = "output") -> None:
    """Raise :class:`NumericsError` if ``x`` holds a NaN or an Inf."""
    if not bool(torch.isfinite(x).all()):
        raise NumericsError(f"{name} contains NaN/Inf")


def assert_normalized(p: torch.Tensor, name: str = "params") -> None:
    """Raise :class:`NumericsError` unless every value of ``p`` lies in
    [0, 1] (a NaN fails)."""
    if not bool((p.min() >= 0.0) & (p.max() <= 1.0)):
        raise NumericsError(f"{name} outside [0, 1]")


def checked(fn: Callable, check_inputs: bool = True) -> Callable:
    """Wrap ``fn(x, *args, **kwargs)`` with NaN/Inf validation of ``x``
    (unless ``check_inputs`` is False) and of the output.

    Returns a function with the same signature that raises
    :class:`NumericsError` ("input contains NaN/Inf" or "output contains
    NaN/Inf") on a violation. JAX's ``checked`` also instruments the
    NaN-producing operations inside ``fn`` (``checkify.float_checks``); this
    one checks the input and the output eagerly, so a NaN made inside
    ``fn`` shows only where it reaches the output.

    Example:
        safe_eq = checked(functools.partial(parametric_eq, filter_method="fsm"))
        y = safe_eq(x, sr, *params)   # raises if the output went non-finite
    """

    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if check_inputs:
            assert_finite(x, "input")
        y = fn(x, *args, **kwargs)
        assert_finite(y, "output")
        return y

    return wrapper
