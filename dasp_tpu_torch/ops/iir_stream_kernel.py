"""One streaming step of the coupled biquad cascade: CUDA kernel D and its
plain version.

A stream step of :func:`~dasp_tpu_torch.ops.sosfilt_coupled` on a CUDA
tensor (``return_zf=True``, no ``seq_group``, nothing that requires grad
under grad mode) runs here, in the hand-written kernel of
``csrc/sosfilt_coupled_step.cu``: the whole cascade of a chunk in one
launch, where the block-state path issues about 30 small float64
operations a section. It runs the realization that ``_coupled_state_space``
builds (the Gold-Rader coupled form for complex pole pairs, the controller
form for real poles), packed per row and section as
``[A00, A01, A10, A11, b0, b1, c0, c1, d]`` (R, S, 9) float64, sample by
sample:

    y[n] = d u[n] + c . s[n-1]
    s[n] = A s[n-1] + b u[n]

section s's output being section s+1's input, from the carried (R, S, 2)
state ``zi``, which it returns as ``zf`` after the last sample: the layout
of the block-state path, so that a stream may move between the two
mid-stream. Arithmetic and state are float64 inside; y and zf are rounded
to the rows' dtype once.

:func:`coupled_step_plain` is the same recursion in PyTorch, in float64,
on any device: the lanes' wavefront of the kernel (at step k section s
filters sample k - s), all sections at once. The tests and ``chip_smoke.py``
hold the kernel against it; the stream on a CPU tensor keeps the
block-state path.

Launches are counted in :mod:`dasp_tpu_torch.trace` as
``kernel_d.forward``, one count a launch.
"""

from __future__ import annotations

import torch

from .. import _build
from ..trace import count

__all__ = ["MAX_SECTIONS", "coupled_step", "coupled_step_plain"]

# the kernel's lane a section (csrc/sosfilt_coupled_step.cu kMaxSections)
MAX_SECTIONS = 32
_ENTRY = {torch.float32: "sosfilt_coupled_step_f32", torch.float64: "sosfilt_coupled_step_f64"}


def _unpack(real: torch.Tensor):
    return real.to(torch.float64).unbind(-1)


def coupled_step_plain(real: torch.Tensor, rows: torch.Tensor, zi: torch.Tensor | None = None):
    """The plain version: (y, zf) in float64 of the cascade with the packed
    (R, S, 9) realization ``real`` on (R, T) ``rows`` from the (R, S, 2)
    state ``zi`` (None: from rest)."""
    R, T = rows.shape
    S = real.shape[1]
    a00, a01, a10, a11, b0, b1, c0, c1, d = _unpack(real)
    x = rows.to(torch.float64)
    z = x.new_zeros((R, S, 2)) if zi is None else zi.to(torch.float64)
    s0, s1 = z[..., 0], z[..., 1]
    y = x.new_empty((R, T))
    prev = x.new_zeros((R, S))  # each section's output of the step before
    lane = torch.arange(S, device=x.device)
    for k in range(T + S - 1):
        head = x[:, k : k + 1] if k < T else x.new_zeros((R, 1))
        u = torch.cat([head, prev[:, :-1]], dim=1)  # section s filters section s-1's output
        v = d * u + (c0 * s0 + c1 * s1)
        n0 = a00 * s0 + a01 * s1 + b0 * u
        n1 = a10 * s0 + a11 * s1 + b1 * u
        if S - 1 <= k < T:  # every section has a sample at this step
            s0, s1, prev = n0, n1, v
        else:  # filling or draining: section s filters sample k - s where that exists
            on = ((k - lane) >= 0) & ((k - lane) < T)
            s0, s1, prev = torch.where(on, n0, s0), torch.where(on, n1, s1), torch.where(on, v, prev)
        if k >= S - 1:
            y[:, k - S + 1] = v[:, -1]
    return y, torch.stack([s0, s1], dim=-1)


def _check(real, rows, zi):
    if rows.dtype not in _ENTRY:
        raise TypeError(f"coupled step kernel takes float32 or float64 rows, got {rows.dtype}")
    if real.dtype != torch.float64 or real.ndim != 3 or real.shape[0] != rows.shape[0] or real.shape[2] != 9:
        raise ValueError(f"expected a float64 realization (R, S, 9) for {rows.shape[0]} rows, got "
                         f"{real.dtype} {tuple(real.shape)}")
    if not 1 <= real.shape[1] <= MAX_SECTIONS:
        raise ValueError(f"coupled step kernel takes 1 to {MAX_SECTIONS} sections, got {real.shape[1]}")
    if zi is not None and zi.shape != real.shape[:2] + (2,):
        raise ValueError(f"expected zi {tuple(real.shape[:2]) + (2,)}, got {tuple(zi.shape)}")
    for name, t in (("realization", real), ("zi", zi)):
        if t is not None and t.device != rows.device:
            raise ValueError(f"{name} on {t.device} but rows on {rows.device}")


def coupled_step(real: torch.Tensor, rows: torch.Tensor, zi: torch.Tensor | None = None):
    """One step of the cascade on CUDA ``rows`` (R, T), float32 or float64,
    by kernel D: the output (R, T) and the state after the last sample
    (R, S, 2), both in the rows' dtype. ``real`` is the packed (R, S, 9)
    float64 realization, ``zi`` the (R, S, 2) state (None: from rest),
    read in float64."""
    _check(real, rows, zi)
    R, T = rows.shape
    S = real.shape[1]
    real, rows = real.contiguous(), rows.contiguous()
    if zi is not None:
        zi = zi.to(torch.float64).contiguous()
    y = torch.empty((R, T), dtype=rows.dtype, device=rows.device)
    zf = torch.empty((R, S, 2), dtype=rows.dtype, device=rows.device)
    if R == 0:
        return y, zf
    _build.launch(_ENTRY[rows.dtype], rows.device, real.data_ptr(), rows.data_ptr(),
                  None if zi is None else zi.data_ptr(), y.data_ptr(), zf.data_ptr(), R, S, T)
    count("kernel_d.forward")
    return y, zf
