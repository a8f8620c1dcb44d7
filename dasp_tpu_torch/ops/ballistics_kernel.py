"""Exact branching attack/release smoother: CUDA kernel and plain version.

PyTorch counterpart of ``dasp_tpu/ops/pallas_ballistics.py``. The
recursion, per row,

    alpha[n] = alpha_attack if g[n] < y[n-1] else alpha_release
    y[n] = (1 - alpha[n]) * g[n] + alpha[n] * y[n-1]

runs in the hand-written kernel ``csrc/ballistics.cu`` for tensors on a CUDA
device, and in :func:`ballistics_rows_plain`, a per-sample PyTorch loop,
for tensors on the CPU. Both round every step the same way, so the kernel is
bitwise equal to the plain loop, and chunk-chained evaluation through ``y0``
is bitwise equal to one pass.

The name ``ballistics_pallas`` is kept from the JAX package so that the
option string ``smoother="exact_pallas"`` means the same in both packages;
in this package it selects the CUDA kernel.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["ballistics_pallas", "ballistics_plain", "ballistics_rows_plain"]


def ballistics_rows_plain(
    g: torch.Tensor, aa: torch.Tensor, ar: torch.Tensor, y0: torch.Tensor
) -> torch.Tensor:
    """The plain version: a loop over time on (R, T) rows with per-row
    coefficients and initial state, each (R,). Differentiable by autograd,
    on any device (sample by sample, so slow for long rows on a GPU)."""
    y_prev = y0
    out = []
    for g_n in g.unbind(dim=-1):
        alpha = torch.where(g_n < y_prev, aa, ar)
        y_prev = (1.0 - alpha) * g_n + alpha * y_prev
        out.append(y_prev)
    if not out:
        return g.clone()
    return torch.stack(out, dim=-1)


def _launch(g: torch.Tensor, aa: torch.Tensor, ar: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    R, T = g.shape
    y = torch.empty_like(g)
    if R == 0 or T == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.ballistics_f32(
            g.data_ptr(), aa.data_ptr(), ar.data_ptr(), y0.data_ptr(), y.data_ptr(),
            R, T, stream,
        )
    _build.check(err, "ballistics_f32")
    ballistics_pallas.launches += 1
    return y


class _BallisticsKernel(torch.autograd.Function):
    """Forward runs the CUDA kernel; the backward kernel (the anticausal
    adjoint of dasp_tpu/ops/pallas_ballistics.py _bwd_kernel) is not
    ported yet."""

    @staticmethod
    def forward(ctx, g, aa, ar, y0):
        return _launch(g, aa, ar, y0)

    @staticmethod
    def backward(ctx, grad_y):
        raise NotImplementedError(
            "the ballistics kernel has no backward yet: it comes with the "
            "training step (ROADMAP.md Queue 2, kernel B backward). For "
            "gradients on the GPU use smoother='exact' (plain autograd)."
        )


def _check_cuda(g: torch.Tensor) -> None:
    if g.dtype != torch.float32:
        raise TypeError(f"ballistics kernel takes float32, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("ballistics kernel takes a contiguous g")
    if g.ndim != 3:
        raise ValueError(f"g must be (bs, ch, T), got shape {tuple(g.shape)}")


def _rows(g, alpha_attack, alpha_release, y0):
    bs, ch, T = g.shape
    R = bs * ch

    def coef(a):
        a = torch.as_tensor(a, dtype=g.dtype, device=g.device).reshape(bs, 1)
        return a.expand(bs, ch).reshape(R).contiguous()

    if y0 is None:
        y0_rows = torch.zeros(R, dtype=g.dtype, device=g.device)
    else:
        y0_rows = torch.as_tensor(y0, dtype=g.dtype, device=g.device).reshape(R).contiguous()
    return g.reshape(R, T), coef(alpha_attack), coef(alpha_release), y0_rows


def _finish(y_rows, g, return_yf):
    out = y_rows.reshape(g.shape)
    if return_yf:
        yf = out[..., -1]
        return out, (yf, yf)
    return out


def ballistics_plain(g, alpha_attack, alpha_release, y0=None, return_yf=False):
    """:func:`ballistics_pallas` evaluated by the plain loop on any device."""
    rows = _rows(g, alpha_attack, alpha_release, y0)
    return _finish(ballistics_rows_plain(*rows), g, return_yf)


def ballistics_pallas(g, alpha_attack, alpha_release, y0=None, return_yf=False):
    """Exact branching attack/release smoother (see the module docstring).

    On a CUDA tensor this launches the CUDA kernel (forward only: backward
    raises ``NotImplementedError``); on a CPU tensor it runs the plain loop.

    Args:
        g: gain-reduction curve, shape (bs, ch, T); on CUDA float32 and
            contiguous.
        alpha_attack / alpha_release: coefficients with bs elements
            (e.g. (bs,) or (bs, 1, 1)).
        y0: carried envelope state, shape (bs, ch) (None = from rest).
        return_yf: also return the final state ``(y[..., -1], y[..., -1])``.

    Returns:
        Smoothed curve, same shape as g; with ``return_yf`` a tuple
        ``(y, (yf, yf))``.
    """
    if g.device.type == "cpu":
        return ballistics_plain(g, alpha_attack, alpha_release, y0, return_yf)
    if g.device.type != "cuda":
        raise ValueError(f"ballistics_pallas runs on CPU or CUDA tensors, not {g.device}")
    _check_cuda(g)
    rows = _rows(g, alpha_attack, alpha_release, y0)
    return _finish(_BallisticsKernel.apply(*rows), g, return_yf)


ballistics_pallas.launches = 0  # kernel launches, counted in _launch
