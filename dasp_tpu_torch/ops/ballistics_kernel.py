"""Exact branching attack/release smoother and its gradient: CUDA kernels
and plain versions.

PyTorch counterpart of ``dasp_tpu/ops/pallas_ballistics.py``. The
recursion, per row,

    alpha[n] = alpha_attack if g[n] < y[n-1] else alpha_release
    y[n] = (1 - alpha[n]) * g[n] + alpha[n] * y[n-1]

runs in the hand-written kernel ``csrc/ballistics.cu`` for tensors on a CUDA
device, and in :func:`ballistics_rows_plain`, a per-sample PyTorch loop,
for tensors on the CPU. The kernel is time-parallel: it walks 32-sample
chunks from guessed states and walks them again from their predecessors'
outputs until every chunk agrees bit for bit (speculate and verify); each
step rounds as the plain loop does, so the kernel is bitwise equal to it,
and chunk-chained evaluation through ``y0`` is bitwise equal to one pass.

The gradient is the anticausal adjoint of the recursion with the branch
pattern held fixed (as autograd through ``torch.where`` does), recomputed
from the saved output:

    lam[n]    = ct[n] + alpha[n+1] * lam[n+1]
    dg[n]     = (1 - alpha[n]) * lam[n]
    dalpha[n] = lam[n] * y[n-1] - lam[n] * g[n]   -> daa or dar by branch
    dy0       = alpha[0] * lam[0]

It runs in ``csrc/ballistics_bwd.cu`` on a CUDA device, a chunked scan of
that linear recursion in float64 with each result rounded to fp32 once, and
in :func:`ballistics_bwd_rows_plain`, a reverse loop, on the CPU. The loop
rounds as autograd does through the plain forward (daa and dar are serial
fp32 sums from the last sample back, as autograd and the TPU kernel
accumulate them), so loop and autograd are bitwise equal; the kernel is
held against the same loop run in float64 on float64 copies of its inputs
(whose branches are the kernel's). Its daa and dar are bitwise equal from
run to run. The same autograd Function runs on both devices with either
engine. :func:`ballistics_plain` (autograd through the plain loop) stays
the independent reference.

Launches are counted per kernel: ``ballistics_pallas.launches`` (forward)
and ``ballistics_pallas.bwd_launches`` (backward); each is one zero fill of
the kernel's scratch and one kernel launch on the device.
``ballistics_pallas.last_work`` holds, for the last forward launch, the
work of its verify rounds: an (R, tiles, 3) int64 device tensor of rounds,
passes and samples walked again per 8192-sample tile.

The name ``ballistics_pallas`` is kept from the JAX package so that the
option string ``smoother="exact_pallas"`` means the same in both packages;
in this package it selects the CUDA kernels.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = [
    "ballistics_pallas",
    "ballistics_plain",
    "ballistics_rows_plain",
    "ballistics_bwd_rows_plain",
]


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


def ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct):
    """The plain backward: a reverse loop over time on (R, T) rows.

    Args:
        y: the forward output; g: its input curve; ct: the cotangent of y,
            each (R, T). aa, ar, y0: (R,).

    Returns:
        (dg (R, T), daa (R,), dar (R,), dy0 (R,)), rounded step by step in
        the kernel's order (which is autograd's through
        :func:`ballistics_rows_plain`).
    """
    T = g.shape[-1]
    lam_next = torch.zeros_like(y0)  # alpha[n+1] * lam[n+1]
    daa = torch.zeros_like(y0)
    dar = torch.zeros_like(y0)
    dg = []
    for n in range(T - 1, -1, -1):
        g_n = g[:, n]
        y_prev = y[:, n - 1] if n > 0 else y0
        attack = g_n < y_prev
        alpha = torch.where(attack, aa, ar)
        lam = ct[:, n] + lam_next
        dg.append((1.0 - alpha) * lam)
        dalpha = lam * y_prev - lam * g_n
        daa = torch.where(attack, daa + dalpha, daa)
        dar = torch.where(attack, dar, dar + dalpha)
        lam_next = alpha * lam
    dg = torch.stack(dg[::-1], dim=-1) if dg else torch.zeros_like(g)
    return dg, daa, dar, lam_next


class _PlainEngine:
    forward = staticmethod(ballistics_rows_plain)
    backward = staticmethod(ballistics_bwd_rows_plain)


class _CudaEngine:
    @staticmethod
    def forward(g, aa, ar, y0):
        R, T = g.shape
        y = torch.empty_like(g)
        if R == 0 or T == 0:
            return y
        lib = _build.library()
        ntiles = -(-T // lib.ballistics_tile())
        # the tile counter, each tile's published last output and each
        # tile's work (rounds, passes, samples walked again); zeroed
        scratch = torch.zeros(1 + 4 * R * ntiles, dtype=torch.int64, device=g.device)
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            err = lib.ballistics_f32(
                g.data_ptr(), aa.data_ptr(), ar.data_ptr(), y0.data_ptr(), y.data_ptr(),
                R, T, scratch.data_ptr(), stream,
            )
        _build.check(err, "ballistics_f32")
        ballistics_pallas.launches += 1
        ballistics_pallas.last_work = scratch[1 + R * ntiles:].view(R, ntiles, 3)
        return y

    @staticmethod
    def backward(y, g, aa, ar, y0, ct):
        R, T = g.shape
        dg = torch.empty_like(g)
        daa, dar, dy0 = (torch.zeros_like(y0) for _ in range(3))
        if R == 0 or T == 0:
            return dg, daa, dar, dy0
        lib = _build.library()
        tiles = R * -(-T // lib.ballistics_tile())
        # the chunked scan's scratch: the tile counter, per tile whether its
        # carry is published and per row the blocks finished (zeroed); per
        # tile the carry and the two branch sums
        sync = torch.zeros(1 + tiles + R, dtype=torch.int32, device=g.device)
        states = torch.empty(3 * tiles, dtype=torch.float64, device=g.device)
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            err = lib.ballistics_bwd_f32(
                y.data_ptr(), g.data_ptr(), aa.data_ptr(), ar.data_ptr(), y0.data_ptr(),
                ct.data_ptr(), dg.data_ptr(), daa.data_ptr(), dar.data_ptr(), dy0.data_ptr(),
                R, T, sync.data_ptr(), states.data_ptr(), stream,
            )
        _build.check(err, "ballistics_bwd_f32")
        ballistics_pallas.bwd_launches += 1
        return dg, daa, dar, dy0


class _BallisticsKernel(torch.autograd.Function):
    """The smoother with its adjoint gradient on (R, T) rows, evaluated by
    ``engine`` (CUDA kernels or plain loops)."""

    @staticmethod
    def forward(ctx, g, aa, ar, y0, engine):
        y = engine.forward(g, aa, ar, y0)
        ctx.save_for_backward(y, g, aa, ar, y0)
        ctx.engine = engine
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        y, g, aa, ar, y0 = ctx.saved_tensors
        grads = ctx.engine.backward(y, g, aa, ar, y0, ct.contiguous())
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)), None)


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
    """:func:`ballistics_pallas` evaluated by the plain loop on any device,
    differentiated by autograd through it."""
    rows = _rows(g, alpha_attack, alpha_release, y0)
    return _finish(ballistics_rows_plain(*rows), g, return_yf)


def ballistics_pallas(g, alpha_attack, alpha_release, y0=None, return_yf=False):
    """Exact branching attack/release smoother (see the module docstring).

    On a CUDA tensor this launches the CUDA kernels; on a CPU tensor it runs
    the plain loops. Differentiable with respect to g, both coefficients and
    y0 by the adjoint recursion (one backward launch).

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
        engine = _PlainEngine
    elif g.device.type == "cuda":
        _check_cuda(g)
        engine = _CudaEngine
    else:
        raise ValueError(f"ballistics_pallas runs on CPU or CUDA tensors, not {g.device}")
    rows = _rows(g, alpha_attack, alpha_release, y0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in rows):
        y = _BallisticsKernel.apply(*rows, engine)
    else:
        y = engine.forward(*rows)
    return _finish(y, g, return_yf)


# kernel launches by kernel, counted in _CudaEngine
ballistics_pallas.launches = 0
ballistics_pallas.bwd_launches = 0
# the last forward launch's rounds, passes and samples walked again per tile
ballistics_pallas.last_work = None
