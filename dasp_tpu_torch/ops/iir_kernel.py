"""Exact biquad-cascade filtering and its gradient: CUDA kernel and plain
version.

PyTorch counterpart of ``dasp_tpu/ops/pallas_iir.py``. For tensors on a
CUDA device the cascade runs in the hand-written kernel of
``csrc/sosfilt_cascade.cuh`` (entry points ``sosfilt_cascade.cu``,
``sosfilt_cascade_save_all.cu`` and ``sosfilt_cascade_adjoint.cu``), a
time-parallel chunked scan: each thread walks a 32-sample chunk of a row
from zero state, a 2x2 carry per section is scanned across chunks and
tiles in float64, and each chunk is walked again from its true state. For
tensors on the CPU it runs
:func:`sosfilt_rows_plain`, the block-state formulation the TPU kernel
computes: per block of L samples,

    y[k] = sum_{j<=k} h[k-j] f[j] + h[k+1] y[-1] - a2 h[k] y[-2]

with f the section's FIR part and h the impulse response of its AR part;
the intra-block Toeplitz products of all blocks are one batched matmul and
the two carried samples go through a loop over blocks. The two evaluations
round differently (recursion with FMA against Toeplitz sums), so each is
held against float64 ``scipy.signal.sosfilt``.

Gradients (the TPU kernel's custom VJP, ``_rows_fwd`` / ``_rows_bwd``):
when a gradient is needed the forward runs the cascade in its save-all
form, keeping every section's output (S, R, T). The backward runs the SAME
cascade once more, save-all, over the (S+1)-section adjoint cascade in
flipped time (:func:`adjoint_sos`), which yields every section's adjoint
lambda and dL/dx; the coefficient gradients are then correlations,
db_k = sum lambda[n] u[n-k] and da_j = -sum lambda[n] y[n-j]. The same
autograd Function runs on both devices: the CUDA kernel is one engine,
the plain block-state version the other, so the CPU tests exercise the
adjoint formulas themselves. :func:`sosfilt_plain` (autograd through the
plain forward) stays the independent reference.

Three uses of the kernel are counted apart in :mod:`dasp_tpu_torch.trace`:
``kernel_a.forward``, ``kernel_a.save_all`` (forward with residuals) and
``kernel_a.adjoint`` (backward), one count per use; each use is one zero
fill of the scan's scratch and one kernel launch on the device. The same
names are the spans round each use, on either engine.

The names ``sosfilt_pallas`` / ``lfilter1_pallas`` are kept from the JAX
package so that ``filter_method="pallas"`` and ``smoother="pallas"`` mean
the same in both packages; in this package they select the CUDA kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from ..trace import count, span
from .iir import _fold_rows, block_toeplitz_operators, embed_first_order_sos, stabilize_sos

__all__ = [
    "sosfilt_pallas",
    "lfilter1_pallas",
    "sosfilt_plain",
    "sosfilt_rows_plain",
    "sosfilt_rows_grad_plain",
    "adjoint_sos",
]

# time block of the plain version: the TPU kernel's 128-sample block
BLOCK = 128


def sosfilt_rows_plain(sos: torch.Tensor, x: torch.Tensor, save_all: bool = False) -> torch.Tensor:
    """The plain version on (R, T) rows with (R, S, 6) sections (no
    stabilization here). Differentiable by autograd, on any device.

    Returns the last section's output (R, T), or with ``save_all`` every
    section's output (S, R, T)."""
    R, T = x.shape
    S = sos.shape[1]
    L = BLOCK
    pad_t = (-T) % L
    y = torch.nn.functional.pad(x, (0, pad_t))
    nb = y.shape[-1] // L
    _, Tt, h1, h2 = block_toeplitz_operators(sos, L)
    outs = []
    for s in range(S):
        b = sos[:, s, :3]
        x1 = torch.nn.functional.pad(y, (1, 0))[:, :-1]
        x2 = torch.nn.functional.pad(y, (2, 0))[:, :-2]
        f = b[:, 0:1] * y + b[:, 1:2] * x1 + b[:, 2:3] * x2
        c = torch.matmul(f.reshape(R, nb, L), Tt[:, s])  # (R, nb, L)
        h1_s, h2_s = h1[:, s], h2[:, s]
        ym1 = ym2 = torch.zeros_like(c[:, 0, 0])
        blocks = []
        for c_i in c.unbind(dim=1):
            y_i = c_i + h1_s * ym1[:, None] + h2_s * ym2[:, None]
            ym1, ym2 = y_i[:, L - 1], y_i[:, L - 2]
            blocks.append(y_i)
        y = torch.stack(blocks, dim=1).reshape(R, nb * L)
        outs.append(y[:, :T])
    if save_all:
        return torch.stack(outs) if outs else x.new_zeros((0, R, T))
    return y[:, :T]


def adjoint_sos(sos: torch.Tensor) -> torch.Tensor:
    """The (R, S+1, 6) adjoint cascade of (R, S, 6) sections, run in flipped
    time on the cotangent (``_rows_bwd``, pallas_iir.py:259-317):

        section 0:  b = [1, 0, 0],  a = A_{S-1}   -> lambda_{S-1}
        section j:  b = B_{S-j},    a = A_{S-1-j} -> lambda_{S-1-j}
        section S:  b = B_0,        a = [1, 0, 0] -> dL/dx
    """
    b = sos[..., :3]
    a = sos[..., 3:]
    unit = torch.zeros_like(a[:, :1])
    unit[..., 0] = 1.0
    return torch.cat(
        [torch.cat([unit, b.flip(1)], dim=1), torch.cat([a.flip(1), unit], dim=1)], dim=-1
    )


def _vjp(sos, x, inters, grad_y, adjoint):
    """(dsos, dx) of the cascade from the forward residuals ``inters``
    (S, R, T) and one save-all pass of ``adjoint`` over the adjoint cascade;
    ``adjoint(adj_sos, g)`` returns its (S+1, R, T) outputs in forward time."""
    S = sos.shape[1]
    T = x.shape[-1]
    outs = adjoint(adjoint_sos(sos).contiguous(), grad_y)
    lam = outs[:S].flip(0)  # lam[s], s = 0..S-1
    u = torch.cat([x[None], inters[:-1]])  # section inputs (S, R, T)

    def corr(z, k):  # sum_n lam[n] z[n-k], zero history
        return (lam[..., k:] * z[..., : max(T - k, 0)]).sum(-1)

    db = [corr(u, k) for k in range(3)]
    da = [-corr(inters, k) for k in (1, 2)]
    dsos = torch.stack([*db, torch.zeros_like(db[0]), *da], dim=-1)  # (S, R, 6)
    return dsos.transpose(0, 1), outs[S]


class _PlainEngine:
    """The three uses of the cascade, evaluated by :func:`sosfilt_rows_plain`."""

    @staticmethod
    def forward(sos, x):
        return sosfilt_rows_plain(sos, x)

    @staticmethod
    def save_all(sos, x):
        return sosfilt_rows_plain(sos, x, save_all=True)

    @staticmethod
    def adjoint(adj_sos, g):
        return sosfilt_rows_plain(adj_sos, g.flip(-1), save_all=True).flip(-1)


class _CudaEngine:
    """The three uses of the cascade, each one launch of the CUDA kernel
    (after the zero fill of its scratch). The adjoint's kernel walks time
    backward: the flipped-time cascade with its input and outputs left in
    forward time."""

    @staticmethod
    def _use(use: str, entry: str, sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        R, T = x.shape
        S = sos.shape[1]
        y = torch.empty((R, T) if use == "forward" else (S, R, T), dtype=x.dtype, device=x.device)
        if R and T:
            lib = _build.library()
            if S > lib.sosfilt_cascade_max_sections():
                raise ValueError(
                    f"sosfilt kernel takes at most {lib.sosfilt_cascade_max_sections()} sections, got {S}"
                )
            # the chunked scan's scratch: a tile counter and per tile the
            # sections published (zeroed), and each tile's outgoing state
            # per section
            tiles = R * -(-T // lib.sosfilt_cascade_tile())
            sync = torch.zeros(1 + tiles, dtype=torch.int32, device=x.device)
            states = torch.empty(tiles * S * 2, dtype=torch.float64, device=x.device)
            _build.launch(entry, x.device, sos.data_ptr(), x.data_ptr(), y.data_ptr(), R, S, T,
                          sync.data_ptr(), states.data_ptr())
        count("kernel_a." + use)  # per use, empty rows included
        return y

    @staticmethod
    def forward(sos, x):
        return _CudaEngine._use("forward", "sosfilt_cascade_f32", sos, x)

    @staticmethod
    def save_all(sos, x):
        return _CudaEngine._use("save_all", "sosfilt_cascade_save_all_f32", sos, x)

    @staticmethod
    def adjoint(adj_sos, g):
        return _CudaEngine._use("adjoint", "sosfilt_cascade_adjoint_f32", adj_sos, g)


class _SosfiltKernel(torch.autograd.Function):
    """The cascade with its adjoint-state gradient, on (R, S, 6) sections
    and (R, T) rows, evaluated by ``engine`` (CUDA kernel or plain)."""

    @staticmethod
    def forward(ctx, sos, x, engine):
        with span("kernel_a.save_all"):
            inters = engine.save_all(sos, x)  # (S, R, T)
        ctx.save_for_backward(sos, x, inters)
        ctx.engine = engine
        return inters[-1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_y):
        sos, x, inters = ctx.saved_tensors
        with span("kernel_a.adjoint"):
            dsos, dx = _vjp(sos, x, inters, grad_y.contiguous(), ctx.engine.adjoint)
        return (
            dsos if ctx.needs_input_grad[0] else None,
            dx if ctx.needs_input_grad[1] else None,
            None,
        )


def sosfilt_rows_grad_plain(sos: torch.Tensor, x: torch.Tensor, grad_y: torch.Tensor):
    """(dsos, dx) of the cascade on (R, T) rows for the cotangent ``grad_y``,
    by the adjoint formulas with the plain version as the engine, on any
    device: what the kernel's backward computes, in the TPU kernel's
    rounding."""
    inters = _PlainEngine.save_all(sos, x)
    return _vjp(sos, x, inters, grad_y, _PlainEngine.adjoint)


def _rows(sos, x, stabilize):
    if stabilize:
        sos = stabilize_sos(sos)
    # per-batch sections are shared by the channels of that batch item
    rows, sos_rows = _fold_rows(x, sos)
    return sos_rows, rows


def sosfilt_plain(sos: torch.Tensor, x: torch.Tensor, stabilize: bool = True) -> torch.Tensor:
    """:func:`sosfilt_pallas` evaluated by the plain block-state version on
    any device, differentiated by autograd through it."""
    sos_rows, rows = _rows(sos, x, stabilize)
    return sosfilt_rows_plain(sos_rows, rows).reshape(x.shape)


def _check_cuda(sos: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or sos.dtype != torch.float32:
        raise TypeError(f"sosfilt kernel takes float32, got x {x.dtype}, sos {sos.dtype}")
    if not x.is_contiguous():
        raise ValueError("sosfilt kernel takes a contiguous x")
    if sos.ndim != 3 or sos.shape[0] != x.shape[0] or sos.shape[2] != 6 or x.ndim < 2:
        raise ValueError(
            f"expected sos (bs, S, 6) and x (bs, ..., T), got {tuple(sos.shape)} and {tuple(x.shape)}"
        )
    if sos.device != x.device:
        raise ValueError(f"sos on {sos.device} but x on {x.device}")


def sosfilt_pallas(sos: torch.Tensor, x: torch.Tensor, stabilize: bool = True) -> torch.Tensor:
    """Exact time-domain biquad cascade (see the module docstring).

    On a CUDA tensor this launches the CUDA kernel; on a CPU tensor it runs
    the plain block-state version. Differentiable with respect to sos and x
    by the adjoint cascade: when autograd needs a gradient the forward keeps
    every section's output (the save-all launch) and the backward is one
    more launch; otherwise it is one forward launch.

    Args:
        sos: (bs, n_sections, 6) with a0 normalized to 1.
        x: signal (bs, ..., T); on CUDA float32 and contiguous.
        stabilize: clamp denominators into the stability triangle first
            (a no-op for every cookbook design; see :func:`stabilize_sos`).
            Its straight-through gradient stays outside the kernel's
            gradient, as in the JAX package.

    Returns:
        Filtered signal, same shape as x.
    """
    engine = _build.engine("sosfilt_pallas", x.device, _PlainEngine, _CudaEngine, _check_cuda, sos, x)
    sos_rows, rows = _rows(sos, x, stabilize)
    sos_rows = sos_rows.contiguous()
    if torch.is_grad_enabled() and (sos_rows.requires_grad or rows.requires_grad):
        y = _SosfiltKernel.apply(sos_rows, rows, engine)
    else:
        with span("kernel_a.forward"):
            y = engine.forward(sos_rows, rows)
    return y.reshape(x.shape)


def lfilter1_pallas(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """First-order IIR through the biquad-cascade kernel (b2 = a2 = 0).

    Args:
        x: (bs, ..., T); b/a: (bs, 2) with a0 == 1.
    """
    return sosfilt_pallas(embed_first_order_sos(b, a)[:, None, :], x)
