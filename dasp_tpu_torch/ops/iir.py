"""IIR building blocks: coefficient layouts, stability projection, the
block-state operators of the biquad cascade, the first-order scans, the
exact scan-based and block-state filters, ballistics and the peak-decay
follower.

PyTorch counterpart of ``dasp_tpu/ops/iir.py``: ``stabilize_sos``,
``embed_first_order_sos``, ``onepole_ba``, ``ar_impulse_response``,
``block_toeplitz_operators`` (which the plain version of the biquad-cascade
kernel is also built from), the first-order scans ``onepole_exact``,
``onepole_varying`` and ``lfilter1_exact`` (one associative scan over time),
``sosfilt_exact`` (a 2x2 matrix associative scan over time),
``sosfilt_blockmat``, ``lfilter1_blockmat`` and ``sosfilt_coupled`` (the
block-state formulation: one batched matmul per section for the
intra-block Toeplitz part, an associative scan over blocks for the carried
state; ``sosfilt_coupled`` on the Gold-Rader coupled realization, whose
stream steps on the card run the stream step's kernel instead,
:mod:`~dasp_tpu_torch.ops.iir_stream_kernel`),
``lti_affine_scan`` (that scan, with the adjoint recurrence as its
backward), ``ballistics_smooth`` (``"parallel"``, ``"attack_only"`` and
``"exact"``, the last the plain version of the ballistics kernel) and
``peak_decay`` (a max-plus scan).

:func:`associative_scan` stands in for ``lax.associative_scan``: the same
odd/even recursion, so the elements combine in JAX's order. The first-order
scans and ``peak_decay`` compute in the input's dtype on it, so their fp32
results stay within a few ulps of JAX's; ``peak_decay``'s running max goes
through it with ``torch.maximum`` (not ``torch.cummax``, whose backward
gives a tie's whole gradient to the last tied index, where JAX's
``lax.cummax`` splits it by the balanced max of the same recursion).

Precision: ``sosfilt_exact``, ``sosfilt_blockmat``, ``lfilter1_blockmat``
and ``sosfilt_coupled`` compute in float64 and round their output to the
input's dtype once (:data:`WORK_DTYPE`). JAX computes them in fp32 with
``Precision.HIGHEST`` products. In fp32 the impulse response h, the
cross-block transition and the scanned states round near poles close to
the unit circle, which moves those poles: with ``ParametricEQ``'s random
parameters at 8 x 131072 (a low shelf down to 20 Hz at Q up to 6) fp32
evaluation strayed up to 7e-3 (block) and 0.31 (scan) of the peak from
float64 on the CPU (the biquad-cascade kernel carries its state in float64
for the same reason); the coupled realization in fp32 strayed 1.0e-4 of
the peak on the graphic EQ at +-12 dB (8 x 2 x 131072 on an H100), and
1.3e-3 with TF32 allowed, where in float64 it sits at 4e-8. In float64 no TF32 setting of the caller reaches the block
matmuls (cuBLAS DGEMM on the card) and no process-wide setting is changed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

from ..trace import span
from .ballistics_kernel import ballistics_plain
from .iir_stream_kernel import MAX_SECTIONS, coupled_step

__all__ = [
    "onepole_exact",
    "onepole_varying",
    "lfilter1_exact",
    "peak_decay",
    "sosfilt_coupled",
    "coupled_operators",
    "stabilize_sos",
    "embed_first_order_sos",
    "onepole_ba",
    "ar_impulse_response",
    "block_toeplitz_operators",
    "ballistics_smooth",
    "associative_scan",
    "lti_affine_scan",
    "lfilter1_blockmat",
    "sosfilt_exact",
    "sosfilt_blockmat",
]


def embed_first_order_sos(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Embed first-order (b, a) of shape (bs, 2) as one degenerate biquad
    section ``[b0, b1, 0, 1, a1, 0]`` of shape (bs, 6)."""
    zeros = torch.zeros_like(b[..., :1])
    ones = torch.ones_like(zeros)
    return torch.cat([b, zeros, ones, a[..., 1:2], zeros], dim=-1)


def onepole_ba(alpha: torch.Tensor):
    """First-order (b, a), each (bs, 2), of ``y[n] = (1-a) x[n] + a y[n-1]``."""
    alpha = alpha.reshape(alpha.shape[0], 1)
    zeros = torch.zeros_like(alpha)
    ones = torch.ones_like(alpha)
    b = torch.cat([1.0 - alpha, zeros], dim=-1)
    a = torch.cat([ones, -alpha], dim=-1)
    return b, a


def ar_impulse_response(a1: torch.Tensor, a2: torch.Tensor, length: int) -> torch.Tensor:
    """h[0..length-1] of 1/(1 + a1 z^-1 + a2 z^-2); a1/a2 shape (...,).

    Returns shape (..., length)."""
    h = [torch.ones_like(a1), -a1]
    for _ in range(length - 2):
        h.append(-a1 * h[-1] - a2 * h[-2])
    return torch.stack(h[:length], dim=-1)


def block_toeplitz_operators(sos: torch.Tensor, block: int):
    """Per-(row, section) block-state operators of the biquad cascade.

    Over a block of L samples with incoming state (y[-1], y[-2]), one section
    gives y[k] = sum_{j<=k} h[k-j] f[j] + h[k+1] y[-1] - a2 h[k] y[-2], with
    h the impulse response of its AR part and f its FIR part.

    Args:
        sos: (R, S, 6) normalized coefficients.
        block: time block length L.

    Returns:
        h:  (R, S, L+1) AR impulse response
        Tt: (R, S, L, L) with Tt[j, k] = h[k - j] for k >= j else 0
            (so the intra-block part is f @ Tt)
        h1: (R, S, L) = h[k + 1]        (multiplies the carried y[-1])
        h2: (R, S, L) = -a2 * h[k]      (multiplies the carried y[-2])
    """
    a1 = sos[..., 4]
    a2 = sos[..., 5]
    h = ar_impulse_response(a1, a2, block + 1)  # (R, S, L+1)

    k = torch.arange(block, device=sos.device)
    d = k[None, :] - k[:, None]  # d[j, k] = k - j
    gather = d.clamp(0, block)
    mask = (d >= 0).to(h.dtype)
    Tt = h[..., gather] * mask  # (R, S, L, L)

    h1 = h[..., 1 : block + 1]
    h2 = -a2[..., None] * h[..., :block]
    return h, Tt, h1, h2


def stabilize_sos(sos: torch.Tensor, margin: float = 1e-6) -> torch.Tensor:
    """Project biquad denominators onto the stability triangle.

    A denominator z^2 + a1 z + a2 is stable iff |a2| < 1 and |a1| < 1 + a2.
    Stable sections (every cookbook design) pass bit-identical; unstable
    ones are clamped to a stable neighbour. The clamp is straight-through
    for gradients (forward uses the clamped value, backward the identity).

    Args:
        sos: (..., 6) sections [b0, b1, b2, a0, a1, a2] with a0 == 1.
        margin: distance kept inside the triangle boundary.
    """

    def ste_clip(v, lo, hi):
        return v + (torch.clamp(v, lo, hi) - v).detach()

    a1 = sos[..., 4]
    a2 = ste_clip(sos[..., 5], -1.0 + margin, 1.0 - margin)
    lim = 1.0 + a2.detach() - margin
    a1 = ste_clip(a1, -lim, lim)
    return torch.cat([sos[..., :4], a1[..., None], a2[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# associative scans
# ---------------------------------------------------------------------------


def _take(t: torch.Tensor, dim: int, start, stop=None, step: int = 1) -> torch.Tensor:
    """``t[start:stop:step]`` along ``dim``."""
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(start, stop, step)
    return t[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along ``dim``; ``even`` is as
    long as ``odd`` or one longer."""
    n = odd.shape[dim]
    pairs = torch.stack([_take(even, dim, 0, n), odd], dim=dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] == n:
        return pairs
    return torch.cat([pairs, _take(even, dim, n)], dim=dim)


def associative_scan(combine, elems, dim: int):
    """All prefixes ``e[0], e[0] . e[1], ...`` of ``elems`` along ``dim``
    under an associative ``combine``, in O(log n) depth.

    The recursion of ``lax.associative_scan``: combine adjacent pairs, scan
    that half-length sequence (it holds the odd prefixes), then combine each
    odd prefix with the next even element. The elements therefore combine
    in JAX's order.

    Args:
        combine: ``(a, b) -> a . b`` on tuples of tensors, ``a`` the earlier
            elements; elementwise over every dimension but the trailing
            ones an element owns (e.g. a 2x2 matrix).
        elems: tuple of tensors with the same leading shape up to ``dim``.
        dim: the scanned dimension, counted from the front (>= 0), the same
            for every tensor.

    Returns:
        A tuple of tensors shaped as ``elems``.
    """
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                      tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    later = tuple(_take(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_take(e, dim, 0, -1) for e in odd), later)
    else:
        even = combine(odd, later)
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))


def _affine_combine_2x2(e1, e2):
    """``(A2 A1, A2 u1 + u2)``: the step ``v -> A1 v + u1`` followed by
    ``v -> A2 v + u2``, on (..., 2, 2) matrices and (..., 2) vectors, the
    products written out elementwise."""
    A1, u1 = e1
    A2, u2 = e2
    mm = (A2[..., :, :, None] * A1[..., None, :, :]).sum(-2)
    mv = (A2 * u1[..., None, :]).sum(-1)
    return mm, mv + u2


def _affine_combine_scalar(e1, e2):
    a1, u1 = e1
    a2, u2 = e2
    return a2 * a1, a2 * u1 + u2


def _lti_scan_value(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """All states of v_i = A v_{i-1} + u_i (v_-1 = 0) by one associative
    scan. A: (R, 2, 2), the same for every step of a row; u: (R, n, 2)."""
    A_b = A[:, None].expand(u.shape[0], u.shape[1], 2, 2)
    _, v = associative_scan(_affine_combine_2x2, (A_b, u), 1)
    return v


class _LTIAffineScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, u):
        v = _lti_scan_value(A, u)
        ctx.save_for_backward(A, v)
        return v

    @staticmethod
    def backward(ctx, dv):
        A, v = ctx.saved_tensors
        # the adjoint recurrence lam_i = dv_i + A^T lam_{i+1}: the same scan
        # with A^T over flipped time
        lam = torch.flip(_lti_scan_value(A.transpose(-1, -2), torch.flip(dv, (1,))), (1,))
        dA = (lam[:, 1:, :, None] * v[:, :-1, None, :]).sum(1)
        return dA, lam


def lti_affine_scan(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """v_i = A v_{i-1} + u_i for i = 0..n-1 with v_-1 = 0, all states.

    The cross-block state recurrence of :func:`sosfilt_blockmat`, linear
    and time-invariant: the 2x2 transition ``A`` is the same for every block
    of a section. The forward is one associative scan. The backward does
    not go through the scan's internals (the JAX package's custom VJP): the
    adjoint of an LTI recurrence is the same recurrence run backward with
    A^T, lam_i = dv_i + A^T lam_{i+1}, so it is one more scan and one sum,

        du_i = lam_i,   dA = sum_i lam_i v_{i-1}^T.

    Args:
        A: (R, 2, 2) per-row transition matrix.
        u: (R, n, 2) per-block increments (an initial state is folded into
            ``u[:, 0]`` by the caller).

    Returns:
        v: (R, n, 2), the state after each block.
    """
    return _LTIAffineScan.apply(A, u)


# the dtype the exact and block-state filters compute in (see the module
# docstring); their output rounds to the input's dtype
WORK_DTYPE = torch.float64


def _per_row(coeffs: torch.Tensor, shape) -> torch.Tensor:
    """The per-item ``coeffs`` repeated for each of the ``mid`` rows of an
    item of a signal of ``shape`` (bs, ..., T)."""
    mid = math.prod(shape[1:-1])
    return coeffs.repeat_interleave(mid, dim=0) if mid > 1 else coeffs


def _fold_rows(x: torch.Tensor, coeffs: torch.Tensor):
    """x (bs, ..., T) as (bs * mid, T) rows, with the per-item ``coeffs``
    repeated for each of the ``mid`` rows of an item."""
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1]), _per_row(coeffs, x.shape)


# ---------------------------------------------------------------------------
# the exact filters: associative scan over time, block-state formulation
# ---------------------------------------------------------------------------


def _sos_section_exact(x: torch.Tensor, sec: torch.Tensor) -> torch.Tensor:
    """One biquad section by a 2x2 matrix associative scan over time.

    State v[n] = [y[n], y[n-1]]: v[n] = A v[n-1] + [f[n], 0] with
    A = [[-a1, -a2], [1, 0]] and f[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2].

    Args:
        x: signal (..., T).
        sec: (..., 6) = [b0, b1, b2, a0, a1, a2] with a0 == 1, broadcastable
            against x's leading dimensions.
    """
    x1 = nnf.pad(x, (1, 0))[..., :-1]
    x2 = nnf.pad(x, (2, 0))[..., :-2]
    f = sec[..., 0:1] * x + sec[..., 1:2] * x1 + sec[..., 2:3] * x2

    a1, a2 = sec[..., 4], sec[..., 5]
    A = torch.stack([torch.stack([-a1, -a2], dim=-1),
                     torch.stack([torch.ones_like(a1), torch.zeros_like(a1)], dim=-1)], dim=-2)
    A_t = A[..., None, :, :].expand(*f.shape, 2, 2)
    u_t = torch.stack([f, torch.zeros_like(f)], dim=-1)
    _, v = associative_scan(_affine_combine_2x2, (A_t, u_t), f.ndim - 1)
    return v[..., 0]


def sosfilt_exact(sos: torch.Tensor, x: torch.Tensor, stabilize: bool = True) -> torch.Tensor:
    """Exact cascade of second-order sections (time-domain ``sosfilt``),
    each section one associative scan over time; differentiable by
    autograd through the scans, on any device.

    Args:
        sos: (bs, n_sections, 6) with a0 normalized to 1.
        x: signal (bs, ..., T).
        stabilize: clamp denominators into the stability triangle (no-op
            for stable sections; see :func:`stabilize_sos`).

    Returns:
        Filtered signal, same shape as x.
    """
    if stabilize:
        sos = stabilize_sos(sos)
    extra = x.ndim - 2  # broadcast dims between batch and time
    sos = sos.to(WORK_DTYPE)
    y = x.to(WORK_DTYPE)
    for s in range(sos.shape[-2]):
        y = _sos_section_exact(y, sos[:, s, :].reshape(sos.shape[0], *([1] * extra), 6))
    return y.to(x.dtype)


def sosfilt_blockmat(
    sos: torch.Tensor,
    x: torch.Tensor,
    block: int = 128,
    stabilize: bool = True,
    zi: torch.Tensor | None = None,
    return_zf: bool = False,
):
    """Exact biquad cascade by the block-state formulation.

    Over blocks of L samples, one section with AR impulse response h
    (h[0] = 1, h[m] = -a1 h[m-1] - a2 h[m-2]) gives

      y_i[k] = (f_i convolved causally with h)[k]
               + h[k+1] y_{i-1}[L-1] - a2 h[k] y_{i-1}[L-2]

    so each section is (1) an intra-block lower-triangular Toeplitz product,
    over all rows and blocks one batched matmul (R, nb, L) @ (R, L, L)
    (cuBLAS on the card), and (2) a 2x2 linear recurrence over blocks for
    the two carried samples, :func:`lti_affine_scan`. A Python loop runs
    the S sections in turn.

    It computes in float64 (see the module docstring): for poles very near
    the unit circle (|r| ~ 0.9999, high-Q sections below about 100 Hz at
    44.1 kHz) h cancels in fp32.

    Streaming: ``zi`` (and ``return_zf``) carry the exact filter state
    across consecutive chunks. The state is per section ``[x[-1], x[-2],
    y[-1], y[-2]]`` (the section's input and output history), shape
    ``x.shape[:-1] + (n_sections, 4)``; zeros == rest.

    Args:
        sos: (bs, n_sections, 6) with a0 normalized to 1.
        x: signal (bs, ..., T).
        block: intra-block length L.
        stabilize: clamp denominators into the stability triangle (no-op
            for stable sections; see :func:`stabilize_sos`).
        zi: initial state, shape ``x.shape[:-1] + (n_sections, 4)``.
        return_zf: also return the final state in the same layout (needs
            T to be a multiple of ``block``).

    Returns:
        Filtered signal, same shape as x; with ``return_zf`` a tuple
        ``(y, zf)``.
    """
    if stabilize:
        sos = stabilize_sos(sos)
    T = x.shape[-1]
    rows, sos_rows = _fold_rows(x.to(WORK_DTYPE), sos.to(WORK_DTYPE))
    R, S, L = rows.shape[0], sos_rows.shape[1], block
    pad_t = (-T) % L
    if return_zf and pad_t:
        raise ValueError(
            f"return_zf requires T ({T}) to be a multiple of block ({L}); "
            "pick a streaming chunk size that divides by the block length"
        )
    y = nnf.pad(rows, (0, pad_t))
    Tp = y.shape[-1]
    nb = Tp // L
    z = rows.new_zeros((R, S, 4)) if zi is None else zi.to(WORK_DTYPE).reshape(R, S, 4)

    a2 = sos_rows[..., 5]
    h, Tt, h1, h2 = block_toeplitz_operators(sos_rows, L)
    # the cross-block transition of v = [y[L-1], y[L-2]] of each block
    hL, hL1, hL2 = h[..., L], h[..., L - 1], h[..., L - 2]
    A_all = torch.stack([torch.stack([hL, -a2 * hL1], dim=-1),
                         torch.stack([hL1, -a2 * hL2], dim=-1)], dim=-2)  # (R, S, 2, 2)

    zf = []
    for s in range(S):
        bc, A_s, z_s = sos_rows[:, s, :3], A_all[:, s], z[:, s]
        # the section's input history from the carried state
        x1, x2 = z_s[:, 0:1], z_s[:, 1:2]
        s1 = torch.cat([x1, y[:, :-1]], dim=1)
        s2 = torch.cat([x2, x1, y[:, :-2]], dim=1)
        f = bc[:, 0:1] * y + bc[:, 1:2] * s1 + bc[:, 2:3] * s2

        c = torch.matmul(f.reshape(R, nb, L), Tt[:, s])  # (R, nb, L)
        u = torch.stack([c[..., L - 1], c[..., L - 2]], dim=-1)  # (R, nb, 2)
        # the incoming output history folds into block 0's increment
        v_init = z_s[:, 2:4]
        u0 = u[:, 0] + (A_s * v_init[:, None, :]).sum(-1)
        u = torch.cat([u0[:, None], u[:, 1:]], dim=1)
        v = lti_affine_scan(A_s, u)
        v_prev = torch.cat([v_init[:, None], v[:, : nb - 1]], dim=1)  # state entering each block

        yb = c + h1[:, s, None, :] * v_prev[..., 0:1] + h2[:, s, None, :] * v_prev[..., 1:2]
        zf.append(torch.cat([y[:, -1:], y[:, -2:-1], v[:, -1]], dim=-1))
        y = yb.reshape(R, Tp)
    y = y[:, :T].reshape(x.shape).to(x.dtype)
    if return_zf:
        return y, torch.stack(zf, dim=1).reshape(*x.shape[:-1], S, 4).to(x.dtype)
    return y


def lfilter1_blockmat(
    x: torch.Tensor, b: torch.Tensor, a: torch.Tensor, block: int = 128
) -> torch.Tensor:
    """First-order IIR ``y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1]`` by the
    block-state formulation with a scalar carried state.

    The AR impulse response is the powers of the pole (a ``cumprod``), the
    intra-block part one batched matmul (R, nb, L) @ (R, L, L), and the
    cross-block recurrence v_n = ar^L v_{n-1} + c[n, L-1] a scalar
    associative scan, differentiable by autograd.

    Args:
        x: signal (bs, ..., T).
        b, a: (bs, 2) with a0 == 1.
        block: intra-block length L.
    """
    T = x.shape[-1]
    rows, ba = _fold_rows(x.to(WORK_DTYPE), torch.cat([b, a], dim=-1).to(WORK_DTYPE))
    b, a = ba[:, :2], ba[:, 2:]
    R, L = rows.shape[0], block
    xp = nnf.pad(rows, (0, (-T) % L))
    Tp = xp.shape[-1]
    nb = Tp // L

    ar = -a[:, 1:2]  # (R, 1): y[k] = f[k] + ar y[k-1]
    apow = torch.cat([torch.ones_like(ar), torch.cumprod(ar.expand(R, L), dim=-1)], dim=-1)  # (R, L+1)

    x1 = torch.cat([torch.zeros_like(xp[:, :1]), xp[:, :-1]], dim=-1)
    f = b[:, 0:1] * xp + b[:, 1:2] * x1

    k = torch.arange(L, device=x.device)
    d = k[None, :] - k[:, None]
    Tt = apow[:, d.clamp(0, L)] * (d >= 0).to(apow.dtype)  # Tt[j, k] = ar^(k-j) for k >= j

    c = torch.matmul(f.reshape(R, nb, L), Tt)
    A_b = apow[:, L:].expand(R, nb)
    _, v = associative_scan(_affine_combine_scalar, (A_b, c[..., L - 1]), 1)
    v_prev = torch.cat([torch.zeros_like(v[:, :1]), v[:, : nb - 1]], dim=1)

    yb = c + apow[:, None, 1 : L + 1] * v_prev[..., None]
    return yb.reshape(R, Tp)[:, :T].reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# first-order scans, ballistics and the peak-decay follower
# ---------------------------------------------------------------------------


def _first_order_scan(decay: torch.Tensor, drive: torch.Tensor) -> torch.Tensor:
    """y[n] = decay[n] y[n-1] + drive[n] (y[-1] = 0) along the last
    dimension, by one associative scan; both (..., T) of one shape."""
    _, y = associative_scan(_affine_combine_scalar, (decay, drive), drive.ndim - 1)
    return y


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _coef(v, x: torch.Tensor) -> torch.Tensor:
    """A coefficient as a tensor on x's device, in x's dtype unless it is an
    array or tensor of a narrower float type: that one keeps its type, as
    in JAX, where a float32 coefficient on float64 audio multiplies the
    scan's decays in float32."""
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        t = torch.as_tensor(v, device=x.device)
        if t.is_floating_point() and t.dtype.itemsize < x.dtype.itemsize:
            return t
    return _like(v, x)


def onepole_exact(x: torch.Tensor, alpha, y0: torch.Tensor | None = None) -> torch.Tensor:
    """Exact one-pole lowpass smoother y[n] = (1 - alpha) x[n] + alpha y[n-1].

    ``alpha`` broadcasts against ``x`` (e.g. (bs, 1, 1) against
    (bs, 1, T)); a float32 array or tensor on float64 audio keeps its type
    (see :func:`_coef`). ``y0`` is the carried y[-1] (shape x.shape[:-1];
    None = from rest), so chunk-chained evaluation follows one pass.
    """
    alpha = torch.broadcast_to(_coef(alpha, x), x.shape)
    drive = (1.0 - alpha) * x
    if y0 is not None:
        first = drive[..., :1] + alpha[..., :1] * y0[..., None]
        drive = torch.cat([first, drive[..., 1:]], dim=-1)
    return _first_order_scan(alpha, drive)


def onepole_varying(x: torch.Tensor, alpha, y0: torch.Tensor | None = None) -> torch.Tensor:
    """One-pole smoother with a per-sample coefficient alpha[n]: the
    recursion of :func:`onepole_exact` (which broadcasts any alpha), under
    the JAX package's name."""
    return onepole_exact(x, alpha, y0=y0)


def lfilter1_exact(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Exact first-order IIR y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] by one
    associative scan, in x's dtype.

    Args:
        x: signal (..., T).
        b: numerator (..., 2), broadcastable against x's leading dims.
        a: denominator (..., 2) with a0 == 1.
    """
    x_prev = nnf.pad(x, (1, 0))[..., :-1]
    drive = b[..., 0:1] * x + b[..., 1:2] * x_prev
    decay = torch.broadcast_to(-a[..., 1:2], drive.shape)
    return _first_order_scan(decay, drive)


def ballistics_smooth(
    g: torch.Tensor,
    alpha_attack,
    alpha_release,
    mode: str = "parallel",
    y0=None,
    return_yf: bool = False,
):
    """Attack/release smoothing of a gain-reduction curve, in the JAX
    package's three modes:

      * ``"parallel"`` (the default): the attack-coefficient one-pole, then
        per sample attack where g[n] is below that envelope delayed by one
        sample, release otherwise, and one time-varying one-pole
        (:func:`onepole_varying`); two associative scans, close to the
        branching recursion;
      * ``"exact"``: the branching recursion itself (attack when
        g[n] < y[n-1]), a sequential loop over time; the plain version of
        the ballistics kernel
        (:func:`~dasp_tpu_torch.ops.ballistics_kernel.ballistics_plain`);
      * ``"attack_only"``: the attack-coefficient one-pole alone.

    All are differentiable by autograd on the tensors' own device.

    Args:
        g: gain-reduction curve in dB, shape (bs, ch, T).
        alpha_attack / alpha_release: coefficients broadcastable to g
            (e.g. (bs, 1, 1)); "exact" takes a scalar, bs elements or
            (bs, ch, 1): one coefficient a row.
        mode: "parallel", "exact" or "attack_only".
        y0: carried state ``(y_attack_pass, y_main)`` from a previous chunk,
            each of shape g.shape[:-1]; "parallel" needs both (its branch
            compares against the delayed attack pass, which crosses the
            chunk boundary), the others use ``y_main``; None = from rest.
        return_yf: also return the final state tuple.

    Returns:
        Smoothed curve, same shape as g; with ``return_yf`` a tuple
        ``(y, (ya_f, ym_f))``.
    """
    ya0, ym0 = (None, None) if y0 is None else y0

    if mode == "attack_only":
        y = onepole_exact(g, alpha_attack, y0=ym0)
        return (y, (y[..., -1], y[..., -1])) if return_yf else y

    if mode == "parallel":
        y_a = onepole_exact(g, alpha_attack, y0=ya0)
        # y[n-1]'s stand-in: the attack pass delayed one sample; the first
        # slot takes the previous chunk's last attack-pass value (0 at rest)
        first = torch.zeros_like(y_a[..., :1]) if ya0 is None else ya0[..., None].to(g.dtype)
        y_prev = torch.cat([first, y_a[..., :-1]], dim=-1)
        alpha = torch.where(g < y_prev, torch.broadcast_to(_like(alpha_attack, g), g.shape),
                            torch.broadcast_to(_like(alpha_release, g), g.shape))
        y = onepole_varying(g, alpha, y0=ym0)
        return (y, (y_a[..., -1], y[..., -1])) if return_yf else y

    if mode != "exact":
        raise ValueError(f"Unknown ballistics mode: {mode!r}")
    return ballistics_plain(g, alpha_attack, alpha_release, y0=ym0, return_yf=return_yf)


def _max_combine(a, b):
    return (torch.maximum(a[0], b[0]),)


def running_max(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """The running maximum of ``x`` along ``dim`` (from the end with
    ``reverse``), as ``lax.cummax``: an associative scan with
    ``torch.maximum``, whose backward splits a tie's gradient between the
    tied elements as JAX's does (``torch.cummax`` gives it all to the last
    one)."""
    if reverse:
        return torch.flip(running_max(torch.flip(x, (dim,)), dim), (dim,))
    return associative_scan(_max_combine, (x,), dim)[0]


def peak_decay(g: torch.Tensor, delta, y0: torch.Tensor | None = None, return_yf: bool = False):
    """Peak envelope with linear decay, ``y[n] = max(g[n], y[n-1] - delta)``:
    instant rise, a fall of ``delta`` per sample.

    The max-plus recursion has the exact parallel form
    ``y[n] = cummax(g[k] + delta k)[n] - delta n``, one running max
    (:func:`running_max`). Gradients flow to g (to the maximum, a tie's
    split as in JAX) and to delta.

    Args:
        g: envelope input, shape (bs, ..., T).
        delta: decay per sample (>= 0), broadcastable to g (e.g. (bs, 1, 1)).
        y0: carried y[-1] from a previous chunk (shape g.shape[:-1]; None =
            from rest at g[..., 0]).
        return_yf: also return y[..., -1] (the streaming state).

    The ramp grows as ``delta * n``: in fp32 keep ``delta * T`` below about
    1e4 per call (chunked evaluation restarts it every chunk).
    """
    T = g.shape[-1]
    delta = _like(delta, g)
    ramp = delta * torch.arange(T, dtype=g.dtype, device=g.device)
    y = running_max(g + ramp, g.ndim - 1) - ramp
    if y0 is not None:
        y = torch.maximum(y, y0[..., None] - delta * torch.arange(1, T + 1, dtype=g.dtype, device=g.device))
    return (y, y[..., -1]) if return_yf else y


# ---------------------------------------------------------------------------
# the coupled-form block-state cascade
# ---------------------------------------------------------------------------


def _coupled_state_space(sos: torch.Tensor):
    """Per-section 2-state realization (A, bvec, cvec, d) of a biquad.

    Sections with a complex-conjugate pole pair (disc = a1^2 - 4 a2 < 0,
    every resonant design) get the Gold-Rader coupled form, whose
    transition ``[[re, -im], [im, re]]`` is a decaying rotation: its powers
    never exceed 1, where the direct form's AR impulse response swings
    through about 1/im near the unit circle. Real-pole sections keep the
    controller-canonical realization, well conditioned where the coupled
    form degenerates.

    The recursion is ``s[n] = A s[n-1] + bvec x[n]``,
    ``y[n] = d x[n] + cvec . s[n-1]``.

    Args:
        sos: (..., 6) normalized [b0, b1, b2, 1, a1, a2].

    Returns:
        A (..., 2, 2), bvec (..., 2), cvec (..., 2), d (...,).
    """
    b0, b1, b2 = sos[..., 0], sos[..., 1], sos[..., 2]
    a1, a2 = sos[..., 4], sos[..., 5]
    be1 = b1 - b0 * a1
    be2 = b2 - b0 * a2

    disc = a1 * a1 - 4.0 * a2
    is_cplx = disc < 0.0
    # both branches stay finite for every input, or the unused one would
    # poison the gradient through the select
    re = -a1 / 2.0
    im = torch.sqrt(torch.clamp(-disc, min=1e-30)) / 2.0
    im_safe = torch.clamp(im, min=1e-12)
    r_re = be1 / 2.0
    r_im = -(be1 * re + be2) / (2.0 * im_safe)

    one = torch.ones_like(a1)
    zero = torch.zeros_like(a1)

    def mat(r0c0, r0c1, r1c0, r1c1):
        return torch.stack([torch.stack([r0c0, r0c1], -1), torch.stack([r1c0, r1c1], -1)], -2)

    A = torch.where(is_cplx[..., None, None], mat(re, -im, im, re), mat(-a1, -a2, one, zero))
    bvec = torch.where(is_cplx[..., None], torch.stack([r_re, r_im], -1), torch.stack([one, zero], -1))
    cvec = torch.where(is_cplx[..., None], torch.stack([2.0 * one, zero], -1), torch.stack([be1, be2], -1))
    return A, bvec, cvec, b0


def _matrix_powers(A: torch.Tensor, n: int) -> torch.Tensor:
    """A^0 .. A^(n-1) of (..., 2, 2) matrices as (..., n, 2, 2), by
    doubling the table (log2(n) batched products)."""
    P = torch.eye(2, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], 1, 2, 2)
    Ak = A  # A^(the table's length)
    while P.shape[-3] < n:
        P = torch.cat([P, torch.matmul(Ak[..., None, :, :], P)], dim=-3)
        Ak = torch.matmul(Ak, Ak)
    return P[..., :n, :, :]


def _coupled_operators(sos_rows, L):
    """What the coupled-form cascade computes from its (R, S, 6) sections
    alone, for blocks of ``L``: the output injection rows cA (R, S, L, 2),
    the block transition A_L (R, S, 2, 2), the Toeplitz operators Tt
    (R, S, L, L) and the state-increment columns q (R, S, L, 2)."""
    A, bvec, cvec, d = _coupled_state_space(sos_rows)  # (R, S, 2, 2), (R, S, 2), (R, S, 2), (R, S)
    P = _matrix_powers(A, L)  # (R, S, L, 2, 2): A^k
    cA = torch.einsum("rsi,rskij->rskj", cvec, P)  # cvec A^k: the output injection rows
    Ab = torch.einsum("rskij,rsj->rski", P, bvec)  # A^k bvec
    A_L = torch.matmul(A, P[:, :, L - 1])

    # impulse response t[0] = d, t[m] = cvec A^(m-1) bvec, and the Toeplitz
    # operator Tt[j, k] = t[k - j] (k >= j)
    t = torch.cat([d[..., None], (cA[:, :, : L - 1] * bvec[:, :, None, :]).sum(-1)], dim=-1)  # (R, S, L)
    k = torch.arange(L, device=sos_rows.device)
    dd = k[None, :] - k[:, None]
    Tt = t[..., dd.clamp(0, L - 1)] * (dd >= 0).to(t.dtype)  # (R, S, L, L)
    q = torch.flip(Ab, (2,))  # state-increment columns q[j] = A^(L-1-j) bvec
    return cA, A_L, Tt, q


def _sosfilt_coupled_rows(operators, rows, zi_rows, seq_group=None):
    """The coupled-form cascade on (R, T) rows with the :func:`_coupled_operators`
    of (R, S, 6) sections and an (R, S, 2) initial state, in the inputs'
    dtype; returns the output (R, T) and the final state (R, S, 2). With
    ``seq_group`` the rows are this rank's time block and each section's
    state is continued across the group's blocks (see
    :func:`sosfilt_coupled`)."""
    cA, A_L, Tt, q = operators
    R, T = rows.shape
    S, L = Tt.shape[1], Tt.shape[-1]
    xp = nnf.pad(rows, (0, (-T) % L))
    Tp = xp.shape[-1]
    nb = Tp // L

    y = xp
    zf = []
    for s in range(S):
        yb = y.reshape(R, nb, L)
        c = torch.matmul(yb, Tt[:, s])  # (R, nb, L)
        w = torch.matmul(yb, q[:, s])  # (R, nb, 2): the state increment of each block
        z_s, A_s = zi_rows[:, s], A_L[:, s]
        # the incoming state folds into block 0's increment
        w0 = w[:, 0] + (A_s * z_s[:, None, :]).sum(-1)
        v = lti_affine_scan(A_s, torch.cat([w0[:, None], w[:, 1:]], dim=1))
        if seq_group is not None:
            # this block maps an incoming state v_in to v_in's image A_L^(i+1)
            # v_in plus v at block i: gather every rank's map (M, c) of its
            # whole block, chain the ranks before this one for the true
            # incoming state, and correct linearly
            from ..parallel.mesh import all_gather

            M = _matrix_powers(A_s, nb + 1)[:, 1:]  # (R, nb, 2, 2): A_L^(i+1)
            Ms = all_gather(M[:, -1], seq_group)  # (n, R, 2, 2)
            cs = all_gather(v[:, -1], seq_group)  # (n, R, 2)
            z_ins = [torch.zeros_like(z_s)]
            for j in range(Ms.shape[0] - 1):
                z_ins.append(torch.matmul(Ms[j], z_ins[-1][..., None])[..., 0] + cs[j])
            # every rank keeps every rank's map in its graph: the
            # all-gathers' transposes are collectives that all ranks join
            z_s = torch.stack(z_ins)[torch.distributed.get_rank(seq_group)]
            v = v + torch.matmul(M, z_s[:, None, :, None])[..., 0]
        v_prev = torch.cat([z_s[:, None], v[:, : nb - 1]], dim=1)  # the state entering each block
        y = (c + torch.matmul(v_prev, cA[:, s].transpose(-1, -2))).reshape(R, Tp)
        zf.append(v[:, -1])
    return y[:, :T], torch.stack(zf, dim=1)


def _coupled_realization(sos_rows):
    """The realization of :func:`_coupled_state_space` packed per (row,
    section) as ``[A00, A01, A10, A11, b0, b1, c0, c1, d]``: (R, S, 9), what
    the stream step's kernel reads (:mod:`~dasp_tpu_torch.ops.iir_stream_kernel`)."""
    A, bvec, cvec, d = _coupled_state_space(sos_rows)
    return torch.cat([A.flatten(-2), bvec, cvec, d[..., None]], dim=-1).contiguous()


class CoupledOperators:
    """What :func:`sosfilt_coupled` builds from the sections alone for a
    signal's leading shape and a block length: the (R, S, 6) float64
    sections ``sos_rows`` (stabilized if asked, each item's repeated for its
    rows) and, each made at its first use and kept, the two forms the
    cascade runs on: ``"blocks"``, the :func:`_coupled_operators` of the
    block-state path, and ``"realization"``, the packed
    :func:`_coupled_realization` of the stream step's kernel. Both come
    from the same sections by the same operations whoever asks first, so a
    kept object filters bitwise as a fresh one."""

    __slots__ = ("sos_rows", "block", "_made")

    def __init__(self, sos_rows: torch.Tensor, block: int):
        self.sos_rows, self.block, self._made = sos_rows, block, {}

    def get(self, form: str):
        made = self._made.get(form)
        if made is None:
            if form == "blocks":
                made = _coupled_operators(self.sos_rows, self.block)
            elif form == "realization":
                made = _coupled_realization(self.sos_rows)
            else:
                raise ValueError(f"unknown form {form!r}: 'blocks' or 'realization'")
            self._made[form] = made
        return made


def coupled_operators(sos: torch.Tensor, x_shape, block: int = 128, stabilize: bool = True) -> CoupledOperators:
    """What :func:`sosfilt_coupled` builds from the sections alone for a
    signal of shape ``x_shape`` and blocks of ``block`` (see
    :class:`CoupledOperators`). Pass it as ``sosfilt_coupled(operators=)``
    to filter signals of the same leading shape without building it
    again."""
    if stabilize:
        sos = stabilize_sos(sos)
    return CoupledOperators(_per_row(sos.to(WORK_DTYPE), x_shape), block)


def _coupled_form(x, zi, return_zf, seq_group, sos) -> str:
    """The form of :class:`CoupledOperators` a call of :func:`sosfilt_coupled`
    runs on, from what the call itself shows: ``"realization"`` (the stream
    step's kernel) for a stream step (``return_zf``, no ``seq_group``) of a
    CUDA float32 or float64 x with at most MAX_SECTIONS sections and nothing
    that requires grad under grad mode; else ``"blocks"``."""
    kernel = (return_zf and seq_group is None and x.is_cuda and x.dtype in (torch.float32, torch.float64)
              and sos.shape[-2] <= MAX_SECTIONS
              and not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, zi, sos))))
    return "realization" if kernel else "blocks"


def sosfilt_coupled(
    sos: torch.Tensor | None,
    x: torch.Tensor,
    block: int = 128,
    stabilize: bool = True,
    zi: torch.Tensor | None = None,
    return_zf: bool = False,
    seq_group=None,
    operators=None,
):
    """Exact biquad cascade by the block-state formulation on the coupled
    realization (:func:`_coupled_state_space`).

    The algorithmic shape of :func:`sosfilt_blockmat`, one batched
    lower-triangular Toeplitz matmul per section and a 2x2 scan across
    blocks (:func:`lti_affine_scan`), but built on the section's full
    impulse response t[0] = d, t[m] = cvec A^(m-1) bvec (near a delta for
    audio EQ sections, where the direct form's AR response reaches about
    1/im), on transition powers that are decaying rotations, and with the
    per-block state increment as two more matmul columns
    q[j] = A^(L-1-j) bvec. A^k for k < L comes from a doubling table, A^L
    from it. A Python loop runs the S sections in turn.

    It computes in float64 and rounds the output once (see the module
    docstring); ``_sosfilt_coupled_rows`` computes in its inputs' dtype.

    Streaming: the realization state s holds the whole past (the Toeplitz
    operator carries the full impulse response). Pass ``zi`` of shape
    ``x.shape[:-1] + (n_sections, 2)`` (zeros == rest) and set
    ``return_zf`` to carry it across chunks; it is opaque realization
    state, not ``sosfilt_blockmat``'s.

    The engine a stream step takes on the card: a call with ``return_zf``,
    no ``seq_group``, x a CUDA float32 or float64 tensor, at most 32
    sections, and nothing that requires grad under grad mode runs the whole
    cascade in one launch of the stream step's kernel
    (:func:`~dasp_tpu_torch.ops.iir_stream_kernel.coupled_step`, kernel D):
    the same realization and state, sample by sample in float64, y and zf
    rounded once as here. Every other call (CPU tensors, the offline and
    sharded filters, differentiable steps) runs the block-state loop.

    Sequence-sharded: with ``seq_group``, a ``torch.distributed`` process
    group whose ranks hold consecutive blocks of the time axis (the JAX
    package's ``seq_axis_name``), x is this rank's block and the recursion
    is exact across the blocks: each rank runs its chain from rest, one
    all-gather per section of every rank's affine state map (a 2x2 matrix
    and a 2-vector per row) gives each rank its true incoming state, and it
    corrects its outputs linearly. Use it through
    :func:`~dasp_tpu_torch.parallel.sharded_sosfilt_coupled`; ``zi`` must be
    None and the block's length a multiple of ``block``.

    Args:
        sos: (bs, n_sections, 6) with a0 normalized to 1.
        x: signal (bs, ..., T).
        block: intra-block length L.
        stabilize: clamp denominators into the stability triangle first
            (:func:`stabilize_sos`).
        zi: initial state, shape x.shape[:-1] + (n_sections, 2).
        return_zf: also return the final state (needs T to be a multiple
            of ``block``).
        seq_group: the process group over which the time axis is split
            (None: x is the whole signal).
        operators: what :func:`coupled_operators` built from ``sos`` for
            x's leading shape and ``block``, used in place of building it
            (``sos`` and ``stabilize`` are then not read).

    Returns:
        Filtered signal, same shape as x; with ``return_zf`` a tuple
        ``(y, zf)``.
    """
    T = x.shape[-1]
    with span("iir.coupled.operators"):
        if operators is None:
            operators = coupled_operators(sos, x.shape, block, stabilize)
        sos_rows = operators.sos_rows
        R, S = sos_rows.shape[0], sos_rows.shape[1]
        if R != math.prod(x.shape[:-1]) or operators.block != block:
            raise ValueError(
                f"operators built for {R} rows and blocks of {operators.block}; "
                f"x has {math.prod(x.shape[:-1])} rows and block is {block}"
            )
        form = _coupled_form(x, zi, return_zf, seq_group, sos_rows)
        made = operators.get(form)
    if return_zf and T % block:
        raise ValueError(
            f"return_zf requires T ({T}) to be a multiple of block ({block}); "
            "pick a streaming chunk size that divides by the block length"
        )
    if seq_group is not None and (zi is not None or T % block):
        raise ValueError(
            "sequence-sharded filtering requires zi=None and a per-device "
            f"length divisible by block ({block}); got T={T}"
        )
    if form == "realization":
        with span("kernel_d.forward"):
            y, zf = coupled_step(made, x.reshape(R, T), None if zi is None else zi.reshape(R, S, 2))
        return y.reshape(x.shape), zf.reshape(*x.shape[:-1], S, 2)
    rows = x.to(WORK_DTYPE).reshape(R, T)
    zi_rows = rows.new_zeros((R, S, 2)) if zi is None else zi.to(WORK_DTYPE).reshape(R, S, 2)
    y, zf = _sosfilt_coupled_rows(made, rows, zi_rows, seq_group)
    y = y.reshape(x.shape).to(x.dtype)
    if return_zf:
        return y, zf.reshape(*x.shape[:-1], S, 2).to(x.dtype)
    return y
