"""IIR building blocks: coefficient layouts, stability projection, the
block-state operators of the biquad cascade, the exact scan-based and
block-state filters, and exact ballistics.

PyTorch counterpart of ``dasp_tpu/ops/iir.py``: ``stabilize_sos``,
``embed_first_order_sos``, ``onepole_ba``, ``ar_impulse_response``,
``block_toeplitz_operators`` (which the plain version of the biquad-cascade
kernel is also built from), ``sosfilt_exact`` (a 2x2 matrix associative
scan over time), ``sosfilt_blockmat`` and ``lfilter1_blockmat`` (the
block-state formulation: one batched matmul per section for the
intra-block Toeplitz part, an associative scan over blocks for the carried
state), ``lti_affine_scan`` (that scan, with the adjoint recurrence as its
backward) and ``ballistics_smooth(mode="exact")`` (the plain version of the
ballistics kernel).

:func:`associative_scan` stands in for ``lax.associative_scan``: the same
odd/even recursion, so the elements combine in JAX's order.

Precision: ``sosfilt_exact``, ``sosfilt_blockmat`` and ``lfilter1_blockmat``
compute in float64 and round their output to the input's dtype once
(:data:`WORK_DTYPE`). JAX computes them in fp32 with ``Precision.HIGHEST``
products. In fp32 the impulse response h, the cross-block transition and
the scanned states round near poles close to the unit circle, which moves
those poles: with ``ParametricEQ``'s random parameters at 8 x 131072 (a
low shelf down to 20 Hz at Q up to 6) fp32 evaluation strayed up to 7e-3
(block) and 0.31 (scan) of the peak from float64 on the CPU (the
biquad-cascade kernel carries its state in float64 for the same reason).
In float64 no TF32 setting of the caller reaches the block matmuls
(cuBLAS DGEMM on the card) and no process-wide setting is changed. The
other scan modes of ``ballistics_smooth``, ``sosfilt_coupled``, ``onepole_exact`` and
``lfilter1_exact`` are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

from .ballistics_kernel import ballistics_rows_plain

__all__ = [
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


def ballistics_smooth(
    g: torch.Tensor,
    alpha_attack: torch.Tensor,
    alpha_release: torch.Tensor,
    mode: str = "exact",
    y0=None,
    return_yf: bool = False,
):
    """Attack/release smoothing of a gain-reduction curve, ``mode="exact"``:
    the true branching recursion (attack when g[n] < y[n-1], release
    otherwise), as a sequential loop over time.

    This is the plain PyTorch version of the ballistics kernel
    (:func:`~dasp_tpu_torch.ops.ballistics_kernel.ballistics_rows_plain`),
    differentiable by autograd and run on the tensors' own device. The
    JAX package's ``"parallel"`` and ``"attack_only"`` modes are not ported
    yet (see ROADMAP.md).

    Args:
        g: gain-reduction curve in dB, shape (bs, ch, T).
        alpha_attack / alpha_release: coefficients broadcastable to
            (bs, 1, 1).
        mode: "exact".
        y0: carried state ``(y_attack_pass, y_main)`` from a previous chunk,
            each of shape g.shape[:-1] (only ``y_main`` is used); None = rest.
        return_yf: also return the final state ``(y[..., -1], y[..., -1])``.
    """
    if mode != "exact":
        raise ValueError(
            f"ballistics mode {mode!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 9); the port has mode='exact'"
        )
    bs, ch, T = g.shape
    R = bs * ch

    def rows(alpha):
        alpha = torch.as_tensor(alpha, dtype=g.dtype, device=g.device)
        return torch.broadcast_to(alpha, g.shape)[..., 0].reshape(R)

    ym0 = None if y0 is None else y0[1]
    y0_rows = g.new_zeros(R) if ym0 is None else ym0.reshape(R).to(g.dtype)
    y = ballistics_rows_plain(
        g.reshape(R, T), rows(alpha_attack), rows(alpha_release), y0_rows
    ).reshape(g.shape)
    if return_yf:
        return y, (y[..., -1], y[..., -1])
    return y


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


def _fold_rows(x: torch.Tensor, coeffs: torch.Tensor):
    """x (bs, ..., T) as (bs * mid, T) rows, with the per-item ``coeffs``
    repeated for each of the ``mid`` rows of an item."""
    bs, T = x.shape[0], x.shape[-1]
    mid = math.prod(x.shape[1:-1])
    rows = x.reshape(bs * mid, T)
    if mid > 1:
        coeffs = coeffs.repeat_interleave(mid, dim=0)
    return rows, coeffs


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
