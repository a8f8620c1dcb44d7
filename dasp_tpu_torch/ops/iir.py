"""IIR building blocks: coefficient layouts, stability projection, the
block-state operators of the biquad cascade, and exact ballistics.

PyTorch counterpart of the parts of ``dasp_tpu/ops/iir.py`` that the
style-transfer render runs through: ``stabilize_sos``,
``embed_first_order_sos``, ``onepole_ba``, ``ar_impulse_response``,
``block_toeplitz_operators`` (which the plain version of the biquad-cascade
kernel is built from) and ``ballistics_smooth(mode="exact")`` (which is the
plain version of the ballistics kernel). The scan-based filters of that
module are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from .ballistics_kernel import ballistics_rows_plain

__all__ = [
    "stabilize_sos",
    "embed_first_order_sos",
    "onepole_ba",
    "ar_impulse_response",
    "block_toeplitz_operators",
    "ballistics_smooth",
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
