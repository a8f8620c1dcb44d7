"""Exact biquad-cascade filtering: CUDA kernel and plain version.

PyTorch counterpart of ``dasp_tpu/ops/pallas_iir.py`` (forward). For
tensors on a CUDA device the cascade runs in the hand-written kernel
``csrc/sosfilt_cascade.cu``: one thread per row walks time in order and
advances all sections per sample in direct form I. For tensors on the CPU
it runs :func:`sosfilt_rows_plain`, the block-state formulation the TPU
kernel computes: per block of L samples,

    y[k] = sum_{j<=k} h[k-j] f[j] + h[k+1] y[-1] - a2 h[k] y[-2]

with f the section's FIR part and h the impulse response of its AR part;
the intra-block Toeplitz products of all blocks are one batched matmul and
the two carried samples go through a loop over blocks. The two evaluations
round differently (recursion with FMA against Toeplitz sums), so each is
held against float64 ``scipy.signal.sosfilt``.

The names ``sosfilt_pallas`` / ``lfilter1_pallas`` are kept from the JAX
package so that ``filter_method="pallas"`` and ``smoother="pallas"`` mean
the same in both packages; in this package they select the CUDA kernel.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .iir import block_toeplitz_operators, embed_first_order_sos, stabilize_sos

__all__ = ["sosfilt_pallas", "lfilter1_pallas", "sosfilt_plain", "sosfilt_rows_plain"]

# time block of the plain version: the TPU kernel's 128-sample block
BLOCK = 128


def sosfilt_rows_plain(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version on (R, T) rows with (R, S, 6) sections (no
    stabilization here). Differentiable by autograd, on any device."""
    R, T = x.shape
    S = sos.shape[1]
    L = BLOCK
    pad_t = (-T) % L
    y = torch.nn.functional.pad(x, (0, pad_t))
    nb = y.shape[-1] // L
    _, Tt, h1, h2 = block_toeplitz_operators(sos, L)
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
    return y[:, :T]


def _launch(sos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    R, T = x.shape
    S = sos.shape[1]
    y = torch.empty_like(x)
    if R == 0 or T == 0:
        return y
    lib = _build.library()
    if S > lib.sosfilt_cascade_max_sections():
        raise ValueError(
            f"sosfilt kernel takes at most {lib.sosfilt_cascade_max_sections()} sections, got {S}"
        )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sosfilt_cascade_f32(sos.data_ptr(), x.data_ptr(), y.data_ptr(), R, S, T, stream)
    _build.check(err, "sosfilt_cascade_f32")
    sosfilt_pallas.launches += 1
    return y


class _SosfiltKernel(torch.autograd.Function):
    """Forward runs the CUDA kernel; the backward (the adjoint cascade of
    dasp_tpu/ops/pallas_iir.py _rows_bwd) is not ported yet."""

    @staticmethod
    def forward(ctx, sos, x):
        return _launch(sos, x)

    @staticmethod
    def backward(ctx, grad_y):
        raise NotImplementedError(
            "the biquad-cascade kernel has no backward yet: it comes with the "
            "training step (ROADMAP.md Queue 2, kernel A adjoint). For "
            "gradients on the GPU use filter_method='exact' (plain autograd)."
        )


def _rows(sos, x, stabilize):
    if stabilize:
        sos = stabilize_sos(sos)
    bs, T = x.shape[0], x.shape[-1]
    mid = math.prod(x.shape[1:-1])
    rows = x.reshape(bs * mid, T)
    # per-batch sections are shared by the channels of that batch item
    sos_rows = sos.repeat_interleave(mid, dim=0) if mid > 1 else sos
    return sos_rows, rows


def sosfilt_plain(sos: torch.Tensor, x: torch.Tensor, stabilize: bool = True) -> torch.Tensor:
    """:func:`sosfilt_pallas` evaluated by the plain block-state version on
    any device."""
    sos_rows, rows = _rows(sos, x, stabilize)
    return sosfilt_rows_plain(sos_rows, rows).reshape(x.shape)


def sosfilt_pallas(sos: torch.Tensor, x: torch.Tensor, stabilize: bool = True) -> torch.Tensor:
    """Exact time-domain biquad cascade (see the module docstring).

    On a CUDA tensor this launches the CUDA kernel (forward only: backward
    raises ``NotImplementedError``); on a CPU tensor it runs the plain
    block-state version.

    Args:
        sos: (bs, n_sections, 6) with a0 normalized to 1.
        x: signal (bs, ..., T); on CUDA float32 and contiguous.
        stabilize: clamp denominators into the stability triangle first
            (a no-op for every cookbook design; see :func:`stabilize_sos`).

    Returns:
        Filtered signal, same shape as x.
    """
    if x.device.type == "cpu":
        return sosfilt_plain(sos, x, stabilize)
    if x.device.type != "cuda":
        raise ValueError(f"sosfilt_pallas runs on CPU or CUDA tensors, not {x.device}")
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
    sos_rows, rows = _rows(sos, x, stabilize)
    return _SosfiltKernel.apply(sos_rows.contiguous(), rows).reshape(x.shape)


sosfilt_pallas.launches = 0  # kernel launches, counted in _launch


def lfilter1_pallas(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """First-order IIR through the biquad-cascade kernel (b2 = a2 = 0).

    Args:
        x: (bs, ..., T); b/a: (bs, 2) with a0 == 1.
    """
    return sosfilt_pallas(embed_first_order_sos(b, a)[:, None, :], x)
