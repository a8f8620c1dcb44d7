"""One eval-mode layer of the TCN encoder in one launch: CUDA kernel E and
its plain version.

A layer of :class:`~dasp_tpu_torch.models.tcn.TCNBlock` is a convolution
with no padding, its bias, PReLU (one slope) or ReLU, and BatchNorm. In
eval mode BatchNorm is a per-channel affine of the activation, so the whole
layer is one function of the input:

    acc = conv1d(bf16(x), bf16(w), stride, dilation)        fp32 sums
    v   = bf16(bf16(acc) + bf16(bias))
    v   = PReLU: v > 0 ? v : bf16(bf16(slope) * v);  ReLU: max(v, 0)
    y   = bf16(((gamma * (v - mean)) * invstd) + beta),  invstd = 1 / sqrt(var + eps)

in the configuration's bf16 (flax's ``nn.Conv`` with ``dtype=bfloat16``, and
cuDNN's path on the card, which adds the bias in a pass of its own): bf16
operands, fp32 accumulation, one rounding of the convolution's output and
one after the bias is added to it, one after the activation, BatchNorm's
affine in fp32 and one rounding after it, each fp32 operation rounded on its
own. The running
statistics and the affine are read at every call: nothing folded is kept.

:func:`tcn_layer` runs it by ``_build.engine``: on a CUDA tensor the
hand-written kernel of ``csrc/tcn_layer.cu`` (one launch: an implicit GEMM
on the tensor cores with the bias, activation and BatchNorm in its
epilogue; a direct kernel for one input channel), on a CPU tensor
:func:`tcn_layer_plain`, the same rounding in PyTorch with the sums taken
in float64. ``TCNBlock._layer`` decides when a layer comes here.

Layout: the kernel reads and writes activations channels-last. The output
has the NCW shape (B, 256, T_out) that the module's callers expect, over
NWC memory (strides (T_out * 256, 1, 256)), and a call reads such an input
as it is: from the first layer (one channel, where NCW is NWC) to the time
mean the activations are never copied to another layout.

Launches are counted in :mod:`dasp_tpu_torch.trace` as
``kernel_e.forward``, one count a launch, inside the span of the same name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from .. import _build
from ..trace import count, span

__all__ = ["CHANNELS", "accepts", "out_len", "tcn_layer", "tcn_layer_plain"]

# the kernel's output channels (csrc/tcn_layer.cu kCout) and K-slab (kBK):
# C_in is 1 or a multiple of the slab
CHANNELS = 256
_SLAB = 64
# the one-channel path: taps (kMaxTaps), output rows a block (kDirectRows),
# and the input samples a block stages in shared memory
_MAX_DIRECT_TAPS = 16
_DIRECT_ROWS = 64
_MAX_DIRECT_SPAN = 4096


def out_len(n: int, taps: int, stride: int, dilation: int) -> int:
    """Output length of a convolution with no padding."""
    return (n - dilation * (taps - 1) - 1) // stride + 1


def _direct_span(taps: int, stride: int, dilation: int) -> int:
    return (_DIRECT_ROWS - 1) * stride + (taps - 1) * dilation + 1


def accepts(x: torch.Tensor, weight: torch.Tensor, stride: int, dilation: int) -> bool:
    """Whether kernel E takes a layer of ``weight`` (256, C_in, taps) on
    ``x`` (B, C_in, T): C_in a multiple of 64, or 1 with at most 16 taps
    (and a window of the input that fits the block's shared memory), at
    least one output sample, and rows that 32-bit indices reach."""
    if x.dim() != 3 or weight.dim() != 3 or stride < 1 or dilation < 1:
        return False
    c_out, c_in, taps = weight.shape
    B, _, T = x.shape
    if c_out != CHANNELS or x.shape[1] != c_in or B < 1:
        return False
    rows = B * out_len(T, taps, stride, dilation)
    if rows < B or rows * CHANNELS >= 2**31 or B * T * c_in >= 2**31:
        return False
    if c_in == 1:
        return taps <= _MAX_DIRECT_TAPS and _direct_span(taps, stride, dilation) <= _MAX_DIRECT_SPAN and B < 2**16
    return c_in % _SLAB == 0


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    """y (B, C, T) over NWC memory (no copy where it already is)."""
    return y.transpose(1, 2).contiguous().transpose(1, 2)


def tcn_layer_plain(x, weight, bias, slope, mean, var, gamma, beta, eps: float, stride: int, dilation: int):
    """The plain version: the layer of the module docstring in PyTorch on
    any device, the convolution's sums in float64 (then fp32), every other
    operation as the kernel rounds it. Returns (B, 256, T_out) bf16 over NWC
    memory."""
    bf = torch.bfloat16
    acc = nnf.conv1d(x.to(bf).double(), weight.to(bf).double(), stride=stride, dilation=dilation).float()
    v = (acc.to(bf).float() + bias.to(bf).float()[:, None]).to(bf)
    if slope is None:
        v = torch.where(v < 0, torch.zeros_like(v), v)
    else:
        v = torch.where(v > 0, v, (slope.to(bf).float() * v.float()).to(bf))
    inv = 1 / torch.sqrt(var.float() + eps)
    y = (gamma.float()[:, None] * (v.float() - mean.float()[:, None])) * inv[:, None] + beta.float()[:, None]
    return _channels_last(y.to(bf))


def _nwc(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, T) in bf16 over NWC memory whose data starts on 16 bytes (a
    cp.async copy): x itself where it already is (a kernel E output, or one
    channel), else a copy."""
    B, C, T = x.shape
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    if (x.stride() == (T * C, 1, C) or C == 1 and x.is_contiguous()) and x.data_ptr() % 16 == 0:
        return x
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _tcn_layer_cuda(x, weight, bias, slope, mean, var, gamma, beta, eps: float, stride: int, dilation: int):
    B, c_in, T = x.shape
    taps = weight.shape[2]
    t_out = out_len(T, taps, stride, dilation)
    x = _nwc(x)
    w = torch.empty((CHANNELS, taps, c_in), dtype=torch.bfloat16, device=x.device)
    w.copy_(weight.permute(0, 2, 1))  # tap-major, cast in the same pass, from the parameter as it is now
    bias, mean, var, gamma, beta = (_f32(t) for t in (bias, mean, var, gamma, beta))
    slope = None if slope is None else _f32(slope)
    y = torch.empty((B, t_out, CHANNELS), dtype=torch.bfloat16, device=x.device)
    _build.launch("tcn_layer_bf16", x.device, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  None if slope is None else slope.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), y.data_ptr(), float(eps), B, T, t_out, c_in, taps, stride, dilation)
    count("kernel_e.forward")
    return y.transpose(1, 2)


def _check(x, weight, stride, dilation, slope, *channel_params):
    if not accepts(x, weight, stride, dilation):
        raise ValueError(f"kernel E takes x (B, C_in, T) and weight ({CHANNELS}, C_in, taps) with C_in 1 (at most "
                         f"{_MAX_DIRECT_TAPS} taps) or a multiple of {_SLAB} and at least one output sample, got x "
                         f"{tuple(x.shape)}, weight {tuple(weight.shape)}, stride {stride}, dilation {dilation}")
    if slope is not None and slope.numel() != 1:
        raise ValueError(f"kernel E takes one PReLU slope, got {slope.numel()}")
    if any(t.numel() != CHANNELS for t in channel_params):
        raise ValueError(f"kernel E takes {CHANNELS} biases and BatchNorm values, got "
                         f"{[tuple(t.shape) for t in channel_params]}")
    for t in (weight, slope, *channel_params):
        if t is not None and t.device != x.device:
            raise ValueError(f"a parameter on {t.device} but x on {x.device}")


def tcn_layer(x, weight, bias, slope, mean, var, gamma, beta, eps: float, stride: int, dilation: int):
    """One eval-mode TCN layer (see the module docstring) on ``x`` (B,
    C_in, T) with the convolution's ``weight`` (256, C_in, taps) and
    ``bias``, PReLU's one ``slope`` (None: ReLU) and BatchNorm's running
    ``mean`` and ``var``, affine ``gamma`` and ``beta`` and ``eps``. Kernel
    E on a CUDA tensor, the plain version on a CPU one. Returns (B, 256,
    T_out) bf16 over channels-last memory. The kernel computes no gradient:
    a caller that needs one takes another path."""
    engine = _build.engine("tcn_layer", x.device, tcn_layer_plain, _tcn_layer_cuda, _check, x, weight, stride,
                           dilation, slope, bias, mean, var, gamma, beta)
    with span("kernel_e.forward"):
        return engine(x, weight, bias, slope, mean, var, gamma, beta, eps, stride, dilation)
