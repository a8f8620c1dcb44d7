"""Banded time-varying fractional multi-tap delay: CUDA kernels and plain
versions.

PyTorch counterpart of ``dasp_tpu/ops/pallas_interp.py``. With the signal
left-extended by ``Dm`` samples (``x_ext``: (bs, chs, Dm + nb*B), signal
sample t at t + Dm) and per-tap delays and gains ``d_stk`` / ``g_stk``
(nt, bs, nb*B), output sample t of tile k = t // B reads the tile's window
``x_ext[..., k*B : k*B + Dm + B]`` at the fractional position

    r_i = (j + Dm) - d_i          j = t - k*B, in the input's dtype
    i0 = floor(r_i),  f = r_i - i0
    wet[b, c, t] = sum_i gv_i * ((1 - f) * win[i0] + f * win[i0 + 1])

with ``gv_i = g_i`` where ``t - d_i >= 0`` and 0 before the signal starts.
A lattice point outside the window [0, Dm + B) counts zero, as the dense
interpolation matrix of ``functional._frac_delay_tiles_ad`` has no such
column. The coordinates are tile-local: at t near 131072 an fp32 ulp of
``t - d`` is 0.0156 samples, enough to flip floor and frac near integers;
only the mask uses the global t, and ``(float) t - d >= 0`` is exact for
t < 2**24.

The linear-interpolation weights are the hat function on the integer
lattice, so the two points are read directly: no row plan, no gates and no
slope bound (the TPU kernel's row plan under-covers spans beyond about 255
lanes, so its ``wraps=False`` path errs at steep delay slopes; see
ROADMAP.md Queue 3). The gradient, with ct the cotangent of wet:

    dx[i0] += ct * gv * (1 - f),   dx[i0 + 1] += ct * gv * f
    dd_i = -sum_c ct * gv * (win[i0 + 1] - win[i0])   (0 where f == 0)
    dg_i =  sum_c ct * mask * interp

At an exact integer r the hat has a kink; like the TPU kernel
(``sign(0) = 0``) the dd term vanishes there, where autodiff of the dense
form splits the tie. Values agree either way.

``_CudaEngine`` launches ``csrc/frac_delay.cu`` (forward) and
``csrc/frac_delay_bwd.cu`` (backward) for float32 tensors on a CUDA device;
``_PlainEngine`` runs the same formulas in plain PyTorch (two gathers
forward; ``index_add_`` for dx) on any device and in any float dtype, and
is what CPU tensors use. Both round the forward in the same order. dx is
computed only when autograd asks for it. On the card dx is summed with
atomics, in an order that changes from run to run, so it is not bitwise
reproducible; dd and dg are (a fixed order per output sample, no atomics).

Launches are counted per kernel: ``frac_delay_pallas.launches`` (forward)
and ``frac_delay_pallas.bwd_launches`` (backward). The name is kept from the
JAX package.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["frac_delay_pallas", "frac_delay_plain", "frac_delay_bwd_plain"]

MAX_TAPS = 2  # the CUDA kernels keep each tap's coordinates in registers


def _coords(d_stk: torch.Tensor, B: int, Dm: int):
    """Per tap and output sample: window start, i0 (as a float), f, the
    start mask and the validity of the two lattice points."""
    Tp = d_stk.shape[-1]
    W = Dm + B
    t = torch.arange(Tp, device=d_stk.device)
    start = t - t % B
    j = (t - start).to(d_stk.dtype)
    r = (j + Dm) - d_stk
    i0 = torch.floor(r)
    f = r - i0
    mask = (t.to(d_stk.dtype) - d_stk) >= 0
    valid0 = (i0 >= 0) & (i0 < W)
    valid1 = (i0 >= -1) & (i0 < W - 1)
    return start, i0, f, mask, valid0, valid1


def _positions(start, i0, valid, offset, T_ext):
    """Flat read positions in x_ext's last axis (clamped where invalid)."""
    pos = start + torch.where(valid, i0, torch.zeros_like(i0)).long() + offset
    return pos.clamp(0, T_ext - 1)


def _gather(x_ext, pos, valid):
    """x_ext[b, c, pos[b, t]] for every channel, 0 where not valid."""
    bs, chs, _ = x_ext.shape
    v = torch.gather(x_ext, 2, pos[:, None, :].expand(bs, chs, pos.shape[-1]))
    return torch.where(valid[:, None, :], v, torch.zeros_like(v))


def _taps(x_ext, d_stk, g_stk, B, Dm):
    """For each tap: (x0, x1, 1 - f, f, gv, mask, pos0, pos1, valid0, valid1)."""
    T_ext = x_ext.shape[-1]
    start, i0, f, mask, valid0, valid1 = _coords(d_stk, B, Dm)
    out = []
    for i in range(d_stk.shape[0]):
        pos0 = _positions(start, i0[i], valid0[i], 0, T_ext)
        pos1 = _positions(start, i0[i], valid1[i], 1, T_ext)
        x0 = _gather(x_ext, pos0, valid0[i])
        x1 = _gather(x_ext, pos1, valid1[i])
        gv = torch.where(mask[i], g_stk[i], torch.zeros_like(g_stk[i]))
        out.append((x0, x1, 1.0 - f[i], f[i], gv, mask[i], pos0, pos1, valid0[i], valid1[i]))
    return out


def frac_delay_plain(x_ext, d_stk, g_stk, B: int, Dm: int) -> torch.Tensor:
    """The plain forward: two gathers per tap, rounded in the kernel's order
    (``gv * ((1 - f) * x0 + f * x1)``, taps summed in order)."""
    wet = None
    for x0, x1, w0, f, gv, *_ in _taps(x_ext, d_stk, g_stk, B, Dm):
        v = gv[:, None, :] * (w0[:, None, :] * x0 + f[:, None, :] * x1)
        wet = v if wet is None else wet + v
    return wet


def frac_delay_bwd_plain(x_ext, d_stk, g_stk, ct, B: int, Dm: int, need_dx: bool = True):
    """The plain backward (see the module docstring).

    Returns:
        ``(dx, dd, dg)``: dx like x_ext (None unless ``need_dx``), dd and dg
        like d_stk.
    """
    bs, chs, T_ext = x_ext.shape
    dx = torch.zeros(bs * chs * T_ext, dtype=x_ext.dtype, device=x_ext.device) if need_dx else None
    rows = (torch.arange(bs * chs, device=x_ext.device) * T_ext).reshape(bs, chs, 1)
    dd, dg = [], []
    for x0, x1, w0, f, gv, mask, pos0, pos1, valid0, valid1 in _taps(x_ext, d_stk, g_stk, B, Dm):
        interp = w0[:, None, :] * x0 + f[:, None, :] * x1
        cg = ct * gv[:, None, :]
        dg.append((ct * mask[:, None, :].to(ct.dtype) * interp).sum(1))
        term = cg * (x1 - x0)
        dd.append(-torch.where((f == 0)[:, None, :], torch.zeros_like(term), term).sum(1))
        if need_dx:
            for pos, valid, w in ((pos0, valid0, w0), (pos1, valid1, f)):
                val = torch.where(valid[:, None, :], cg * w[:, None, :], torch.zeros_like(cg))
                dx.index_add_(0, (rows + pos[:, None, :]).reshape(-1), val.reshape(-1))
    dx = None if dx is None else dx.reshape(bs, chs, T_ext)
    return dx, torch.stack(dd), torch.stack(dg)


class _PlainEngine:
    forward = staticmethod(frac_delay_plain)
    backward = staticmethod(frac_delay_bwd_plain)


def _launch(device, fn, *args) -> None:
    """Call the C entry point ``fn`` with the current stream of ``device``
    (entering it first only when it is not the current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, fn.__name__)


class _CudaEngine:
    @staticmethod
    def forward(x_ext, d_stk, g_stk, B, Dm):
        bs, chs, _ = x_ext.shape
        nt, _, Tp = d_stk.shape
        wet = torch.empty((bs, chs, Tp), dtype=x_ext.dtype, device=x_ext.device)
        if wet.numel() == 0:
            return wet
        _launch(x_ext.device, _build.library().frac_delay_f32,
                x_ext.data_ptr(), d_stk.data_ptr(), g_stk.data_ptr(), wet.data_ptr(), bs, chs, nt, Tp, B, Dm)
        frac_delay_pallas.launches += 1
        return wet

    @staticmethod
    def backward(x_ext, d_stk, g_stk, ct, B, Dm, need_dx=True):
        bs, chs, _ = x_ext.shape
        nt, _, Tp = d_stk.shape
        dx = torch.zeros_like(x_ext) if need_dx else None
        dd = torch.empty_like(d_stk)
        dg = torch.empty_like(g_stk)
        if ct.numel() == 0:
            return dx, dd.zero_(), dg.zero_()
        _launch(x_ext.device, _build.library().frac_delay_bwd_f32,
                x_ext.data_ptr(), d_stk.data_ptr(), g_stk.data_ptr(), ct.data_ptr(),
                None if dx is None else dx.data_ptr(), dd.data_ptr(), dg.data_ptr(),
                bs, chs, nt, Tp, B, Dm)
        frac_delay_pallas.bwd_launches += 1
        return dx, dd, dg


class _FracDelay(torch.autograd.Function):
    """The contraction with its one-pass gradient, evaluated by ``engine``
    (CUDA kernels or plain PyTorch)."""

    @staticmethod
    def forward(ctx, x_ext, d_stk, g_stk, B, Dm, engine):
        wet = engine.forward(x_ext, d_stk, g_stk, B, Dm)
        ctx.save_for_backward(x_ext, d_stk, g_stk)
        ctx.B, ctx.Dm, ctx.engine = B, Dm, engine
        return wet

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        x_ext, d_stk, g_stk = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dd, dg = ctx.engine.backward(x_ext, d_stk, g_stk, ct.contiguous(), ctx.B, ctx.Dm, need[0])
        return dx, dd if need[1] else None, dg if need[2] else None, None, None, None


def _check_shapes(x_ext, d_stk, g_stk, B, Dm):
    if x_ext.ndim != 3:
        raise ValueError(f"x_ext must be (bs, chs, Dm + nb*B), got shape {tuple(x_ext.shape)}")
    bs, _, T_ext = x_ext.shape
    Tp = T_ext - Dm
    if B < 1 or Dm < 0 or Tp < 0 or Tp % B:
        raise ValueError(f"x_ext length {T_ext} is not Dm ({Dm}) + a multiple of B ({B})")
    if d_stk.ndim != 3 or not 1 <= d_stk.shape[0] <= MAX_TAPS or tuple(d_stk.shape[1:]) != (bs, Tp):
        raise ValueError(f"d_stk must be (nt <= {MAX_TAPS}, {bs}, {Tp}), got {tuple(d_stk.shape)}")
    if g_stk.shape != d_stk.shape:
        raise ValueError(f"g_stk {tuple(g_stk.shape)} and d_stk {tuple(d_stk.shape)} differ")


def _check_cuda(*tensors) -> None:
    bs, _, T_ext = tensors[0].shape
    if T_ext >= 2**31 or bs >= 2**16:
        raise ValueError(f"the frac_delay kernels index a row in 32 bits and take bs < 65536, got x_ext "
                         f"{tuple(tensors[0].shape)}")
    for name, t in zip(("x_ext", "d_stk", "g_stk"), tensors):
        if t.dtype != torch.float32:
            raise TypeError(f"frac_delay kernel takes float32, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"frac_delay kernel takes a contiguous {name}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name} is on {t.device}, x_ext on {tensors[0].device}")


def frac_delay_pallas(x_ext, d_stk, g_stk, B: int, Dm: int, wraps: bool = True) -> torch.Tensor:
    """Banded fractional multi-tap delay contraction (see the module
    docstring).

    On a CUDA tensor this launches the CUDA kernels (float32, contiguous);
    on a CPU tensor it runs the plain version in the input's dtype.
    Differentiable with respect to all three tensors (one backward launch).

    Args:
        x_ext: (bs, chs, Dm + nb*B) signal, left-extended by Dm zeros.
        d_stk / g_stk: (nt, bs, nb*B) delays (at most Dm - 1) and gains,
            nt in {1, 2}.
        B: tile length; Dm: history length (any integer: the JAX kernel's
            rounding up to 128 was the TPU's lane geometry).
        wraps: the JAX kernel's row-plan switch, accepted for the same
            signature; this kernel reads the two lattice points of each tap
            directly, so wrapping and smooth delays take the same path.

    Returns:
        wet, (bs, chs, nb*B), in x_ext's dtype.
    """
    del wraps
    B, Dm = int(B), int(Dm)
    _check_shapes(x_ext, d_stk, g_stk, B, Dm)
    if x_ext.device.type == "cpu":
        engine = _PlainEngine
    elif x_ext.device.type == "cuda":
        _check_cuda(x_ext, d_stk, g_stk)
        engine = _CudaEngine
    else:
        raise ValueError(f"frac_delay_pallas runs on CPU or CUDA tensors, not {x_ext.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_ext, d_stk, g_stk)):
        return _FracDelay.apply(x_ext, d_stk, g_stk, B, Dm, engine)
    return engine.forward(x_ext, d_stk, g_stk, B, Dm)


# kernel launches by kernel, counted in _CudaEngine
frac_delay_pallas.launches = 0
frac_delay_pallas.bwd_launches = 0
