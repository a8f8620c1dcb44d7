"""Sequence-parallel DSP: the time axis split over the mesh's sp ranks.

PyTorch counterpart of ``dasp_tpu/parallel/sharded.py``. Each function
takes and returns this rank's block of the time axis (and, where the batch
is split over dp, its dp slice of the batch): what the body of the JAX
package's ``shard_map`` sees. A block of T/sp samples is rank
``mesh.index("sp")``'s, in order. Every function is differentiable by
autograd through the collectives of :mod:`~dasp_tpu_torch.parallel.mesh`.

  * :func:`sharded_fft_conv_causal`: causal FIR convolution after a
    (K-1)-sample halo from the left neighbour; the unsharded convolution's
    result up to fp32 reassociation.
  * :func:`sharded_sosfilt_coupled`: the exact biquad cascade; each rank
    filters its block from rest, the ranks' affine state maps are
    all-gathered and each rank corrects its block linearly.
  * :func:`sharded_onepole` and :func:`sharded_ballistics_smooth`'s
    ``"parallel"`` / ``"attack_only"`` modes: per-block one-pole scans and
    the same affine correction.
  * :func:`sharded_ballistics_smooth`'s ``"exact_pallas"`` / ``"exact"``:
    the branching recursion, whose state relays from rank to rank. Rank k
    waits for rank k-1's final state, runs the ballistics kernel (B) once on
    its block, and sends its own final state on; the backward runs the
    relay in reverse through B's backward, which returns the gradient of
    the incoming state. The JAX package's SPMD program runs the kernel sp
    times on every shard and masks the results, so that every shard takes
    part in every collective; here each rank runs it once. The result is
    bitwise the unsharded kernel's.
  * :func:`sharded_tv_freq_filter` and :func:`sharded_tv_power`: the WOLA
    filter and the detectors' power spectrogram over the frames that read
    (or write) this rank's block, after an input halo from both neighbours.
  * :func:`sharded_multi_resolution_stft_loss`: the MR-STFT loss, each
    rank computing an equal share of every resolution's frames, the scalar
    terms summed over the ranks (and over dp when the batch is split).

The JAX package's DFT-matmul branches (``fft_mode="dft"``, XLA:CPU and TPU
workarounds) are not ported: every transform here is ``torch.fft``.
``batch_axis_name`` is accepted where the JAX package takes it: there it
splits the batch inside the ``shard_map``; here the caller holds its dp
slice already, and the MR-STFT loss uses it to sum over dp.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

from ..ops.ballistics_kernel import ballistics_pallas
from ..ops.fir import fft_conv_causal
from ..ops.iir import ballistics_smooth, onepole_varying, sosfilt_coupled
from ..ops.tv_filter import tv_analysis_window, tv_frame_count, tv_freq_filter, tv_stft
from ..utils.loss import (_mag_from_power, _window, a_weighting, a_weighting_fir_taps, fir_prefilter,
                          multi_resolution_stft_loss, reflect_pad)
from .mesh import Mesh, all_gather, psum, relay_recv, relay_send, shift

__all__ = [
    "sharded_fft_conv_causal",
    "sharded_sosfilt_coupled",
    "sharded_tv_freq_filter",
    "sharded_tv_power",
    "sharded_multi_resolution_stft_loss",
    "sharded_ballistics_smooth",
    "sharded_onepole",
]


def _direct_causal_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal convolution as one grouped ``conv1d`` (per item and channel
    kernels), without TF32: the short-IR path."""
    bs, ch, T = x.shape
    K = h.shape[-1]
    h = torch.broadcast_to(h, (bs, ch, K)).to(x.dtype)
    lhs = nnf.pad(x, (K - 1, 0)).reshape(1, bs * ch, T + K - 1)
    rhs = torch.flip(h.reshape(bs * ch, 1, K), (-1,))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = nnf.conv1d(lhs, rhs, groups=bs * ch)
    return out.reshape(bs, ch, T)


def _halo_conv_block(x_blk: torch.Tensor, h: torch.Tensor, halo: int, group, method: str) -> torch.Tensor:
    """Receive the left halo, convolve, crop."""
    conv = _direct_causal_conv if method == "direct" else fft_conv_causal
    if halo == 0:  # a 1-tap IR: pointwise, nothing to exchange
        return conv(x_blk, h)
    left = shift(x_blk[..., -halo:], group, 1)  # rank 0 has no history: zeros
    y = conv(torch.cat([left, x_blk], dim=-1), h)
    return y[..., halo:]


def sharded_fft_conv_causal(x: torch.Tensor, h: torch.Tensor, mesh: Mesh, seq_axis_name: str = "sp",
                            method: str = "auto") -> torch.Tensor:
    """Causal FIR convolution of this rank's time block, the unsharded
    :func:`~dasp_tpu_torch.ops.fft_conv_causal`'s result on it (same zero
    initial history).

    Args:
        x: this rank's block (bs, ch, T/sp) of a (bs, ch, T) signal;
            T/sp must be at least K - 1 (one neighbour's halo).
        h: impulse response (bs, ch, K) or broadcastable, alike on every
            rank.
        mesh / seq_axis_name: the mesh and the axis that splits time.
        method: "fft", "direct" (grouped conv1d) or "auto" (direct for IRs
            up to 4096 taps).

    Returns:
        This rank's block of the convolution.
    """
    sp = mesh.shape[seq_axis_name]
    T_local = x.shape[-1]
    K = h.shape[-1]
    if method == "auto":
        method = "direct" if K <= 4096 else "fft"
    halo = K - 1
    if T_local < halo:
        raise ValueError(
            f"local block {T_local} (T = {T_local * sp} over sp = {sp}) shorter than the halo {halo} "
            f"of a {K}-tap IR; reduce sp or the IR length"
        )
    return _halo_conv_block(x, h, halo, mesh.group(seq_axis_name), method)


def sharded_sosfilt_coupled(sos: torch.Tensor, x: torch.Tensor, mesh: Mesh, seq_axis_name: str = "sp",
                            block: int = 128) -> torch.Tensor:
    """The exact biquad cascade (:func:`~dasp_tpu_torch.ops.sosfilt_coupled`)
    on this rank's time block, continued exactly across the blocks: each
    rank filters from rest, one all-gather per section of every rank's
    affine state map (a 2x2 matrix and a 2-vector per row) gives each rank
    its true incoming state, and it corrects its block linearly. The
    unsharded filter's result up to reassociation.

    Args:
        sos: (bs, n_sections, 6), a0 = 1, alike on every rank.
        x: this rank's block (bs, ch, T/sp); T/sp must divide by ``block``.
        mesh / seq_axis_name: the mesh and the axis that splits time.
        block: the block-state formulation's block length.
    """
    sp = mesh.shape[seq_axis_name]
    T_local = x.shape[-1]
    if T_local % block:
        raise ValueError(
            f"per-device shard {T_local} (T = {T_local * sp} over sp = {sp}) not divisible by block={block}"
        )
    return sosfilt_coupled(sos, x, block=block, seq_group=mesh.group(seq_axis_name))


# ---------------------------------------------------------------------------
# dynamics smoothing. A one-pole y[n] = a[n] y[n-1] + (1 - a[n]) g[n] is
# linear in its initial state: y(t; y_in) = y_zero(t) + C(t) y_in with
# C(t) = prod_{s <= t} a[s]. Each rank scans its block from rest, the
# ranks' maps (y_zero[-1], C[-1]) are all-gathered, and each rank composes
# those of the ranks before it.
# ---------------------------------------------------------------------------


def _onepole_block(g_blk: torch.Tensor, alpha_blk: torch.Tensor, group) -> torch.Tensor:
    y_zero = onepole_varying(g_blk, alpha_blk)  # from rest
    C = torch.cumprod(alpha_blk, dim=-1)  # dy / dy_in
    f_all = all_gather(y_zero[..., -1], group)  # (n, bs, ch)
    P_all = all_gather(C[..., -1], group)
    y_ins = [torch.zeros_like(y_zero[..., -1])]
    for k in range(f_all.shape[0] - 1):
        y_ins.append(f_all[k] + P_all[k] * y_ins[-1])
    # every rank keeps every rank's map in its graph (rank 0 uses none): the
    # all-gathers' transposes are collectives, which every rank must join
    y_in = torch.stack(y_ins)[torch.distributed.get_rank(group)]
    return y_zero + C * y_in[..., None]


def _ballistics_parallel_block(g_blk, aa, ar, group):
    """The sharded "parallel" ballistics: value-equal to
    ``ballistics_smooth(mode="parallel")`` up to fp32 reassociation."""
    aa_b = torch.broadcast_to(aa, g_blk.shape).to(g_blk.dtype)
    ar_b = torch.broadcast_to(ar, g_blk.shape).to(g_blk.dtype)
    y_a = _onepole_block(g_blk, aa_b, group)  # the attack pass
    # the delayed comparison sample crosses the block boundary
    y_prev = torch.cat([shift(y_a[..., -1:], group, 1), y_a[..., :-1]], dim=-1)
    alpha = torch.where(g_blk < y_prev, aa_b, ar_b)
    return _onepole_block(g_blk, alpha, group)


def sharded_onepole(g: torch.Tensor, alpha, mesh: Mesh, seq_axis_name: str = "sp",
                    batch_axis_name=None) -> torch.Tensor:
    """The (time-varying) one-pole :func:`~dasp_tpu_torch.ops.onepole_varying`
    from rest on this rank's time block, continued exactly across blocks.
    ``alpha`` broadcasts against g: per-item coefficients (bs, 1, 1), or
    per-sample ones as this rank's block like g."""
    sp = mesh.shape[seq_axis_name]
    alpha = torch.as_tensor(alpha, dtype=g.dtype, device=g.device)
    if sp == 1:
        return onepole_varying(g, alpha)
    return _onepole_block(g, torch.broadcast_to(alpha, g.shape), mesh.group(seq_axis_name))


def _ballistics_exact_relay(g, aa, ar, group, mode):
    """The exact branching recursion on this rank's block, its state relayed
    from rank to rank (see the module docstring)."""
    y0 = relay_recv(g[..., 0], group, g, aa, ar)
    if mode == "exact_pallas":
        y, (yf, _) = ballistics_pallas(g, aa, ar, y0=y0, return_yf=True)
    else:  # "exact": the plain loop
        y, (yf, _) = ballistics_smooth(g, aa, ar, mode="exact", y0=(y0, y0), return_yf=True)
    return relay_send(y, yf, group)


def sharded_ballistics_smooth(g: torch.Tensor, alpha_attack, alpha_release, mesh: Mesh,
                              seq_axis_name: str = "sp", mode: str = "exact_pallas",
                              batch_axis_name=None) -> torch.Tensor:
    """Attack/release smoothing of this rank's time block of a gain curve.

    Pass ``functools.partial(sharded_ballistics_smooth, mesh=mesh)`` as a
    processor's ``smoother=`` to keep the dynamics stage sequence-sharded.

    Modes and their unsharded equivalents:

      * ``"exact_pallas"`` (default) / ``"exact"``: the branching recursion,
        bitwise :func:`~dasp_tpu_torch.ops.ballistics_pallas` /
        ``ballistics_smooth(mode="exact")`` on the whole row. The state
        relays from rank to rank: one launch of the kernel per rank, the
        ranks in turn, so the wall time is about one unsharded pass
        whatever sp, and the compute is that pass's once (the JAX package's
        masked relay computes it sp times).
      * ``"parallel"`` / ``"attack_only"``: the two-scan approximation and
        the attack-only one-pole, ``ballistics_smooth``'s of the same mode
        up to fp32 reassociation, every rank at once.

    Args:
        g: this rank's block (bs, ch, T/sp) of the gain curve.
        alpha_attack / alpha_release: coefficients with bs elements.
        mode: "exact_pallas", "exact", "parallel" or "attack_only".
    """
    if mode not in ("exact_pallas", "exact", "parallel", "attack_only"):
        raise ValueError(
            f"sharded_ballistics_smooth mode must be one of 'exact_pallas', "
            f"'exact', 'parallel', 'attack_only'; got {mode!r}")
    sp = mesh.shape[seq_axis_name]
    shape = (g.shape[0],) + (1,) * (g.ndim - 1)
    aa = torch.as_tensor(alpha_attack, dtype=g.dtype, device=g.device).reshape(shape)
    ar = torch.as_tensor(alpha_release, dtype=g.dtype, device=g.device).reshape(shape)
    if sp == 1:
        if mode == "exact_pallas":
            return ballistics_pallas(g.contiguous(), aa, ar)
        return ballistics_smooth(g, aa, ar, mode=mode)
    group = mesh.group(seq_axis_name)
    if mode == "attack_only":
        return _onepole_block(g, torch.broadcast_to(aa, g.shape), group)
    if mode == "parallel":
        return _ballistics_parallel_block(g, aa, ar, group)
    return _ballistics_exact_relay(g.contiguous(), aa, ar, group, mode)


# ---------------------------------------------------------------------------
# WOLA (time-varying filtering) and STFT losses. Frames are independent
# given an input halo: analysis computes the frames that read this rank's
# block, synthesis the frames that write it (the n_fft/hop - 1 frames whose
# tails cross a block boundary are recomputed on the right neighbour
# instead of exchanging output tails), so the only communication is the
# input halo.
# ---------------------------------------------------------------------------


def _ring_halo(x_blk: torch.Tensor, lh: int, rh: int, group) -> torch.Tensor:
    """x_blk with lh samples of the left neighbour's block before it and rh
    of the right one's after it (zeros at the ends, as the unsharded
    framing's zero padding)."""
    parts = []
    if lh:
        parts.append(shift(x_blk[..., -lh:], group, 1))
    parts.append(x_blk)
    if rh:
        parts.append(shift(x_blk[..., :rh], group, -1))
    return torch.cat(parts, dim=-1)


def _check_tv_shard(T: int, frame_size: int, hop: int, halo: int, sp: int) -> None:
    if T % sp != 0:
        raise ValueError(f"sequence length {T} not divisible by sp={sp}")
    T_local = T // sp
    if T_local % hop != 0:
        raise ValueError(f"per-device shard {T_local} not divisible by hop={hop}")
    if T_local < halo:
        raise ValueError(
            f"per-device shard {T_local} shorter than the halo {halo}; "
            f"reduce sp (or the FFT/frame size)"
        )


def _windowed_frames(x_ext: torch.Tensor, frame_size: int, hop: int) -> torch.Tensor:
    window = torch.from_numpy(tv_analysis_window(frame_size, hop)).to(device=x_ext.device, dtype=x_ext.dtype)
    return x_ext.unfold(-1, frame_size, hop) * window


def sharded_tv_freq_filter(x: torch.Tensor, H: torch.Tensor, frame_size: int, hop: int, mesh: Mesh,
                           seq_axis_name: str = "sp", batch_axis_name=None) -> torch.Tensor:
    """:func:`~dasp_tpu_torch.ops.tv_freq_filter` of this rank's time block.

    Same contract (H: (bs, n_frames, n_bins), the per-frame response of the
    whole signal, alike on every rank of the sp group; real or complex) and
    the same result up to fp32 reassociation: each rank analyses, filters
    and overlap-adds only the frames that write its T/sp samples (plus
    n_fft/hop - 1 recomputed boundary frames), after an (n_fft - hop)-sample
    halo from the left neighbour and a (frame_size - hop)-sample one from
    the right. Beyond the unsharded op's limits: sp | T, hop | T/sp and
    T/sp >= n_fft - hop.
    """
    sp = mesh.shape[seq_axis_name]
    if sp == 1:
        return tv_freq_filter(x, H, frame_size, hop)
    bs, chs, T_local = x.shape
    T = T_local * sp
    n_bins = H.shape[-1]
    n_fft = 2 * (n_bins - 1)
    n_frames = tv_frame_count(T, frame_size, hop)
    if H.shape[0] != bs or H.shape[1] != n_frames:
        raise ValueError(
            f"H has shape {tuple(H.shape)}; expected ({bs}, {n_frames}, n_bins) "
            f"for seq_len={T}, frame_size={frame_size}, hop={hop}."
        )
    if frame_size % (2 * hop) != 0:
        raise ValueError(f"frame_size ({frame_size}) must be a multiple of 2*hop ({2 * hop}).")
    if n_fft < 2 * frame_size or n_fft % hop != 0:
        raise ValueError(
            f"n_fft ({n_fft}) must be >= 2*frame_size ({2 * frame_size}) and a multiple of hop ({hop})."
        )
    _check_tv_shard(T, frame_size, hop, n_fft - hop, sp)
    group = mesh.group(seq_axis_name)
    Th = T_local // hop
    nch = n_fft // hop
    F = Th + nch - 1
    # H's frames with q phantom rows in front: rank d's F frames are rows
    # [d * Th, d * Th + F); a phantom frame multiplies to zero where the
    # unsharded overlap-add has no frame
    q = nch - frame_size // hop
    d = torch.distributed.get_rank(group)
    H_loc = torch.cat([H.new_zeros((bs, q, n_bins)), H], dim=1)[:, d * Th : d * Th + F]

    x_ext = _ring_halo(x, n_fft - hop, frame_size - hop, group)
    X = torch.fft.rfft(_windowed_frames(x_ext, frame_size, hop), n_fft, dim=-1)  # (bs, chs, F, n_bins)
    yf = torch.fft.irfft(X * H_loc[:, None].to(X.dtype), n_fft, dim=-1)
    # overlap-add at hop; frame j starts at output-local j * hop - (n_fft - hop)
    out_len = (F - 1) * hop + n_fft
    cols = yf.reshape(bs * chs, F, n_fft).transpose(1, 2)
    y = nnf.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(bs, chs, out_len)
    return y[..., n_fft - hop : n_fft - hop + T_local]


def sharded_tv_power(x: torch.Tensor, frame_size: int, hop: int, n_fft: int, mesh: Mesh,
                     seq_axis_name: str = "sp", batch_axis_name=None) -> torch.Tensor:
    """The channel-mean power spectrogram of the WOLA analysis frames,
    ``mean_chs |tv_stft(x)|^2``, with the frames computed sequence-sharded:
    each rank transforms the frames that read its block, after a
    (frame_size - hop)-sample halo from each neighbour.

    Returns the whole signal's frame sequence, (bs, n_frames, n_bins),
    alike on every rank of the sp group: what the spectral detectors
    (dynamic_eq, spectral_gate) consume for their frame-rate gain logic.
    """
    sp = mesh.shape[seq_axis_name]
    bs, chs, T_local = x.shape
    if sp == 1:
        X = tv_stft(x, frame_size, hop, n_fft)
        return torch.mean(X.real**2 + X.imag**2, dim=1)
    if frame_size % (2 * hop) != 0:
        raise ValueError(f"frame_size ({frame_size}) must be a multiple of 2*hop ({2 * hop}).")
    T = T_local * sp
    _check_tv_shard(T, frame_size, hop, frame_size - hop, sp)
    group = mesh.group(seq_axis_name)
    Th = T_local // hop
    left = frame_size - hop
    X = torch.fft.rfft(_windowed_frames(_ring_halo(x, left, left, group), frame_size, hop), n_fft, dim=-1)
    P_loc = torch.mean(X.real**2 + X.imag**2, dim=1)  # (bs, F2, n_bins), F2 = Th + frame_size/hop - 1
    Pg = all_gather(P_loc, group)  # (sp, bs, F2, n_bins)
    # consecutive ranks overlap by frame_size/hop - 1 rows: rows [0, Th) of
    # every rank, then the last rank's tail rows
    main = Pg[:, :, :Th].permute(1, 0, 2, 3).reshape(bs, sp * Th, -1)
    return torch.cat([main, Pg[-1, :, Th:]], dim=1)


def _mrstft_partial(yh, y, *, fft_size, hop, win, sp, d, sp_group, w_sc, w_log_mag, w_lin_mag, eps,
                    auraloss_compat, weight, dp_group=None, dp=1):
    """One resolution's loss from the whole signals: rank d of the sp group
    computes frames [d * F_each, (d + 1) * F_each) (masked past the true
    count) and every reduction is summed over the ranks."""
    T = y.shape[-1]
    pad = fft_size // 2
    lead_shape = y.shape[:-1]
    yhp, yp = reflect_pad(yh, pad), reflect_pad(y, pad)
    n_frames = 1 + (T + 2 * pad - fft_size) // hop
    F_each = -(-n_frames // sp)
    need = (sp * F_each - 1) * hop + fft_size
    extra = need - yp.shape[-1]
    if extra > 0:
        yhp, yp = nnf.pad(yhp, (0, extra)), nnf.pad(yp, (0, extra))
    W = (F_each - 1) * hop + fft_size
    wh = yhp[..., d * F_each * hop : d * F_each * hop + W]
    wy = yp[..., d * F_each * hop : d * F_each * hop + W]
    window = _window(fft_size, win, y.dtype, y.device)

    def mag(sig):
        spec = torch.fft.rfft(sig.unfold(-1, fft_size, hop) * window, fft_size, dim=-1)
        return _mag_from_power(spec.real**2 + spec.imag**2, eps, not auraloss_compat)

    mag_hat = mag(wh) * weight
    mag_ref = mag(wy) * weight
    frame = d * F_each + torch.arange(F_each, device=y.device)
    m = (frame < n_frames).to(y.dtype)[:, None]
    n_bins = fft_size // 2 + 1
    lead = math.prod(lead_shape) * dp  # the whole batch's lead count
    count = lead * n_frames * n_bins

    def total(v):  # summed over sp, and over dp where the batch is split
        v = psum(v, sp_group)
        return psum(v, dp_group) if dp_group is not None else v

    loss = y.new_zeros(())
    if w_sc:
        if auraloss_compat:
            # per-item Frobenius sums assemble over sp; the mean over items
            # over dp (each dp rank holds its own items)
            num = psum(torch.sum((mag_ref - mag_hat) ** 2 * m, dim=(-2, -1)), sp_group)
            den = psum(torch.sum(mag_ref**2 * m, dim=(-2, -1)), sp_group)
            sc_items = torch.sqrt(num) / torch.sqrt(den)
            sc = (psum(torch.sum(sc_items), dp_group) / lead) if dp_group is not None else torch.mean(sc_items)
        else:
            num = total(torch.sum((mag_ref - mag_hat) ** 2 * m))
            den = total(torch.sum(mag_ref**2 * m))
            sc = torch.sqrt(num) / (torch.sqrt(den) + eps)
        loss = loss + w_sc * sc
    if w_log_mag:
        loss = loss + w_log_mag * total(torch.sum(torch.abs(torch.log(mag_ref) - torch.log(mag_hat)) * m)) / count
    if w_lin_mag:
        loss = loss + w_lin_mag * total(torch.sum(torch.abs(mag_ref - mag_hat) * m)) / count
    return loss


def sharded_multi_resolution_stft_loss(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    mesh: Mesh,
    seq_axis_name: str = "sp",
    fft_sizes=(1024, 2048, 512),
    hop_sizes=None,
    win_lengths=(600, 1200, 240),
    w_sc: float = 1.0,
    w_log_mag: float = 1.0,
    w_lin_mag: float = 0.0,
    perceptual_weighting: bool = False,
    sample_rate=None,
    eps: float = 1e-8,
    auraloss_compat: bool = False,
    batch_axis_name=None,
) -> torch.Tensor:
    """:func:`~dasp_tpu_torch.utils.multi_resolution_stft_loss` of signals
    whose time axis is split over sp: ``y_hat`` and ``y`` are this rank's
    blocks. The signals are all-gathered once (T samples, small next to the
    spectrograms), each rank computes an equal share of every resolution's
    frames, and the scalar terms are summed over the sp ranks. With
    ``batch_axis_name`` (e.g. "dp"), each dp rank holds its slice of the
    batch and the terms are summed over dp too, so the loss is the whole
    batch's (its spectral convergence is a ratio of sums over the whole
    batch, not a mean of the ranks' losses).

    Returns the loss, alike on every rank; its gradient reaches each rank's
    block. Value equal to the unsharded loss up to fp32 reassociation.
    """
    sp = mesh.shape[seq_axis_name]
    dp_group = mesh.group(batch_axis_name) if batch_axis_name else None
    if sp == 1 and dp_group is None:
        return multi_resolution_stft_loss(
            y_hat, y, fft_sizes=fft_sizes, hop_sizes=hop_sizes, win_lengths=win_lengths, w_sc=w_sc,
            w_log_mag=w_log_mag, w_lin_mag=w_lin_mag, perceptual_weighting=perceptual_weighting,
            sample_rate=sample_rate, auraloss_compat=auraloss_compat,
        )
    if perceptual_weighting and sample_rate is None:
        raise ValueError("perceptual_weighting requires sample_rate")
    if hop_sizes is None:
        hop_sizes = (120, 240, 50) if auraloss_compat else tuple(n // 4 for n in fft_sizes)
    sp_group = mesh.group(seq_axis_name)
    yh = all_gather(y_hat, sp_group, dim=-1, tiled=True)
    yg = all_gather(y, sp_group, dim=-1, tiled=True)
    if perceptual_weighting and auraloss_compat:
        taps = a_weighting_fir_taps(sample_rate)
        yh, yg = fir_prefilter(yh, taps), fir_prefilter(yg, taps)
    d = mesh.index(seq_axis_name)
    out = y.new_zeros(())
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        if perceptual_weighting and not auraloss_compat:
            freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
            weight = torch.as_tensor(a_weighting(freqs), dtype=y.dtype, device=y.device)
        else:
            weight = 1.0
        out = out + _mrstft_partial(
            yh, yg, fft_size=n_fft, hop=hop, win=win, sp=sp, d=d, sp_group=sp_group, w_sc=w_sc,
            w_log_mag=w_log_mag, w_lin_mag=w_lin_mag, eps=eps, auraloss_compat=auraloss_compat,
            weight=weight, dp_group=dp_group, dp=mesh.shape[batch_axis_name] if batch_axis_name else 1,
        )
    return out / len(fft_sizes)


def whole_signal(fn, mesh: Mesh, seq_axis_name: str = "sp", gather: bool = True):
    """A sequence-sharded function as a hook on the whole time axis: the
    returned callable takes a signal (bs, chs, T) that every rank of the sp
    group holds alike (the JAX package's hooks see global arrays), hands
    ``fn`` this rank's block, and with ``gather`` all-gathers the blocks of
    the result back into the whole signal. Use it where the stages around
    the hook are not sequence-sharded, e.g. ``tv_filter_fn=whole_signal(
    partial(sharded_tv_freq_filter, mesh=mesh), mesh)`` in a chain that
    runs on the whole signal; ``gather=False`` for
    :func:`sharded_tv_power`, whose result is the whole frame sequence
    already."""
    from .mesh import Sharding

    group = mesh.group(seq_axis_name)

    def hook(x, *args, **kwargs):
        spec = (None,) * (x.ndim - 1) + (seq_axis_name,)
        y = fn(Sharding(mesh, spec).block(x), *args, **kwargs)
        return all_gather(y, group, dim=-1, tiled=True) if gather else y

    return hook
