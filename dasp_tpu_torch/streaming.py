"""Stateful chunk-by-chunk processing for low-latency serving.

PyTorch counterpart of ``dasp_tpu/streaming.py``. The offline effects
(:mod:`dasp_tpu_torch.functional`) render whole clips; a server instead
pushes fixed-size chunks through a step function with the state carried on
the device. Every ``*_stream`` function is pure: ``(x_chunk, state) ->
(y_chunk, state)``, and processing a signal chunk by chunk reproduces the
offline effect (``tests/test_torch_streaming.py`` holds each one against
the offline render and against the JAX package's stream). ``state=None``
starts from rest; chunk lengths must be multiples of the IIR block length
(128 by default, 2.9 ms at 44.1 kHz) and, for the WOLA streams, of their
hop.

The IIR streams carry the block-state filters' ``zi`` / ``zf``
(``ops.sosfilt_coupled``, ``ops.sosfilt_blockmat``). On a CUDA chunk a
coupled step (the parametric and graphic EQs, and every stream that goes
through :func:`sosfilt_stream`'s default) runs its whole cascade in one
launch of the stream step's kernel (kernel D,
:func:`~dasp_tpu_torch.ops.iir_stream_kernel.coupled_step`), in float64
inside; on a CPU chunk, or where a parameter or the chunk requires grad
under grad mode, it runs the block-state loop. The state is the same
either way. The reverbs carry an
overlap-save history with the IR's spectrum taken once. The true
attack/release ballistics carry the ``(ya, ym)`` envelope state:
``smoother="exact"`` runs the branching recursion through the ballistics
kernel (:func:`~dasp_tpu_torch.ops.ballistics_pallas`, one launch per call
on a CUDA tensor, its plain loop on a CPU tensor), whose chunk-chained
evaluation is bitwise equal to one pass. The transient shaper, the
spectral gate and the dynamic EQ take their ballistics through the offline
effects' own helpers, whose ``"exact"`` is the plain loop.

Example (EQ and compressor on the card)::

    chain = StreamChain([
        ("eq", lambda c, s: parametric_eq_stream(c, sr, *p_eq, zi=s)),
        ("comp", lambda c, s: compressor_stream(c, sr, *p_c, zi=s, smoother="exact")),
    ])
    state = None
    for chunk in chunks:
        y, state = chain(chunk, state)

Memoryless effects (gain, distortion, panner, widener, bus) need no state:
call the offline functions on each chunk.

The parametric EQ stream keeps its designed sections and coupled
operators (:func:`~dasp_tpu_torch.ops.iir.coupled_operators`: the packed
realization kernel D reads, or the block-state operators, each made at
first use) across chunks while its parameters are unchanged (a small memo
held by this module, :class:`_OperatorMemo`): a chunk whose 18 parameters,
sample rate and leading shape, dtype and device match a kept entry bit for
bit filters with that entry, bitwise what a rebuild gives. Only the inputs
decide: with grad mode on and a parameter that requires grad the memo is
bypassed, so that no operator ties two chunks' graphs together.

Spans (:mod:`~dasp_tpu_torch.trace`, on in a profiled run):
``stream.chunk`` round each ``StreamChain`` call, ``stream.parametric_eq``,
``stream.compressor`` and ``stream.reverb`` inside those three streams, so
that they fall inside any wrapper a caller puts round a step; inside
``stream.parametric_eq``, ``eq.design`` round getting the sections (the
memo's lookup; on a miss the design, stabilized and folded into rows) and
``sosfilt_coupled``'s ``iir.coupled.operators`` round getting the form the
call runs on, once a call whether the operators hold it or it is built;
``kernel_d.forward`` round the stream step's kernel. Counters:
``stream.eq_operators.hit`` or ``stream.eq_operators.miss`` once on each
call that consults the memo; ``kernel_d.forward`` once a launch of kernel D.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from . import functional as F
from .ops.ballistics_kernel import ballistics_pallas
from .ops.biquad import biquad
from .ops.fft_filter import fft_freqz, next_pow2
from .ops.fir import fft_conv_causal
from .ops.iir import (
    ballistics_smooth,
    coupled_operators,
    embed_first_order_sos,
    onepole_ba,
    running_max,
    sosfilt_blockmat,
    sosfilt_coupled,
)
from .ops.tv_filter import tv_analysis_window
from .trace import count, span

__all__ = [
    "sosfilt_stream",
    "parametric_eq_stream",
    "graphic_eq_stream",
    "compressor_stream",
    "expander_stream",
    "sidechain_compressor_stream",
    "noise_gate_stream",
    "de_esser_stream",
    "bitcrusher_stream",
    "transient_shaper_stream",
    "exciter_stream",
    "spectral_gate_stream",
    "dynamic_eq_stream",
    "limiter_stream",
    "reverb_stream_init",
    "reverb_stream",
    "convolution_reverb_stream_init",
    "convolution_reverb_stream",
    "delay_stream",
    "modulated_delay_stream",
    "pitch_shift_stream",
    "time_stretch_stream",
    "pitch_shift_pv_stream",
    "tremolo_stream",
    "ring_modulator_stream",
    "phaser_stream",
    "auto_wah_stream",
    "multiband_compressor_stream",
    "StreamChain",
]

_TWO_PI = 2.0 * np.pi


def sosfilt_stream(
    sos: torch.Tensor,
    x: torch.Tensor,
    zi: Optional[torch.Tensor] = None,
    filter_method: str = "coupled",
    block: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming step of an exact biquad cascade.

    Args:
        sos: (bs, n_sections, 6), a0 normalized to 1; fixed for the life of
            a stream (the state is realization-specific).
        x: chunk (bs, ..., T); T a multiple of ``block``.
        zi: the previous step's state (None = from rest).
        filter_method: "coupled" (the default, :func:`~dasp_tpu_torch.ops.
            sosfilt_coupled`: one launch of the stream step's kernel on a
            CUDA chunk, see the module docstring) or "block"
            (:func:`~dasp_tpu_torch.ops.sosfilt_blockmat`).
        block: the formulations' intra-block length.

    Returns:
        (y, zf): the filtered chunk and the state for the next step.
    """
    if filter_method == "coupled":
        return sosfilt_coupled(sos, x, block=block, zi=zi, return_zf=True)
    if filter_method == "block":
        return sosfilt_blockmat(sos, x, block=block, zi=zi, return_zf=True)
    raise ValueError(f"Unknown filter_method: {filter_method!r}. Expected 'coupled' or 'block'.")


# the integer dtype of each element size, to compare floats bit for bit
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class _OperatorMemo:
    """Designed sections and coupled operators kept across chunks.

    An entry is found by its host key (what it was built from that the host
    holds: sample rate, the signal's leading shape, dtype and device, the
    block, the Python number parameters' bits, the tensor parameters'
    shapes) and then by a copy of the tensor parameters' bits as the design
    reads them (in the signal's dtype, on its device), compared with every
    candidate in one device-to-host read. A copy and not the tensors
    themselves: a write in place, also one through ``.data`` (which leaves
    the version counter alone), must miss. Parameters that hold a NaN are
    never kept. At most ``size`` entries; the least recently used goes
    first. Lookups and stores from several threads at once are safe (a race
    may keep one entry twice, within the bound)."""

    def __init__(self, size: int = 4):
        self.size = size
        self._entries: list = []  # [host key, bits or None, value], most recently used last
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def lookup(self, key, values: Optional[torch.Tensor]):
        """(the kept value or None, whether ``values`` hold a NaN)."""
        with self._lock:
            cands = [e for e in self._entries if e[0] == key]
        flags = [False] * (len(cands) + 1)  # each candidate's mismatch, then NaN
        if values is not None and values.numel():
            bits = values.view(_BITS[values.element_size()])
            flags = torch.stack([(bits != e[1]).any() for e in cands] + [torch.isnan(values).any()]).tolist()
        hit = next((e for e, f in zip(cands, flags) if not f), None)
        if hit is None:
            return None, flags[-1]
        with self._lock:
            for i, e in enumerate(self._entries):
                if e is hit:
                    self._entries.append(self._entries.pop(i))
                    break
        return hit[2], False

    def store(self, key, values: Optional[torch.Tensor], value) -> None:
        """Keep ``value`` under ``key`` and ``values``, a tensor of its own
        (:func:`_eq_memo_key` makes it with ``torch.cat``)."""
        bits = None if values is None else values.view(_BITS[values.element_size()])
        with self._lock:
            self._entries.append([key, bits, value])
            del self._entries[: -self.size]


_EQ_MEMO = _OperatorMemo()
# the intra-block length of the EQ's coupled cascade (sosfilt_stream's)
_EQ_BLOCK = 128


def _eq_memo_key(x: torch.Tensor, sample_rate, params):
    """(host key, the tensor parameters flat as the design reads them or
    None, a Python number is NaN) of a call of :func:`parametric_eq_stream`;
    None where the memo is bypassed: a sample rate that is not a Python
    number, a parameter that is neither a Python number nor a tensor, or
    grad mode with a parameter that requires grad (so the flat copy records
    no graph)."""

    def number(v):  # a Python number's type and bits
        return type(v), v.hex() if isinstance(v, float) else v

    if not isinstance(sample_rate, (int, float)):
        return None
    if torch.is_grad_enabled() and any(isinstance(p, torch.Tensor) and p.requires_grad for p in params):
        return None
    key = [x.shape[:-1], x.dtype, x.device, _EQ_BLOCK, torch.is_inference_mode_enabled(), number(sample_rate)]
    tensors, nan = [], math.isnan(sample_rate)
    for p in params:
        if isinstance(p, torch.Tensor):
            key.append(p.shape)
            if p.dtype != x.dtype or p.device != x.device:
                p = p.to(x.device, x.dtype)  # the value functional._param gives the design
            tensors.append(p if p.dim() == 1 else p.reshape(-1))
        elif isinstance(p, (int, float)):
            key.append(number(p))
            nan = nan or math.isnan(p)
        else:
            return None
    return tuple(key), torch.cat(tensors) if tensors else None, nan


def parametric_eq_stream(
    x: torch.Tensor,
    sample_rate: float,
    *params,
    zi: Optional[torch.Tensor] = None,
    filter_method: str = "coupled",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming 6-band parametric EQ (the 18 parameters of the offline
    :func:`~dasp_tpu_torch.functional.parametric_eq`). With the default
    coupled realization the sections and operators come from the module's
    memo while the parameters are unchanged (see the module docstring)."""
    with span("stream.parametric_eq"):
        with span("eq.design"):
            memo = _eq_memo_key(x, sample_rate, params) if filter_method == "coupled" else None
            operators = None
            if memo is not None:
                key, values, nan = memo
                operators, values_nan = _EQ_MEMO.lookup(key, values)
                count("stream.eq_operators." + ("miss" if operators is None else "hit"))
            if operators is None:
                sos = F._parametric_eq_sections(x.shape[0], x.dtype, sample_rate, *params, device=x.device)
                if memo is not None:
                    operators = coupled_operators(sos, x.shape, _EQ_BLOCK)
                    if not (nan or values_nan):
                        _EQ_MEMO.store(key, values, operators)
        if memo is None:
            return sosfilt_stream(sos, x, zi=zi, filter_method=filter_method)
        # sosfilt_coupled builds the form this call runs on where the
        # operators do not hold it yet, and keeps it in them
        return sosfilt_coupled(None, x, block=_EQ_BLOCK, zi=zi, return_zf=True, operators=operators)


def graphic_eq_stream(
    x: torch.Tensor,
    sample_rate: float,
    band_gains_db,
    zi: Optional[torch.Tensor] = None,
    filter_method: str = "coupled",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming 10-band octave graphic EQ; its sub-100 Hz bands want the
    default coupled realization."""
    sos = F.graphic_eq_sos(x.shape[0], x.dtype, sample_rate, band_gains_db, device=x.device)
    return sosfilt_stream(sos, x, zi=zi, filter_method=filter_method)


def _ballistics_stream(g, alpha_attack, alpha_release, smoother, y0):
    """True attack/release ballistics of a chunk with the carried ``(ya,
    ym)`` state (None = from rest): ``"parallel"`` by
    :func:`~dasp_tpu_torch.ops.ballistics_smooth`'s two scans, ``"exact"``
    by the ballistics kernel (:func:`~dasp_tpu_torch.ops.ballistics_pallas`,
    one launch; its plain loop on a CPU tensor), which takes ``ym``.

    ``g`` is (bs, ch, T); the coefficients are per item or, as (bs,
    n_bands, 1), per band. Returns ``(y, (ya_f, ym_f))``.
    """
    if smoother == "parallel":
        return ballistics_smooth(g, alpha_attack, alpha_release, mode="parallel", y0=y0, return_yf=True)
    if smoother != "exact":
        raise ValueError(f"Unknown streaming ballistics: {smoother!r}. Expected 'parallel' or 'exact'.")
    return ballistics_pallas(g.contiguous(), alpha_attack, alpha_release, y0=None if y0 is None else y0[1],
                             return_yf=True)


def _dynamics_stream(
    x, sample_rate, threshold_db, ratio, attack_ms, release_ms,
    knee_db, makeup_gain_db, eps, zi, mode, smoother="block", detector=None,
):
    bs, dtype, device = x.shape[0], x.dtype, x.device
    threshold_db, attack_ms, release_ms, knee_db, makeup_gain_db = F._params(
        bs, dtype, device, threshold_db, attack_ms, release_ms, knee_db, makeup_gain_db)
    if ratio is not None:  # the limiter's curve has no ratio
        ratio = F._param(ratio, bs, dtype, device)
    _, x_db, alpha_a, alpha_r = F._dynamics_common(
        x if detector is None else detector, sample_rate, attack_ms, release_ms, eps)
    g_c = F.static_gain_computer(x_db, threshold_db, ratio, knee_db, mode)
    if smoother == "block":
        # the attack-only one-pole (the offline smoother="block") as an
        # embedded first-order section with carried state
        b, a = onepole_ba(alpha_a.reshape(bs, 1).to(dtype))
        sec = embed_first_order_sos(b, a)[:, None, :]
        g_smooth, zf = sosfilt_blockmat(sec, g_c, zi=zi, return_zf=True)
    elif smoother in ("parallel", "exact"):
        g_smooth, zf = _ballistics_stream(g_c, alpha_a, alpha_r, smoother, zi)
    else:
        raise ValueError(f"Unknown streaming smoother: {smoother!r}. Expected 'block', 'parallel' or 'exact'.")
    return x * F.db_to_linear(g_smooth + makeup_gain_db), zf


def compressor_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    zi=None,
    smoother: str = "block",
) -> Tuple[torch.Tensor, Any]:
    """Streaming feed-forward compressor, the offline
    :func:`~dasp_tpu_torch.functional.compressor` at the same ``smoother``:
    ``"block"`` (the default, the attack-only one-pole; state (bs, 1, 1,
    4)), or ``"parallel"`` / ``"exact"`` (true attack/release ballistics,
    ``"exact"`` on the ballistics kernel; state the ``(ya, ym)`` envelope
    tuple). No lookahead."""
    with span("stream.compressor"):
        return _dynamics_stream(x, sample_rate, threshold_db, ratio, attack_ms, release_ms,
                                knee_db, makeup_gain_db, eps, zi, "compressor", smoother)


def expander_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    zi=None,
    smoother: str = "block",
) -> Tuple[torch.Tensor, Any]:
    """Streaming downward expander (see :func:`compressor_stream`)."""
    return _dynamics_stream(x, sample_rate, threshold_db, ratio, attack_ms, release_ms,
                            knee_db, makeup_gain_db, eps, zi, "expander", smoother)


def sidechain_compressor_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    zi=None,
    smoother: str = "parallel",
    sidechain: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming sidechain compressor (ducker), the offline
    :func:`~dasp_tpu_torch.functional.sidechain_compressor` at the same
    ``smoother`` (states as :func:`compressor_stream`'s). The key chunk
    comes as ``sidechain=``: x's batch and length, any channel count."""
    if sidechain is None:
        raise ValueError(
            "sidechain_compressor_stream requires `sidechain` (the key signal chunk); pass it as a keyword argument."
        )
    return _dynamics_stream(x, sample_rate, threshold_db, ratio, attack_ms, release_ms,
                            knee_db, makeup_gain_db, eps, zi, "compressor", smoother, detector=sidechain)


def limiter_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    attack_ms,
    release_ms,
    knee_db,
    makeup_gain_db,
    eps: float = 1e-8,
    zi=None,
    smoother: str = "parallel",
) -> Tuple[torch.Tensor, Any]:
    """Streaming feed-forward limiter, the offline
    :func:`~dasp_tpu_torch.functional.limiter` at the same ``smoother``:
    ``"parallel"`` (the default) or ``"exact"`` (the ballistics kernel),
    true attack/release with the ``(ya, ym)`` state, or ``"block"`` as in
    :func:`compressor_stream`. No lookahead."""
    return _dynamics_stream(x, sample_rate, threshold_db, None, attack_ms, release_ms,
                            knee_db, makeup_gain_db, eps, zi, "limiter", smoother)


def noise_gate_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    ratio,
    range_db,
    attack_ms,
    release_ms,
    knee_db,
    eps: float = 1e-8,
    hold_ms: float = 0.0,
    state=None,
    smoother: str = "parallel",
) -> Tuple[torch.Tensor, Any]:
    """Streaming noise gate, the offline
    :func:`~dasp_tpu_torch.functional.noise_gate` at the same ``smoother``
    ("parallel" or "exact") and ``hold_ms``. The state is the ballistics
    envelope and the last ``hold`` samples of the gain curve before
    smoothing, so the causal moving maximum sees across chunks."""
    if smoother not in ("parallel", "exact"):
        raise ValueError(f"noise_gate_stream smoother must be 'parallel' or 'exact', got {smoother!r}.")
    bs, dtype, device = x.shape[0], x.dtype, x.device
    threshold_db, ratio, range_db, attack_ms, release_ms, knee_db = F._params(
        bs, dtype, device, threshold_db, ratio, range_db, attack_ms, release_ms, knee_db)
    state = state or {"env": None, "hold": None}
    _, x_db, alpha_a, alpha_r = F._dynamics_common(x, sample_rate, attack_ms, release_ms, eps)
    g_c = F.static_gain_computer(x_db, threshold_db, ratio, knee_db, "expander")
    g_c = torch.maximum(g_c, -range_db)

    hold = int(round(sample_rate * hold_ms / 1e3))
    new_state: Dict[str, Any] = {"hold": None}
    if hold > 0:
        # the carried tail ahead of the chunk; from rest, -range (the gate
        # shut: the offline render's -inf left edge, the same after the
        # floor since g_c >= -range everywhere)
        tail = state.get("hold")
        if tail is None:
            tail = torch.broadcast_to(-range_db, (bs, 1, hold)).to(dtype)
        g_ext = torch.cat([tail, g_c], dim=-1)
        new_state["hold"] = g_ext[..., -hold:]
        g_c = F._hold_max(g_ext, hold)[..., hold:]

    # the gate's swapped coefficients (see functional.noise_gate)
    g_smooth, new_state["env"] = _ballistics_stream(g_c, alpha_r, alpha_a, smoother, state.get("env"))
    return x * F.db_to_linear(g_smooth), new_state


def de_esser_stream(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db,
    eps: float = 1e-8,
    mode: str = "split",
    state=None,
    smoother: str = "parallel",
    filter_method: str = "coupled",
) -> Tuple[torch.Tensor, Any]:
    """Streaming de-esser, the offline
    :func:`~dasp_tpu_torch.functional.de_esser`. The state is the LR4
    crossover's (both legs in one filter call in ``"split"`` mode, the
    high-pass leg in ``"wideband"``) and the ballistics envelope."""
    if mode not in ("split", "wideband"):
        raise ValueError(f"de_esser mode must be 'split' or 'wideband', got {mode!r}.")
    if smoother not in ("parallel", "exact"):
        raise ValueError(f"de_esser_stream smoother must be 'parallel' or 'exact', got {smoother!r}.")
    bs, dtype, device = x.shape[0], x.dtype, x.device
    frequency_hz = F._param(frequency_hz, bs, dtype, device).reshape(bs)
    threshold_db, ratio, attack_ms, release_ms, knee_db = F._params(
        bs, dtype, device, threshold_db, ratio, attack_ms, release_ms, knee_db)
    state = state or {"xo": None, "env": None}
    new_state: Dict[str, Any] = {}

    sos_lp, sos_hp = F.lr4_crossover_sos(frequency_hz, sample_rate, bs, dtype)
    if mode == "split":
        y2, new_state["xo"] = sosfilt_stream(torch.cat([sos_lp, sos_hp]), torch.cat([x, x]),
                                             zi=state.get("xo"), filter_method=filter_method)
        low, high = y2[:bs], y2[bs:]
    else:
        high, new_state["xo"] = sosfilt_stream(sos_hp, x, zi=state.get("xo"), filter_method=filter_method)
    _, det_db, alpha_a, alpha_r = F._dynamics_common(high, sample_rate, attack_ms, release_ms, eps)
    g_c = F.static_gain_computer(det_db, threshold_db, ratio, knee_db, "compressor")
    g_smooth, new_state["env"] = _ballistics_stream(g_c, alpha_a, alpha_r, smoother, state.get("env"))
    g_lin = F.db_to_linear(g_smooth)
    return (low + high * g_lin if mode == "split" else x * g_lin), new_state


def bitcrusher_stream(
    x: torch.Tensor,
    sample_rate: float,
    bit_depth,
    sample_rate_hz,
    mix,
    state=None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming bitcrusher, the offline
    :func:`~dasp_tpu_torch.functional.bitcrusher`.

    The state is the hold clock's wrapped fractional phase ``c0`` (an fp32
    absolute counter would miss or double ticks after about 2^24 samples)
    and the held sample, so holds that span a chunk boundary are seamless:
    with ``c0 = frac(n0 r)``, ``floor((n0 + k) r + eps) - floor((n0 + k -
    1) r + eps)`` is ``floor(c0 + k r + eps) - floor(c0 + (k - 1) r +
    eps)``. The quantizer rounds (no gradient through it, as the JAX
    package's stream).
    """
    bs, chs, Tc = x.shape
    dtype, device = x.dtype, x.device
    bit_depth, sample_rate_hz, mix = F._params(bs, dtype, device, bit_depth, sample_rate_hz, mix)
    if state is None:
        state = {"c0": torch.zeros((bs, 1, 1), dtype=dtype, device=device),
                 "held": torch.zeros((bs, chs, 1), dtype=dtype, device=device)}
    # a tensor divisor, as the offline effect's (see functional.bitcrusher)
    r = torch.clamp(sample_rate_hz / torch.full_like(sample_rate_hz, sample_rate), 0.0, 1.0)
    k = torch.arange(Tc, dtype=dtype, device=device)[None, None, :]
    tick = torch.floor(state["c0"] + k * r + 1e-6)
    tick_prev = torch.cat([torch.floor(state["c0"] - r + 1e-6), tick[..., :-1]], dim=-1)
    n_loc = torch.arange(Tc, dtype=torch.int64, device=device)[None, None, :]
    idx_local = running_max(torch.where(tick > tick_prev, n_loc, -1), 2)
    held = torch.gather(x, -1, torch.clamp(idx_local, min=0).expand(bs, chs, Tc))
    held = torch.where(idx_local >= 0, held, state["held"])

    scale = 2.0 ** (bit_depth - 1.0)
    q = torch.round(held * scale) / scale
    y = (1.0 - mix) * x + mix * q
    c0 = state["c0"] + Tc * r
    return y.to(dtype), {"c0": c0 - torch.floor(c0), "held": held[..., -1:]}


def exciter_stream(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    drive_db,
    amount,
    zi=None,
    filter_method: str = "coupled",
) -> Tuple[torch.Tensor, Any]:
    """Streaming harmonic exciter, the offline
    :func:`~dasp_tpu_torch.functional.exciter`; the state is the high-pass
    section's (the waveshaper and blend are memoryless)."""
    bs, dtype, device = x.shape[0], x.dtype, x.device
    frequency_hz, drive_db, amount = F._params(bs, dtype, device, frequency_hz, drive_db, amount)
    sos = F.exciter_sos(bs, dtype, frequency_hz, sample_rate)
    high, zf = sosfilt_stream(sos, x, zi=zi, filter_method=filter_method)
    g = F.db_to_linear(drive_db)
    return (x + amount * (torch.tanh(high * g) / g)).to(dtype), zf


def transient_shaper_stream(
    x: torch.Tensor,
    sample_rate: float,
    attack,
    sustain,
    output_gain_db=0.0,
    fast_attack_ms=1.0,
    slow_attack_ms=30.0,
    fast_release_ms=50.0,
    slow_release_ms=500.0,
    pre_smooth_ms=5.0,
    max_det_db=24.0,
    eps: float = 1e-8,
    state=None,
    smoother: str = "parallel",
) -> Tuple[torch.Tensor, Any]:
    """Streaming transient shaper, the offline
    :func:`~dasp_tpu_torch.functional.transient_shaper`. The state is the
    detector's pre-smoother, its two ballistics envelopes and two
    peak-decay followers (``functional._transient_detectors``, whose
    ``"exact"`` is the plain loop)."""
    bs, dtype, device = x.shape[0], x.dtype, x.device
    attack, sustain, output_gain_db = F._params(bs, dtype, device, attack, sustain, output_gain_db)
    att_det, sus_det, new_state = F._transient_detectors(
        x, sample_rate, fast_attack_ms, slow_attack_ms, fast_release_ms, slow_release_ms, eps, smoother,
        pre_smooth_ms, max_det_db, y0=state, return_yf=True,
    )
    gain_db = attack * att_det + sustain * sus_det + output_gain_db
    return (x * F.db_to_linear(gain_db)).to(dtype), new_state


# ---------------------------------------------------------------------------
# reverbs: overlap-save with the IR's spectrum taken once
# ---------------------------------------------------------------------------


def _conv_state(ir, mix, bs, chs, chunk_len, dtype):
    K = ir.shape[-1]
    n_fft = next_pow2(K - 1 + (chunk_len or K))
    return {
        "ir": ir,
        "ir_rfft": torch.fft.rfft(ir, n_fft, dim=-1),
        "hist": torch.zeros((bs, chs, K - 1), dtype=dtype, device=ir.device),
        "mix": F._param(mix, bs, dtype, ir.device),
    }


def reverb_stream_init(
    sample_rate: float,
    band_gains,
    band_decays,
    mix,
    generator: torch.Generator,
    *,
    num_samples: int = 65536,
    num_bandpass_taps: int = 1023,
    noise_mode: str = "frequency",
    chunk_len: Optional[int] = None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, Any]:
    """Start a filtered-noise reverb stream: draw the stereo IR once
    (:func:`~dasp_tpu_torch.functional.noise_shaped_ir`), transform it once
    and allocate the convolution history.

    Args:
        band_gains / band_decays: (bs, 12) values on (0, 1), the offline
            effect's 24 band parameters stacked.
        mix: wet/dry mix on (0, 1), (bs,) or scalar.
        generator: the noise draw's ``torch.Generator`` (the JAX package
            takes a PRNG key here), on ``device``.
        chunk_len: the expected chunk length T; sizes the overlap-save FFT
            at next_pow2(K - 1 + T) (default: any T up to about K).
        device: where the state lives; the CUDA card unless named.

    Returns:
        The state dict for :func:`reverb_stream`.
    """
    device = F._entry_device(device)
    band_gains = torch.as_tensor(band_gains, dtype=dtype, device=device)
    band_decays = torch.as_tensor(band_decays, dtype=dtype, device=device)
    ir = F.noise_shaped_ir(
        sample_rate, band_gains, band_decays, num_samples=num_samples,
        num_bandpass_taps=num_bandpass_taps, generator=generator, noise_mode=noise_mode, dtype=dtype,
    )
    return _conv_state(ir, mix, band_gains.shape[0], 2, chunk_len, dtype)


def reverb_stream(x: torch.Tensor, state: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the filtered-noise reverb: the chunk (bs, 1 or
    2, T), mono duplicated to stereo as offline, and the state of
    :func:`reverb_stream_init` or the previous step; returns the wet/dry
    stereo chunk (bs, 2, T) and the new state."""
    with span("stream.reverb"):
        if x.shape[1] == 1:
            x = x.expand(x.shape[0], 2, x.shape[-1])
        return _conv_stream_step(x, state)


def _conv_stream_step(x: torch.Tensor, state: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The overlap-save step of both reverbs: ``x`` against the carried
    history convolved with the IR by its spectrum, mixed dry/wet."""
    hist = state["hist"]
    K = state["ir"].shape[-1]
    seg = torch.cat([hist, x], dim=-1)
    ir_rfft = state["ir_rfft"]
    n_fft = 2 * (ir_rfft.shape[-1] - 1)
    if n_fft >= seg.shape[-1]:
        # alias-free for outputs from K - 1 on while n_fft >= K - 1 + T
        wet_full = torch.fft.irfft(torch.fft.rfft(seg, n_fft, dim=-1) * ir_rfft, n_fft, dim=-1)
        wet = wet_full[..., K - 1 : K - 1 + x.shape[-1]]
    else:  # a chunk too long for the spectrum: the exact convolution
        wet = fft_conv_causal(seg, state["ir"])[..., hist.shape[-1]:]
    mix = state["mix"]
    y = (1.0 - mix) * x + mix * wet
    return y, {**state, "hist": seg[..., seg.shape[-1] - (K - 1):]}


def convolution_reverb_stream_init(
    ir,
    mix,
    bs: int,
    chs: int,
    chunk_len: Optional[int] = None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, Any]:
    """Start a user-IR convolution reverb stream (the offline
    :func:`~dasp_tpu_torch.functional.convolution_reverb`): transform the IR
    once and allocate the history.

    Args:
        ir: impulse response, (K,), (bs, K) or (bs, chs, K).
        mix: dry/wet on [0, 1], (bs,) or scalar.
        bs / chs: the chunks' batch and channels.
        chunk_len: the expected chunk length (sizes the FFT as in
            :func:`reverb_stream_init`).
        device: where the state lives; the CUDA card unless named.
    """
    ir = torch.as_tensor(ir, dtype=dtype, device=F._entry_device(device))
    if ir.ndim == 1:
        ir = ir[None, None, :]
    elif ir.ndim == 2:
        ir = ir[:, None, :]
    return _conv_state(ir, mix, bs, chs, chunk_len, dtype)


def convolution_reverb_stream(x: torch.Tensor, state: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the user-IR convolution reverb; the channel
    layout is the caller's (no mono-to-stereo duplication)."""
    return _conv_stream_step(x, state)


# ---------------------------------------------------------------------------
# time-based and modulation effects
# ---------------------------------------------------------------------------


def _local_time(T: int, sample_rate: float, device) -> torch.Tensor:
    """``n / sample_rate`` for the chunk's n, (1, 1, T), rounded to fp32 on
    the host as the JAX package's numpy constant is."""
    n = np.arange(T, dtype=np.float32)[None, None, :]
    return torch.from_numpy(n / np.float32(sample_rate)).to(device)


def _wrapped_phase(state, bs, lfo_phase, dtype, device):
    """The carried wrapped phase (bs, 1, 1), ``lfo_phase`` from rest."""
    if state is None:
        return torch.full((bs, 1, 1), float(lfo_phase), dtype=dtype, device=device)
    return state["ph"]


def delay_stream(
    x: torch.Tensor,
    sample_rate: float,
    delay_samples: int,
    feedback,
    mix,
    state: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of a feedback delay (echo): the comb recursion
    ``w[n] = x[n-D] + fb w[n-D]`` over a carried delay line, the causal
    time-domain form of the response the offline
    :func:`~dasp_tpu_torch.functional.delay` samples (minus its negligible
    circular tail). The delay is a whole number of samples here (the
    state's layout depends on it). Samples within one delay period do not
    depend on each other, so the chunk runs as ``ceil(T / D)`` vectorized
    blocks.

    Args:
        x: chunk (bs, chs, T). sample_rate: unused (uniform signature).
        delay_samples: the delay D (an int >= 1).
        feedback: on [0, 1), (bs,), clamped to <= 0.999.
        mix: dry/wet on [0, 1], (bs,).
        state: the previous step's (None = from rest).
    """
    bs, chs, T = x.shape
    dtype, device = x.dtype, x.device
    D = int(delay_samples)
    if D < 1:
        raise ValueError(f"delay_samples must be >= 1, got {D}")
    feedback = torch.clamp(F._param(feedback, bs, dtype, device), max=0.999)
    mix = F._param(mix, bs, dtype, device)
    if state is None:
        zeros = torch.zeros((bs, chs, D), dtype=dtype, device=device)
        state = {"dry_hist": zeros, "wet_hist": zeros}

    x_ext = torch.cat([state["dry_hist"], x], dim=-1)
    n_blocks = -(-T // D)
    dd = nnf.pad(x_ext[..., :T], (0, n_blocks * D - T)).reshape(bs, chs, n_blocks, D)  # x[n - D]
    wet_b = state["wet_hist"]
    blocks = []
    for k in range(n_blocks):
        wet_b = dd[:, :, k] + feedback * wet_b
        blocks.append(wet_b)
    wet = torch.cat(blocks, dim=-1)[..., :T]
    y = (1.0 - mix) * x + mix * wet
    new_state = {
        "dry_hist": x_ext[..., -D:],
        "wet_hist": torch.cat([state["wet_hist"], wet], dim=-1)[..., -D:],
    }
    return y.to(dtype), new_state


def _two_point_read(x_ext, idx, valid):
    """Linearly interpolated read of ``x_ext`` at fractional positions
    ``idx`` (bs, 1, T), zero where ``valid`` is false."""
    bs, chs, L_ext = x_ext.shape
    T = idx.shape[-1]
    i0 = torch.floor(idx)
    frac = idx - i0
    i0i = torch.clamp(i0, 0, L_ext - 1).long().expand(bs, chs, T)
    i1i = torch.clamp(i0 + 1.0, 0, L_ext - 1).long().expand(bs, chs, T)
    wet = torch.gather(x_ext, -1, i0i) * (1.0 - frac) + torch.gather(x_ext, -1, i1i) * frac
    return torch.where(valid, wet, torch.zeros_like(wet))


def modulated_delay_stream(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz,
    depth_ms,
    base_ms,
    mix,
    max_delay_samples: int,
    state: Optional[Dict[str, Any]] = None,
    lfo_phase: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the LFO-modulated fractional delay (chorus,
    flanger; the offline :func:`~dasp_tpu_torch.functional.modulated_delay`).
    Two-point gathers, as the JAX package's stream: the fractional-delay
    kernel serves the offline effect.

    The state is ``max_delay_samples`` of input history, the wrapped LFO
    phase (see :func:`ring_modulator_stream`) and an int32 sample counter
    used only for the mask before the signal's start.

    Args:
        x: chunk (bs, chs, T).
        max_delay_samples: the history length, at least ``ceil((base_ms +
            depth_ms) * sample_rate / 1000) + 1`` for every parameter value.
        state: the previous step's (None = from rest).
        Others: as the offline effect's.
    """
    bs, chs, T = x.shape
    dtype, device = x.dtype, x.device
    L = int(max_delay_samples)
    rate_hz, depth_ms, base_ms, mix = F._params(bs, dtype, device, rate_hz, depth_ms, base_ms, mix)
    ph = _wrapped_phase(state, bs, lfo_phase, dtype, device)
    hist = torch.zeros((bs, chs, L), dtype=dtype, device=device) if state is None else state["hist"]
    n0 = torch.zeros((), dtype=torch.int32, device=device) if state is None else state["n0"]

    n_local = torch.arange(T, dtype=dtype, device=device)[None, None, :]
    t_abs = n0.to(dtype) + n_local  # the mask only
    lfo = 0.5 * (1.0 + torch.sin(ph + _TWO_PI * rate_hz * _local_time(T, sample_rate, device)))
    d = (base_ms + depth_ms * lfo) * (sample_rate / 1e3)  # samples
    x_ext = torch.cat([hist, x], dim=-1)
    # before the signal's start the offline effect's wet is zero; mask on
    # absolute time as it masks its read position
    wet = _two_point_read(x_ext, (L + n_local) - d, t_abs - d >= 0.0)
    y = (1.0 - mix) * x + mix * wet
    ph = torch.remainder(ph + _TWO_PI * rate_hz * (T / sample_rate), _TWO_PI)
    return y.to(dtype), {"hist": x_ext[..., -L:], "ph": ph, "n0": n0 + T}


def ring_modulator_stream(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    mix,
    state: Optional[Dict[str, Any]] = None,
    lfo_phase: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the ring modulator (the offline
    :func:`~dasp_tpu_torch.functional.ring_modulator`). The state is the
    wrapped carrier phase: an absolute sample counter in fp32 would
    quantize after about 2^24 samples (6.3 min at 44.1 kHz) and staircase
    the carrier, where the wrapped accumulator never grows."""
    bs, _, T = x.shape
    dtype, device = x.dtype, x.device
    frequency_hz, mix = F._params(bs, dtype, device, frequency_hz, mix)
    ph = _wrapped_phase(state, bs, lfo_phase, dtype, device)
    carrier = torch.sin(ph + _TWO_PI * frequency_hz * _local_time(T, sample_rate, device))
    y = ((1.0 - mix) + mix * carrier) * x
    ph = torch.remainder(ph + _TWO_PI * frequency_hz * (T / sample_rate), _TWO_PI)
    return y.to(dtype), {"ph": ph}


def pitch_shift_stream(
    x: torch.Tensor,
    sample_rate: float,
    semitones,
    mix,
    window_ms: float = 60.0,
    state: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the dual-tap delay-line pitch shifter (the
    offline :func:`~dasp_tpu_torch.functional.pitch_shift` with
    ``compensate_latency=False``: a stream is causal, so the mean
    W/2-sample latency stays). Two-point gathers, as the JAX package's
    stream.

    The state is W samples of input history, the wrapped sawtooth phase
    and an int32 counter used only for the mask before the signal's start.
    ``semitones`` and ``mix`` stay fixed for the life of a stream.
    """
    bs, chs, T = x.shape
    dtype, device = x.dtype, x.device
    semitones, mix = F._params(bs, dtype, device, semitones, mix)
    W = F.pitch_shift_window_samples(window_ms, sample_rate)
    if state is None:
        state = {"hist": torch.zeros((bs, chs, W), dtype=dtype, device=device),
                 "u0": torch.zeros((bs, 1, 1), dtype=dtype, device=device),
                 "n0": torch.zeros((), dtype=torch.int32, device=device)}

    n_local = torch.arange(T, dtype=dtype, device=device)[None, None, :]
    t_abs = state["n0"].to(dtype) + n_local  # the mask only
    slope = 1.0 - 2.0 ** (semitones / 12.0)
    u = state["u0"] + slope * n_local / W
    x_ext = torch.cat([state["hist"], x], dim=-1)
    wet = 0.0
    for i in (0.0, 0.5):
        p = u + i
        p = p - torch.floor(p)  # the sawtooth phase in [0, 1)
        d = W * p
        wet = wet + torch.sin(np.pi * p) * _two_point_read(x_ext, (W + n_local) - d, t_abs - d >= 0.0)
    y = (1.0 - mix) * x + mix * wet
    u0 = state["u0"] + slope * (T / W)
    return y.to(dtype), {"hist": x_ext[..., -W:], "u0": u0 - torch.floor(u0), "n0": state["n0"] + T}


def tremolo_stream(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz,
    depth,
    state: Optional[Dict[str, Any]] = None,
    lfo_phase: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the tremolo (the offline
    :func:`~dasp_tpu_torch.functional.tremolo`); the state is the wrapped
    LFO phase (see :func:`ring_modulator_stream`)."""
    bs, _, T = x.shape
    dtype, device = x.dtype, x.device
    rate_hz, depth = F._params(bs, dtype, device, rate_hz, depth)
    ph = _wrapped_phase(state, bs, lfo_phase, dtype, device)
    lfo = 0.5 * (1.0 + torch.sin(ph + _TWO_PI * rate_hz * _local_time(T, sample_rate, device)))
    y = x * (1.0 - depth * lfo)
    ph = torch.remainder(ph + _TWO_PI * rate_hz * (T / sample_rate), _TWO_PI)
    return y.to(dtype), {"ph": ph}


# ---------------------------------------------------------------------------
# the WOLA streams
# ---------------------------------------------------------------------------


def _wola_analyze(x, frame_size: int, hop: int, n_fft: int, xhist):
    """The streaming half of :func:`~dasp_tpu_torch.ops.tv_stft`: windowed
    frame spectra of a chunk after the carried ``frame_size - hop`` input
    samples. Returns ``(X, new_xhist)``, X (bs, chs, Tc / hop, n_bins)."""
    bs, chs, Tc = x.shape
    if Tc % hop != 0:
        raise ValueError(f"chunk length {Tc} must be a multiple of hop {hop}.")
    left = frame_size - hop
    if xhist is None:
        xhist = torch.zeros((bs, chs, left), dtype=x.dtype, device=x.device)
    x_ext = torch.cat([xhist, x], dim=-1)
    window = torch.from_numpy(tv_analysis_window(frame_size, hop)).to(device=x.device, dtype=x.dtype)
    frames = x_ext.unfold(-1, frame_size, hop)  # (bs, chs, Tc / hop, frame_size)
    return torch.fft.rfft(frames * window, n_fft, dim=-1), x_ext[..., -left:]


def _wola_synthesize(Y, hop: int, ola):
    """The streaming half of :func:`~dasp_tpu_torch.ops.tv_istft`: irFFT and
    overlap-add after the carried ``n_fft - hop`` tail. Returns ``(y,
    new_ola)``, y (bs, chs, Tc = K * hop)."""
    bs, chs, K, n_bins = Y.shape
    n_fft = 2 * (n_bins - 1)
    Tc = K * hop
    yf = torch.fft.irfft(Y, n_fft, dim=-1)
    out_len = (K - 1) * hop + n_fft
    cols = yf.reshape(bs * chs, K, n_fft).transpose(1, 2)
    out = nnf.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop)).reshape(bs, chs, out_len)
    if ola is not None:
        out = torch.cat([out[..., : n_fft - hop] + ola.to(out.dtype), out[..., n_fft - hop:]], dim=-1)
    return out[..., :Tc], out[..., Tc:]


def _wola_stream(x, H, frame_size: int, hop: int, state):
    """The streaming core of :func:`~dasp_tpu_torch.ops.tv_freq_filter`:
    ``H`` holds the complex responses of the ``Tc / hop`` frames whose
    input completes in this chunk. The state is the last ``frame_size -
    hop`` input samples and the ``n_fft - hop`` overlap-add tail. The
    output is the offline WOLA render delayed by ``frame_size - hop``
    samples (the window's lookahead)."""
    n_fft = 2 * (H.shape[-1] - 1)
    state = state or {"xhist": None, "ola": None}
    X, xhist = _wola_analyze(x, frame_size, hop, n_fft, state["xhist"])
    y, ola = _wola_synthesize(X * H[:, None].to(X.dtype), hop, state["ola"])
    return y, {"xhist": xhist, "ola": ola}


def spectral_gate_stream(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db,
    range_db,
    attack_ms,
    release_ms,
    noise_profile_db: torch.Tensor,
    sharpness_db=3.0,
    det_smooth_ms: float = 40.0,
    freq_smooth_bins: int = 9,
    frame_size: int = 2048,
    hop: int = 512,
    eps: float = 1e-8,
    state=None,
    smoother: str = "parallel",
) -> Tuple[torch.Tensor, Any]:
    """Streaming spectral gate, the offline
    :func:`~dasp_tpu_torch.functional.spectral_gate` with
    ``det_smooth_mode="causal"`` and a measured ``noise_profile_db`` (bs,
    frame_size + 1) (:func:`~dasp_tpu_torch.functional.
    spectral_noise_profile`): a stream cannot estimate the offline
    quantile floor. The output is the offline render delayed by
    ``frame_size - hop`` samples (34.8 ms at the defaults and 44.1 kHz).
    The state: the WOLA tails, the detector's smoother and the per-bin
    ballistics. Chunk lengths are multiples of ``hop``.
    """
    dtype, device = x.dtype, x.device
    bs = x.shape[0]
    threshold_db, range_db, attack_ms, release_ms, sharpness_db = F._params(
        bs, dtype, device, threshold_db, range_db, attack_ms, release_ms, sharpness_db)
    state = state or {"xhist": None, "ola": None, "det": None, "bal": None}
    ln9 = math.log(9.0)
    frame_rate = sample_rate / hop
    X, xhist = _wola_analyze(x, frame_size, hop, 2 * frame_size, state["xhist"])
    alpha_d = np.exp(-ln9 / (frame_rate * (det_smooth_ms / 1e3))).astype(np.float32)
    power, det = F._smooth_det_power(F._power(X).mean(dim=1), alpha_d, "causal", y0=state["det"])
    det_db = 10.0 * torch.log10(torch.clamp(power, min=eps * eps))
    noise_db = torch.as_tensor(noise_profile_db, dtype=dtype, device=device)[:, None, :]
    alpha_a = torch.exp(-ln9 / (frame_rate * (attack_ms / 1e3)))
    alpha_r = torch.exp(-ln9 / (frame_rate * (release_ms / 1e3)))
    gain, bal = F._spectral_gate_gain(
        det_db, noise_db, threshold_db, range_db, sharpness_db, alpha_a, alpha_r, smoother,
        freq_smooth_bins, y0=state["bal"], return_yf=True,
    )
    y, ola = _wola_synthesize(X * gain[:, None].to(X.dtype), hop, state["ola"])
    return y.to(dtype), {"xhist": xhist, "ola": ola, "det": det, "bal": bal}


def dynamic_eq_stream(
    x: torch.Tensor,
    sample_rate: float,
    frequency_hz,
    q_factor,
    threshold_db,
    ratio,
    attack_ms,
    release_ms,
    knee_db: float = 6.0,
    max_cut_db: float = 24.0,
    frame_size: int = 1024,
    hop: int = 256,
    eps: float = 1e-8,
    state=None,
    smoother: str = "parallel",
) -> Tuple[torch.Tensor, Any]:
    """Streaming dynamic EQ, the offline
    :func:`~dasp_tpu_torch.functional.dynamic_eq` delayed by ``frame_size -
    hop`` samples (the WOLA lookahead). The state: the WOLA tails and the
    per-band ballistics. Chunk lengths are multiples of ``hop``."""
    bs = x.shape[0]
    dtype, device = x.dtype, x.device
    frequency_hz = torch.as_tensor(frequency_hz, dtype=dtype, device=device)
    if frequency_hz.ndim < 2:
        frequency_hz = frequency_hz.reshape(bs, -1)
    nb = frequency_hz.shape[-1]
    q_factor, threshold_db, ratio, attack_ms, release_ms = (
        F._band_param(p, bs, nb, dtype, device) for p in (q_factor, threshold_db, ratio, attack_ms, release_ms))
    state = state or {"xhist": None, "ola": None, "bal": None}
    n_bins = 2 * frame_size + 1  # n_fft = 4 * frame_size, as offline
    X, xhist = _wola_analyze(x, frame_size, hop, 4 * frame_size, state["xhist"])
    band_w = F._dynamic_eq_band_weights(frequency_hz, q_factor, n_bins, sample_rate, frame_size, hop)
    ln9 = math.log(9.0)
    frame_rate = sample_rate / hop
    alpha_a = torch.exp(-ln9 / (frame_rate * (attack_ms / 1e3)))[..., None]
    alpha_r = torch.exp(-ln9 / (frame_rate * (release_ms / 1e3)))[..., None]
    g, bal = F._dynamic_eq_gain(
        F._power(X).mean(dim=1), band_w, threshold_db[..., None], ratio[..., None], knee_db, max_cut_db,
        alpha_a, alpha_r, smoother, eps, y0=state["bal"], return_yf=True,
    )
    H = F._dynamic_eq_response(frequency_hz, q_factor, g, n_bins, sample_rate)
    y, ola = _wola_synthesize(X * H[:, None], hop, state["ola"])
    return y.to(dtype), {"xhist": xhist, "ola": ola, "bal": bal}


def phaser_stream(
    x: torch.Tensor,
    sample_rate: float,
    rate_hz,
    depth,
    centre_frequency_hz,
    feedback,
    mix,
    stages: int = 6,
    lfo_phase: float = 0.0,
    frame_size: int = 512,
    hop: int = 128,
    state=None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming phaser, the offline
    :func:`~dasp_tpu_torch.functional.phaser` delayed by ``frame_size -
    hop`` samples (8.7 ms at the defaults and 44.1 kHz). The state: the
    WOLA tails and the wrapped LFO phase. Chunk lengths are multiples of
    ``hop``."""
    bs, _, Tc = x.shape
    dtype, device = x.dtype, x.device
    rate_hz, depth, centre, feedback, mix = (
        F._param(p, bs, dtype, device).reshape(bs, 1)
        for p in (rate_hz, depth, centre_frequency_hz, feedback, mix))
    state = state or {"wola": None, "ph": torch.full((bs, 1), float(lfo_phase), dtype=dtype, device=device)}
    K = Tc // hop
    # the frames' centres in the chunk, k hop + hop - frame_size / 2 (the
    # offline tv_frame_centers at the carried phase)
    offs = np.arange(K, dtype=np.float32) * hop + (hop - frame_size / 2.0)
    t_c = torch.from_numpy((offs / np.float32(sample_rate)).astype(np.float32)).to(device)[None, :]
    lfo = torch.sin(state["ph"] + _TWO_PI * rate_hz * t_c)
    f_break = torch.clamp(centre * 2.0 ** (2.0 * depth * lfo), 1.0, 0.49 * sample_rate)
    H = F._phaser_response(f_break, feedback, mix, 2 * frame_size + 1, stages, sample_rate)
    y, wola = _wola_stream(x, H, frame_size, hop, state["wola"])
    ph = torch.remainder(state["ph"] + _TWO_PI * rate_hz * (Tc / sample_rate), _TWO_PI)
    return y.to(dtype), {"wola": wola, "ph": ph}


def auto_wah_stream(
    x: torch.Tensor,
    sample_rate: float,
    sensitivity,
    attack_ms,
    release_ms,
    min_frequency_hz,
    max_frequency_hz,
    q_factor,
    mix,
    eps: float = 1e-8,
    frame_size: int = 512,
    hop: int = 128,
    state=None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming auto-wah, the offline
    :func:`~dasp_tpu_torch.functional.auto_wah` delayed by ``frame_size -
    hop`` samples. The state: the WOLA tails, the envelope follower's
    ballistics and the last ``frame_size - hop`` envelope samples the
    frame centres read. It equals the offline render but for the offline
    clipping of the first and last frame centres (a sub-frame transient at
    a clip's ends)."""
    bs, _, Tc = x.shape
    dtype, device = x.dtype, x.device
    sensitivity, attack_ms, release_ms = F._params(bs, dtype, device, sensitivity, attack_ms, release_ms)
    f_min, f_max, q_factor, mix = (
        F._param(p, bs, dtype, device).reshape(bs, 1) for p in (min_frequency_hz, max_frequency_hz, q_factor, mix))
    f_max = torch.maximum(f_max, 1.01 * f_min)
    state = state or {"wola": None, "env": None, "env_hist": None}
    left = frame_size - hop

    level = torch.mean(torch.abs(x), dim=1, keepdim=True)
    ln9 = math.log(9.0)
    alpha_a = torch.exp(-ln9 / (sample_rate * (attack_ms / 1e3)))
    alpha_r = torch.exp(-ln9 / (sample_rate * (release_ms / 1e3)))
    # the smoother's first coefficient acts where the level falls: the release
    env, env_f = _ballistics_stream(level, alpha_r, alpha_a, "parallel", state.get("env"))
    env_hist = state.get("env_hist")
    if env_hist is None:
        # from rest the first envelope sample, as the offline render's
        # clipped negative frame centres read it
        env_hist = env[..., :1].expand(bs, 1, left)
    env_ext = torch.cat([env_hist, env], dim=-1)

    K = Tc // hop
    # frame k's centre is index k hop + frame_size / 2 of env_ext
    idx = torch.from_numpy(np.arange(K) * hop + frame_size // 2).to(device)
    env_c = torch.index_select(env_ext[:, 0], -1, idx)  # (bs, K)
    f_c = f_min * (f_max / f_min) ** torch.tanh(sensitivity.reshape(bs, 1) * env_c)
    n_fft = 4 * frame_size
    b, a = biquad(torch.zeros((bs * K,), dtype=dtype, device=device), f_c.reshape(bs * K),
                  q_factor.expand(bs, K).reshape(bs * K), sample_rate, "band_pass")
    H_bp = fft_freqz(b, a, n_fft).reshape(bs, K, n_fft // 2 + 1)
    H = (1.0 - mix[..., None]) + mix[..., None] * H_bp
    y, wola = _wola_stream(x, H, frame_size, hop, state["wola"])
    return y.to(dtype), {"wola": wola, "env": env_f, "env_hist": env_ext[..., -left:]}


# ---------------------------------------------------------------------------
# the phase vocoder
# ---------------------------------------------------------------------------


def _pv_stream_layout(rate: float, K_in: int):
    """The streaming phase vocoder's frame layout: K_out output frames a
    chunk (a whole number), D the output-frame delay that puts every
    interpolation on analysed frames, P + 1 the carried analysis spectra."""
    K_out = round(K_in / rate)
    if abs(K_out * rate - K_in) > 1e-9 or K_out < 1:
        raise ValueError(
            f"chunk frames ({K_in}) / rate ({rate}) must be a positive integer (got {K_in / rate}); pick a "
            "chunk length whose frame count divides by the rate"
        )
    D = max(1, int(math.ceil(2.0 / rate - 1.0)))
    P = max(0, int(math.ceil(D * rate)) - 1)
    return K_out, D, P


def time_stretch_stream(
    x: torch.Tensor,
    sample_rate: float,
    rate: float,
    frame_size: int = 2048,
    hop: int = 512,
    state=None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming phase-vocoder time stretch (the offline
    :func:`~dasp_tpu_torch.functional.time_stretch` at a static ``rate``).

    Takes chunks of Tc samples and gives chunks of Tc / rate (so ``Tc / hop
    / rate`` must be a whole number: hop 512, Tc 10 x 512 and rate 1.25
    give 8 output frames a chunk). The stream is the offline render
    delayed by ``frame_size - hop + D hop`` samples, ``D = max(1, ceil(2 /
    rate - 1))`` the frames of lookahead the interpolation needs; the
    first D output frames are warm-up. The state: the WOLA tails, the last
    P + 1 analysis spectra and the wrapped synthesis phase (the expected
    advance accumulates exactly by the integer ramp,
    ``functional._pv_phase_ramp``). It computes in float64 inside and
    rounds its output once, as the offline phase vocoder; the phase of an
    exact zero is 0 (``functional._phase``).
    """
    bs, chs, Tc = x.shape
    dtype, device = x.dtype, x.device
    rate = float(rate)
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if Tc % hop != 0:
        raise ValueError(f"chunk length {Tc} must be a multiple of hop {hop}.")
    K_out, D, P = _pv_stream_layout(rate, Tc // hop)
    n_fft, n_bins = 2 * frame_size, frame_size + 1
    first = state is None
    if first:
        state = {"wola_xhist": None, "ola": None,
                 "Xbuf": torch.zeros((bs, chs, P + 1, n_bins), dtype=torch.complex128, device=device),
                 "phi0": None}

    X, xhist = _wola_analyze(x.double(), frame_size, hop, n_fft, state["wola_xhist"])
    Xall = torch.cat([state["Xbuf"], X], dim=2)  # (bs, chs, P + 1 + K_in, n_bins)
    # output frame j reads analysis position (j - D) rate, at (j - D) rate +
    # P + 1 in the buffer (>= 0: P + 1 >= D rate)
    tau = np.arange(K_out, dtype=np.float64) * rate - D * rate + P + 1
    i0 = np.floor(tau).astype(np.int64)
    frac = torch.from_numpy((tau - np.floor(tau)).astype(np.float32)).to(device)[:, None]
    X0 = torch.index_select(Xall, 2, torch.from_numpy(i0).to(device))
    X1 = torch.index_select(Xall, 2, torch.from_numpy(i0 + 1).to(device))
    mag = (1.0 - frac) * X0.abs() + frac * X1.abs()
    dev = F._phase(X1 * torch.conj(X0) * F._pv_bin_advance(n_bins, hop, n_fft, device))  # princarg(adv - expected)

    # the synthesis phase: the carried phase, the exact expected ramp and the
    # running sum of the small deviations
    ramp = F._pv_phase_ramp(K_out + 1, n_bins, hop, n_fft)
    if first:
        # the first D output frames read the zeroed buffer: silence them and
        # anchor the phase at analysis frame 0's, so the stream is the
        # offline render delayed by frame_size - hop + D hop
        warm = torch.from_numpy((np.arange(K_out) >= D).astype(np.float32)).to(device)[:, None]
        mag, dev = mag * warm, dev * warm
        ramp = ramp[np.maximum(np.arange(K_out + 1) - D, 0)]
        phi0 = F._phase(X[:, :, :1])
    else:
        phi0 = state["phi0"][:, :, None]
    ramp = torch.from_numpy(ramp).to(device)
    cum = torch.cat([torch.zeros_like(dev[:, :, :1]), torch.cumsum(dev, dim=2)], dim=2)
    phase = phi0 + ramp[:K_out] + cum[:, :, :K_out]
    # wrapped with the fp32 constants of the JAX package's stream
    pi, two_pi = float(np.float32(np.pi)), float(np.float32(_TWO_PI))
    phi_next = torch.remainder(phase[:, :, -1] + (ramp[K_out] - ramp[K_out - 1]) + dev[:, :, -1] + pi, two_pi) - pi
    y, ola = _wola_synthesize(torch.complex(mag * torch.cos(phase), mag * torch.sin(phase)), hop, state["ola"])
    new_state = {"wola_xhist": xhist, "ola": ola, "Xbuf": Xall[:, :, -(P + 1):], "phi0": phi_next}
    return y.to(dtype), new_state


def pitch_shift_pv_stream(
    x: torch.Tensor,
    sample_rate: float,
    semitones: float,
    frame_size: int = 2048,
    hop: int = 512,
    state=None,
) -> Tuple[torch.Tensor, Any]:
    """Streaming phase-vocoder pitch shifter (the offline
    :func:`~dasp_tpu_torch.functional.pitch_shift_pv` at a static
    ``semitones``): :func:`time_stretch_stream` at ``1 / r`` and a streaming
    linear resampler at ``r = 2^(semitones / 12)``. Tc samples in, Tc out;
    ``(Tc / hop) r`` must be a whole number (r = 1.5, +7.02 semitones, is;
    r = 2^(7/12) is not: for any shift use the offline effect or
    :func:`pitch_shift_stream`). It adds ``ceil((2 - r) / r)`` output
    samples of latency to the stretch's."""
    bs, chs, Tc = x.shape
    r = 2.0 ** (float(semitones) / 12.0)
    state = state or {"stretch": None, "hist": None}
    stretched, st_stretch = time_stretch_stream(x, sample_rate, 1.0 / r, frame_size, hop, state["stretch"])
    Dr = max(1, int(math.ceil((2.0 - r) / r)))
    H = int(math.ceil(Dr * r))
    hist = state["hist"]
    if hist is None:
        hist = torch.zeros((bs, chs, H), dtype=stretched.dtype, device=x.device)
    buf = torch.cat([hist, stretched], dim=-1)  # (bs, chs, H + Tc r)
    pos = np.arange(Tc, dtype=np.float64) * r - Dr * r + H
    j0 = np.floor(pos).astype(np.int64)
    fr = torch.from_numpy((pos - np.floor(pos)).astype(np.float32)).to(x.device)
    s0 = torch.index_select(buf, -1, torch.from_numpy(j0).to(x.device))
    s1 = torch.index_select(buf, -1, torch.from_numpy(j0 + 1).to(x.device))
    y = (1.0 - fr) * s0 + fr * s1
    return y.to(x.dtype), {"stretch": st_stretch, "hist": buf[..., -H:]}


def multiband_compressor_stream(
    x: torch.Tensor,
    sample_rate: float,
    crossover_low_hz,
    crossover_high_hz,
    low_threshold_db, low_ratio, low_attack_ms, low_release_ms, low_makeup_gain_db,
    mid_threshold_db, mid_ratio, mid_attack_ms, mid_release_ms, mid_makeup_gain_db,
    high_threshold_db, high_ratio, high_attack_ms, high_release_ms, high_makeup_gain_db,
    knee_db,
    eps: float = 1e-8,
    state: Optional[Dict[str, Any]] = None,
    filter_method: str = "coupled",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One streaming step of the three-band compressor, the offline
    :func:`~dasp_tpu_torch.functional.multiband_compressor` at the same
    ``filter_method`` and ``smoother="block"``. The state is the LR4 tree's
    (``xo_s1`` the two f_lo legs stacked on the batch axis, ``xo_s2`` the
    four f_hi legs, each stage one filter call as offline) and the three
    band compressors' (the bands stacked 3x on the batch axis). Chunk
    lengths are multiples of the IIR block (128)."""
    bs, dtype, device = x.shape[0], x.dtype, x.device
    f_lo = F._param(crossover_low_hz, bs, dtype, device).reshape(bs)
    f_hi = torch.maximum(F._param(crossover_high_hz, bs, dtype, device).reshape(bs), 1.01 * f_lo)
    state = state or {}
    sos_lo_lp, sos_lo_hp = F.lr4_crossover_sos(f_lo, sample_rate, bs, dtype)
    sos_hi_lp, sos_hi_hp = F.lr4_crossover_sos(f_hi, sample_rate, bs, dtype)

    new_state: Dict[str, Any] = {}
    # stage 1: both f_lo legs on x, one call
    y1, new_state["xo_s1"] = sosfilt_stream(torch.cat([sos_lo_lp, sos_lo_hp]), torch.cat([x, x]),
                                            zi=state.get("xo_s1"), filter_method=filter_method)
    low_pre, rest = y1[:bs], y1[bs:]
    # stage 2: mid and high from the rest, and the low band through the f_hi
    # allpass (its LP + HP) to stay phase-aligned: four legs, one call
    y2, new_state["xo_s2"] = sosfilt_stream(
        torch.cat([sos_hi_lp, sos_hi_hp, sos_hi_lp, sos_hi_hp]), torch.cat([rest, rest, low_pre, low_pre]),
        zi=state.get("xo_s2"), filter_method=filter_method)
    mid, high = y2[:bs], y2[bs : 2 * bs]
    low = y2[2 * bs : 3 * bs] + y2[3 * bs :]

    def cat(*ps):
        return torch.cat([F._param(p, bs, dtype, device).reshape(bs) for p in ps])

    y, new_state["dyn"] = compressor_stream(
        torch.cat([low, mid, high]), sample_rate,
        cat(low_threshold_db, mid_threshold_db, high_threshold_db),
        cat(low_ratio, mid_ratio, high_ratio),
        cat(low_attack_ms, mid_attack_ms, high_attack_ms),
        cat(low_release_ms, mid_release_ms, high_release_ms),
        cat(knee_db, knee_db, knee_db),
        cat(low_makeup_gain_db, mid_makeup_gain_db, high_makeup_gain_db),
        eps=eps, zi=state.get("dyn"),
    )
    return (y[:bs] + y[bs : 2 * bs] + y[2 * bs :]).to(dtype), new_state


class StreamChain:
    """Serial composition of stream steps with one carried state dict, the
    streaming counterpart of :class:`~dasp_tpu_torch.modules.Chain`.

    Each entry is ``(name, step_fn)``, ``step_fn(chunk, state) -> (chunk,
    state)`` any ``*_stream`` function with its parameters bound
    (``functools.partial`` or a lambda). The chain is itself a pure
    ``(chunk, state_dict) -> (chunk, state_dict)`` function; ``state=None``
    starts every member from rest.

    Example::

        chain = StreamChain([
            ("eq", lambda c, s: parametric_eq_stream(c, sr, *p_eq, zi=s)),
            ("comp", lambda c, s: compressor_stream(c, sr, *p_c, zi=s)),
            ("lim", lambda c, s: limiter_stream(c, sr, *p_l, zi=s, smoother="exact")),
        ])
        y, state = chain(chunk, None)
    """

    def __init__(self, steps):
        steps = list(steps)
        if not steps:
            raise ValueError("StreamChain requires at least one step.")
        names = [name for name, _ in steps]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate step names: {names}")
        self.steps = steps

    def __call__(self, x: torch.Tensor, state: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        state = {} if state is None else state
        new_state: Dict[str, Any] = {}
        with span("stream.chunk"):
            for name, fn in self.steps:
                x, new_state[name] = fn(x, state.get(name))
        return x, new_state
