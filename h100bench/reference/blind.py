"""Blind estimation of a pitch shifter, as dasp-pytorch's
``examples/blind_estimation.py`` trains its estimator, in plain PyTorch: a
TCN listens to a processed clip and predicts the processor's normalized
parameters; the clean clip is processed again with the prediction, a
single-resolution STFT loss compares the two renders, and Adam steps.

- The net: five blocks of 16, 32, 64, 128, 128 channels, kernel 3,
  dilations 1, 2, 4, 8, 16, each block conv (stride 2, dilation d) ->
  ReLU -> BatchNorm -> conv -> ReLU -> BatchNorm with no padding; the time
  mean; a linear head and a sigmoid. BatchNorm in train mode normalizes
  with the biased batch statistics and moves its running ones by momentum
  0.99 (``style._bn``). It runs in float32 with TF32 off.
- The pitch shifter (two crossfaded sawtooth taps on a delay line): with
  ``r = 2 ** (semitones / 12)`` and ``u(n) = (1 - r) n / W``, tap i in {0,
  1/2} has phase ``p_i = frac(u + i)``, delay ``W p_i`` and gain ``sin(pi
  p_i)``; each tap reads the clip at ``n - W p_i`` by linear interpolation
  between the two neighbouring samples (a gather), and nothing before the
  clip starts; the taps' sum is moved ``W / 2`` samples earlier (latency
  compensation, zeros at the tail) and mixed, ``(1 - mix) x + mix wet``.
  The taps' coordinates (phase, delay, gain, the read position and its
  fraction) have the float32 values the configuration states, the read
  position is the kernel's tile-local one, and where it falls exactly on a
  sample the delay's gradient is zero, as the kernel's (``_tap_reads``);
  the reads, the wet path and the mix are float64. The loss's gradient in
  the semitones sums, over the clip, n times the signal's slope at each
  read, weighted by the log-magnitude term's 1 / |Y|, so it is rough at
  the scale by which float32 moves a read: a float64 phase (an ulp of u is
  a hundredth of a sample at the end of a 131072-sample clip) moves it by
  30-65 %, and the right-hand slope on exact samples (about one float32
  read in 4096) by 7-9 % (bs 2 x 16384 and 65536 on the CPU). A reference
  with coordinates of its own would hold the program to another gradient
  and hide a fault of kernel C's backward in that gap.
- The loss: spectral convergence plus the mean absolute log-magnitude
  difference of one STFT (``dsp.mrstft_loss`` at one resolution), in
  float64. Adam is ``style.Adam``.

Departures from the program (``dasp_tpu_torch.functional.pitch_shift`` on
kernel C): the reads, the interpolation, the taps' sum, the wet path, the
mix and the loss are float64 (the program's float32), and the coordinates'
derivatives are taken in float64 from their float32 values; each tap reads
the whole clip by one gather, where the kernel reads each tile's window
(the same two samples).

``Precision`` lowers the net and the effect for the control.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as nnf

from . import dsp
from .style import Adam, _bn, no_tf32

__all__ = ["Precision", "REFERENCE", "CONTROL", "net_forward", "pitch_shift", "render",
           "train_steps", "param_shapes", "bn_stats"]


@dataclass(frozen=True)
class Precision:
    """How the reference computes the net and the effect.

    ``conv``: "fp32" (float32, TF32 off) or "bf16" (the convolutions take
    bf16 inputs and weights and give bf16 outputs, ReLU runs in bf16,
    BatchNorm takes its statistics and normalizes in float32 and rounds its
    output to bf16; the time mean and the head run in float32).

    ``dsp_bf16``: the effect's input, each tap's delay and gain (its
    coefficients, one a sample), its wet path and output, and the loss's
    inputs rounded to bfloat16; the sample a tap reads stays an exact
    index."""

    conv: str = "fp32"
    dsp_bf16: bool = False

    @property
    def dsp_round(self):
        return dsp.bf16_round if self.dsp_bf16 else dsp.exact


# the reference's own precision, above what the configuration states (TF32
# convolutions; a float32 effect and loss), and the control's, one step
# below each of those: bf16 convolutions, a bfloat16 effect and loss
REFERENCE = Precision()
CONTROL = Precision(conv="bf16", dsp_bf16=True)


def _conv(x, w, b, prec: Precision, **kw):
    if prec.conv == "fp32":
        return nnf.conv1d(x, w, b, **kw)
    if prec.conv == "bf16":
        return nnf.conv1d(x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16), **kw)
    raise ValueError(f"unknown convolution precision {prec.conv!r}")


def net_forward(P, stats, x, net: dict, train: bool = True, prec: Precision = REFERENCE) -> torch.Tensor:
    """Normalized parameters (bs, n) of clips x (bs, 1, T); ``stats``
    (BatchNorm's running statistics) is updated in train mode."""
    h = x
    for i, d in enumerate(net["dilations"]):
        for j, kw in enumerate((dict(stride=2, dilation=d), {})):
            pre = f"blocks.{i}."
            h = _conv(h, P[pre + f"conv{j}.weight"], P[pre + f"conv{j}.bias"], prec, **kw)
            h = _bn(torch.relu(h), P, stats, pre + f"bn{j}", train)
    h = h.float().mean(dim=-1)
    return torch.sigmoid(nnf.linear(h, P["dense0.weight"], P["dense0.bias"]))


def window_samples(proc: dict, sr: int) -> int:
    """The delay line's (even) length W for a window of ``window_ms``."""
    return max(2, 2 * int(round(proc["window_ms"] * sr / 2e3)))


def _taps(semitones: torch.Tensor, T: int, W: int):
    """Each tap's delay and gain (bs, T) in the dtype of ``semitones``."""
    n = torch.arange(T, dtype=semitones.dtype, device=semitones.device)
    u = (1.0 - 2.0 ** (semitones / 12.0))[:, None] * n / W
    out = []
    for i in (0.0, 0.5):
        p = u + i
        p = p - torch.floor(p)
        out.append((W * p, torch.sin(math.pi * p)))
    return out


def _as_float32(v: torch.Tensor) -> torch.Tensor:
    """float64 v with the value of its float32 rounding and its own
    (float64) derivative."""
    return v + (v.float().double() - v).detach()


def _tap_reads(x: torch.Tensor, d: torch.Tensor, g: torch.Tensor, W: int, B: int) -> torch.Tensor:
    """One tap of delays d and gains g (bs, T), float32, read from x (bs, T)
    in float64. The read position is tile-local, as the configuration's
    kernel forms it: output sample t of the tile that starts at t - j (j = t
    mod B) reads the window of the W + 1 samples before the tile and the
    tile itself at r = (j + W + 1) - d, rounded to float32; i0 = floor(r) and
    f = r - i0 (the gradient of the delay flows through f); a point outside
    the window and every read where t - d < 0 count zero."""
    T = x.shape[-1]
    t = torch.arange(T, device=x.device)
    j = t % B
    Dm = W + 1
    r = _as_float32((j + Dm).double() - d)
    i0 = torch.floor(r)
    f = r - i0
    f = torch.where(f == 0, f.detach(), f)  # on a sample, the hat's kink: no slope taken
    left = (t - j - Dm) + i0.detach().long()  # the first point's index in the clip
    xp = nnf.pad(x, (1, 1))  # index -1 (before the clip: zero) and T (past it, weight 0)
    x0 = torch.gather(xp, -1, (left + 1).clamp(0, T + 1))
    x1 = torch.gather(xp, -1, (left + 2).clamp(0, T + 1))
    x1 = torch.where(i0 + 1 < Dm + B, x1, torch.zeros_like(x1))
    on = (t.float() - d.float()) >= 0
    return torch.where(on, g * ((1.0 - f) * x0 + f * x1), torch.zeros_like(x0))


def pitch_shift(x: torch.Tensor, semitones: torch.Tensor, mix: torch.Tensor, W: int, B: int,
                prec: Precision = REFERENCE) -> torch.Tensor:
    """The pitch shifter of the module docstring on x (bs, 1, T); semitones
    (bs,) float32, mix (bs,). The taps' coordinates in float32, their reads
    and the rest in float64 (see the module docstring)."""
    r = prec.dsp_round
    x = r(x.double())[:, 0]
    T = x.shape[-1]
    taps32 = _taps(semitones.detach().float(), T, W)
    taps64 = _taps(semitones.double(), T, W)
    wet = 0.0
    for (d32, g32), (d64, g64) in zip(taps32, taps64):
        d, g = d64 + (d32.double() - d64).detach(), g64 + (g32.double() - g64).detach()
        if prec.dsp_bf16:
            d, g = dsp.bf16_round(d), dsp.bf16_round(g)
        wet = wet + _tap_reads(x, d, g, W, B)
    half = W // 2
    wet = r(nnf.pad(wet, (0, half))[:, half:])
    m = mix.double()[:, None]
    return r((1.0 - m) * x + m * wet)[:, None, :]


def render(x, params: torch.Tensor, proc: dict, sr: int, prec: Precision = REFERENCE) -> torch.Tensor:
    """x through the pitch shifter at normalized parameters (bs, 2) on [0,
    1] (clamped first), columns semitones then mix."""
    p = torch.clamp(params.float(), 0.0, 1.0)
    (s_lo, s_hi), (m_lo, m_hi) = proc["semitones"], proc["mix"]
    return pitch_shift(x, s_lo + p[:, 0] * (s_hi - s_lo), m_lo + p[:, 1].double() * (m_hi - m_lo),
                       window_samples(proc, sr), proc["block"], prec)


def stft_loss(y_hat, y, loss: dict, prec: Precision = REFERENCE):
    r = prec.dsp_round
    return dsp.mrstft_loss(r(y_hat), r(y), sizes=((loss["fft_size"], loss["hop_size"], loss["win_length"]),))


def train_steps(P0: Dict[str, torch.Tensor], stats0: Dict[str, torch.Tensor], cfg: dict, batches: List[dict],
                prec: Precision = REFERENCE, estimates: Optional[List[torch.Tensor]] = None) -> dict:
    """Follow the training steps on ``batches`` (each a dict of clips ``x``
    (bs, 1, T) and target parameters ``rand`` (bs, 2)) from the weights P0.

    With ``estimates`` (the program's estimate at each step, (bs, 2)), each
    step's effect and loss are taken at the program's estimate and not at
    the reference's own: the loss, and its gradient in the estimate, there;
    the net's gradient is that gradient through the reference's net (its
    own forward, weights and statistics). The loss's gradient in the
    semitones is rough at the scale by which float32 or TF32 arithmetic
    moves an estimate (1e-5 of an estimate moves a read by a tenth of a
    sample at the end of a 131072-sample clip), so a reference free to
    make its own estimate would hold the program to another gradient.

    Returns:
        ``{"losses", "grads1", "P", "stats", "targets", "estimates",
        "effect_grads"}``: each step's loss, the first step's gradient of
        each leaf, the weights and BatchNorm's running statistics after the
        last step, and of each step the target render, the reference's
        estimate and the loss's gradient in the estimate.
    """
    proc, sr = cfg["processor"], cfg["sample_rate"]
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    stats = {k: v.detach().clone().float() for k, v in stats0.items()}
    opt = Adam(P, cfg["optimizer"]["lr"], *cfg["optimizer"]["betas"], cfg["optimizer"]["eps"])
    out = {"losses": [], "grads1": None, "targets": [], "estimates": [], "effect_grads": []}
    with no_tf32():
        for i, b in enumerate(batches):
            leaves = {k: v.requires_grad_(True) for k, v in P.items()}
            with torch.no_grad():
                y = render(b["x"], b["rand"], proc, sr, prec)
            p_hat = net_forward(leaves, stats, y.float(), cfg["net"], True, prec)
            p = p_hat if estimates is None else estimates[i].detach().float().clone().requires_grad_(True)
            loss = stft_loss(render(b["x"], p, proc, sr, prec), y, cfg["loss"], prec)
            g_p = torch.autograd.grad(loss, p, retain_graph=estimates is None)[0]
            grads = dict(zip(leaves, torch.autograd.grad(p_hat, list(leaves.values()), grad_outputs=g_p)))
            P = {k: v.detach() for k, v in leaves.items()}
            for key, v in (("losses", float(loss.detach())), ("targets", y), ("estimates", p_hat.detach()),
                           ("effect_grads", g_p.detach())):
                out[key].append(v)
            if out["grads1"] is None:
                out["grads1"] = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(P, grads)
    out["P"], out["stats"] = P, stats
    return out


def param_shapes(net: dict) -> Dict[str, tuple]:
    """The shape of every weight of the net, keyed as the program's
    ``ParameterNetwork`` state dict."""
    shapes, c_in, k = {}, 1, net["kernel_size"]
    for i, ch in enumerate(net["channels"]):
        for j, cin in enumerate((c_in, ch)):
            pre = f"blocks.{i}."
            shapes.update({pre + f"conv{j}.weight": (ch, cin, k), pre + f"conv{j}.bias": (ch,),
                           pre + f"bn{j}.weight": (ch,), pre + f"bn{j}.bias": (ch,)})
        c_in = ch
    shapes["dense0.weight"], shapes["dense0.bias"] = (net["num_params"], c_in), (net["num_params"],)
    return shapes


def bn_stats(net: dict, device) -> Dict[str, torch.Tensor]:
    """BatchNorm's running statistics at rest: mean 0, variance 1."""
    stats = {}
    for i, ch in enumerate(net["channels"]):
        for j in range(2):
            key = f"blocks.{i}.bn{j}"
            stats[key + ".running_mean"] = torch.zeros(ch, device=device)
            stats[key + ".running_var"] = torch.ones(ch, device=device)
    return stats
