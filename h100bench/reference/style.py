"""The style-transfer model of Steinmetz, Bryan and Reiss, "Style Transfer
of Audio Effects with Differentiable Signal Processing" (JAES 2022), in
plain PyTorch: a TCN encoder shared by the input and the reference, four
parameter projectors, the EQ -> compressor -> reverb -> gain render, the
self-supervised corruption, the MR-STFT loss and Adam.

Parameters live in one dict keyed as ``StyleTransferNet``'s state dict
(``encoder.blocks.0.conv0.weight``, ``projectors.gain.dense2.bias``...).
The net runs in float32 with TF32 off; the effects and the loss in float64.
``Precision`` lowers both for the control.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as nnf

from . import dsp

PROJECTORS = ("equalizer", "compressor", "reverb", "gain")
BN_EPS = 1e-5
BN_MOMENTUM = 0.99


@dataclass(frozen=True)
class Precision:
    """How the reference computes the net and the effects.

    ``conv``: "fp32" (float32, TF32 off), "bf16" (as the configuration
    states: the convolutions take bf16 inputs and weights and give bf16
    outputs, PReLU runs in bf16, BatchNorm takes its statistics and
    normalizes in float32 and rounds its output to bf16, so activations
    stay bf16 from one convolution to the next; the time mean and the dense
    layers run in float32) or "fp8" (as "bf16", with each convolution's
    inputs and weights rounded to float8 e4m3 under one scale a tensor: an
    fp8 matmul that accumulates in float32).

    ``dsp_bf16``: the effects' coefficients, each stage's output, the gain
    curve, the IR and the loss's inputs rounded to bfloat16 (see ``dsp``)."""

    conv: str = "fp32"
    dsp_bf16: bool = False

    @property
    def dsp_round(self):
        return dsp.bf16_round if self.dsp_bf16 else dsp.exact


# the configuration's precisions (bfloat16 convolutions; float32 effects and
# loss, which run in float64 here), and the control: each one step lower
# (fp8 convolutions, bfloat16 effects and loss)
STATED = Precision(conv="bf16")
CONTROL = Precision(conv="fp8", dsp_bf16=True)
_CONV = {"float32": "fp32", "bfloat16": "bf16"}


def stated(cfg: dict) -> Precision:
    """The precision a configuration states for its encoder's convolutions."""
    return Precision(conv=_CONV[cfg["precision"]["encoder_convolutions"]])




@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with a per-tensor scale (amax to 448)."""
    scale = 448.0 / torch.clamp(t.detach().abs().amax(), min=1e-30)
    q = (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()  # the gradient passes straight through


def _conv(x, w, b, prec: Precision, **kw):
    if prec.conv == "fp32":
        return nnf.conv1d(x, w, b, **kw)
    if prec.conv == "bf16":
        return nnf.conv1d(x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16), **kw)
    if prec.conv == "fp8":
        return nnf.conv1d(fp8_round(x.float()), fp8_round(w), b, **kw).to(torch.bfloat16)
    raise ValueError(f"unknown convolution precision {prec.conv!r}")


def _bn(x, P, stats, key, train: bool):
    """BatchNorm over (batch, time), statistics in float32 and the output in
    the input's type: biased batch statistics in train mode (moving the
    running ones by momentum 0.99 toward the batch mean and biased
    variance), the running ones in eval mode."""
    w, b = P[key + ".weight"], P[key + ".bias"]
    if not train:
        return nnf.batch_norm(x, stats[key + ".running_mean"], stats[key + ".running_var"], w, b,
                              training=False, eps=BN_EPS)
    if stats is not None:
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2), unbiased=False)
            for name, v in (("running_mean", mean), ("running_var", var)):
                stats[f"{key}.{name}"] = BN_MOMENTUM * stats[f"{key}.{name}"] + (1 - BN_MOMENTUM) * v
    return nnf.batch_norm(x, None, None, w, b, training=True, eps=BN_EPS)


def encoder(P, stats, x, net: dict, train: bool, prec: Precision = STATED):
    """TCN blocks (each: conv stride 2 dilation d -> PReLU -> BN -> conv ->
    PReLU -> BN, no padding), the time mean, then a ReLU MLP to the
    embedding."""
    h = x
    for i, d in enumerate(net["encoder_dilations"]):
        pre = f"encoder.blocks.{i}."
        for j, kw in enumerate((dict(stride=2, dilation=d), {})):
            h = _conv(h, P[pre + f"conv{j}.weight"], P[pre + f"conv{j}.bias"], prec, **kw)
            h = nnf.prelu(h, P[pre + f"prelu{j}.weight"].to(h.dtype))
            h = _bn(h, P, stats, pre + f"bn{j}", train)
    h = h.float().mean(dim=-1)
    h = torch.relu(nnf.linear(h, P["encoder.dense0.weight"], P["encoder.dense0.bias"]))
    h = torch.relu(nnf.linear(h, P["encoder.dense1.weight"], P["encoder.dense1.bias"]))
    return nnf.linear(h, P["encoder.dense2.weight"], P["encoder.dense2.bias"])


def net_forward(P, stats, inp, ref, net: dict, train: bool, prec: Precision = STATED) -> Dict[str, torch.Tensor]:
    """Normalized parameters from (input, reference): the embeddings of
    both joined, then each projector's ReLU MLP and sigmoid."""
    z = torch.cat([encoder(P, stats, inp, net, train, prec), encoder(P, stats, ref, net, train, prec)], dim=-1)
    out = {}
    for name in PROJECTORS:
        pre = f"projectors.{name}."
        h = torch.relu(nnf.linear(z, P[pre + "dense0.weight"], P[pre + "dense0.bias"]))
        h = torch.relu(nnf.linear(h, P[pre + "dense1.weight"], P[pre + "dense1.bias"]))
        out[name] = torch.sigmoid(nnf.linear(h, P[pre + "dense2.weight"], P[pre + "dense2.bias"]))
    return out


def effects(x, params: Dict[str, torch.Tensor], noise: torch.Tensor, prec: Precision = STATED):
    """EQ -> compressor -> reverb of x (bs, 1, T) with normalized
    parameters, in float64; ``noise`` the reverb's white noise."""
    r = prec.dsp_round
    p = {k: v.double() for k, v in params.items()}
    y = dsp.parametric_eq(x.double(), dsp.denorm(p["equalizer"], dsp.eq_ranges()), r)
    y = dsp.compressor(y, dsp.denorm(p["compressor"], dsp.COMP_RANGES), r)
    rv = torch.clamp(p["reverb"], 0.0, 1.0)
    ir = r(dsp.noise_ir(noise, rv[:, :12], rv[:, 12:24]))
    return dsp.reverb(y, ir, rv[:, 24], r)


def chain(x, params: Dict[str, torch.Tensor], noise: torch.Tensor, prec: Precision = STATED):
    """The style chain: :func:`effects`, then the gain."""
    y = effects(x, params, noise, prec)
    return prec.dsp_round(dsp.gain(y, dsp.denorm(params["gain"].double(), (dsp.GAIN_RANGE,))[:, 0]))


@torch.no_grad()
def corrupt(x, rand: Dict[str, torch.Tensor], noise, prec: Precision = STATED):
    """The pseudo-reference: x (bs, 1, 2 half) through the random EQ,
    compressor and reverb, peak-normalized per channel, gains g1 (reference)
    and g2 (input) in dB; returns (input A, reference A, reference B)."""
    ref = effects(x, {"equalizer": rand["eq"], "compressor": rand["comp"], "reverb": rand["reverb"]}, noise, prec)
    ref = ref / (torch.amax(torch.abs(ref), dim=-1, keepdim=True) + 1e-9)
    ref = ref * 10.0 ** (-rand["g1"].double() / 20.0)
    x = x.double() * 10.0 ** (-rand["g2"].double() / 20.0)
    half = x.shape[-1] // 2
    return x[..., :half], ref[..., :half], ref[..., half:]


def loss_of(P, stats, net: dict, x, rand, noise_ref, noise_out, prec: Precision = STATED):
    """The training loss of one batch: corruption, the net in train mode on
    (input A, the channel mean of reference B), the render of input A, its
    MR-STFT loss against reference A."""
    inp_a, ref_a, ref_b = corrupt(x, rand, noise_ref, prec)
    params = net_forward(P, stats, inp_a.float(), ref_b.mean(dim=1, keepdim=True).float(), net, True, prec)
    out = chain(inp_a, params, noise_out, prec)
    return dsp.mrstft_loss(prec.dsp_round(out), prec.dsp_round(ref_a))


class Adam:
    """Adam with bias correction (lr, betas 0.9 / 0.999, eps 1e-8 outside the
    square root)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[k] -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)


def train_steps(P0: Dict[str, torch.Tensor], stats0: Dict[str, torch.Tensor], net: dict, batches: List[dict],
                lr: float, prec: Precision = STATED):
    """Follow the training steps on ``batches`` (each a dict x, rand,
    noise_ref, noise_out) from the weights P0.

    Returns:
        (losses, grads1, P, stats): each step's loss, the first step's
        gradient of each leaf, the weights and BatchNorm's running
        statistics after the last step.
    """
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    stats = {k: v.detach().clone().float() for k, v in stats0.items()}
    opt = Adam(P, lr)
    losses, grads1 = [], None
    with no_tf32():
        for b in batches:
            leaves = {k: v.requires_grad_(True) for k, v in P.items()}
            loss = loss_of(leaves, stats, net, b["x"], b["rand"], b["noise_ref"], b["noise_out"], prec)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            P = {k: v.detach() for k, v in leaves.items()}
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(P, grads)
    return losses, grads1, P, stats


@torch.no_grad()
def render(P, stats, net: dict, inp, ref, noise, prec: Precision = STATED):
    """The served render in eval mode: the net on (input, reference), then
    the chain of the input. Returns (normalized parameters, output)."""
    with no_tf32():
        params = net_forward(P, stats, inp, ref, net, False, prec)
        return params, chain(inp, params, noise, prec)


def param_shapes(net: dict) -> Dict[str, tuple]:
    """The shape of every weight of the net, keyed as its state dict."""
    ch, k, emb, hid = net["ch_dim"], net["kernel_size"], net["embed_dim"], net["mlp_hidden"]
    shapes, c_in = {}, 1
    for i, _ in enumerate(net["encoder_dilations"]):
        pre = f"encoder.blocks.{i}."
        for j, cin in enumerate((c_in, ch)):
            shapes.update({pre + f"conv{j}.weight": (ch, cin, k), pre + f"conv{j}.bias": (ch,),
                           pre + f"prelu{j}.weight": (1,), pre + f"bn{j}.weight": (ch,), pre + f"bn{j}.bias": (ch,)})
        c_in = ch
    dense = [("encoder.dense0", ch, hid), ("encoder.dense1", hid, hid), ("encoder.dense2", hid, emb)]
    for name, n in zip(PROJECTORS, net["num_params"]):
        ph = net["projector_hidden"]
        dense += [(f"projectors.{name}.dense0", 2 * emb, ph), (f"projectors.{name}.dense1", ph, ph),
                  (f"projectors.{name}.dense2", ph, n)]
    for name, fan_in, fan_out in dense:
        shapes[name + ".weight"], shapes[name + ".bias"] = (fan_out, fan_in), (fan_out,)
    return shapes


def bn_stats(net: dict, device) -> Dict[str, torch.Tensor]:
    """BatchNorm's running statistics at rest: mean 0, variance 1."""
    stats = {}
    for i, _ in enumerate(net["encoder_dilations"]):
        for j in range(2):
            key = f"encoder.blocks.{i}.bn{j}"
            stats[key + ".running_mean"] = torch.zeros(net["ch_dim"], device=device)
            stats[key + ".running_var"] = torch.ones(net["ch_dim"], device=device)
    return stats
