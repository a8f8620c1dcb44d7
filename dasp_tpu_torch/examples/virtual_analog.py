"""Virtual analog: grey-box distortion model (EQ -> MLP -> EQ).

A distortion model holds two learnable normalized EQ parameter vectors
(sigmoid-squashed) around a small MLP nonlinearity; the MLP is first fit to
tanh; then the whole model is fit to (clean, amp-processed) pairs with the
MR-STFT loss + 100 x MSE. Without a dataset, the targets come from a hidden
reference "amp" (EQ -> distortion -> EQ with fixed parameters).

``--amps`` trains one model per IDMT amp recording: the six (input,
amp-output) wav pairs are looked up under ``--amp-audio-dir`` and fetched
through :func:`dasp_tpu_torch.utils.acquire` only where missing, so pairs
placed there beforehand train offline.

    python -m dasp_tpu_torch.examples.virtual_analog [--data-dir wavs/] [--steps N] [--smoke]
    python -m dasp_tpu_torch.examples.virtual_analog --amps                 # all six
    python -m dasp_tpu_torch.examples.virtual_analog --amps jazz-amp --smoke --steps 3
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from .. import functional as F
from .. import modules as M
from ..utils import MetricsLogger, multi_resolution_stft_loss, save_checkpoint
from ..utils import datasets
from ..utils.audio import load_wav, save_wav
from .common import base_parser, device_batches, device_of

MRSTFT_KW = dict(  # the reference virtual-analog loss configuration
    fft_sizes=(128, 256, 512, 1024, 2048, 4096, 8192),
    hop_sizes=(64, 128, 256, 512, 1024, 2048, 4096),
    win_lengths=(128, 256, 512, 1024, 2048, 4096, 8192),
    w_sc=0.0, w_log_mag=1.0, w_lin_mag=1.0,
    perceptual_weighting=True,
)

# the six IDMT-SMT-Audio-Effects amp recordings, all responses to the same
# varying-gain input
IDMT_SRC = "idmt-rock-input-varying-gain.wav"
IDMT_AMPS = {
    "65twin-reverb": "idmt-rock-clean1-65twin-reverb.wav",
    "jazz-amp": "idmt-rock-clean2-jazz-amp-120.wav",
    "orange-dual-terror": "idmt-rock-crunch1-orange-dual-terror.wav",
    "british-blue-tube-30": "idmt-rock-crunch2-british-blue-tube-30tb.wav",
    "brit-8000": "idmt-rock-high-gain1-brit-8000.wav",
    "mesa-triple-rectifier": "idmt-rock-high-gain2-mesa-triple-rectifier.wav",
}


class MLPNonlinearity(nn.Module):
    """Pointwise 1 -> 128 x 4 -> 1 MLP waveshaper: each sample is a
    one-feature token. Weights drawn as flax's Dense draws them (LeCun
    normal, truncated at two deviations; zero biases) from ``generator``."""

    def __init__(self, hidden: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        widths = [1, hidden, hidden, hidden, hidden, 1]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        with torch.no_grad():
            for layer in self.layers:
                std = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[..., None]  # (bs, chs, T) -> (bs, chs, T, 1)
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)[..., 0]


def fetch_idmt_amps(audio_dir: str, names) -> None:
    """The IDMT amp pairs under ``audio_dir``, fetched through the dataset
    registry (resumable, verified) only where missing."""
    files = [IDMT_SRC] + [IDMT_AMPS[n] for n in names]
    try:
        datasets.acquire("idmt-amps", audio_dir, files=files)
    except datasets.DownloadError as e:
        raise SystemExit(f"{e}\nOr run without --amps for synthetic targets.")


def paired_chunk_iterator(src, target, length, batch_size, nprng):
    """Random batches of aligned (src, target) chunks of ``length`` samples
    (sequential segments, drawn with replacement)."""
    n_segments = src.shape[-1] // length
    if n_segments == 0:
        raise ValueError(f"file shorter than one {length}-sample segment")
    while True:
        starts = nprng.integers(0, n_segments, size=batch_size) * length
        yield (np.stack([src[:, s:s + length] for s in starts]),
               np.stack([target[:, s:s + length] for s in starts]))


def hidden_amp(x, sr):
    """The 'real amp' that synthesizes targets when no dataset is given."""
    bs = x.shape[0]
    f = lambda v: torch.full((bs,), v, dtype=x.dtype, device=x.device)  # noqa: E731
    y = F.parametric_eq(x, sr, f(6.0), f(120.0), f(0.7), f(8.0), f(700.0), f(1.2),
                        f(-4.0), f(3000.0), f(2.0), f(2.0), f(9000.0), f(1.0),
                        f(0.0), f(13000.0), f(1.0), f(-6.0), f(7000.0), f(0.7))
    y = F.distortion(y, sr, f(18.0))
    y = F.parametric_eq(y, sr, f(-3.0), f(150.0), f(0.7), f(3.0), f(900.0), f(1.0),
                        f(2.0), f(4000.0), f(1.5), f(0.0), f(9000.0), f(1.0),
                        f(0.0), f(13000.0), f(1.0), f(-8.0), f(8000.0), f(0.7))
    return y


class DistortionModel(nn.Module):
    """EQ -> MLP -> EQ with two learnable logit vectors for the EQs."""

    def __init__(self, equalizer, generator: torch.Generator):
        super().__init__()
        self.equalizer = equalizer
        n = equalizer.num_params
        self.pre = nn.Parameter(torch.rand((1, n), generator=generator) * 0.1)
        self.post = nn.Parameter(torch.rand((1, n), generator=generator) * 0.1)
        self.mlp = MLPNonlinearity(generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs = x.shape[0]
        y = self.equalizer.process_normalized(x, torch.sigmoid(self.pre).expand(bs, -1), clip_params=True)
        y = self.mlp(y)
        return self.equalizer.process_normalized(y, torch.sigmoid(self.post).expand(bs, -1), clip_params=True)


def fit_distortion_model(args, sr, data_iter, log_dir, synth_amp=None):
    """Fit the MLP nonlinearity to tanh, then the grey-box model to (src,
    target) batches from ``data_iter`` (a target of None is rendered by
    ``synth_amp``). Returns ``(model, losses)``."""
    os.makedirs(log_dir, exist_ok=True)
    device = device_of(args)
    equalizer = M.ParametricEQ(sr, min_gain_db=-48.0, max_gain_db=48.0, filter_method=args.filter_method)
    model = DistortionModel(equalizer, torch.Generator().manual_seed(args.seed)).to(device)

    # ---- fit the MLP to tanh ----
    pre_opt = torch.optim.Adam(model.mlp.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    nprng = np.random.default_rng(args.seed + 2)
    for _ in range(200 if args.smoke else 2000):
        xb = torch.as_tensor(nprng.uniform(-3, 3, (32, 1, 64)).astype(np.float32), device=device)
        ploss = torch.mean((model.mlp(xb) - torch.tanh(xb)) ** 2)
        pre_opt.zero_grad(set_to_none=True)
        ploss.backward()
        pre_opt.step()
    print(f"nonlinearity pretrained: tanh fit mse {float(ploss.detach()):.2e}")

    # ---- fit the whole grey-box model ----
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    logger = MetricsLogger(log_dir)
    losses = []
    for step in range(args.steps):
        src_np, target_np = next(data_iter)
        src = torch.as_tensor(src_np, device=device)
        if target_np is None:
            with torch.no_grad():
                target = synth_amp(src)
        else:
            target = torch.as_tensor(target_np, device=device)
        y_hat = model(src)
        freq = multi_resolution_stft_loss(y_hat, target, sample_rate=sr,
                                          auraloss_compat=args.auraloss_compat, **MRSTFT_KW)
        time_l = torch.mean((y_hat - target) ** 2)
        loss = freq + 100.0 * time_l
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss, freq, time_l = loss.detach(), freq.detach(), time_l.detach()
        losses.append(float(loss))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {float(loss):.4f}  (freq {float(freq):.4f}, "
                  f"mse {float(time_l):.2e})")
            logger.log(step, loss=loss, freq=freq, mse=time_l)

    save_checkpoint(os.path.join(log_dir, "ckpt.pkl"), {"params": model.state_dict(), "step": args.steps})
    print(f"done; metrics at {logger.path}")
    return model, losses


def run_amps(args) -> dict:
    """One grey-box model per IDMT amp, prediction wavs saved per amp."""
    device = device_of(args)
    sr = args.sample_rate
    names = args.amps if args.amps else list(IDMT_AMPS)
    bad = [n for n in names if n not in IDMT_AMPS]
    if bad:
        raise SystemExit(f"unknown amp(s) {bad}; choose from {list(IDMT_AMPS)}")
    fetch_idmt_amps(args.amp_audio_dir, names)

    src, file_sr = load_wav(os.path.join(args.amp_audio_dir, IDMT_SRC))
    if file_sr != sr:
        print(f"warning: file rate {file_sr} != --sample-rate {sr}; using {file_sr}")
        sr = file_sr
    src = src[0:1]  # mono

    base_log = args.log_dir or "outputs/virtual_analog"
    out = {}
    for name in names:
        print(f"=== amp: {name} ===")
        target, _ = load_wav(os.path.join(args.amp_audio_dir, IDMT_AMPS[name]))
        target = target[0:1]
        t = min(src.shape[-1], target.shape[-1])
        data_iter = paired_chunk_iterator(src[:, :t], target[:, :t], args.length, args.batch_size,
                                          np.random.default_rng(args.seed))
        log_dir = os.path.join(base_log, name)
        model, out[name] = fit_distortion_model(args, sr, data_iter, log_dir)

        # render a bounded-length prediction in chunks of args.length
        n_render = min(t // args.length, 8) * args.length
        with torch.no_grad():
            chunks = [model(torch.as_tensor(src[None, :, s:s + args.length], device=device))[0].cpu().numpy()
                      for s in range(0, n_render, args.length)]
        y_hat = np.concatenate(chunks, axis=-1)
        os.makedirs(os.path.join(log_dir, "audio"), exist_ok=True)
        stem = IDMT_AMPS[name].replace(".wav", "")
        save_wav(os.path.join(log_dir, "audio", f"{stem}-pred.wav"), y_hat, sr)
        save_wav(os.path.join(log_dir, "audio", f"{stem}-input.wav"), src[:, :n_render], sr)
        save_wav(os.path.join(log_dir, "audio", f"{stem}-target.wav"), target[:, :n_render], sr)
        print(f"saved prediction wavs under {log_dir}/audio")
    return {"losses": out}


def main(argv=None) -> dict:
    parser = base_parser(__doc__.splitlines()[0])
    parser.add_argument("--amps", nargs="*", default=None,
                        help="train one model per IDMT amp recording "
                             "(fetched on first use where missing; no names = all six)")
    parser.add_argument("--amp-audio-dir", default="audio/amps",
                        help="where the IDMT wav pairs live / are downloaded to")
    args = parser.parse_args(argv)
    args.lr = args.lr if args.lr != 1e-4 else 1e-2  # the reference virtual-analog default
    if args.smoke:
        args.length, args.batch_size = 8192, 2
    elif args.length == 131072:
        args.length = 32768  # the reference trains on 32768-sample segments
    sr = args.sample_rate

    if args.amps is not None:
        return run_amps(args)

    log_dir = args.log_dir or "outputs/virtual_analog"
    data = device_batches(args)  # staged copies, int16 wire
    data_iter = ((next(data), None) for _ in iter(int, 1))
    _, losses = fit_distortion_model(args, sr, data_iter, log_dir, synth_amp=lambda x: hidden_amp(x, sr))
    return {"losses": losses}


if __name__ == "__main__":
    main()
