"""Mixing console: multitrack mix by gradient descent on console parameters.

A differentiable console

    per-track EQ -> per-track pan -> stereo bus (send levels) -> widener

whose parameters (pans, sends, EQ gains, width) are optimized so that the
mix matches a target stereo image and spectrum, on synthetic multitrack
audio.

    python -m dasp_tpu_torch.examples.mixing_console [--steps 400]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import functional as F
from ..utils import multi_resolution_stft_loss, synthetic_batch
from ..utils.audio import save_wav
from .common import add_device_flag, device_of


def console(tracks, sample_rate, params):
    """tracks: (bs, n_tracks, T) mono -> stereo mix (bs, 2, T)."""
    bs, n_tracks, T = tracks.shape

    # per-track 10-band graphic EQ: reshape tracks into the batch dim
    flat = tracks.reshape(bs * n_tracks, 1, T)
    eq_gains = torch.tanh(params["eq_gains"]) * 12.0  # (bs, n_tracks, 10) -> +-12 dB
    flat = F.graphic_eq(flat, sample_rate, eq_gains.reshape(bs * n_tracks, 10))
    tracks = flat.reshape(bs, n_tracks, T)

    # constant-power pan per track
    pan = torch.sigmoid(params["pan"])  # (bs, n_tracks)
    panned = F.stereo_panner(tracks, sample_rate, pan)  # (bs, 2, n_tracks, T)

    # stereo bus with per-track sends
    send_db = torch.tanh(params["send_db"]) * 24.0  # (bs, n_tracks)
    mix = F.stereo_bus(panned, sample_rate, send_db)  # (bs, 2, T)

    # master widener
    width = torch.sigmoid(params["width"])  # (bs,)
    return F.stereo_widener(mix, sample_rate, width)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--tracks", type=int, default=4)
    ap.add_argument("--length", type=int, default=32768)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--out-dir", type=str, default="outputs/mixing_console")
    args = add_device_flag(ap).parse_args(argv)
    device = device_of(args)

    sr = 44100
    bs = 1
    rng = np.random.default_rng(0)
    tracks = torch.as_tensor(np.concatenate(
        [synthetic_batch(rng, bs, args.length, sr) for _ in range(args.tracks)], axis=1), device=device)

    # a "reference mix" made with hidden console settings
    draw = lambda lo, hi, shape: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32), device=device)
    true_params = {
        "eq_gains": draw(-0.5, 0.5, (bs, args.tracks, 10)),
        "pan": draw(-1.5, 1.5, (bs, args.tracks)),
        "send_db": draw(-0.4, 0.4, (bs, args.tracks)),
        "width": draw(-0.5, 0.5, (bs,)),
    }
    with torch.no_grad():
        target = console(tracks, sr, true_params)

    params = {k: torch.zeros_like(v, requires_grad=True) for k, v in true_params.items()}
    opt = torch.optim.Adam(params.values(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    l0 = None
    for i in range(args.steps):
        mix = console(tracks, sr, params)
        loss = multi_resolution_stft_loss(mix, target) + 10.0 * torch.mean((mix - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if l0 is None:
            l0 = float(loss.detach())
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss.detach()):.4f}")

    print(f"loss {l0:.4f} -> {float(loss.detach()):.4f}")
    with torch.no_grad():
        pan_err = float((torch.sigmoid(params["pan"]) - torch.sigmoid(true_params["pan"])).abs().mean())
        mix = console(tracks, sr, params)
    print(f"mean pan error: {pan_err:.3f} (0 = perfect)")

    os.makedirs(args.out_dir, exist_ok=True)
    save_wav(os.path.join(args.out_dir, "mix.wav"), mix[0].cpu().numpy(), sr)
    save_wav(os.path.join(args.out_dir, "target.wav"), target[0].cpu().numpy(), sr)
    print(f"wrote {args.out_dir}/mix.wav and target.wav")
    return {"loss0": l0, "loss": float(loss.detach()), "pan_err": pan_err}


if __name__ == "__main__":
    main()
