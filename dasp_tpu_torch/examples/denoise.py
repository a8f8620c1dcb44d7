"""Denoising: spectral gate with a measured noise profile, then tuned by
gradient descent.

Broadband noise is measured from a noise-only capture
(``spectral_noise_profile``), the ``SpectralGate`` denoises with that
profile, and its four parameters (threshold, range, attack, release) are
then tuned by Adam against the clean reference. Reports SNR before and after
and integrated LUFS.

    python -m dasp_tpu_torch.examples.denoise [--steps 60] [--smoke]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import train
from ..functional import spectral_noise_profile
from ..utils import integrated_loudness, synthetic_batch
from ..utils.audio import save_wav
from .common import add_device_flag, device_of


def snr_db(clean, x) -> float:
    clean, x = np.asarray(clean), np.asarray(x)
    n = x - clean
    return 10.0 * np.log10(float(np.mean(clean ** 2)) / max(float(np.mean(n ** 2)), 1e-12))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--length", type=int, default=131072)
    ap.add_argument("--noise-db", type=float, default=-30.0)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", type=str, default="outputs/denoise")
    ap.add_argument("--smoke", action="store_true")
    args = add_device_flag(ap).parse_args(argv)
    device = device_of(args)
    if args.smoke:
        args.length, args.steps = 32768, min(args.steps, 10)

    sr = 44100
    rng = np.random.default_rng(args.seed)
    clean_np = synthetic_batch(rng, 1, args.length, sr)
    amp = 10.0 ** (args.noise_db / 20.0)
    noisy_np = clean_np + (amp * rng.standard_normal(clean_np.shape)).astype(np.float32)
    noise_only_np = (amp * rng.standard_normal(clean_np.shape)).astype(np.float32)
    clean = torch.as_tensor(clean_np, device=device)
    noisy = torch.as_tensor(noisy_np, device=device)

    # measure the floor from the noise-only capture (the production path)
    with torch.no_grad():
        prof = spectral_noise_profile(torch.as_tensor(noise_only_np, device=device))
    gate, z, opt = train.make_denoise(sr, bs=1, device=device)
    for group in opt.param_groups:
        group["lr"] = args.lr

    def render(p):
        return gate.process_normalized(noisy, p, clip_params=True, noise_profile_db=prof)

    with torch.no_grad():
        y0 = render(torch.sigmoid(z))
    print(f"SNR: noisy {snr_db(clean_np, noisy_np):6.2f} dB -> "
          f"gated (defaults) {snr_db(clean_np, y0.cpu().numpy()):6.2f} dB")

    # tune the gate against the clean reference
    for i in range(args.steps):
        loss, _ = train.denoise_loss(gate, z, noisy, clean, prof)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  mse {float(loss.detach()):.3e}")

    with torch.no_grad():
        y = render(torch.sigmoid(z))
        lufs_noisy, lufs_y = float(integrated_loudness(noisy, sr)[0]), float(integrated_loudness(y, sr)[0])
    snr = snr_db(clean_np, y.cpu().numpy())
    print(f"SNR: tuned {snr:6.2f} dB")
    print(f"LUFS: noisy {lufs_noisy:6.2f}  denoised {lufs_y:6.2f}")

    os.makedirs(args.out_dir, exist_ok=True)
    save_wav(os.path.join(args.out_dir, "noisy.wav"), noisy_np[0], sr)
    save_wav(os.path.join(args.out_dir, "denoised.wav"), y[0].cpu().numpy(), sr)
    save_wav(os.path.join(args.out_dir, "clean.wav"), clean_np[0], sr)
    print(f"wrote {args.out_dir}/noisy.wav, denoised.wav, clean.wav")
    return {"snr_noisy": snr_db(clean_np, noisy_np), "snr": snr}


if __name__ == "__main__":
    main()
