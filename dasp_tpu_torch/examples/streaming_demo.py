"""Streaming (serving) demo: process audio chunk by chunk with state.

Renders a guitar-like synthetic signal through the serving chain
(parametric EQ -> compressor -> feedback delay -> noise-shaped reverb ->
limiter) twice, once offline on the whole clip and once through
:mod:`dasp_tpu_torch.streaming` in fixed-size chunks with carried state,
checks that the outputs match, and writes both to wav. The limiter streams
with true attack/release ballistics (carried envelope state), and the
delay's comb recursion runs over its carried delay line.

    python -m dasp_tpu_torch.examples.streaming_demo [--chunk 512] [--seconds 3]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import functional as F
from .. import streaming
from ..utils import save_wav, synthetic_batch
from .common import add_device_flag, device_of

SR = 44100
# the offline delay's closed-form spectral comb truncates the infinite
# feedback tail that the streaming recursion carries exactly; at --smoke
# scale the two sit about 1.0e-3 apart
STREAM_TOL = 3e-3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--reverb-samples", type=int, default=16384)
    ap.add_argument("--out-dir", default="outputs/streaming_demo")
    ap.add_argument("--smoke", action="store_true",
                    help="short clip / small IR for a fast functional check")
    ap.add_argument("--steps", type=int, default=None,
                    help="accepted for CLI uniformity with the trainers (unused)")
    args = add_device_flag(ap).parse_args(argv)
    device = device_of(args)
    if args.smoke:
        args.seconds, args.reverb_samples = 0.5, 2048

    T = int(args.seconds * SR) // args.chunk * args.chunk
    rng = np.random.default_rng(0)
    x = torch.as_tensor(synthetic_batch(rng, 1, T, SR, kind="pluck"), device=device)
    x = x.repeat(1, 2, 1)  # stereo

    v = lambda val: torch.full((1,), val, device=device)  # noqa: E731
    eq_p = [v(a) for a in [3.0, 120.0, 0.7, 2.5, 600.0, 1.2, -3.0, 2500.0, 2.0,
                           1.5, 6000.0, 1.0, 2.0, 11000.0, 1.0, -2.0, 9000.0, 0.7]]
    comp_p = {k: v(a) for k, a in dict(
        threshold_db=-28.0, ratio=4.0, attack_ms=5.0, release_ms=60.0,
        knee_db=6.0, makeup_gain_db=3.0).items()}
    gains = torch.full((1, 12), 0.6, device=device)
    decays = torch.full((1, 12), 0.5, device=device)
    seed = 7  # the reverb's noise: the same draw offline and in the stream's init
    # integer-sample delay so the offline closed-form comb and the
    # streaming time-domain recursion agree
    delay_samp = 4410  # 100 ms
    delay_ms, delay_fb, delay_mix = v(delay_samp / SR * 1e3), v(0.35), v(0.3)
    lim_p = {k: v(a) for k, a in dict(
        threshold_db=-8.0, attack_ms=1.0, release_ms=150.0,
        knee_db=2.0, makeup_gain_db=0.0).items()}

    with torch.no_grad():
        # --- offline render (whole clip at once) --------------------------
        y = F.parametric_eq(x, SR, *eq_p, filter_method="coupled")
        y = F.compressor(y, SR, **comp_p, smoother="block")
        y = F.delay(y, SR, delay_ms, delay_fb, delay_mix)
        y = F.noise_shaped_reverberation(
            y, SR, *[gains[:, i] for i in range(12)], *[decays[:, i] for i in range(12)],
            v(0.25), num_samples=args.reverb_samples,
            generator=torch.Generator(device=device).manual_seed(seed), noise_mode="frequency")
        y_offline = F.limiter(y, SR, **lim_p)

        # --- streaming render (chunk by chunk, carried state) -------------
        rev_state = streaming.reverb_stream_init(
            SR, gains, decays, 0.25, torch.Generator(device=device).manual_seed(seed),
            num_samples=args.reverb_samples, noise_mode="frequency", device=device)

        def step(c, st):
            y, eq_zi = streaming.parametric_eq_stream(c, SR, *eq_p, zi=st["eq"])
            y, comp_zi = streaming.compressor_stream(y, SR, **comp_p, zi=st["comp"])
            y, dl_state = streaming.delay_stream(y, SR, delay_samp, delay_fb, delay_mix, state=st["delay"])
            y, rev = streaming.reverb_stream(y, st["rev"])
            y, lim_zi = streaming.limiter_stream(y, SR, **lim_p, zi=st["lim"])
            return y, {"eq": eq_zi, "comp": comp_zi, "delay": dl_state, "rev": rev, "lim": lim_zi}

        st = {"eq": None, "comp": None, "delay": None, "rev": rev_state, "lim": None}
        outs = []
        t0 = time.time()
        n_chunks = T // args.chunk
        for i in range(n_chunks):
            y, st = step(x[..., i * args.chunk:(i + 1) * args.chunk], st)
            outs.append(y)
        y_stream = torch.cat(outs, dim=-1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0

    err = float((y_stream - y_offline).abs().max())
    print(f"{n_chunks} chunks of {args.chunk} samples "
          f"({args.chunk / SR * 1e3:.1f} ms each): "
          f"{wall / n_chunks * 1e3:.2f} ms/chunk host-loop wall")
    print(f"streaming vs offline max abs err: {err:.2e}")
    if not err < STREAM_TOL:
        raise RuntimeError(f"chunked render diverged from the offline render: {err:.3e} >= {STREAM_TOL}")

    os.makedirs(args.out_dir, exist_ok=True)
    save_wav(os.path.join(args.out_dir, "dry.wav"), x[0].cpu().numpy(), SR)
    save_wav(os.path.join(args.out_dir, "streamed.wav"), y_stream[0].cpu().numpy(), SR)
    print(f"wrote {args.out_dir}/dry.wav and streamed.wav")
    return {"err": err, "ms_per_chunk": wall / n_chunks * 1e3}


if __name__ == "__main__":
    main()
