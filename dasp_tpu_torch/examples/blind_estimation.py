"""Blind estimation of effect parameters with a TCN.

Pairs of (clean, processed-with-random-parameters) audio; a TCN sees the
processed audio and predicts the processor's normalized parameters; the
effect is re-applied with the prediction and an STFT loss compares the two
renders. One step (:func:`dasp_tpu_torch.train.blind_estimation_step`)
renders the target, runs the net, re-renders, takes the loss, the gradient
and an Adam update.

    python -m dasp_tpu_torch.examples.blind_estimation [--data-dir wavs/] [--steps N] [--smoke]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import modules as M
from .. import train
from ..utils import MetricsLogger, load_checkpoint, save_checkpoint
from .common import base_parser, device_batches, device_of

PROCESSORS = ["compressor", "expander", "limiter", "multiband_compressor", "delay", "chorus",
              "flanger", "tremolo", "noise_gate", "phaser", "auto_wah", "de_esser", "bitcrusher",
              "pitch_shift", "transient_shaper", "exciter", "spectral_gate", "ring_modulator",
              "dynamic_eq", "clipper"]
# processor -> (class, its smoother when --smoother is not given; None: it
# takes no smoother)
_CLASSES = {
    "compressor": (M.Compressor, "fsm"), "expander": (M.Expander, "parallel"),
    "limiter": (M.Limiter, "parallel"), "multiband_compressor": (M.MultibandCompressor, "fsm"),
    "noise_gate": (M.NoiseGate, "parallel"), "transient_shaper": (M.TransientShaper, "parallel"),
    "delay": (M.Delay, None), "chorus": (M.Chorus, None), "flanger": (M.Flanger, None),
    "tremolo": (M.Tremolo, None), "phaser": (M.Phaser, None), "auto_wah": (M.AutoWah, None),
    "de_esser": (M.DeEsser, None), "bitcrusher": (M.Bitcrusher, None),
    "pitch_shift": (M.PitchShift, None), "exciter": (M.Exciter, None),
    "spectral_gate": (M.SpectralGate, None), "ring_modulator": (M.RingModulator, None),
    "dynamic_eq": (M.DynamicEQ, None), "clipper": (M.Clipper, None),
}


def make_processor(name: str, sr: int, smoother=None):
    """The processor ``--processor name`` selects; ``smoother`` (``--smoother``)
    overrides the default of those that take one."""
    cls, default = _CLASSES[name]
    return cls(sr) if default is None else cls(sr, smoother=smoother or default)


def main(argv=None) -> dict:
    parser = base_parser(__doc__.splitlines()[0])
    parser.add_argument("--processor", choices=PROCESSORS, default="compressor",
                        help="which processor to blind-estimate")
    args = parser.parse_args(argv)
    if args.smoke:
        args.length, args.batch_size = 16384, 2
    device = device_of(args)
    log_dir = args.log_dir or f"outputs/blind_estimation_{args.processor}"
    os.makedirs(log_dir, exist_ok=True)
    ckpt = os.path.join(log_dir, "ckpt.pkl")

    processor = make_processor(args.processor, args.sample_rate, args.smoother)
    torch.manual_seed(args.seed)
    net, opt = train.make_blind_estimation(processor, device=device)
    for group in opt.param_groups:
        group["lr"] = args.lr

    state = load_checkpoint(ckpt) if args.resume else None
    start = 0
    if state:
        net.load_state_dict(state["net"])
        opt.load_state_dict(state["opt"])
        start = state["step"]
        print(f"resumed from step {start}")

    logger = MetricsLogger(log_dir)
    nprng = np.random.default_rng(args.seed + 1)
    data = device_batches(args)  # staged copies, int16 wire
    losses = []
    for step in range(start, args.steps):
        x = next(data)  # already on the device
        rand_params = torch.as_tensor(
            nprng.uniform(0, 1, (args.batch_size, processor.num_params)).astype(np.float32), device=device)
        loss, perr = train.blind_estimation_step(net, processor, opt, x, rand_params,
                                                 auraloss_compat=args.auraloss_compat)
        losses.append(float(loss))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  stft_loss {float(loss):.4f}  param_l1 {float(perr):.4f}")
            logger.log(step, loss=loss, param_l1=perr)
        if (step + 1) % args.checkpoint_every == 0:
            save_checkpoint(ckpt, {"net": net.state_dict(), "opt": opt.state_dict(), "step": step + 1})

    save_checkpoint(ckpt, {"net": net.state_dict(), "opt": opt.state_dict(), "step": args.steps})
    print(f"done; metrics at {logger.path}")
    return {"losses": losses, "start": start}


if __name__ == "__main__":
    main()
