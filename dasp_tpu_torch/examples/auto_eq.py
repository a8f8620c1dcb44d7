"""Automatic EQ: undo a random corrupting equalization with a TCN.

Corrupt audio with a random 6-band EQ (then peak normalization and a random
-24..0 dB gain), show the corrupted signal to a TCN that predicts the 18
normalized EQ parameters, apply the predicted EQ to recover the original,
and minimize a perceptually weighted multi-resolution STFT loss
(:func:`auto_eq_step`). At each checkpoint it writes the corrupted and
recovered audio and, where matplotlib is installed, a plot of the predicted
response.

    python -m dasp_tpu_torch.examples.auto_eq [--data-dir wavs/] [--steps N] [--smoke]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import modules as M
from ..models import ParameterNetwork
from ..utils import MetricsLogger, load_checkpoint, multi_resolution_stft_loss, save_checkpoint
from ..utils.audio import save_wav
from .common import base_parser, device_batches, device_of

MRSTFT_KW = dict(  # the reference auto-EQ's loss configuration
    fft_sizes=(128, 256, 512, 1024, 2048, 4096, 8192),
    hop_sizes=(64, 128, 256, 512, 1024, 2048, 4096),
    win_lengths=(128, 256, 512, 1024, 2048, 4096, 8192),
    w_sc=0.0, w_log_mag=1.0, w_lin_mag=1.0,
    perceptual_weighting=True,
)


def smoke_net(num_params: int) -> ParameterNetwork:
    """The --smoke net: 4 PReLU blocks of 32 channels, kernel 7, MLP 64."""
    return ParameterNetwork(num_params, channels=(32,) * 4, kernel_size=7,
                            dilations=(1, 2, 4, 8), activation="prelu", mlp_hidden=64)


def auto_eq_loss(net, equalizer, x, rand_params, rand_gain_db, auraloss_compat: bool = False):
    """The loss of one step: corrupt ``x`` (bs, 1, T) by the EQ at
    ``rand_params`` (bs, 18), peak normalization (1e-9 floor) and the gain
    ``rand_gain_db`` (bs, 1, 1), without gradient; the net (train mode) on
    the corrupted clips, the EQ at its prediction, ``tanh``, and the
    7-resolution perceptual MR-STFT loss against ``x``.

    Returns:
        ``(loss, p_hat, y, x_hat)``: the loss, the predicted parameters, the
        corrupted and the recovered clips.
    """
    with torch.no_grad():
        y = equalizer.process_normalized(x, rand_params, clip_params=True)
        peak = torch.amax(torch.abs(y), dim=-1, keepdim=True)
        y = y / (peak + 1e-9) * 10.0 ** (rand_gain_db / 20.0)
    net.train()
    p_hat = net(y)
    x_hat = torch.tanh(equalizer.process_normalized(y, p_hat, clip_params=True))
    loss = multi_resolution_stft_loss(x_hat, x, sample_rate=equalizer.sample_rate,
                                      auraloss_compat=auraloss_compat, **MRSTFT_KW)
    return loss, p_hat, y, x_hat


def auto_eq_step(net, equalizer, opt, x, rand_params, rand_gain_db, auraloss_compat: bool = False):
    """One step: :func:`auto_eq_loss`, backward, and the optimizer's step.
    Returns its outputs detached."""
    loss, p_hat, y, x_hat = auto_eq_loss(net, equalizer, x, rand_params, rand_gain_db, auraloss_compat)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), p_hat.detach(), y, x_hat.detach()


def save_response_plot(log_dir, equalizer, p_hat, sample_rate, step):
    """Magnitude response of the first predicted EQ, as a png (skipped
    without matplotlib)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    from ..ops.biquad import biquad

    names = list(equalizer.param_ranges.keys())
    p = torch.as_tensor(p_hat[:1])
    denorm = equalizer.denormalize_param_dict({n: p[:, i] for i, n in enumerate(names)}, validate=False)
    secs = []
    for band, ftype in [("low_shelf", "low_shelf"), ("band0", "peaking"), ("band1", "peaking"),
                        ("band2", "peaking"), ("band3", "peaking"), ("high_shelf", "high_shelf")]:
        b, a = biquad(denorm[f"{band}_gain_db"], denorm[f"{band}_cutoff_freq"],
                      denorm[f"{band}_q_factor"], sample_rate, ftype)
        secs.append(torch.cat([b, a], dim=-1).numpy())
    sos = np.stack(secs, axis=1)  # (1, 6, 6)
    H = np.prod(np.fft.rfft(sos[0, :, :3], 4096, axis=-1) / np.fft.rfft(sos[0, :, 3:], 4096, axis=-1), axis=0)
    freqs = np.fft.rfftfreq(4096, 1 / sample_rate)
    fig, ax = plt.subplots()
    ax.semilogx(freqs[1:], 20 * np.log10(np.abs(H[1:]) + 1e-8))
    ax.set_xlabel("Hz")
    ax.set_ylabel("dB")
    ax.grid(c="lightgray")
    ax.set_title(f"predicted EQ response, step {step}")
    fig.savefig(os.path.join(log_dir, f"response_{step}.png"), dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    args = base_parser(__doc__.splitlines()[0]).parse_args(argv)
    args.lr = args.lr if args.lr != 1e-4 else 2e-3  # the reference auto-EQ's default
    if args.smoke:
        args.length, args.batch_size = 16384, 2
    device = device_of(args)
    log_dir = args.log_dir or "outputs/auto_eq"
    os.makedirs(log_dir, exist_ok=True)
    ckpt = os.path.join(log_dir, "ckpt.pkl")

    sr = args.sample_rate
    equalizer = M.ParametricEQ(sr, max_q_factor=1.0, filter_method=args.filter_method)
    torch.manual_seed(args.seed)
    net = smoke_net(equalizer.num_params) if args.smoke else ParameterNetwork.auto_eq(equalizer.num_params)
    net = net.to(device).train()
    opt = torch.optim.Adam(net.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

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
            nprng.uniform(0, 1, (args.batch_size, equalizer.num_params)).astype(np.float32), device=device)
        rand_gain = torch.as_tensor(nprng.uniform(-24, 0, (args.batch_size, 1, 1)).astype(np.float32), device=device)
        loss, p_hat, y, x_hat = auto_eq_step(net, equalizer, opt, x, rand_params, rand_gain, args.auraloss_compat)
        losses.append(float(loss))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  mrstft {float(loss):.4f}")
            logger.log(step, loss=loss)
        if (step + 1) % args.checkpoint_every == 0 or step == args.steps - 1:
            save_checkpoint(ckpt, {"net": net.state_dict(), "opt": opt.state_dict(), "step": step + 1})
            save_wav(os.path.join(log_dir, f"corrupted_{step}.wav"), y[0].cpu().numpy(), sr)
            save_wav(os.path.join(log_dir, f"recovered_{step}.wav"), x_hat[0].cpu().numpy(), sr)
            save_response_plot(log_dir, equalizer, p_hat.cpu(), sr, step)

    print(f"done; metrics at {logger.path}")
    return {"losses": losses, "start": start}


if __name__ == "__main__":
    main()
