"""The classic live chain over a whole signal at once: parametric EQ ->
compressor (true attack/release ballistics) -> filtered-noise reverb, with
the reverb's IR drawn in the spectral domain. A stream of chunks through
the same chain, its state carried, gives the same signal."""

from typing import Sequence

import torch

from . import dsp


@torch.no_grad()
def classic_chain(x: torch.Tensor, eq: Sequence[float], comp: Sequence[float], re: torch.Tensor,
                  im: torch.Tensor, band_gain: float, band_decay: float, mix: float, ir_len: int,
                  rnd=dsp.exact) -> torch.Tensor:
    """x (bs, 2, L) through the chain in float64. ``eq``: the 18 EQ values
    (gain dB, cutoff Hz, Q for each band); ``comp``: threshold dB, ratio,
    attack ms, release ms, knee dB, makeup dB; ``re``, ``im``: the IR's
    spectral draws (bs * 2, 12, ir_len // 2 + 1); every band's gain and
    decay alike; ``mix`` wet/dry."""
    bs, dev = x.shape[0], x.device
    full = lambda v: torch.tensor(v, dtype=torch.float64, device=dev).expand(bs, len(v))  # noqa: E731
    y = dsp.parametric_eq(x.double(), full(eq), rnd)
    y = dsp.compressor(y, full(comp), rnd)
    ones = torch.ones((bs, 12), dtype=torch.float64, device=dev)
    ir = rnd(dsp.spectral_noise_ir(re, im, band_gain * ones, band_decay * ones, ir_len))
    return dsp.reverb(y, ir, torch.full((bs,), float(mix), dtype=torch.float64, device=dev), rnd)
