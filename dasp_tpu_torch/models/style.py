"""Style-transfer model: shared encoder + per-effect parameter projectors,
and the EQ -> compressor -> reverb -> gain render.

PyTorch counterpart of ``dasp_tpu/models/style.py``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..modules import Compressor, Gain, NoiseShapedReverb, ParametricEQ
from ..trace import span
from .tcn import Encoder, ParameterProjector

__all__ = ["StyleTransferNet", "apply_style_chain", "make_style_processors", "PROJECTOR_NAMES"]

# projector order, as flax numbers them (ParameterProjector_0 .. _3)
PROJECTOR_NAMES = ("equalizer", "compressor", "reverb", "gain")


def make_style_processors(
    sample_rate: int,
    reverb_num_samples: int = 65536,
    eq_filter_method: str = "fsm",
    compressor_smoother: str = "fsm",
    reverb_noise_mode: str = "frequency",
    reverb_ir_conv_fn=None,
):
    """The four processors of the style-transfer chain. The option strings
    are the JAX package's; ``eq_filter_method="pallas"`` and
    ``compressor_smoother="exact_pallas"`` select the CUDA kernels. A
    callable EQ method or smoother, and ``reverb_ir_conv_fn`` (the reverb's
    signal-with-IR convolution), plug in other evaluations: the
    sequence-sharded functions of :mod:`dasp_tpu_torch.parallel` bound to a
    mesh, under which the chain renders this rank's time block."""
    reverb = NoiseShapedReverb(
        sample_rate,
        num_samples=reverb_num_samples,
        noise_mode=reverb_noise_mode,
        ir_conv_fn=reverb_ir_conv_fn,
    )
    return {
        "equalizer": ParametricEQ(sample_rate, filter_method=eq_filter_method),
        "compressor": Compressor(sample_rate, smoother=compressor_smoother),
        "reverb": reverb,
        "gain": Gain(sample_rate),
    }


class StyleTransferNet(nn.Module):
    """Encoder (shared by input and reference) + four parameter projectors.

    ``forward(inp, ref)`` takes two (bs, in_channels, T) clips and returns
    normalized parameters ``{"equalizer": (bs, 18), "compressor": (bs, 6),
    "reverb": (bs, 25), "gain": (bs, 1)}``. ``dtype=torch.bfloat16`` runs
    the encoder's convolutions in bf16. Train/eval mode is the module's
    (``net.eval()`` uses the BatchNorm running statistics). The clips pass
    the encoder by :meth:`Encoder.pair`.
    """

    def __init__(self, embed_dim: int = 512, ch_dim: int = 256,
                 num_eq_params: int = 18, num_comp_params: int = 6,
                 num_reverb_params: int = 25, num_gain_params: int = 1,
                 encoder_dilations: tuple = (1, 2, 4, 8, 16, 1, 2, 4, 8, 16),
                 in_channels: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.encoder = Encoder(embed_dim, ch_dim, encoder_dilations,
                               in_channels=in_channels, dtype=dtype)
        counts = (num_eq_params, num_comp_params, num_reverb_params, num_gain_params)
        self.projectors = nn.ModuleDict(
            {name: ParameterProjector(2 * embed_dim, n) for name, n in zip(PROJECTOR_NAMES, counts)}
        )

    def forward(self, inp: torch.Tensor, ref: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("style.net"):
            z = torch.cat(self.encoder.pair(inp, ref), dim=-1)
            return {name: proj(z) for name, proj in self.projectors.items()}


def apply_style_chain(
    processors: Dict,
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Render the EQ -> compressor -> reverb -> gain chain with normalized
    parameter tensors (clipped into [0, 1]). The reverb draws its noise from
    ``generator`` (the JAX package takes a PRNG key here) unless ``noise``
    is given."""
    with span("style.chain"):
        y = processors["equalizer"].process_normalized(x, params["equalizer"], clip_params=True)
        y = processors["compressor"].process_normalized(y, params["compressor"], clip_params=True)
        y = processors["reverb"].process_normalized(
            y, params["reverb"], clip_params=True, generator=generator, noise=noise
        )
        return processors["gain"].process_normalized(y, params["gain"], clip_params=True)
