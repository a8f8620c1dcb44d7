"""The self-supervised style-transfer training step.

PyTorch counterpart of the step the JAX package keeps in ``bench.py``
(``_step_core``) and ``examples/style_transfer.py`` (``step_fn``). One step:

1. corrupt the clean clips by a random EQ -> compressor -> reverb chain
   (no gradient) into a pseudo-reference, peak-normalize it (1e-9 floor)
   and apply the random gains ``g1`` (reference) and ``g2`` (input), in dB;
2. split both into A/B halves;
3. run the net in train mode on (input A, channel mean of reference B);
4. render input A through EQ -> compressor -> reverb -> gain with the
   predicted parameters;
5. the MR-STFT loss of the render against reference A (the default loss,
   not auraloss-compat, as ``bench.py``);
6. backward, through the render into the CUDA kernels' backward, and an
   Adam step.

With the kernel configuration of :func:`make_style_training` one step
launches kernel A three times (forward in the corruption, save-all in the
render, adjoint in the backward) and kernel B three times (two forwards,
one backward).

The reverb draws its noise from one ``torch.Generator`` (corruption first,
then the render), where the JAX package splits a PRNG key; tests inject the
noise instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from .models import StyleTransferNet, apply_style_chain, make_style_processors
from .utils.loss import multi_resolution_stft_loss

__all__ = ["make_style_training", "random_corruption", "corrupt", "render_loss", "train_step"]

# the JAX package's smoke-scale net and IR (bench.py --smoke, examples --smoke)
SMOKE_NET = dict(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4))
SMOKE_IR = 2048


def make_style_training(
    sample_rate: int = 44100,
    *,
    smoke: bool = False,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    device=None,
    eq_filter_method: str = "pallas",
    compressor_smoother: str = "exact_pallas",
):
    """The net, the processors and the optimizer of the training step.

    Defaults are the kernel configuration: the EQ through the biquad-cascade
    kernel, the compressor through the ballistics kernel (``"exact"`` for
    both selects the plain versions), spectral-domain reverb noise and a
    65536-tap IR (2048 taps and a 3-block, 8-channel net with ``smoke``),
    bf16 encoder convolutions with fp32 parameters, and Adam at 1e-4 with
    optax.adam's defaults (betas 0.9 / 0.999, eps 1e-8 outside the square
    root, bias-corrected), which are torch's.

    Returns:
        ``(net, processors, opt)``, the net in train mode on ``device``.
    """
    processors = make_style_processors(
        sample_rate,
        reverb_num_samples=SMOKE_IR if smoke else 65536,
        eq_filter_method=eq_filter_method,
        compressor_smoother=compressor_smoother,
        reverb_noise_mode="frequency",
    )
    net = StyleTransferNet(**(SMOKE_NET if smoke else {}), dtype=dtype).to(device).train()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    return net, processors, opt


def random_corruption(generator: torch.Generator, bs: int, processors: Dict, device=None):
    """Uniform corruption parameters as ``bench.py`` draws them: normalized
    EQ, compressor and reverb parameters on (0, 1), gains g1 and g2 on
    (0, 24) dB of shape (bs, 1, 1)."""

    def u(*shape, high=1.0):
        return high * torch.rand(shape, generator=generator, device=device)

    return {
        "eq": u(bs, processors["equalizer"].num_params),
        "comp": u(bs, processors["compressor"].num_params),
        "reverb": u(bs, processors["reverb"].num_params),
        "g1": u(bs, 1, 1, high=24.0),
        "g2": u(bs, 1, 1, high=24.0),
    }


@torch.no_grad()
def corrupt(processors: Dict, x: torch.Tensor, rand: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
    """Steps 1-2: the pseudo-reference by random corruption, peak
    normalization and gains, split into halves.

    Args:
        x: clean clips (bs, 1, 2 * half).
        rand: corruption parameters (see :func:`random_corruption`).
        generator / noise: the corruption reverb's noise source.

    Returns:
        ``(input_a, ref_a, ref_b)``: (bs, 1, half), (bs, 2, half) and
        (bs, 2, half), contiguous.
    """
    ref = processors["equalizer"].process_normalized(x, rand["eq"], clip_params=True)
    ref = processors["compressor"].process_normalized(ref, rand["comp"], clip_params=True)
    ref = processors["reverb"].process_normalized(
        ref, rand["reverb"], clip_params=True, generator=generator, noise=noise
    )
    peak = torch.amax(torch.abs(ref), dim=-1, keepdim=True)
    ref = ref / (peak + 1e-9)
    ref = ref * 10.0 ** (-rand["g1"] / 20.0)
    x = x * 10.0 ** (-rand["g2"] / 20.0)
    input_a, _ = x.chunk(2, dim=-1)
    ref_a, ref_b = ref.chunk(2, dim=-1)
    return input_a.contiguous(), ref_a.contiguous(), ref_b.contiguous()


def render_loss(net: torch.nn.Module, processors: Dict, input_a: torch.Tensor,
                ref_a: torch.Tensor, ref_b: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Steps 3-5: the net on (input A, channel mean of reference B), the
    render of input A and its MR-STFT loss against reference A. The net's
    mode is the caller's (train mode in a training step)."""
    params = net(input_a, ref_b.mean(dim=1, keepdim=True))
    out_a = apply_style_chain(processors, input_a, params, generator=generator, noise=noise)
    return multi_resolution_stft_loss(out_a, ref_a)


def train_step(net: torch.nn.Module, processors: Dict, opt: torch.optim.Optimizer,
               x: torch.Tensor, rand: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One optimization step (see the module docstring); returns the loss
    (detached). Updates the net's parameters and BatchNorm statistics and
    the optimizer's state in place.

    Args:
        x: clean clips (bs, 1, 2 * half).
        rand: corruption parameters (see :func:`random_corruption`).
        generator: the reverb noise source for the corruption, then the
            render; or
        noise: ``(corruption_noise, render_noise)``, each (bs * 2, 12,
            IR + 1022) white noise, instead of the generator.
        mark: called with "corrupt", "forward", "backward" and "optimizer"
            as each part ends (e.g. to record CUDA events).
    """
    mark = mark or (lambda name: None)
    noise_ref, noise_out = (None, None) if noise is None else noise
    batch = corrupt(processors, x, rand, generator, noise_ref)
    mark("corrupt")
    net.train()
    loss = render_loss(net, processors, *batch, generator=generator, noise=noise_out)
    mark("forward")
    opt.zero_grad(set_to_none=True)
    loss.backward()
    mark("backward")
    opt.step()
    mark("optimizer")
    return loss.detach()
