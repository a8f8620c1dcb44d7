"""The training steps: self-supervised style transfer and blind estimation.

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

The blind-estimation step (:func:`blind_estimation_step`) is the one of
``examples/blind_estimation.py``: render the target with random normalized
parameters (no gradient), run the ``ParameterNetwork`` preset in train mode
on it, re-render with the prediction, the default STFT loss, backward and
Adam. With ``PitchShift`` or ``Chorus`` one step launches the
fractional-delay kernel twice (both renders) and its backward once.

The mastering step (:func:`mastering_step`) is the one of
``examples/mastering.py``: its whole chain, ``Chain([TransientShaper,
DynamicEQ(num_bands=3), MultibandCompressor, Exciter, Limiter])`` at their
defaults (47 normalized parameters), driven by logits ``z`` through a
sigmoid, the MR-STFT loss plus 10 x the MSE against a target rendered from
hidden parameters, backward and Adam at 2e-2. Here the step renders its
target (no gradient), as the blind step does. One step launches the
ballistics kernel twice (the Limiter in both renders) and its backward
once; the rest of the chain runs the port's plain PyTorch paths
(``"coupled"`` crossovers and high-pass, the ``"block"`` one-pole of the
band compressors, ``"parallel"`` ballistics and ``peak_decay`` in the
transient shaper, the dynamic EQ's WOLA transforms on ``torch.fft``).

The denoising step (:func:`denoise_step`) is the one of
``examples/denoise.py``: the noise floor measured from a noise-only
capture (:func:`~dasp_tpu_torch.functional.spectral_noise_profile`), then
``SpectralGate`` with that profile, driven by four logits that start at
``logit([0.25, 0.66, 0.08, 0.14])``, the MSE against the clean program,
backward and Adam at 3e-2. It launches no kernel: the gate is ``torch.fft``
and the ``"parallel"`` ballistics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from .models import ParameterNetwork, StyleTransferNet, apply_style_chain, make_style_processors
from .functional import _entry_device, spectral_noise_profile
from .modules import Chain, DynamicEQ, Exciter, Limiter, MultibandCompressor, SpectralGate, TransientShaper
from .trace import span
from .utils.loss import multi_resolution_stft_loss, stft_loss

__all__ = [
    "make_style_training",
    "random_corruption",
    "corrupt",
    "render_loss",
    "train_step",
    "make_blind_estimation",
    "blind_estimation_loss",
    "blind_estimation_step",
    "make_mastering",
    "mastering_loss",
    "mastering_step",
    "DENOISE_P0",
    "make_denoise",
    "denoise_loss",
    "denoise_step",
]

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

    Args:
        device: where the net lives; None means the CUDA card (raises
            without one). The CPU runs only when named.

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
    net = StyleTransferNet(**(SMOKE_NET if smoke else {}), dtype=dtype).to(_entry_device(device)).train()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    return net, processors, opt


def random_corruption(generator: torch.Generator, bs: int, processors: Dict, device=None):
    """Uniform corruption parameters as ``bench.py`` draws them: normalized
    EQ, compressor and reverb parameters on (0, 1), gains g1 and g2 on
    (0, 24) dB of shape (bs, 1, 1), on ``device`` (the generator's when
    None)."""
    device = generator.device if device is None else device

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
    with span("train.loss"):
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

    Under a torch profiler the step opens the spans (:mod:`~dasp_tpu_torch.
    trace`) ``train.step``, and inside it ``train.corrupt``, ``train.loss``
    (in :func:`render_loss`), ``train.backward`` and ``train.optimizer``, at
    the edges of the marks.
    """
    mark = mark or (lambda name: None)
    noise_ref, noise_out = (None, None) if noise is None else noise
    with span("train.step"):
        with span("train.corrupt"):
            batch = corrupt(processors, x, rand, generator, noise_ref)
        mark("corrupt")
        net.train()
        loss = render_loss(net, processors, *batch, generator=generator, noise=noise_out)
        mark("forward")
        with span("train.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        mark("backward")
        with span("train.optimizer"):
            opt.step()
        mark("optimizer")
    return loss.detach()


def make_blind_estimation(processor, *, device=None):
    """The net and the optimizer of blind estimation for ``processor``: the
    ``ParameterNetwork.blind_estimation`` preset in train mode on ``device``
    (None means the CUDA card, and raises without one; the CPU runs only
    when named) and Adam at 1e-4 with optax.adam's defaults.

    Returns:
        ``(net, opt)``.
    """
    net = ParameterNetwork.blind_estimation(processor.num_params).to(_entry_device(device)).train()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    return net, opt


def blind_estimation_loss(net: torch.nn.Module, processor, x: torch.Tensor, y: torch.Tensor,
                          auraloss_compat: bool = False, **effect_kwargs):
    """The loss of a blind-estimation step: the net (train mode) estimates
    normalized parameters from the target ``y``, ``x`` is re-rendered with
    them, and the STFT loss (the default one, or auraloss's semantics with
    ``auraloss_compat``) compares the two renders. ``effect_kwargs`` go to
    the effect (e.g. ``adjoint="ad"`` for the dense plain fractional delay).

    Returns:
        ``(loss, p_hat)``.
    """
    net.train()
    with span("blind.net"):
        p_hat = net(y)
    with span("blind.render"):
        y_hat = processor.process_normalized(x, p_hat, clip_params=True, **effect_kwargs)
    with span("blind.loss"):
        return stft_loss(y_hat, y, auraloss_compat=auraloss_compat), p_hat


def blind_estimation_step(net: torch.nn.Module, processor, opt: torch.optim.Optimizer,
                          x: torch.Tensor, rand_params: torch.Tensor, auraloss_compat: bool = False):
    """One blind-estimation step (see the module docstring). Updates the
    net's parameters and BatchNorm statistics and the optimizer's state in
    place.

    Args:
        x: clean clips, (bs, chs, T).
        rand_params: normalized parameters of the target render,
            (bs, processor.num_params), on (0, 1).
        auraloss_compat: the STFT loss with auraloss's semantics.

    Returns:
        ``(loss, param_l1)``, detached: the STFT loss and the mean absolute
        error of the predicted normalized parameters (before the update).

    Under a torch profiler the step opens the spans (:mod:`~dasp_tpu_torch.
    trace`) ``blind.step``, and inside it ``blind.target`` (the target's
    render, no gradient), ``blind.net``, ``blind.render`` and ``blind.loss``
    (in :func:`blind_estimation_loss`), ``blind.backward`` (``zero_grad``
    and ``loss.backward()``) and ``blind.optimizer``.
    """
    with span("blind.step"):
        with span("blind.target"), torch.no_grad():
            y = processor.process_normalized(x, rand_params, clip_params=True)
        loss, p_hat = blind_estimation_loss(net, processor, x, y, auraloss_compat)
        with span("blind.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        with span("blind.optimizer"):
            opt.step()
        param_l1 = torch.mean(torch.abs(p_hat.detach() - rand_params))
    return loss.detach(), param_l1


def make_mastering(sample_rate: int = 44100, *, bs: int = 1, device=None, lr: float = 2e-2,
                   tv_power_fn=None, tv_filter_fn=None):
    """The chain, the logits and the optimizer of the mastering step:
    ``examples/mastering.py``'s ``Chain([TransientShaper, DynamicEQ(
    num_bands=3), MultibandCompressor, Exciter, Limiter])`` at their
    defaults (47 normalized parameters), logits ``z`` of shape (bs, 47) at
    zero (every parameter at the middle of its range) on ``device`` (None
    means the CUDA card, and raises without one), and Adam at ``lr`` with
    optax.adam's defaults. ``tv_power_fn`` / ``tv_filter_fn`` go to the
    dynamic EQ (e.g. its sequence-sharded WOLA transforms).

    Returns:
        ``(chain, z, opt)``.
    """
    chain = Chain([TransientShaper(sample_rate),
                   DynamicEQ(sample_rate, num_bands=3, tv_power_fn=tv_power_fn, tv_filter_fn=tv_filter_fn),
                   MultibandCompressor(sample_rate), Exciter(sample_rate), Limiter(sample_rate)])
    z = torch.zeros((bs, chain.num_params), device=_entry_device(device), requires_grad=True)
    opt = torch.optim.Adam([z], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return chain, z, opt


def mastering_objective(y: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """examples/mastering.py's loss: MR-STFT + 10 x MSE."""
    return multi_resolution_stft_loss(y, target) + 10.0 * torch.mean((y - target) ** 2)


def mastering_loss(chain, z: torch.Tensor, mix: torch.Tensor, target: torch.Tensor, loss_fn=None):
    """The render of ``mix`` with parameters ``sigmoid(z)`` and its loss
    against ``target``: ``loss_fn(y, target)``, by default
    :func:`mastering_objective`.

    Returns:
        ``(loss, y)``: the loss and the render.
    """
    y = chain.process_normalized(mix, torch.sigmoid(z), clip_params=True)
    return (loss_fn or mastering_objective)(y, target), y


def mastering_step(chain, z: torch.Tensor, opt: torch.optim.Optimizer, mix: torch.Tensor,
                   p_true: torch.Tensor, mark: Optional[Callable[[str], None]] = None,
                   loss_fn=None, grad_group=None, target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One mastering step (see the module docstring): the target
    rendered from the hidden normalized parameters ``p_true`` (no
    gradient), the loss of the render from ``z``, backward, Adam. Updates
    ``z`` and the optimizer's state in place.

    Args:
        mix: the program, (bs, chs, T).
        p_true: hidden normalized parameters, (bs, chain.num_params).
        mark: called with "target", "forward", "backward" and "optimizer"
            as each part ends (e.g. to record CUDA events).
        loss_fn: the loss (see :func:`mastering_loss`).
        grad_group: a process group whose ranks hold ``z`` alike and share
            the loss out (sequence parallelism): z's gradient is summed
            over it before the update.
        target: the target render, when the caller keeps it (then
            ``p_true`` is not rendered).

    Returns:
        The loss, detached.
    """
    mark = mark or (lambda name: None)
    if target is None:
        with torch.no_grad():
            target = chain.process_normalized(mix, p_true, clip_params=True)
    mark("target")
    loss, _ = mastering_loss(chain, z, mix, target, loss_fn)
    mark("forward")
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if grad_group is not None:
        from .parallel import sum_gradients

        sum_gradients([z], grad_group)
    mark("backward")
    opt.step()
    mark("optimizer")
    return loss.detach()


# examples/denoise.py's starting point: threshold, range, attack and release
# at these shares of their ranges
DENOISE_P0 = (0.25, 0.66, 0.08, 0.14)


def make_denoise(sample_rate: int = 44100, *, bs: int = 1, device=None):
    """The gate, the logits and the optimizer of the denoising step:
    ``SpectralGate(sample_rate)`` at its defaults, logits ``z`` of shape
    (bs, 4) at ``logit(DENOISE_P0)`` on ``device`` (None means the CUDA
    card, and raises without one), and Adam at 3e-2 with optax.adam's
    defaults.

    Returns:
        ``(gate, z, opt)``.
    """
    gate = SpectralGate(sample_rate)
    p0 = torch.tensor(DENOISE_P0, dtype=torch.float32, device=_entry_device(device))
    z = torch.log(p0 / (1.0 - p0)).expand(bs, gate.num_params).clone().requires_grad_()
    opt = torch.optim.Adam([z], lr=3e-2, betas=(0.9, 0.999), eps=1e-8)
    return gate, z, opt


def denoise_loss(gate, z: torch.Tensor, noisy: torch.Tensor, clean: torch.Tensor, profile_db: torch.Tensor):
    """The gate's render of ``noisy`` with parameters ``sigmoid(z)`` and the
    measured floor ``profile_db``, and its MSE against ``clean``.

    Returns:
        ``(loss, y)``: the loss and the render.
    """
    y = gate.process_normalized(noisy, torch.sigmoid(z), clip_params=True, noise_profile_db=profile_db)
    return torch.mean((y - clean) ** 2), y


def denoise_step(gate, z: torch.Tensor, opt: torch.optim.Optimizer, noisy: torch.Tensor, clean: torch.Tensor,
                 noise_only: torch.Tensor, mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One denoising step (see the module docstring): the noise floor of
    ``noise_only`` (no gradient), the loss of the gated ``noisy`` against
    ``clean``, backward, Adam. Updates ``z`` and the optimizer's state in
    place.

    Args:
        noisy / clean / noise_only: (bs, chs, T) each: the program with
            noise, without it, and a capture of the noise alone.
        mark: called with "profile", "forward", "backward" and "optimizer"
            as each part ends (e.g. to record CUDA events).

    Returns:
        The loss, detached.
    """
    mark = mark or (lambda name: None)
    with torch.no_grad():
        profile_db = spectral_noise_profile(noise_only)
    mark("profile")
    loss, _ = denoise_loss(gate, z, noisy, clean, profile_db)
    mark("forward")
    opt.zero_grad(set_to_none=True)
    loss.backward()
    mark("backward")
    opt.step()
    mark("optimizer")
    return loss.detach()
