"""TCN encoder and parameter projector as ``torch.nn`` modules.

PyTorch counterpart of ``dasp_tpu/models/tcn.py`` (``TCNBlock``,
``ParameterNetwork``, ``Encoder``, ``ParameterProjector``). Audio enters as
(batch, channels, samples) and the convolutions run in that NCW layout,
with no padding (the JAX package's ``VALID``). A PReLU block has two PReLUs
of one slope each, initialised to 0.01 as flax's are; a ReLU block has no
activation parameters. ``models.convert`` carries flax weights over.

BatchNorm follows flax's ``nn.BatchNorm`` (see :class:`BatchNorm`): in
train mode it normalizes with the biased batch statistics and moves the
running statistics by momentum 0.99 (torch's ``momentum=0.01``) toward the
batch mean and the *biased* batch variance.

``dtype=torch.bfloat16`` computes as flax's ``dtype=jnp.bfloat16`` does:
the convolutions take bf16 inputs and weights (cast at the call), their
bf16 outputs go through PReLU (slope cast to bf16) and BatchNorm, whose
statistics and normalization are taken in fp32 and whose output is cast
back to bf16, so activations stay bf16 from one convolution to the next.
Parameters and statistics stay fp32; the encoder's time mean is taken in
fp32.

Kernel E: a layer in eval mode, in bf16, on a CUDA tensor and with no
autograd (grad disabled, or nothing that requires grad) runs as one launch
of ``ops.tcn_kernel.tcn_layer`` where that kernel takes its shapes (256
output channels; in the encoder every layer): flax's rounding, the
convolution's output rounded to bf16 before the bias is added (as cuDNN's
path on the card does; the CPU's convolution adds the bias before it
rounds), the activations channels-last from one layer to the next (an NCW
shape over NWC memory). Every other call, training's above all, keeps the
path above.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as nnf
from torch import nn

from ..ops import tcn_kernel
from ..trace import count

__all__ = ["BatchNorm", "sync_batch_norm", "TCNBlock", "ParameterNetwork", "Encoder", "ParameterProjector"]

# flax nn.BatchNorm's momentum: running = 0.99 * running + 0.01 * batch
FLAX_MOMENTUM = 0.99


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in its own dtype if that is wider (float64 runs)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax ``nn.BatchNorm``'s conventions.

    Same parameters and buffers as ``nn.BatchNorm1d`` (so state dicts carry
    over), with ``momentum=0.01`` in torch's sense and eps 1e-5. Train mode
    normalizes with the biased batch mean and variance and updates the
    running statistics as flax does: ``running = 0.99 * running + 0.01 *
    batch`` with the biased variance (``nn.BatchNorm1d`` feeds the unbiased
    one). Statistics are reduced in fp32 and the output has the input's
    dtype, so a bf16 activation stays bf16. Each call in train mode updates
    the statistics once, so a module called twice in one forward updates
    them twice in sequence, as flax does.

    Data parallelism: with ``group`` set (:func:`sync_batch_norm`), train
    mode normalizes over the whole batch that the group's ranks split, as
    flax's BatchNorm does over a batch-sharded global array: the sums of x
    and of its squared deviations from the mean are all-gathered over the
    group, with autograd.
    ``torch.nn.SyncBatchNorm`` will not do: it refuses CPU tensors.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - FLAX_MOMENTUM)
        # the process group of the ranks that split the batch (data
        # parallelism), or None; see :func:`sync_batch_norm`
        self.group = None

    def _forward_synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the whole batch of the group's ranks: the sums of
        x and the counts all-gathered and summed give the mean, then the
        sums of the squared deviations from it the biased variance (the
        all-gathers' transpose sums each rank's part of the gradient). Two
        passes, not E[x**2] - E[x]**2: the one-pass form's backward cancels
        in fp32 and moved the encoder's gradient well past fp32's own noise
        (PERF.md §6)."""
        from ..parallel.mesh import all_gather

        xf = _at_least_f32(x)
        C = self.num_features
        local = torch.cat([xf.sum(dim=(0, 2)), xf.new_full((1,), float(x.shape[0] * x.shape[2]))])
        total = all_gather(local, self.group).sum(dim=0)
        mean = total[:C] / total[C]
        dev = xf - mean[:, None]
        var = all_gather((dev * dev).sum(dim=(0, 2)), self.group).sum(dim=0) / total[C]
        with torch.no_grad():
            m = FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        scale = self.weight.to(mean.dtype) * torch.rsqrt(var + self.eps)
        return (dev * scale[:, None] + self.bias.to(mean.dtype)[:, None]).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group is not None:
            return self._forward_synced(x)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(_at_least_f32(x), dim=(0, 2), unbiased=False)
                m = FLAX_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
            return nnf.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        return nnf.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, eps=self.eps,
        )


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def sync_batch_norm(module: nn.Module, group) -> nn.Module:
    """Set every :class:`BatchNorm` of ``module`` to take its train-mode
    statistics over the ranks of ``group`` (None: each rank's own batch);
    returns ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


class TCNBlock(nn.Module):
    """Strided dilated conv block: conv(s=2, dil=d) -> act -> BN ->
    conv -> act -> BN, with ``activation`` "relu" (the default, as flax's
    ``TCNBlock``; the blind-estimation net's) or "prelu" (the style-transfer
    encoder's and the auto-EQ net's)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, activation: str = "relu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        if activation not in ("prelu", "relu"):
            raise ValueError(f"Unknown activation: {activation!r}. Expected 'prelu' or 'relu'.")
        self.dtype = dtype
        self.conv0 = nn.Conv1d(in_channels, out_channels, kernel_size, stride=2, dilation=dilation)
        self.prelu0 = nn.PReLU(init=0.01) if activation == "prelu" else None
        self.bn0 = BatchNorm(out_channels)
        self.conv1 = nn.Conv1d(out_channels, out_channels, kernel_size)
        self.prelu1 = nn.PReLU(init=0.01) if activation == "prelu" else None
        self.bn1 = BatchNorm(out_channels)

    def _layer(self, conv: nn.Conv1d, prelu: nn.PReLU | None, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        count("encoder.conv_layer")
        slope = None if prelu is None else prelu.weight
        stride, dilation = conv.stride[0], conv.dilation[0]
        # kernel E: a CUDA tensor, bf16 compute, eval mode, no autograd (grad
        # disabled, or nothing that requires grad) and a shape it takes
        inputs = (x, conv.weight, conv.bias, bn.weight, bn.bias) + (() if slope is None else (slope,))
        autograd = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
        if (_on_card(x) and self.dtype == torch.bfloat16 and not self.training and not bn.training
                and not autograd and tcn_kernel.accepts(x, conv.weight, stride, dilation)):
            return tcn_kernel.tcn_layer(x, conv.weight, conv.bias, slope, bn.running_mean, bn.running_var, bn.weight,
                                        bn.bias, bn.eps, stride, dilation)
        if self.dtype is None:
            h = conv(x)
        else:
            h = nnf.conv1d(
                x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                stride=conv.stride, dilation=conv.dilation,
            )
        if prelu is None:
            return bn(torch.relu(h))
        return bn(nnf.prelu(h, prelu.weight.to(h.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._layer(self.conv0, self.prelu0, self.bn0, x)
        return self._layer(self.conv1, self.prelu1, self.bn1, x)


class ParameterNetwork(nn.Module):
    """TCN that maps audio to normalized effect parameters: the blocks, the
    time mean, an optional 2-layer ReLU MLP, and an fp32 linear head with a
    sigmoid. Dense layers are ``dense0``, ``dense1``, ... in flax's order
    (the head is the last).

    Presets: :meth:`blind_estimation` (channels 16-32-64-128-128, kernel 3,
    dilations 1..16, ReLU, linear head) and :meth:`auto_eq` (10 blocks of
    256 channels, kernel 7, PReLU, 3-layer MLP head).

    ``dtype=torch.bfloat16`` computes as flax's ``dtype=jnp.bfloat16``: the
    blocks as :class:`TCNBlock`'s, the time mean taken in fp32 and rounded
    to bf16, the MLP's dense layers in bf16 (inputs, weights and biases cast
    at the call); the head takes fp32. Parameters stay fp32.
    """

    def __init__(self, num_control_params: int,
                 channels: Sequence[int] = (16, 32, 64, 128, 128), kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16), activation: str = "relu",
                 mlp_hidden: int = 0, in_channels: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        chans = [in_channels, *channels]
        self.blocks = nn.ModuleList(
            TCNBlock(chans[i], ch, kernel_size, d, activation, dtype)
            for i, (ch, d) in enumerate(zip(channels, dilations))
        )
        widths = [chans[-1], *([mlp_hidden] * 2 if mlp_hidden else []), num_control_params]
        self.num_dense = len(widths) - 1
        for i in range(self.num_dense):
            self.add_module(f"dense{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for block in self.blocks:
            h = block(h)
        # aggregate over time (a bf16 mean accumulated in fp32, then rounded)
        h = h.mean(dim=-1) if self.dtype is None else h.float().mean(dim=-1).to(h.dtype)
        for i in range(self.num_dense - 1):
            dense = getattr(self, f"dense{i}")
            if self.dtype is None:
                h = dense(h)
            else:
                h = nnf.linear(h.to(self.dtype), dense.weight.to(self.dtype), dense.bias.to(self.dtype))
            h = torch.relu(h)
        head = getattr(self, f"dense{self.num_dense - 1}")
        return torch.sigmoid(head(_at_least_f32(h)))

    @staticmethod
    def blind_estimation(num_params: int) -> "ParameterNetwork":
        return ParameterNetwork(num_params)

    @staticmethod
    def auto_eq(num_params: int, ch_dim: int = 256) -> "ParameterNetwork":
        return ParameterNetwork(
            num_params,
            channels=(ch_dim,) * 10,
            kernel_size=7,
            dilations=(1, 2, 4, 8, 16, 1, 2, 4, 8, 16),
            activation="prelu",
            mlp_hidden=256,
        )


class Encoder(nn.Module):
    """Style-transfer audio encoder: a TCN of ``len(dilations)`` blocks of
    ``ch_dim`` channels, the time mean (fp32), and a 3-layer MLP to an
    embedding. The default 10-block kernel-7 stack needs inputs of at least
    about 70k samples."""

    def __init__(self, embed_dim: int = 512, ch_dim: int = 256,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16, 1, 2, 4, 8, 16),
                 kernel_size: int = 7, in_channels: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        chans = [in_channels] + [ch_dim] * len(dilations)
        self.blocks = nn.ModuleList(
            TCNBlock(chans[i], ch_dim, kernel_size, d, "prelu", dtype) for i, d in enumerate(dilations)
        )
        self.dense0 = nn.Linear(ch_dim, 256)
        self.dense1 = nn.Linear(256, 256)
        self.dense2 = nn.Linear(256, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for block in self.blocks:
            h = block(h)
        h = _at_least_f32(h).mean(dim=-1)
        h = torch.relu(self.dense0(h))
        h = torch.relu(self.dense1(h))
        return self.dense2(h)

    def pair(self, inp: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The embeddings of two clips. In eval mode on the card, where the
        clips have one shape, they pass as one batch: eval-mode BatchNorm is
        per clip, so that is exact, and it halves the launches. On the CPU,
        where there are no launches to save, each passes alone, so that its
        sums keep their order."""
        if not self.training and inp.shape == ref.shape and _on_card(inp):
            return self(torch.cat([inp, ref])).chunk(2)
        return self(inp), self(ref)


class ParameterProjector(nn.Module):
    """MLP from a joint embedding to sigmoid-normalized effect parameters."""

    def __init__(self, in_features: int, num_control_params: int, num_hidden: int = 256):
        super().__init__()
        self.dense0 = nn.Linear(in_features, num_hidden)
        self.dense1 = nn.Linear(num_hidden, num_hidden)
        self.dense2 = nn.Linear(num_hidden, num_control_params)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense0(z))
        h = torch.relu(self.dense1(h))
        return torch.sigmoid(self.dense2(h))
