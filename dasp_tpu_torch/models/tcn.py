"""TCN encoder and parameter projector as ``torch.nn`` modules.

PyTorch counterpart of ``dasp_tpu/models/tcn.py`` (``TCNBlock``,
``Encoder``, ``ParameterProjector``). Audio enters as (batch, channels,
samples) and the convolutions run in that NCW layout, with no padding (the
JAX package's ``VALID``). Each block has two PReLUs of one slope each,
initialised to 0.01 as flax's are. ``models.convert`` carries flax weights
over.

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
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as nnf
from torch import nn

__all__ = ["BatchNorm", "TCNBlock", "Encoder", "ParameterProjector"]

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
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class TCNBlock(nn.Module):
    """Strided dilated conv block: conv(s=2, dil=d) -> PReLU -> BN ->
    conv -> PReLU -> BN (the JAX package's ``activation="prelu"`` block)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv1d(in_channels, out_channels, kernel_size, stride=2, dilation=dilation)
        self.prelu0 = nn.PReLU(init=0.01)
        self.bn0 = BatchNorm(out_channels)
        self.conv1 = nn.Conv1d(out_channels, out_channels, kernel_size)
        self.prelu1 = nn.PReLU(init=0.01)
        self.bn1 = BatchNorm(out_channels)

    def _layer(self, conv: nn.Conv1d, prelu: nn.PReLU, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return bn(prelu(conv(x)))
        h = nnf.conv1d(
            x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
            stride=conv.stride, dilation=conv.dilation,
        )
        return bn(nnf.prelu(h, prelu.weight.to(self.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._layer(self.conv0, self.prelu0, self.bn0, x)
        return self._layer(self.conv1, self.prelu1, self.bn1, x)


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
            TCNBlock(chans[i], ch_dim, kernel_size, d, dtype) for i, d in enumerate(dilations)
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
