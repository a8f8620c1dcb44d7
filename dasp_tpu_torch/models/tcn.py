"""TCN encoder and parameter projector as ``torch.nn`` modules.

PyTorch counterpart of ``dasp_tpu/models/tcn.py`` (``TCNBlock``,
``Encoder``, ``ParameterProjector``). Audio enters as (batch, channels,
samples) and the convolutions run in that NCW layout, with no padding (the
JAX package's ``VALID``). Each block has two PReLUs of one slope each,
initialised to 0.01 as flax's are. ``models.convert`` carries flax weights
over.

``dtype=torch.bfloat16`` runs the convolutions in bf16 (inputs and weights
cast at the call) while parameters, PReLU, BatchNorm and the time mean stay
in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as nnf
from torch import nn

__all__ = ["TCNBlock", "Encoder", "ParameterProjector"]


class TCNBlock(nn.Module):
    """Strided dilated conv block: conv(s=2, dil=d) -> PReLU -> BN ->
    conv -> PReLU -> BN (the JAX package's ``activation="prelu"`` block)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv1d(in_channels, out_channels, kernel_size, stride=2, dilation=dilation)
        self.prelu0 = nn.PReLU(init=0.01)
        self.bn0 = nn.BatchNorm1d(out_channels, eps=1e-5)
        self.conv1 = nn.Conv1d(out_channels, out_channels, kernel_size)
        self.prelu1 = nn.PReLU(init=0.01)
        self.bn1 = nn.BatchNorm1d(out_channels, eps=1e-5)

    def _conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return conv(x)
        y = nnf.conv1d(
            x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
            stride=conv.stride, dilation=conv.dilation,
        )
        return y.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn0(self.prelu0(self._conv(self.conv0, x)))
        return self.bn1(self.prelu1(self._conv(self.conv1, x)))


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
        h = h.float().mean(dim=-1)
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
