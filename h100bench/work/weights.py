"""The style net's initial weights, made on the device from the seed in one
draw: He-normal convolutions (so that activations keep their scale through
the blocks also in eval mode, where BatchNorm's running statistics are at
rest), LeCun-normal dense layers, small biases, PReLU slopes near 0.01 and
BatchNorm scales near 1."""

import math
from typing import Dict

import torch


def make_weights(shapes: Dict[str, tuple], generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if name.endswith("weight") and ".conv" in name:
            w = z * math.sqrt(2.0 / (shape[1] * shape[2]))
        elif name.endswith("weight") and ".dense" in name:
            w = z * math.sqrt(1.0 / shape[1])
        elif ".prelu" in name:
            w = 0.01 + 0.001 * z
        elif name.endswith("weight"):  # BatchNorm scale
            w = 1.0 + 0.1 * z
        elif ".bn" in name:  # BatchNorm shift
            w = 0.1 * z
        else:  # biases
            w = 0.01 * z
        out[name] = w.contiguous()
    return out
