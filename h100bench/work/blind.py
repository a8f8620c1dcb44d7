"""Operations and bytes counted from shapes for the blind-estimation cell:
the estimator's model FLOPs and the work of kernel C (the banded
fractional delay), forward and backward; and the dense peak of each
precision a configuration may state for its convolutions.

The net's count is its convolutions' and its head's multiply-adds, two
operations each; ReLU, BatchNorm and the time mean are left out, as model
FLOPs leave them out. A training step counts three times its forward pass.
"""

import math
from typing import Sequence

from .flops import conv_out_len
from .peaks import BF16_FLOPS_PER_S, FP32_OPS_PER_S

# TF32 on the tensor cores of one H100 SXM, dense (NVIDIA's data sheet gives
# 989 TFLOP/s with sparsity; 700 W)
TF32_FLOPS_PER_S = 495e12
DENSE_FLOPS_PER_S = {"bfloat16": BF16_FLOPS_PER_S, "tfloat32": TF32_FLOPS_PER_S, "float32": FP32_OPS_PER_S}

# kernel C's float32 operations per output sample: for each tap its read
# position r = (j + Dm) - d, floor(r), f = r - floor(r) and the start mask
# (t - d, a compare); then for each tap and channel the interpolation
# (1 - f, two products, a sum), the gain and the sum over taps
C_FWD_TAP_OPS, C_FWD_CHANNEL_OPS = 5, 6
# the backward's: the same coordinates; for each tap and channel the
# interpolation (4), the cotangent times the gain (1), dg's product with
# the mask and the interpolation and its sum (3), dd's difference, product
# and sum (3)
C_BWD_TAP_OPS, C_BWD_CHANNEL_OPS = 5, 11


def blind_forward_flops(net: dict, n: int) -> int:
    """FLOPs of the net's forward pass over one clip of ``n`` samples: each
    block a strided dilated convolution then an undilated one, the time
    mean, then the linear head."""
    total, c_in, k = 0, 1, net["kernel_size"]
    for ch, d in zip(net["channels"], net["dilations"]):
        n = conv_out_len(n, k, 2, d)
        total += 2 * ch * c_in * k * n
        n = conv_out_len(n, k)
        total += 2 * ch * ch * k * n
        c_in = ch
    if n < 1:
        raise ValueError("clip too short for the net")
    return total + 2 * c_in * net["num_params"]


def blind_train_flops(net: dict, bs: int, n: int) -> int:
    """Model FLOPs of one blind-estimation step: the net's forward and
    backward (3 x forward) over ``bs`` clips."""
    return 3 * bs * blind_forward_flops(net, n)


def frac_delay_work(x_shape: Sequence[int], d_shape: Sequence[int], itemsize: int = 4):
    """(bytes, operations) of kernel C's forward: x_ext read once, each
    tap's delays and gains read once, wet written once."""
    bs, chs, t_ext = x_shape
    nt, _, tp = d_shape
    nbytes = itemsize * (bs * chs * t_ext + 2 * nt * bs * tp + bs * chs * tp)
    return nbytes, nt * bs * tp * (C_FWD_TAP_OPS + C_FWD_CHANNEL_OPS * chs)


def frac_delay_bwd_work(x_shape: Sequence[int], d_shape: Sequence[int], itemsize: int = 4,
                        need_dx: bool = False):
    """(bytes, operations) of kernel C's backward: x_ext, each tap's delays
    and gains and the cotangent read once, dd and dg written once, and dx
    written once where ``need_dx`` (the cell's clips need no gradient)."""
    bs, chs, t_ext = x_shape
    nt, _, tp = d_shape
    nbytes = itemsize * (bs * chs * t_ext * (2 if need_dx else 1) + 4 * nt * bs * tp + bs * chs * tp)
    return nbytes, nt * bs * tp * (C_BWD_TAP_OPS + C_BWD_CHANNEL_OPS * chs)


def pitch_shift_operands(processor: dict, bs: int, n: int):
    """The shapes of x_ext and of the stacked taps that ``pitch_shift``
    hands kernel C for ``bs`` mono clips of ``n`` samples: Dm = W + 1
    samples of history before whole ``block`` tiles."""
    W, B = processor["window_samples"], processor["block"]
    tp = math.ceil(n / B) * B
    return (bs, 1, W + 1 + tp), (processor["taps"], bs, tp)
