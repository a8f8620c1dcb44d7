"""Operations and bytes counted from shapes: the style encoder's model FLOPs
and the work of kernels A and B.

The encoder count is the convolutions' and the dense layers'
multiply-adds, two operations each, of ``StyleTransferNet``: two encoder
passes (input and reference), then four projectors. BatchNorm, PReLU, the
time mean and the effects are left out, as model FLOPs leave them out. A
training step counts three times its forward pass (the backward pass
computes the gradient of the inputs and of the weights).
"""

from typing import Sequence

from .peaks import SECTION_OPS


def conv_out_len(n: int, kernel: int, stride: int = 1, dilation: int = 1) -> int:
    """Output length of a convolution with no padding."""
    return (n - dilation * (kernel - 1) - 1) // stride + 1


def encoder_flops(n: int, ch: int, dilations: Sequence[int], kernel: int, embed: int,
                  in_ch: int = 1, mlp: int = 256) -> int:
    """FLOPs of one encoder pass over one clip of ``n`` samples: each block
    a strided dilated convolution then an undilated one, the time mean,
    then dense layers ch -> mlp -> mlp -> embed."""
    total, c_in = 0, in_ch
    for d in dilations:
        n = conv_out_len(n, kernel, 2, d)
        total += 2 * ch * c_in * kernel * n
        n = conv_out_len(n, kernel)
        total += 2 * ch * ch * kernel * n
        c_in = ch
    if n < 1:
        raise ValueError("clip too short for the encoder")
    return total + 2 * (ch * mlp + mlp * mlp + mlp * embed)


def projector_flops(embed: int, counts: Sequence[int], hidden: int = 256) -> int:
    """FLOPs of the four projectors on one joint embedding (2 * embed)."""
    return sum(2 * (2 * embed * hidden + hidden * hidden + hidden * c) for c in counts)


def style_forward_flops(net: dict, bs: int, n: int) -> int:
    """FLOPs of ``StyleTransferNet.forward`` on ``bs`` (input, reference)
    pairs of ``n`` samples; ``net`` is a configuration's ``net`` group."""
    enc = encoder_flops(n, net["ch_dim"], net["encoder_dilations"], net["kernel_size"], net["embed_dim"])
    return bs * (2 * enc + projector_flops(net["embed_dim"], net["num_params"]))


def style_train_flops(net: dict, bs: int, n: int) -> int:
    """Model FLOPs of one training step: forward and backward (3 x forward)."""
    return 3 * style_forward_flops(net, bs, n)


def sosfilt_work(sos_shape: Sequence[int], x_shape: Sequence[int], itemsize: int = 4):
    """(bytes, operations) of a biquad cascade over x: x read once, y
    written once, the sections read once; 9 operations a sample and section."""
    rows = 1
    for s in x_shape[:-1]:
        rows *= s
    T, sections = x_shape[-1], sos_shape[-2]
    nbytes = 2 * rows * T * itemsize + _numel(sos_shape) * itemsize
    return nbytes, SECTION_OPS * rows * T * sections


def ballistics_work(g_shape: Sequence[int], itemsize: int = 4):
    """(bytes, operations) of the attack/release recursion: g read once and
    y written once; a compare, a select and two multiply-adds a sample."""
    n = _numel(g_shape)
    return 2 * n * itemsize, 4 * n


def _numel(shape: Sequence[int]) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
