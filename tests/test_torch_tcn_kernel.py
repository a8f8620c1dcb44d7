"""Kernel E's plain version and the dispatch that sends a TCN layer to it.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py);
here ``ops.tcn_kernel.tcn_layer_plain``, which repeats its rounding, is held
against ``TCNBlock``'s eval forward in bf16 (cuDNN's path on the card, the
CPU's convolution here), and the dispatch in ``TCNBlock._layer`` is driven
with the device test (``tcn._on_card``) answering yes on CPU tensors, so
that the kernel's wrapper runs its plain engine.

The configuration rounds the convolution's output to bf16 and then adds the
bias in bf16 (flax's ``nn.Conv``; cuDNN's path on the card adds the bias in
a pass of its own), while the CPU's convolution adds the bias before it
rounds: the module's path is held here with its bias added as the card adds
it. Tolerance against it, and against flax's bf16 block: the two sum the
convolution in another order (float64 here, fp32 there) and group
BatchNorm's affine differently, so a bf16 rounding may land one ulp apart
where a value lies next to a rounding boundary: at most 0.1 % of the
elements differ, each by at most 2**-7 * (|gamma * invstd| * (2 |v| +
|bias|) + |y|), with v the value BatchNorm normalized (the sum before the
bias is at most |v| + |bias|, or |v| / slope before a PReLU, whose product
rounds once more). Rounding the sum and bias once, as the CPU's convolution
does, sets about a tenth of the elements apart, and the encoder's embedding
some 1e-4 from flax's, where kernel E's path stays within 3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from dasp_tpu.models import StyleTransferNet as FlaxNet
from dasp_tpu.models.tcn import Encoder as FlaxEncoder
from dasp_tpu.models.tcn import TCNBlock as FlaxBlock
from dasp_tpu_torch import trace
from dasp_tpu_torch.models import StyleTransferNet, style_net_from_flax, tcn
from dasp_tpu_torch.ops import tcn_kernel as E

BF = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    torch.set_num_threads(threads)
    trace.reset()


def randomize_(module, seed=0):
    """BatchNorm statistics and affine away from their defaults, PReLU
    slopes of 0.2, so that every term of the epilogue shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tcn.BatchNorm):
                n = m.num_features
                m.running_mean.copy_(0.4 * torch.rand(n, generator=g) - 0.2)
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.bias.copy_(0.2 * torch.rand(n, generator=g) - 0.1)
            elif isinstance(m, torch.nn.PReLU):
                m.weight.fill_(0.2)
    return module


def layer_args(conv, prelu, bn):
    return (conv.weight, conv.bias, None if prelu is None else prelu.weight, bn.running_mean, bn.running_var,
            bn.weight, bn.bias, bn.eps, conv.stride[0], conv.dilation[0])


def plain(x, conv, prelu, bn):
    w, b, s, mean, var, gamma, beta, eps, stride, dil = layer_args(conv, prelu, bn)
    return E.tcn_layer_plain(x, w, b, s, mean, var, gamma, beta, eps, stride, dil)


def assert_close_to_module(got, want, conv, bn):
    """Apart by the sum's order only (see the module docstring)."""
    assert got.shape == want.shape and got.dtype == want.dtype == BF
    scale = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).detach()[:, None]
    y = want.float()
    v = (y - bn.bias.detach()[:, None]) / scale + bn.running_mean[:, None]  # the value BatchNorm normalized
    diff = (got.float() - y).abs()
    assert float((diff > 0).float().mean()) <= 0.001
    bound = 2.0**-7 * (scale.abs() * (2 * v.abs() + conv.bias.detach().abs()[:, None]) + y.abs())
    assert bool((diff <= bound).all())


@pytest.fixture
def bias_as_on_the_card(monkeypatch):
    """The module's convolution adds its bias in a bf16 pass of its own, as
    cuDNN's path on the card and flax do (the CPU's adds it before it
    rounds)."""
    conv1d = nnf.conv1d

    def conv_then_bias(x, w, b=None, **kw):
        y = conv1d(x, w, None, **kw)
        return y if b is None else y + b[:, None]

    monkeypatch.setattr(tcn.nnf, "conv1d", conv_then_bias)


# (C_in, which conv of the block: 0 is stride 2 and dilation d, 1 is stride 1 dilation 1, activation, d)
LAYERS = [(1, 0, "prelu", 1), (1, 0, "relu", 16), (256, 0, "prelu", 16), (256, 0, "relu", 1),
          (256, 1, "prelu", 1), (256, 1, "relu", 16), (64, 0, "prelu", 2)]


@pytest.mark.parametrize("c_in,which,act,d", LAYERS)
def test_plain_engine_matches_the_module_eval_forward(bias_as_on_the_card, c_in, which, act, d):
    blk = randomize_(tcn.TCNBlock(c_in, 256, 7, d, act, dtype=BF), seed=c_in + d).eval()
    conv, prelu, bn = [getattr(blk, f"{n}{which}") for n in ("conv", "prelu", "bn")]
    x = torch.randn((2, conv.in_channels, 260), generator=torch.Generator().manual_seed(d))
    with torch.no_grad():
        want = blk._layer(conv, prelu, bn, x)  # on the CPU: the module's own path
        got = plain(x, conv, prelu, bn)
    assert got.stride() == (got.shape[1] * got.shape[2], 1, got.shape[1])  # channels-last memory
    assert_close_to_module(got, want, conv, bn)
    assert torch.equal(plain(got.contiguous() if which else x, conv, prelu, bn),
                       plain(got if which else x, conv, prelu, bn))  # layout of the input is no input


def test_plain_engine_rounds_where_the_stated_computation_does():
    """One output by hand: fp32 sum, bf16; + bf16 bias, bf16; PReLU's
    product rounded to bf16; BatchNorm's affine in fp32, each step rounded,
    then bf16."""
    blk = randomize_(tcn.TCNBlock(1, 256, 7, 1, "prelu", dtype=BF)).eval()
    x = torch.randn((1, 1, 20), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = plain(x, blk.conv0, blk.prelu0, blk.bn0)
    n, t = 5, 4
    xb = x.to(BF).double()[0, 0, 2 * t: 2 * t + 7]
    wb = blk.conv0.weight.to(BF).double()[n, 0]
    acc = torch.tensor(float((xb * wb).sum().detach()), dtype=torch.float32)
    v = (acc.to(BF).float() + blk.conv0.bias[n].to(BF).float()).to(BF)
    if not v > 0:
        v = (blk.prelu0.weight.to(BF).float() * v.float()).to(BF)[0]
    bn = blk.bn0
    inv = 1 / torch.sqrt(bn.running_var[n] + bn.eps)
    want = ((bn.weight[n] * (v.float() - bn.running_mean[n])) * inv + bn.bias[n]).to(BF)
    assert torch.equal(y[0, n, t], want.detach())


def test_accepts_the_kernels_shapes_only():
    w = torch.empty((256, 256, 7))
    assert E.accepts(torch.empty((2, 256, 100)), w, 2, 16)
    assert E.accepts(torch.empty((2, 1, 100)), torch.empty((256, 1, 7)), 2, 1)
    assert not E.accepts(torch.empty((2, 256, 100)), torch.empty((128, 256, 7)), 2, 1)  # 128 output channels
    assert not E.accepts(torch.empty((2, 32, 100)), torch.empty((256, 32, 7)), 1, 1)  # C_in not a multiple of 64
    assert not E.accepts(torch.empty((2, 1, 100)), torch.empty((256, 1, 17)), 1, 1)  # 17 taps on one channel
    assert not E.accepts(torch.empty((2, 256, 96)), w, 2, 16)  # no output sample
    assert not E.accepts(torch.empty((2, 128, 100)), w, 1, 1)  # channels differ


def test_wrapper_check_names_the_shapes():
    x, w = torch.empty((2, 32, 100)), torch.empty((256, 32, 7))
    ones = [torch.ones(256)] * 5
    with pytest.raises(ValueError, match="kernel E takes"):
        E._check(x, w, 1, 1, None, *ones)
    with pytest.raises(ValueError, match="one PReLU slope"):
        E._check(torch.empty((2, 64, 100)), torch.empty((256, 64, 7)), 1, 1, torch.ones(2), *ones)
    with pytest.raises(ValueError, match="256 biases"):
        E._check(torch.empty((2, 64, 100)), torch.empty((256, 64, 7)), 1, 1, None, torch.ones(3), *ones[1:])


@pytest.fixture
def on_card(monkeypatch):
    """The device test answers yes on CPU tensors; every call of the
    kernel's wrapper is recorded (it runs its plain engine here)."""
    calls = []
    layer = E.tcn_layer

    def record(*args):
        calls.append(args[0].shape)
        return layer(*args)

    monkeypatch.setattr(tcn, "_on_card", lambda x: True)
    monkeypatch.setattr(E, "tcn_layer", record)
    return calls


def block_and_input(activation="prelu", c_out=256, dtype=BF, seed=0):
    blk = randomize_(tcn.TCNBlock(1, c_out, 7, 2, activation, dtype=dtype), seed)
    x = torch.randn((2, 1, 300), generator=torch.Generator().manual_seed(seed))
    return blk, x


@pytest.mark.parametrize("activation", ["prelu", "relu"])
def test_eval_bf16_without_autograd_takes_the_kernel(on_card, activation):
    blk, x = block_and_input(activation)
    blk.eval()
    with torch.no_grad():
        y = blk(x)
    assert len(on_card) == 2
    assert y.stride()[1] == 1  # channels-last from the kernel
    h = plain(x, blk.conv0, blk.prelu0, blk.bn0)
    assert torch.equal(y, plain(h, blk.conv1, blk.prelu1, blk.bn1))
    with torch.inference_mode():
        blk(x)
    blk.requires_grad_(False)
    blk(x)  # grad mode, but nothing requires grad
    assert len(on_card) == 6


# case: (what differs from the kernel's conditions, train mode, grad enabled, x requires grad)
OTHER_CALLS = {"off_card": (False, False, False), "fp32": (False, False, False), "shape": (False, False, False),
               "train": (True, False, False), "train_grad": (True, True, False), "grad": (False, True, False),
               "input_grad": (False, True, True), "bn_train": (False, False, False)}


@pytest.mark.parametrize("case", list(OTHER_CALLS))
def test_every_other_call_keeps_the_module_path(monkeypatch, on_card, case):
    """Off the card, in fp32, at a width the kernel does not take, in train
    mode, with autograd (parameters or input requiring grad) or with a
    BatchNorm in train mode, a layer never reaches the kernel, and outputs,
    gradients and running statistics are bitwise those of the module's path
    (the device test answering no)."""
    train, grad, x_grad = OTHER_CALLS[case]
    if case == "off_card":
        monkeypatch.setattr(tcn, "_on_card", lambda x: x.device.type == "cuda")
    blk, x = block_and_input(c_out=32 if case == "shape" else 256, dtype=None if case == "fp32" else BF)
    twin = tcn.TCNBlock(1, blk.conv0.out_channels, 7, 2, "prelu", dtype=blk.dtype)
    twin.load_state_dict(blk.state_dict())
    for m in (blk, twin):
        m.train(train)
        if case == "bn_train":  # the block in eval mode, its BatchNorms in train mode
            m.bn0.train()
            m.bn1.train()
        if case == "input_grad":
            m.requires_grad_(False)
    xs = [x.clone().requires_grad_(x_grad) for _ in range(2)]
    with torch.set_grad_enabled(grad):
        y = blk(xs[0])
        assert not on_card
        monkeypatch.setattr(tcn, "_on_card", lambda x: False)
        want = twin(xs[1])
    assert torch.equal(y, want)
    if grad:
        y.float().square().sum().backward()
        want.float().square().sum().backward()
        for (name, p), q in zip(blk.named_parameters(), twin.parameters()):
            assert p.grad is None and q.grad is None or torch.equal(p.grad, q.grad), name
        if x_grad:
            assert torch.equal(xs[0].grad, xs[1].grad)
    for name, b in blk.named_buffers():
        assert torch.equal(b, dict(twin.named_buffers())[name]), name


def test_in_place_changes_to_weights_and_statistics_are_followed(on_card):
    blk, x = block_and_input()
    blk.eval()
    with torch.no_grad():
        y0 = blk(x)
        blk.conv0.weight.mul_(1.25)
        y1 = blk(x)
        assert not torch.equal(y0, y1)
        h = plain(x, blk.conv0, blk.prelu0, blk.bn0)
        assert torch.equal(y1, plain(h, blk.conv1, blk.prelu1, blk.bn1))
        blk.bn1.running_mean.add_(0.5)
        blk.bn1.running_var.mul_(2.0)
        y2 = blk(x)
        assert not torch.equal(y1, y2)
        assert torch.equal(y2, plain(h, blk.conv1, blk.prelu1, blk.bn1))
    assert len(on_card) == 6


def test_every_layer_call_is_counted_on_either_path(on_card, monkeypatch):
    blk, x = block_and_input()
    blk.eval()
    with torch.no_grad():
        blk(x)
    monkeypatch.setattr(tcn, "_on_card", lambda x: False)
    blk.train()
    blk(x)
    assert trace.snapshot()["counts"]["encoder.conv_layer"] == 4
    assert len(on_card) == 2


def small_style_net():
    net = randomize_(StyleTransferNet(embed_dim=16, encoder_dilations=(1, 2), dtype=BF), seed=4)
    return net.eval()


def test_style_net_runs_input_and_reference_as_one_batch_on_the_kernel(on_card, monkeypatch):
    """Eval BatchNorm is per clip: the merged pass gives the separate
    passes' embeddings (the kernel's layers bitwise; the fp32 MLP on 4 rows
    instead of 2 alike here), at half the layer calls."""
    net = small_style_net()
    g = torch.Generator().manual_seed(1)
    inp, ref = torch.randn((2, 1, 400), generator=g), torch.randn((2, 1, 400), generator=g)
    with torch.no_grad():
        merged = net(inp, ref)
        assert on_card == [(4, 1, 400), (4, 256, 197), (4, 256, 191), (4, 256, 90)]
        z = torch.cat([net.encoder(inp), net.encoder(ref)], dim=-1)
        want = {name: proj(z) for name, proj in net.projectors.items()}
    for name in want:
        torch.testing.assert_close(merged[name], want[name], rtol=0, atol=1e-6)
    monkeypatch.setattr(tcn, "_on_card", lambda x: False)
    trace.reset()
    with torch.no_grad():
        net(inp, ref)
    assert trace.snapshot()["counts"]["encoder.conv_layer"] == 8  # the module's path: two passes


def test_kernel_reads_channels_last_inputs_in_place_and_copies_others():
    """The CUDA engine's input: a kernel E output (NWC memory) or a
    one-channel clip is read where it lies; any other layout or dtype is
    made NWC bf16 first."""
    nwc = torch.randn((2, 300, 64)).to(BF).transpose(1, 2)
    assert E._nwc(nwc) is nwc
    mono = torch.randn((2, 1, 300)).to(BF)
    assert E._nwc(mono) is mono
    for x in (nwc.contiguous(), nwc.float(), torch.randn((2, 1, 300))):
        got = E._nwc(x)
        assert got is not x and got.dtype == BF and torch.equal(got, x.to(BF))
        assert got.transpose(1, 2).is_contiguous()  # (B, T, C) in memory


# the style encoder's width and both kinds of block: a first block (one input
# channel) and a 256-channel one at the widest dilation
FLAX_DILATIONS = (1, 16)
FLAX_TOL = 3e-6


@pytest.fixture(scope="module")
def flax_pair():
    """flax's bf16 style net at 256 channels with every BatchNorm statistic,
    PReLU slope and convolution bias drawn at random (init leaves the biases
    at 0, which would hide where the bias is rounded), the port's bf16 net
    with its weights, and a clip."""
    rng = np.random.default_rng(23)

    def redraw(path, leaf):
        name, arr = jax.tree_util.keystr(path), np.asarray(leaf)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, arr.shape).astype(np.float32)
        if "'mean'" in name or "BatchNorm" in name:
            return rng.normal(0.0, 0.3, arr.shape).astype(np.float32)
        if "negative_slope" in name:
            return rng.uniform(0.05, 0.3, arr.shape).astype(np.float32)
        if "Conv" in name and "'bias'" in name:
            return rng.normal(0.0, 0.1, arr.shape).astype(np.float32)
        return arr

    fnet = FlaxNet(embed_dim=16, ch_dim=256, encoder_dilations=FLAX_DILATIONS)
    x0 = jnp.zeros((2, 1, 1200), jnp.float32)
    variables = jax.tree_util.tree_map_with_path(redraw, jax.device_get(fnet.init(jax.random.PRNGKey(0), x0, x0)))
    net = StyleTransferNet(embed_dim=16, ch_dim=256, encoder_dilations=FLAX_DILATIONS, dtype=BF)
    net.load_state_dict(style_net_from_flax(variables, net), strict=True)
    clip = (0.3 * rng.standard_normal((2, 1, 1200))).astype(np.float32)
    enc = {kind: variables[kind]["Encoder_0"] for kind in ("params", "batch_stats")}
    return enc, net.eval(), clip


@pytest.mark.parametrize("i", range(len(FLAX_DILATIONS)))
def test_kernel_path_matches_flax_block_in_bf16(on_card, flax_pair, i):
    """Block ``i`` through the kernel's dispatch (its plain engine here)
    against flax's bf16 ``TCNBlock`` on the same input: apart by the sum's
    order only."""
    enc, net, clip = flax_pair
    h = jnp.swapaxes(jnp.asarray(clip), 1, 2)
    for k in range(i + 1):
        block_vars = {kind: enc[kind][f"TCNBlock_{k}"] for kind in enc}
        h_in, h = h, FlaxBlock(256, 7, FLAX_DILATIONS[k], "prelu", jnp.bfloat16).apply(block_vars, h, train=False)
    blk = net.encoder.blocks[i]
    with torch.no_grad():
        got = blk(torch.tensor(np.asarray(h_in.astype(jnp.float32))).transpose(1, 2))
    assert len(on_card) == 2
    want = torch.tensor(np.asarray(h.astype(jnp.float32))).transpose(1, 2).to(BF)
    assert_close_to_module(got, want, blk.conv1, blk.bn1)


def test_kernel_path_matches_flax_encoder_in_bf16(on_card, monkeypatch, flax_pair):
    """The encoder's embedding through the kernel's dispatch against flax's
    bf16 ``Encoder``; the CPU convolution's path, which rounds the sum and
    the bias once, lies further away than the tolerance."""
    enc, net, clip = flax_pair
    want = np.asarray(FlaxEncoder(16, 256, FLAX_DILATIONS, 7, jnp.bfloat16).apply(enc, jnp.asarray(clip), train=False))
    with torch.no_grad():
        got = net.encoder(torch.tensor(clip)).numpy()
        assert len(on_card) == 2 * len(FLAX_DILATIONS)
        monkeypatch.setattr(tcn, "_on_card", lambda x: False)
        once = net.encoder(torch.tensor(clip)).numpy()
    assert float(np.abs(got - want).max()) <= FLAX_TOL
    assert float(np.abs(once - want).max()) > FLAX_TOL
