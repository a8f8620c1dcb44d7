"""Defaults and dtype options of dasp_tpu_torch against dasp_tpu.

``TCNBlock`` takes flax's field order and default activation ("relu"): a
block built at its defaults has no PReLU, as flax's has none, and both
compute the same function on the same weights (fp32 convolutions summed in
another order: 1e-6). ``ParameterNetwork(dtype=torch.bfloat16)`` computes as
flax's ``dtype=jnp.bfloat16`` (bf16 convolutions and MLP, fp32 parameters
and head), within the 3e-6 of the encoder's bf16 test
(tests/test_torch_models.py), in eval and train mode. ``noise_shaped_ir``
takes JAX's ``dtype=``: float32 band gains with a float64 IR agree with
JAX's in float64 to 1e-12 of the peak, and the default float32 with float64
gains gives a float64 IR over float32 noise, as JAX's does, within 1e-6.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasp_tpu import functional as D
from dasp_tpu.models import ParameterNetwork as FlaxNet
from dasp_tpu.models.tcn import TCNBlock as FlaxBlock
from dasp_tpu_torch import functional as F
from dasp_tpu_torch.models import ParameterNetwork, parameter_network_from_flax
from dasp_tpu_torch.models.tcn import TCNBlock
from test_torch_models import BF16_TOL, randomized_variables

SR = 44100


def test_tcn_block_defaults_and_field_order_match_flax():
    flax_fields = [f for f in FlaxBlock.__dataclass_fields__ if f not in ("parent", "name")]
    port = list(inspect.signature(TCNBlock.__init__).parameters)[2:]  # after self, in_channels
    assert port == flax_fields
    for name in flax_fields[1:]:
        assert inspect.signature(TCNBlock.__init__).parameters[name].default == \
            FlaxBlock.__dataclass_fields__[name].default, name
    blk = TCNBlock(1, 4)
    assert blk.prelu0 is None and blk.prelu1 is None
    assert not any("prelu" in k for k in blk.state_dict())


def test_tcn_block_at_defaults_computes_flax_block():
    x = (np.random.default_rng(0).standard_normal((2, 300, 1)) * 0.5).astype(np.float32)  # NWC
    fblk = FlaxBlock(4)
    variables = randomized_variables(fblk.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 0)
    p, s = variables["params"], variables["batch_stats"]
    assert not any("PReLU" in k for k in p)
    blk = TCNBlock(1, 4)
    with torch.no_grad():
        for i in (0, 1):
            conv = getattr(blk, f"conv{i}")
            conv.weight.copy_(torch.tensor(np.transpose(p[f"Conv_{i}"]["kernel"], (2, 1, 0))))
            conv.bias.copy_(torch.tensor(p[f"Conv_{i}"]["bias"]))
            bn = getattr(blk, f"bn{i}")
            bn.weight.copy_(torch.tensor(p[f"BatchNorm_{i}"]["scale"]))
            bn.bias.copy_(torch.tensor(p[f"BatchNorm_{i}"]["bias"]))
            bn.running_mean.copy_(torch.tensor(s[f"BatchNorm_{i}"]["mean"]))
            bn.running_var.copy_(torch.tensor(s[f"BatchNorm_{i}"]["var"]))
        y_t = blk.eval()(torch.tensor(np.transpose(x, (0, 2, 1))))
    y_j = fblk.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(y_t.numpy(), np.transpose(np.asarray(y_j), (0, 2, 1)), atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_parameter_network_bf16_matches_flax(train):
    kw = dict(channels=(8, 8, 8), kernel_size=7, dilations=(1, 2, 4), activation="prelu", mlp_hidden=16)
    T = 4096
    fnet = FlaxNet(5, **kw)
    variables = randomized_variables(fnet.init(jax.random.PRNGKey(1), jnp.zeros((2, 1, T)), train=False), 1)
    x = (np.random.default_rng(2).standard_normal((2, 1, T)) * 0.3).astype(np.float32)
    fnet16 = FlaxNet(5, **kw, dtype=jnp.bfloat16)
    if train:
        out_j, _ = fnet16.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        out_j = fnet16.apply(variables, jnp.asarray(x), train=False)
    net = ParameterNetwork(5, **kw, dtype=torch.bfloat16)
    net.load_state_dict(parameter_network_from_flax(variables, net), strict=True)
    net.train(train)
    with torch.no_grad():
        out_t = net(torch.tensor(x))
    assert out_t.dtype == torch.float32 and all(p.dtype == torch.float32 for p in net.parameters())
    err = float(np.abs(out_t.numpy() - np.asarray(out_j, np.float32)).max())
    print(f"ParameterNetwork bf16 {'train' if train else 'eval'}: port vs flax {err:.3e}")
    assert err <= BF16_TOL
    # the same net in fp32 is farther from flax's bf16 net than that
    net32 = ParameterNetwork(5, **kw)
    net32.load_state_dict(net.state_dict())
    with torch.no_grad():
        err32 = float(np.abs(net32.train(train)(torch.tensor(x)).numpy() - np.asarray(out_j, np.float32)).max())
    assert err32 > BF16_TOL


def _bands(dtype, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (2, 12)).astype(dtype), rng.uniform(0, 1, (2, 12)).astype(dtype)


def test_noise_shaped_ir_dtype_matches_jax():
    n, taps = 4096, 255
    gains, decays = _bands(np.float32)
    noise = np.random.default_rng(4).standard_normal((4, 12, n + taps - 1))
    jax.config.update("jax_enable_x64", True)
    try:
        ir_j = np.asarray(D.noise_shaped_ir(SR, jnp.asarray(gains), jnp.asarray(decays), num_samples=n,
                                            num_bandpass_taps=taps, noise=noise, dtype=jnp.float64))
        g64, d64 = _bands(np.float64)
        ir_j32 = np.asarray(D.noise_shaped_ir(SR, jnp.asarray(g64), jnp.asarray(d64), num_samples=n,
                                              num_bandpass_taps=taps, noise=noise))
    finally:
        jax.config.update("jax_enable_x64", False)
    ir_t = F.noise_shaped_ir(SR, torch.tensor(gains), torch.tensor(decays), num_samples=n,
                             num_bandpass_taps=taps, noise=torch.tensor(noise), dtype=torch.float64)
    assert ir_j.dtype == np.float64 and ir_t.dtype == torch.float64
    peak = np.abs(ir_j).max()
    assert np.abs(ir_t.numpy() - ir_j).max() <= 1e-12 * peak
    # the default: float32 filter bank and noise, float64 gains -> a float64 IR
    g64, d64 = _bands(np.float64)
    ir_t32 = F.noise_shaped_ir(SR, torch.tensor(g64), torch.tensor(d64), num_samples=n,
                               num_bandpass_taps=taps, noise=torch.tensor(noise))
    assert ir_j32.dtype == np.float64 and ir_t32.dtype == torch.float64
    assert np.abs(ir_t32.numpy() - ir_j32).max() <= 1e-6 * np.abs(ir_j32).max()
    assert np.abs(ir_t32.numpy() - ir_t.numpy()).max() > 1e-12 * peak  # float32 noise path, not float64
    gen = torch.Generator().manual_seed(0)
    ir_g = F.noise_shaped_ir(SR, torch.tensor(gains), torch.tensor(decays), num_samples=n, num_bandpass_taps=taps,
                             generator=gen, noise_mode="frequency", dtype=torch.float64)
    assert ir_g.dtype == torch.float64 and ir_g.shape == (2, 2, n)
