"""dasp_tpu_torch models and the flax -> torch converter against dasp_tpu.

The flax StyleTransferNet's variables (with random BatchNorm statistics
and PReLU slopes, so a swapped or dropped leaf shows) are converted and
loaded into the torch net; both run on the same numpy inputs. The forward
pass agrees to 1e-5 abs in eval and train mode (fp32 convolutions summed in
another order). In train mode the new BatchNorm statistics agree with
flax's ``mutable=["batch_stats"]`` update to 1e-6 abs (momentum 0.99 toward
the biased batch variance, each of the encoder's two calls in turn). With
bf16 convolutions the port keeps bf16 activations as flax does and agrees
with flax's bf16 net to 3e-6 abs in eval and train mode; the test also
measures the fp32-activation variant (bf16 convolutions cast back to fp32,
the port's earlier behaviour), which sits 8e-6 (train) and 8e-5 (eval)
away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from dasp_tpu.models import StyleTransferNet as FlaxNet
from dasp_tpu_torch.models import StyleTransferNet, style_net_from_flax
from dasp_tpu_torch.models.tcn import TCNBlock

SMALL = dict(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4))
TOL = 1e-5
STATS_TOL = 1e-6
BF16_TOL = 3e-6
FULL_WIDTH_PARAMS = 10_322_246  # counted from the flax net.init


def randomized_variables(variables, seed):
    """The flax variables with every BatchNorm statistic and PReLU slope
    redrawn (init leaves them at 0 / 1 / 0.01, which would hide a swap)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        arr = np.asarray(leaf)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, arr.shape).astype(np.float32)
        if "'mean'" in name or "negative_slope" in name or "BatchNorm" in name:
            return rng.normal(0.0, 0.3, arr.shape).astype(np.float32)
        return arr

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))


def small_pair(seed=0, T=4096):
    fnet = FlaxNet(**SMALL)
    x0 = jnp.zeros((2, 1, T), jnp.float32)
    variables = randomized_variables(fnet.init(jax.random.PRNGKey(seed), x0, x0, train=False), seed)
    tnet = StyleTransferNet(**SMALL)
    tnet.load_state_dict(style_net_from_flax(variables, tnet), strict=True)
    return fnet, variables, tnet.eval()


def test_small_net_eval_forward_matches_flax():
    fnet, variables, tnet = small_pair()
    rng = np.random.default_rng(1)
    inp = (rng.standard_normal((2, 1, 4096)) * 0.3).astype(np.float32)
    ref = (rng.standard_normal((2, 1, 4096)) * 0.3).astype(np.float32)
    out_j = fnet.apply(variables, jnp.asarray(inp), jnp.asarray(ref), train=False)
    with torch.no_grad():
        out_t = tnet(torch.tensor(inp), torch.tensor(ref))
    assert set(out_t) == set(out_j)
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=TOL, err_msg=k)


def test_encoder_concatenation_order():
    """The projectors see z = [encoder(input), encoder(reference)], one
    shared encoder for both clips."""
    _, _, tnet = small_pair()
    a, b = torch.randn(1, 1, 4096), torch.randn(1, 1, 4096)
    with torch.no_grad():
        z = torch.cat([tnet.encoder(a), tnet.encoder(b)], dim=-1)
        out = tnet(a, b)
        for name, proj in tnet.projectors.items():
            assert torch.equal(out[name], proj(z))


def test_converter_carries_every_full_width_parameter():
    """The full-width net's variable tree, by shape only (no compute), with
    random values: every leaf lands in the torch state_dict, nothing is
    missing or left over, and kernels arrive transposed."""
    fnet = FlaxNet()
    x0 = jax.ShapeDtypeStruct((1, 1, 131072), jnp.float32)
    shapes = jax.eval_shape(lambda x: fnet.init(jax.random.PRNGKey(0), x, x, train=False), x0)
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )
    n_flax = sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    assert n_flax == FULL_WIDTH_PARAMS
    tnet = StyleTransferNet()
    state = style_net_from_flax(variables, tnet)
    tnet.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in tnet.parameters()) == FULL_WIDTH_PARAMS
    p = variables["params"]
    np.testing.assert_array_equal(
        tnet.encoder.blocks[3].conv1.weight.detach().numpy(),
        p["Encoder_0"]["TCNBlock_3"]["Conv_1"]["kernel"].transpose(2, 1, 0),
    )
    np.testing.assert_array_equal(
        tnet.projectors["reverb"].dense2.weight.detach().numpy(),
        p["ParameterProjector_2"]["Dense_2"]["kernel"].T,
    )
    np.testing.assert_array_equal(
        tnet.encoder.blocks[9].bn1.running_var.numpy(),
        variables["batch_stats"]["Encoder_0"]["TCNBlock_9"]["BatchNorm_1"]["var"],
    )


def test_converter_rejects_left_over_and_missing_leaves():
    _, variables, tnet = small_pair()
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["Encoder_0"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="left over"):
        style_net_from_flax(extra, tnet)
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["batch_stats"]["Encoder_0"]["TCNBlock_1"]["BatchNorm_0"]
    with pytest.raises(ValueError, match="missing"):
        style_net_from_flax(missing, tnet)
    odd = jax.tree_util.tree_map(lambda a: a, variables)
    odd["params"]["Encoder_0"]["Pool_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unexpected flax leaf"):
        style_net_from_flax(odd)


def test_tcn_block_conventions():
    blk = TCNBlock(1, 4, kernel_size=7, dilation=2, activation="prelu")
    assert blk.prelu0.weight.item() == pytest.approx(0.01)
    assert blk.prelu0.weight.numel() == 1 and blk.bn0.eps == 1e-5
    # VALID strided dilated conv: floor((T - d (k - 1) - 1) / 2) + 1, then k - 1 less
    y = blk(torch.randn(2, 1, 100))
    assert y.shape == (2, 4, (100 - 2 * 6 - 1) // 2 + 1 - 6)


def test_bf16_encoder_runs_and_stays_close():
    _, _, tnet = small_pair()
    bnet = StyleTransferNet(**SMALL, dtype=torch.bfloat16)
    bnet.load_state_dict(tnet.state_dict())
    bnet.eval()
    x = torch.randn(2, 1, 4096) * 0.3
    with torch.no_grad():
        out32, out16 = tnet(x, x), bnet(x, x)
    for k in out32:
        assert out16[k].dtype == torch.float32
        # bf16 keeps ~3 significant digits through 6 convolutions
        np.testing.assert_allclose(out16[k].numpy(), out32[k].numpy(), atol=5e-2)
    assert all(p.dtype == torch.float32 for p in bnet.parameters())


def clips(seed=1, T=4096):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((2, 1, T)) * 0.3).astype(np.float32) for _ in range(2))


def test_train_mode_batch_stats_match_flax():
    """One train-mode forward updates the running statistics as flax does:
    running = 0.99 running + 0.01 batch, with the biased batch variance,
    once per encoder call (the shared encoder runs twice)."""
    fnet, variables, tnet = small_pair()
    inp, ref = clips()
    out_j, updates = fnet.apply(variables, jnp.asarray(inp), jnp.asarray(ref), train=True,
                                mutable=["batch_stats"])
    tnet.train()
    with torch.no_grad():
        out_t = tnet(torch.tensor(inp), torch.tensor(ref))
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=TOL, err_msg=k)
    new = style_net_from_flax({"params": variables["params"], "batch_stats": updates["batch_stats"]})
    state = tnet.state_dict()
    for k, v in new.items():
        if "running" in k:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=STATS_TOL, err_msg=k)
    assert all(int(state[k]) == 2 for k in state if k.endswith("num_batches_tracked"))


def _fp32_activation_layer(self, conv, prelu, bn, x):
    """The earlier bf16 variant: convolution outputs cast back to fp32, so
    PReLU and BatchNorm run on fp32 activations."""
    h = nnf.conv1d(x.to(self.dtype), conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                   stride=conv.stride, dilation=conv.dilation)
    return bn(prelu(h.float()))


@pytest.mark.parametrize("train", [False, True])
def test_bf16_activations_match_flax(train, monkeypatch):
    _, variables, _ = small_pair()
    inp, ref = clips()
    fnet = FlaxNet(**SMALL, dtype=jnp.bfloat16)
    if train:
        out_j, _ = fnet.apply(variables, jnp.asarray(inp), jnp.asarray(ref), train=True,
                              mutable=["batch_stats"])
    else:
        out_j = fnet.apply(variables, jnp.asarray(inp), jnp.asarray(ref), train=False)

    def max_err():
        bnet = StyleTransferNet(**SMALL, dtype=torch.bfloat16)
        bnet.load_state_dict(style_net_from_flax(variables, bnet), strict=True)
        bnet.train(train)
        with torch.no_grad():
            out_t = bnet(torch.tensor(inp), torch.tensor(ref))
        assert all(v.dtype == torch.float32 for v in out_t.values())
        return max(float(np.abs(out_t[k].numpy() - np.asarray(out_j[k], np.float32)).max()) for k in out_j)

    err = max_err()
    print(f"bf16 {'train' if train else 'eval'}: port vs flax {err:.3e}")
    assert err <= BF16_TOL
    monkeypatch.setattr(TCNBlock, "_layer", _fp32_activation_layer)
    err_fp32_act = max_err()
    print(f"fp32-activation variant vs flax {err_fp32_act:.3e}")
    assert err_fp32_act > BF16_TOL


def test_bf16_block_keeps_bf16_activations():
    blk = TCNBlock(1, 4, kernel_size=7, dilation=2, dtype=torch.bfloat16)
    for mode in (True, False):
        blk.train(mode)
        y = blk(torch.randn(2, 1, 200))
        assert y.dtype == torch.bfloat16
        assert blk.bn1.running_var.dtype == torch.float32
