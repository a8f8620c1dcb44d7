"""Blind estimation, dasp_tpu_torch against dasp_tpu: the ParameterNetwork
and its flax converter, and one whole estimation step.

The network: the flax ParameterNetwork's variables (BatchNorm statistics and
PReLU slopes redrawn, so a swapped or dropped leaf shows) are converted with
``parameter_network_from_flax`` and loaded; both nets run on the same numpy
clips. Outputs agree to 1e-6 abs in eval and train mode and the new
BatchNorm statistics to 1e-6 (fp32 convolutions summed in another order).
The blind-estimation preset runs at full width on 4096-sample clips; the
auto-EQ preset, whose ten kernel-7 blocks need about 70k samples, runs at 8
channels on 131072-sample clips, and its full width is counted by shape.

The step: ``train.blind_estimation_step`` against the step of
examples/blind_estimation.py built here from the package's parts (the flax
``ParameterNetwork.blind_estimation`` preset in train mode, ``PitchShift``
or ``Chorus`` with its default ``adjoint="auto"``, the default
``stft_loss``, ``optax.adam(1e-4)``), at the example's ``--smoke`` size: bs
2, 16384-sample mono clips, the same converted weights, clips and random
parameters. JAX on the CPU runs the dense tiled contraction; the port in
fp32 runs the plain engine of its fractional-delay kernel, and in float64
the dense plain version.

Tolerances. float64 (the flax head's cast of its input to float32
reproduced on the port's side): the loss 1e-12 relative, each parameter's
gradient 1e-9 of its largest value, the new BatchNorm statistics 1e-10 and
the mean parameter error 1e-12 absolute, and Adam's update equal to 1e-9
(measured: 5e-15, 5e-11, 5e-11, 0). fp32 is far from float64 here: the
renders carry about 2e-3 of their peak (the pitch shifter's sawtooth phase
u = (1 - r) n / W rounds by an ulp of u, which the window W turns into 1e-3
samples of delay), and the L1 log-magnitude loss weights every bin by
1 / |Y|, so its quietest bins, the most sensitive to that error, steer the
gradient: both packages' fp32 gradients sit 0.5 to 1.7 of the gradient norm
from the float64 step (measured at this size). The port is therefore held to
the float64 step: its global gradient distance at most twice JAX's plus
1e-3 of the norm, and its loss no farther than twice JAX's plus 1e-6
relative; against JAX's fp32 step directly, the loss within 2e-3 relative,
the mean parameter error and the BatchNorm statistics 1e-4 absolute;
and the port's Adam on JAX's gradients gives JAX's updated parameters to
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dasp_tpu as D
from dasp_tpu.models import ParameterNetwork as FlaxNet
from dasp_tpu.utils import stft_loss as j_stft_loss
from dasp_tpu_torch import modules as M
from dasp_tpu_torch import train as TR
from dasp_tpu_torch.models import ParameterNetwork, parameter_network_from_flax, tcn
from test_torch_models import randomized_variables

SR = 44100
BS = 2
T = 16384  # examples/blind_estimation.py --smoke
LR = 1e-4
TOL = 1e-6
BLIND_PARAMS = {2: 198_354, 4: 198_612}  # counted from flax init
BLIND_STATS = 1_472


def clip(T, seed=1, bs=BS):
    return (np.random.default_rng(seed).standard_normal((bs, 1, T)) * 0.3).astype(np.float32)


def make_pair(preset, num_params, T, seed=0, **kw):
    fnet = getattr(FlaxNet, preset)(num_params, **kw)
    variables = randomized_variables(
        fnet.init(jax.random.PRNGKey(seed), jnp.zeros((BS, 1, T)), train=False), seed)
    tnet = getattr(ParameterNetwork, preset)(num_params, **kw)
    tnet.load_state_dict(parameter_network_from_flax(variables, tnet), strict=True)
    return fnet, variables, tnet


PRESETS = [("blind_estimation", {}, 4096), ("auto_eq", {"ch_dim": 8}, 131072)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("preset,kw,T_in", PRESETS, ids=[p[0] for p in PRESETS])
def test_parameter_network_matches_flax(preset, kw, T_in, train):
    fnet, variables, tnet = make_pair(preset, 3, T_in, **kw)
    x = clip(T_in)
    tnet.train(train)
    with torch.no_grad():
        out_t = tnet(torch.tensor(x))
    if train:
        out_j, upd = fnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        new = parameter_network_from_flax({"params": variables["params"], "batch_stats": upd["batch_stats"]})
        state = tnet.state_dict()
        stats = [k for k in new if "running" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(state[k].numpy(), new[k].numpy(), atol=TOL, err_msg=k)
    else:
        out_j = fnet.apply(variables, jnp.asarray(x), train=False)
    assert out_t.shape == (BS, 3) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL)


@pytest.mark.parametrize("preset", ["blind_estimation", "auto_eq"])
@pytest.mark.parametrize("num_params", [2, 4])
def test_parameter_counts_and_converter_at_full_width(preset, num_params):
    """The full-width variable tree by shape (no compute), random values:
    every leaf lands once, the counts match, kernels arrive transposed."""
    fnet = getattr(FlaxNet, preset)(num_params)
    x0 = jax.ShapeDtypeStruct((1, 1, 131072), jnp.float32)
    shapes = jax.eval_shape(lambda x: fnet.init(jax.random.PRNGKey(0), x, train=False), x0)
    rng = np.random.default_rng(num_params)
    variables = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    n_flax = sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    n_stats = sum(v.size for v in jax.tree_util.tree_leaves(variables["batch_stats"]))
    tnet = getattr(ParameterNetwork, preset)(num_params)
    tnet.load_state_dict(parameter_network_from_flax(variables, tnet), strict=True)
    assert sum(p.numel() for p in tnet.parameters()) == n_flax
    assert sum(b.numel() for n, b in tnet.named_buffers() if "running" in n) == n_stats
    if preset == "blind_estimation":
        assert (n_flax, n_stats) == (BLIND_PARAMS[num_params], BLIND_STATS)
        assert not any("prelu" in k for k in tnet.state_dict())  # a ReLU net
    head = f"Dense_{tnet.num_dense - 1}"
    np.testing.assert_array_equal(tnet.get_submodule(f"dense{tnet.num_dense - 1}").weight.detach().numpy(),
                                  variables["params"][head]["kernel"].T)
    np.testing.assert_array_equal(tnet.blocks[4].conv1.weight.detach().numpy(),
                                  variables["params"]["TCNBlock_4"]["Conv_1"]["kernel"].transpose(2, 1, 0))


def test_converter_rejects_left_over_and_missing_leaves():
    _, variables, tnet = make_pair("blind_estimation", 2, 4096)
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["Dense_1"] = {"kernel": np.zeros((2, 2), np.float32), "bias": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="left over|missing|unexpected"):
        parameter_network_from_flax(extra, tnet)
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["batch_stats"]["TCNBlock_2"]["BatchNorm_1"]
    with pytest.raises(ValueError, match="missing"):
        parameter_network_from_flax(missing, tnet)
    with pytest.raises(ValueError, match="activation"):
        ParameterNetwork(2, activation="gelu")


# ---------------------------------------------------------------------------
# one blind-estimation step
# ---------------------------------------------------------------------------

PROCS = {"PitchShift": (M.PitchShift, D.PitchShift), "Chorus": (M.Chorus, D.Chorus)}
_JAX = {}


def batch(num_params, dtype=np.float32):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((BS, 1, T)) * 0.25).astype(dtype)
    return x, rng.uniform(0, 1, (BS, num_params)).astype(dtype)


def jax_step(name, dtype):
    """The example's step from the package's parts: (loss, grads, new
    batch statistics, new params, param_l1, initial variables)."""
    if (name, dtype) in _JAX:
        return _JAX[name, dtype]
    jproc = PROCS[name][1](SR)
    fnet = FlaxNet.blind_estimation(jproc.num_params)
    x, rp = batch(jproc.num_params, dtype)
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        variables = jax.device_get(fnet.init(jax.random.PRNGKey(0), jnp.zeros((BS, 1, T)), train=False))
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        opt = optax.adam(LR)

        @jax.jit
        def step(params, stats, x, rp):
            y = jproc.process_normalized(x, rp, clip_params=True)

            def loss_fn(params):
                p_hat, upd = fnet.apply({"params": params, "batch_stats": stats}, y, train=True,
                                        mutable=["batch_stats"])
                y_hat = jproc.process_normalized(x, p_hat, clip_params=True)
                return j_stft_loss(y_hat, y), (upd["batch_stats"], p_hat)

            (loss, (new_stats, p_hat)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = opt.update(grads, opt.init(params))
            return loss, grads, new_stats, optax.apply_updates(params, updates), jnp.mean(jnp.abs(p_hat - rp))

        out = jax.device_get(step(variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(rp)))
    finally:
        jax.config.update("jax_enable_x64", False)
    _JAX[name, dtype] = (*out, variables)
    return _JAX[name, dtype]


def port_step(name, variables, torch_dtype, data_dtype=np.float32):
    """The port's step on the clips and parameters of ``batch(data_dtype)``."""
    proc = PROCS[name][0](SR)
    x, rp = batch(proc.num_params, data_dtype)
    net, opt = TR.make_blind_estimation(proc, device="cpu")
    net.load_state_dict(parameter_network_from_flax(variables, net), strict=True)
    net.to(torch_dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch_dtype)  # noqa: E731
    loss, param_l1 = TR.blind_estimation_step(net, proc, opt, t(x), t(rp))
    assert loss.dtype == torch_dtype
    grads = {k: p.grad.double() for k, p in net.named_parameters()}
    return float(loss), float(param_l1), grads, net


def norm(tree):
    return float(torch.sqrt(sum((v.double() ** 2).sum() for v in tree.values())))


@pytest.mark.parametrize("name", list(PROCS))
def test_blind_step_matches_jax_in_float64(name, monkeypatch):
    # the flax head casts its input to float32 whatever the run's dtype
    # (h.astype(jnp.float32)); round it the same way here so that the rest
    # of the step is compared in float64
    monkeypatch.setattr(tcn, "_at_least_f32",
                        lambda h: h.float().to(torch.promote_types(h.dtype, torch.float32)))
    loss_j, grads_j, stats_j, params_j, l1_j, variables = jax_step(name, np.float64)
    loss_t, l1_t, grads_t, net = port_step(name, variables, torch.float64, np.float64)
    gj = parameter_network_from_flax({"params": grads_j}, dtype=torch.float64)
    leaf = {k: float((grads_t[k] - g).abs().max() / g.abs().max()) for k, g in gj.items()}
    worst = max(leaf.values())
    new = parameter_network_from_flax({"params": params_j, "batch_stats": stats_j}, dtype=torch.float64)
    state = net.state_dict()
    stats_err = max(float((state[k] - v).abs().max()) for k, v in new.items() if "running" in k)
    moved = sum(int(((state[k] - new[k]).abs() > 1e-9).sum()) for k in gj)
    print(f"{name} float64: loss rel {abs(loss_t - loss_j) / loss_j:.3e}, worst gradient {worst:.3e} "
          f"of its max, batch stats {stats_err:.3e}, param_l1 {abs(l1_t - l1_j):.3e}, Adam {moved} apart")
    assert abs(loss_t - float(loss_j)) <= 1e-12 * abs(float(loss_j))
    assert worst <= 1e-9
    assert stats_err <= 1e-10
    assert abs(l1_t - float(l1_j)) <= 1e-12
    assert moved == 0


@pytest.mark.parametrize("name", list(PROCS))
def test_blind_step_matches_jax_fp32(name):
    loss_j, grads_j, stats_j, params_j, l1_j, variables = jax_step(name, np.float32)
    loss_t, l1_t, grads_t, net = port_step(name, variables, torch.float32)
    loss64, _, g64, _ = port_step(name, variables, torch.float64)
    gj = {k: v.double() for k, v in parameter_network_from_flax({"params": grads_j}).items()}
    gt = {k: grads_t[k] for k in gj}
    n64 = norm(g64)
    d_t, d_j = norm({k: gt[k] - g64[k] for k in gj}), norm({k: gj[k] - g64[k] for k in gj})
    loss_j = float(loss_j)
    print(f"{name} fp32: loss port {loss_t:.7f} JAX {loss_j:.7f} float64 {loss64:.7f}; gradient distance "
          f"to float64 port {d_t / n64:.3e} JAX {d_j / n64:.3e} of its norm; norms "
          f"port {norm(gt):.6f} JAX {norm(gj):.6f} float64 {n64:.6f}")
    assert abs(loss_t - loss64) <= 2 * abs(loss_j - loss64) + 1e-6 * loss64
    assert d_t <= 2 * d_j + 1e-3 * n64
    assert abs(loss_t - loss_j) <= 2e-3 * loss_j
    print(f"param_l1 {abs(l1_t - float(l1_j)):.3e}")
    assert abs(l1_t - float(l1_j)) <= 1e-4
    new = parameter_network_from_flax({"params": params_j, "batch_stats": stats_j})
    state = net.state_dict()
    stats_err = max(float((state[k] - v).abs().max()) for k, v in new.items() if "running" in k)
    print(f"batch stats {stats_err:.3e}")
    assert stats_err <= 1e-4
    # the port's Adam on JAX's gradients
    ref_net, ref_opt = TR.make_blind_estimation(PROCS[name][0](SR), device="cpu")
    ref_net.load_state_dict(parameter_network_from_flax(variables, ref_net), strict=True)
    for k, p in ref_net.named_parameters():
        p.grad = gj[k].float()
    ref_opt.step()
    ref_state = ref_net.state_dict()
    assert max(float((ref_state[k] - new[k]).abs().max()) for k in gj) <= 1e-7
