"""One whole style-transfer training step, dasp_tpu_torch against dasp_tpu.

The JAX step is built here from the package's own parts, as bench.py's
``_step_core`` builds it: the random EQ -> compressor -> reverb corruption,
peak normalization and gains, the A/B split, the flax net in train mode
(``mutable=["batch_stats"]``), the render, the default MR-STFT loss,
``jax.value_and_grad`` and ``optax.adam(1e-4)``; EQ ``"pallas"`` and
compressor ``"exact_pallas"`` run their Pallas kernels in interpret mode.
The port runs ``dasp_tpu_torch.train.train_step`` with the same converted
weights, clips, corruption parameters and injected reverb noise (numpy,
from a seed), its kernels' plain versions and their adjoint formulas.
Smoke size: StyleTransferNet(embed_dim=32, ch_dim=8, encoder_dilations=(1,
2, 4)), bs 2, 4096-sample clips (2048-sample halves), a 2048-tap IR.

The JAX side is jitted in two parts, the DSP chain with its loss (shared by
the fp32 and bf16 cases) and the net; the chain rule joins them.

Tolerances, fp32. Float64 settles the semantics: the port's step in float64
(plain engines) matches JAX's float64 step (scan-based EQ and ballistics,
the same formulas) to 1e-8 in the loss and 1e-5 of each parameter's largest
gradient (test_train_step_matches_jax_in_float64). In fp32 both packages
carry the block-Toeplitz EQ's error (about 1e-3 of the signal, the bound of
tests/test_pallas_iir.py) through the corruption and the render, and the
L1 log-magnitude loss has a gradient that flips sign in every bin where the
two spectra cross, so both fp32 steps sit about 1.3e-2 (global gradient
norm) from the float64 step, and single parameters of the early encoder
layers, whose gradients cancel through train-mode BatchNorm, up to about a
quarter of their largest gradient.
Hence, in fp32:

* loss: 1e-3 relative to JAX's, and no farther from the float64 step than
  twice JAX's distance;
* gradients: the global difference 3e-2 of JAX's gradient norm, the
  gradient norms 1e-2 apart (MULTICHIP_r05's measure), and the port's
  global distance to the float64 step no more than twice JAX's; each
  parameter within 0.5 of its largest JAX gradient (a guard against a
  dropped or misrouted gradient, which is 1 away);
* new BatchNorm statistics: 5e-5 absolute (the second encoder call sees
  the corrupted reference, which carries the EQ's error);
* Adam: the port's optimizer applied to JAX's gradients gives JAX's
  updated parameters to 1e-7 (a few ulps). End to end, Adam's first step
  moves an element by lr g / (|g| + eps), i.e. by +-lr wherever |g| >> eps,
  so the two updated nets differ by at most 2 lr per element, and by more
  than 1e-6 on at most 2% of the elements (tiny gradients of either sign).

bf16 (encoder convolutions and activations in bf16 in both packages): the
loss 2e-3 relative, the global gradient difference 6e-2, the gradient
norms 2e-2 apart, batch statistics 5e-3 absolute; Adam as above, with up
to 5% of the elements more than 1e-6 apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dasp_tpu as D
from dasp_tpu.models import StyleTransferNet as FlaxNet
from dasp_tpu.utils import multi_resolution_stft_loss as j_mrstft
from dasp_tpu_torch import train as TR
from dasp_tpu_torch.models import style_net_from_flax

SR = 44100
BS = 2
T = 4096
IR = TR.SMOKE_IR
TAPS = 1023
LR = 1e-4


def make_batch(seed=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((BS, 1, T)) * 0.25).astype(dtype)
    rand = {
        "eq": rng.uniform(0, 1, (BS, 18)),
        "comp": rng.uniform(0, 1, (BS, 6)),
        "reverb": rng.uniform(0, 1, (BS, 25)),
        "g1": rng.uniform(0, 24, (BS, 1, 1)),
        "g2": rng.uniform(0, 24, (BS, 1, 1)),
    }
    rand = {k: v.astype(dtype) for k, v in rand.items()}
    noise = tuple(rng.standard_normal((BS * 2, 12, IR + TAPS - 1)).astype(dtype) for _ in range(2))
    return x, rand, noise


def flax_variables(dtype=None, cast=np.float32):
    fnet = FlaxNet(**TR.SMOKE_NET, dtype=dtype)
    x0 = jnp.zeros((BS, 1, T // 2))
    variables = jax.device_get(fnet.init(jax.random.PRNGKey(0), x0, x0, train=False))
    return fnet, jax.tree_util.tree_map(lambda a: np.asarray(a, cast), variables)


class JaxStep:
    """bench.py's _step_core from the JAX package's parts, jitted as the
    corruption, the DSP chain with its loss, and the net."""

    def __init__(self, eq="pallas", comp="exact_pallas"):
        jp = D.models.make_style_processors(
            SR, reverb_num_samples=IR, eq_filter_method=eq, compressor_smoother=comp
        )

        def corrupt(x, r, noise):
            ref = jp["equalizer"].process_normalized(x, r["eq"], clip_params=True)
            ref = jp["compressor"].process_normalized(ref, r["comp"], clip_params=True)
            ref = jp["reverb"].process_normalized(ref, r["reverb"], clip_params=True, noise=noise)
            peak = jnp.max(jnp.abs(ref), axis=-1, keepdims=True)
            ref = ref / (peak + 1e-9)
            ref = ref * 10.0 ** (-r["g1"] / 20.0)
            x = x * 10.0 ** (-r["g2"] / 20.0)
            input_a, _ = jnp.split(x, 2, axis=-1)
            ref_a, ref_b = jnp.split(ref, 2, axis=-1)
            return input_a, ref_a, ref_b

        def dsp_loss(p, input_a, ref_a, noise):
            y = jp["equalizer"].process_normalized(input_a, p["equalizer"], clip_params=True)
            y = jp["compressor"].process_normalized(y, p["compressor"], clip_params=True)
            y = jp["reverb"].process_normalized(y, p["reverb"], clip_params=True, noise=noise)
            y = jp["gain"].process_normalized(y, p["gain"], clip_params=True)
            return j_mrstft(y, ref_a)

        self.corrupt = jax.jit(corrupt)
        self.dsp = jax.jit(jax.value_and_grad(dsp_loss))

    def __call__(self, fnet, variables, x, rand, noise):
        input_a, ref_a, ref_b = self.corrupt(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in rand.items()}, jnp.asarray(noise[0])
        )
        params, stats = variables["params"], variables["batch_stats"]

        def net_fn(p):
            out, upd = fnet.apply({"params": p, "batch_stats": stats}, input_a,
                                  jnp.mean(ref_b, axis=1, keepdims=True),
                                  train=True, mutable=["batch_stats"])
            return out, upd["batch_stats"]

        out, net_vjp, new_stats = jax.vjp(jax.jit(net_fn), params, has_aux=True)
        loss, d_out = self.dsp(out, input_a, ref_a, jnp.asarray(noise[1]))
        (grads,) = net_vjp(d_out)
        opt = optax.adam(LR)
        updates, _ = opt.update(grads, opt.init(params))
        new_params = optax.apply_updates(params, updates)
        return jax.device_get((loss, grads, new_stats, new_params))


@pytest.fixture(scope="module")
def jax_step():
    return JaxStep()


def torch_step(variables, x, rand, noise, dtype, torch_dtype=torch.float32, eq="pallas", comp="exact_pallas"):
    net, procs, opt = TR.make_style_training(SR, smoke=True, dtype=dtype, device="cpu",
                                             eq_filter_method=eq, compressor_smoother=comp)
    net.load_state_dict(style_net_from_flax(variables, net), strict=True)
    net.to(torch_dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch_dtype)  # noqa: E731
    loss = TR.train_step(net, procs, opt, t(x), {k: t(v) for k, v in rand.items()},
                         noise=tuple(t(n) for n in noise))
    grads = {k: p.grad for k, p in net.named_parameters()}
    return float(loss), grads, net


def norm(tree):
    return float(torch.sqrt(sum((v.double() ** 2).sum() for v in tree.values())))


def flat_grads(grads_tree):
    """A flax gradient tree under the torch parameter names, float64."""
    return {k: v.double() for k, v in style_net_from_flax({"params": grads_tree}).items()}


def check_step(variables, jax_out, torch_out, bounds, record_property):
    loss_j, grads_j, stats_j, params_j = jax_out
    loss_t, grads_t, net = torch_out
    gj = flat_grads(grads_j)
    gt = {k: grads_t[k].double() for k in gj}
    loss_rel = abs(loss_t - float(loss_j)) / abs(float(loss_j))
    diff_rel = norm({k: gt[k] - gj[k] for k in gj}) / norm(gj)
    gnorm_rel = abs(norm(gt) - norm(gj)) / norm(gj)
    leaf = {k: float((gt[k] - gj[k]).abs().max() / gj[k].abs().max()) for k in gj}
    new = style_net_from_flax({"params": params_j, "batch_stats": stats_j})
    state = net.state_dict()
    stats_err = max(float((state[k].double() - new[k].double()).abs().max())
                    for k in new if "running" in k)
    moved, n = 0, 0
    for k in gj:
        d = (state[k].double() - new[k].double()).abs()
        assert float(d.max()) <= 2 * LR + 1e-6, k
        moved += int((d > 1e-6).sum())
        n += d.numel()
    # the port's Adam on JAX's gradients
    ref_net, _, ref_opt = TR.make_style_training(SR, smoke=True, dtype=None, device="cpu")
    ref_net.load_state_dict(style_net_from_flax(variables, ref_net), strict=True)
    for k, p in ref_net.named_parameters():
        p.grad = gj[k].float()
    ref_opt.step()
    ref_state = ref_net.state_dict()
    adam_err = max(float((ref_state[k].double() - new[k].double()).abs().max()) for k in gj)
    report = dict(loss_rel=loss_rel, grad_diff_rel=diff_rel, grad_norm_rel=gnorm_rel,
                  worst_leaf=max(leaf.values()), stats_err=stats_err,
                  adam_err=adam_err, adam_moved=moved / n)
    for key, v in report.items():
        record_property(key, v)
    print(report)
    assert loss_rel <= bounds["loss"]
    assert diff_rel <= bounds["grad_diff"]
    assert gnorm_rel <= bounds["grad_norm"]
    assert max(leaf.values()) <= bounds["leaf"], max(leaf, key=leaf.get)
    assert stats_err <= bounds["stats"]
    assert adam_err <= 1e-7
    assert moved / n <= bounds["moved"]
    return gt, gj


def test_train_step_matches_jax_fp32(jax_step, record_property):
    x, rand, noise = make_batch()
    fnet, variables = flax_variables()
    jax_out = jax_step(fnet, variables, x, rand, noise)
    torch_out = torch_step(variables, x, rand, noise, dtype=None)
    bounds = dict(loss=1e-3, grad_diff=3e-2, grad_norm=1e-2, leaf=0.5, stats=5e-5, moved=0.02)
    gt, gj = check_step(variables, jax_out, torch_out, bounds, record_property)

    # the float64 step through the port's plain engines: no farther from it
    # than twice the JAX package
    loss64, g64, _ = torch_step(variables, x, rand, noise, dtype=None, torch_dtype=torch.float64)
    g64 = {k: g64[k] for k in gj}
    loss_t, loss_j = torch_out[0], float(jax_out[0])
    assert abs(loss_t - loss64) <= 2 * abs(loss_j - loss64) + 1e-7
    d_t = norm({k: gt[k] - g64[k] for k in gj})
    d_j = norm({k: gj[k] - g64[k] for k in gj})
    print(f"distance to the float64 step: port {d_t / norm(g64):.3e}, JAX {d_j / norm(g64):.3e}")
    assert d_t <= 2 * d_j


def test_train_step_matches_jax_block_fp32(record_property):
    """The JAX bench's own configuration (bench.py): EQ "block" and
    compressor "block" in both packages, under the fp32 bounds above."""
    x, rand, noise = make_batch(seed=7)
    fnet, variables = flax_variables()
    jax_out = JaxStep(eq="block", comp="block")(fnet, variables, x, rand, noise)
    torch_out = torch_step(variables, x, rand, noise, dtype=None, eq="block", comp="block")
    bounds = dict(loss=1e-3, grad_diff=3e-2, grad_norm=1e-2, leaf=0.5, stats=5e-5, moved=0.02)
    check_step(variables, jax_out, torch_out, bounds, record_property)


def test_train_step_matches_jax_bf16(jax_step, record_property):
    x, rand, noise = make_batch(seed=6)
    fnet, variables = flax_variables(dtype=jnp.bfloat16)
    jax_out = jax_step(fnet, variables, x, rand, noise)
    torch_out = torch_step(variables, x, rand, noise, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in torch_out[2].parameters())
    bounds = dict(loss=2e-3, grad_diff=6e-2, grad_norm=2e-2, leaf=0.5, stats=5e-3, moved=0.05)
    check_step(variables, jax_out, torch_out, bounds, record_property)


@pytest.mark.parametrize("entry", ["make_style_training", "make_blind_estimation"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device named, an entry point builds on the CUDA card: where
    there is none it raises instead of building on the CPU; the CPU runs
    only when named."""
    from dasp_tpu_torch import train as TR
    from dasp_tpu_torch.modules import PitchShift

    args = {"make_style_training": (SR,), "make_blind_estimation": (PitchShift(SR),)}[entry]
    kw = {"smoke": True} if entry == "make_style_training" else {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(TR, entry)(*args, **kw)
    net = getattr(TR, entry)(*args, device="cpu", **kw)[0]
    assert all(p.device.type == "cpu" for p in net.parameters())
