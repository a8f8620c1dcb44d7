"""Training under dasp_tpu_torch.parallel against one rank and against JAX,
and the hooks that the parallel layer plugs into.

* The dp step (tests/test_parallel.py's ``test_dp_step_matches_single_device``:
  bs 8 x 2048 through ``distortion``, 5 Adam steps on the drive at 0.05) on
  4 gloo CPU ranks: the drive within 1e-5 and the losses within 1e-6 of the
  one-rank run.
* The dp x sp style step at ``test_dpsp_step_matches_dp_only``'s sizes (bs 4,
  halves of 1024, a 256-tap IR, the 8/4-channel net): the EQ's coupled
  cascade, the "parallel" smoother and the reverb's convolution
  sequence-sharded, BatchNorm over the dp ranks, the MR-STFT's sums over
  dp x sp, the gradients summed over the ranks. On dp 2 x sp 2 ranks
  against the port's one-rank step: in float64 every gradient within 1e-8
  of its scale; in fp32 the loss within 2e-5, the gradient within 3e-3 of
  its norm and the BatchNorm running statistics within 1e-5; both steps
  within tests/test_torch_train.py's fp32 bars of JAX's (flax weights
  carried by ``style_net_from_flax``, the reverb's noise injected into
  both).
* Each hook (a callable ``filter_method``, ``smoother``, ``tv_power_fn`` /
  ``tv_filter_fn``, ``ir_conv_fn``, ``reverb_ir_conv_fn``) handed a plain
  wrapper of the built-in method gives the built-in's result.
* ``parallel.spawn``: a rank that raises ends the world, and its traceback
  is raised in the caller.
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as C

SR = 44100


@pytest.fixture(scope="module")
def inputs():
    """The dp step's batch and target, the style step's flax variables, x,
    ref and the reverb's noise (numpy), and JAX's style loss, gradients and
    statistics."""
    import jax
    import jax.numpy as jnp

    import dasp_tpu as D
    from dasp_tpu.models import StyleTransferNet as FlaxNet
    from dasp_tpu.models import make_style_processors
    from dasp_tpu.parallel.sharded import _direct_causal_conv
    from dasp_tpu.utils import multi_resolution_stft_loss

    rng = np.random.default_rng(21)
    x_d = (rng.standard_normal((8, 1, 2048)) * 0.25).astype(np.float32)
    y_d = np.asarray(D.distortion(jnp.asarray(x_d), SR, jnp.full((8,), 14.0)))
    bs, half, ir = C.STYLE["bs"], C.STYLE["half"], C.STYLE["ir"]
    x = (rng.standard_normal((bs, 1, half)) * 0.25).astype(np.float32)
    ref = (rng.standard_normal((bs, 1, half)) * 0.25).astype(np.float32)
    noise = rng.standard_normal((bs * 2, 12, ir + 1022)).astype(np.float32)
    net = FlaxNet(embed_dim=8, ch_dim=4, encoder_dilations=(1, 2))
    variables = jax.device_get(net.init(jax.random.PRNGKey(0), x, x, train=False))
    procs = make_style_processors(SR, reverb_num_samples=ir, compressor_smoother="parallel",
                                  reverb_noise_mode="time", eq_filter_method="coupled",
                                  reverb_ir_conv_fn=_direct_causal_conv)

    def loss_fn(params, x, ref):
        p, upd = net.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                           jnp.mean(ref, axis=1, keepdims=True), train=True, mutable=["batch_stats"])
        y = procs["equalizer"].process_normalized(x, p["equalizer"], clip_params=True)
        y = procs["compressor"].process_normalized(y, p["compressor"], clip_params=True)
        y = procs["reverb"].process_normalized(y, p["reverb"], clip_params=True, noise=jnp.asarray(noise))
        y = procs["gain"].process_normalized(y, p["gain"], clip_params=True)
        return multi_resolution_stft_loss(y, jnp.tile(ref, (1, y.shape[1], 1)), cpu_fft_workaround=True), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"], x, ref)
    return dict(x_d=x_d, y_d=y_d, variables=variables, x=x, ref=ref, noise=noise,
                jax=(float(loss), jax.device_get(grads), jax.device_get(upd["batch_stats"])))


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    from dasp_tpu_torch.models import style_net_from_flax

    state = style_net_from_flax(inputs["variables"])
    res = C.spawn_world(2, 2, str(tmp_path_factory.mktemp("step22")), target=C.step_target,
                        args=(inputs["x_d"], inputs["y_d"], state, inputs["x"], inputs["ref"], inputs["noise"]))
    return res, state


def test_dp_step_matches_one_rank(inputs, world):
    res, _ = world
    drive1, losses1 = C.dp_distortion_run(inputs["x_d"], inputs["y_d"])
    for r in res:
        drive, losses = r["dp"]
        print(f"drive {drive:.8f} (one rank {drive1:.8f}), losses {losses} / {losses1}")
        np.testing.assert_allclose(drive, drive1, atol=1e-5)
        np.testing.assert_allclose(losses, losses1, atol=1e-6)
    assert abs(res[0]["dp"][0]) > 0.2  # the drive moved


def _check(got, want, what, loss_tol=2e-5, leaf_tol=3e-3, stats_tol=1e-5):
    """The loss, every parameter's gradient against its largest value, and
    the BatchNorm statistics."""
    g_loss, g_grads, g_stats = got
    w_loss, w_grads, w_stats = want
    np.testing.assert_allclose(g_loss, w_loss, atol=loss_tol, rtol=loss_tol, err_msg=what)
    assert sorted(g_grads) == sorted(w_grads)
    worst = {k: float(np.abs(g_grads[k] - w).max()) / max(float(np.abs(w).max()), 1e-6) for k, w in w_grads.items()}
    diff = np.sqrt(sum(float(np.sum((g_grads[k].astype(np.float64) - w) ** 2)) for k, w in w_grads.items()))
    norm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in w_grads.values()))
    stats = max(float(np.abs(g_stats[k] - w).max()) for k, w in w_stats.items())
    key = max(worst, key=worst.get)
    print(f"{what}: loss {g_loss:.10f} / {w_loss:.10f}, gradient difference {diff / norm:.2e} of the norm, "
          f"worst parameter {worst[key]:.2e} ({key}), statistics {stats:.2e}")
    if leaf_tol is None:  # fp32: the gradient as a whole (see the test)
        assert diff <= 3e-3 * norm, (what, diff / norm)
    else:
        assert worst[key] <= leaf_tol, (what, key, worst[key])
    assert stats <= stats_tol, (what, stats)


def _check_vs_jax(got, want, what):
    """tests/test_torch_train.py's fp32 bars for the port's style step
    against JAX's: the loss 1e-3 relative, the global gradient difference
    3e-2 of JAX's norm, each parameter within 0.5 of its largest gradient
    (in fp32 the two packages' gradients of the L1 log-magnitude loss, whose
    sign flips wherever the spectra cross, differ by about 1e-2 of the norm,
    and early encoder parameters, cancelling through BatchNorm, by more), the
    statistics 5e-5."""
    g_loss, g_grads, g_stats = got
    w_loss, w_grads, w_stats = want
    assert abs(g_loss - w_loss) <= 1e-3 * abs(w_loss), (what, g_loss, w_loss)
    diff = np.sqrt(sum(float(np.sum((g_grads[k].astype(np.float64) - w) ** 2)) for k, w in w_grads.items()))
    norm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in w_grads.values()))
    leaf = max(float(np.abs(g_grads[k] - w).max() / max(np.abs(w).max(), 1e-12)) for k, w in w_grads.items())
    stats = max(float(np.abs(g_stats[k] - w).max()) for k, w in w_stats.items())
    print(f"{what}: loss {g_loss:.8f} / {w_loss:.8f}, gradient difference {diff / norm:.2e} of the norm, "
          f"worst parameter {leaf:.2e}, statistics {stats:.2e}")
    assert diff <= 3e-2 * norm and leaf <= 0.5 and stats <= 5e-5, what


def test_dpsp_style_step_matches_one_rank_and_jax(inputs, world):
    """dp 2 x sp 2 against the port's one-rank step, and both against JAX's
    at tests/test_torch_train.py's fp32 bars.

    Against one rank: in float64 the loss to 1e-12 and every parameter's
    gradient to 1e-8 of its largest value; in fp32 the loss within 2e-5 and
    the gradient within 3e-3 of its norm (tests/test_parallel.py's bars). In
    fp32 a parameter whose gradient cancels through the next BatchNorm
    (block 0's second BatchNorm bias, 3e-4 against the largest gradient's
    0.5) moves by up to 1e-2 of its own scale with the order of the batch's
    sums (the dp ranks sum their slices, then the ranks' sums), so the fp32
    bar is on the gradient as a whole."""
    from dasp_tpu_torch.models import style_net_from_flax

    res, state = world
    one = C.style_grads(state, inputs["x"], inputs["ref"], inputs["noise"])
    j_loss, j_grads, j_stats = inputs["jax"]
    jg = {k: v.numpy() for k, v in style_net_from_flax({"params": j_grads}).items()
          if not k.endswith("num_batches_tracked")}
    js = {k: v.numpy() for k, v in style_net_from_flax(
        {"params": inputs["variables"]["params"], "batch_stats": j_stats}).items() if "running" in k}
    _check_vs_jax(one, (j_loss, jg, js), "one rank vs JAX")
    one64 = C.style_grads(state, inputs["x"], inputs["ref"], inputs["noise"], dtype=torch.float64)
    for r in res:
        _check(r["style float64"], one64, "float64: dp 2 x sp 2 vs one rank", 1e-12, 1e-8, 1e-12)
        _check(r["style"], one, "fp32: dp 2 x sp 2 vs one rank", leaf_tol=None)
        _check_vs_jax(r["style"], (j_loss, jg, js), "dp 2 x sp 2 vs JAX")


# ---------------------------------------------------------------------------
# the hooks


def _hook_cases():
    import dasp_tpu_torch.functional as F
    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch.models import make_style_processors
    from dasp_tpu_torch.ops import ballistics_smooth, fft_conv_causal, sosfilt_coupled
    from dasp_tpu_torch.ops.tv_filter import tv_freq_filter, tv_stft

    rng = np.random.default_rng(31)
    x = torch.tensor(rng.standard_normal((2, 2, 8192)).astype(np.float32) * 0.3)
    noise = torch.tensor(rng.standard_normal((4, 12, 2048 + 1022)).astype(np.float32))
    t = torch.tensor
    cpl = lambda sos, x: sosfilt_coupled(sos, x)  # noqa: E731
    filt = lambda x, H, fs, hop: tv_freq_filter(x, H, fs, hop)  # noqa: E731

    def power(x, fs, hop, n_fft):
        X = tv_stft(x, fs, hop, n_fft)
        return (X.real ** 2 + X.imag ** 2).mean(dim=1)

    rev = [0.5] * 25
    eq = (2.0, 200.0, 0.7, 3.0, 400.0, 1.0, -2.0, 3000.0, 2.0, 1.0, 9000.0, 1.0, 2.0, 13000.0, 1.0, -3.0, 8000.0, 0.7)
    return {
        "filter_method": (lambda fm: F.parametric_eq(x, SR, *eq, filter_method=fm), "coupled", cpl, 0),
        "first-order filter_method": (lambda fm: F.advanced_distortion(x, SR, 12.0, 0.0, 0.4, 0.1, filter_method=fm),
                                      "coupled", cpl, 0),
        "smoother": (lambda s: F.compressor(x, SR, -24.0, 4.0, 5.0, 80.0, 6.0, 0.0, smoother=s), "parallel",
                     lambda g, aa, ar: ballistics_smooth(g, aa, ar, mode="parallel"), 0),
        "spectral_gate": (lambda h: F.spectral_gate(x, SR, t([6.0, 8.0]), t([24.0, 18.0]), t([5.0, 10.0]),
                                                    t([80.0, 120.0]), frame_size=1024, hop=256, **h),
                          {}, {"tv_power_fn": power, "tv_filter_fn": filt}, 1e-6),
        "dynamic_eq": (lambda h: F.dynamic_eq(x, SR, t([[300.0, 2000.0], [500.0, 4000.0]]), 2.0, -30.0, 4.0, 5.0,
                                              80.0, frame_size=512, hop=128, **h),
                       {}, {"tv_power_fn": power, "tv_filter_fn": filt}, 1e-6),
        "phaser": (lambda h: F.phaser(x, SR, t([1.0, 2.0]), t([0.5, 0.5]), t([800.0, 1200.0]), t([0.4, 0.2]),
                                      t([0.5, 0.5]), **h), {}, {"tv_filter_fn": filt}, 0),
        "auto_wah": (lambda h: F.auto_wah(x, SR, t([5.0, 8.0]), t([10.0, 20.0]), t([80.0, 120.0]),
                                          t([300.0, 400.0]), t([2000.0, 3000.0]), t([2.0, 4.0]), t([0.5, 0.5]), **h),
                     {}, {"tv_filter_fn": filt}, 0),
        "ir_conv_fn": (lambda h: F.noise_shaped_reverberation(x, SR, *rev, num_samples=2048, noise=noise, **h),
                       {}, {"ir_conv_fn": lambda x, ir: fft_conv_causal(x, ir)}, 0),
        "NoiseShapedReverb ir_conv_fn": (
            lambda h: M.NoiseShapedReverb(SR, num_samples=2048, **h).process_normalized(
                x, torch.full((2, 25), 0.5), noise=noise), {}, {"ir_conv_fn": lambda x, ir: fft_conv_causal(x, ir)}, 0),
        "reverb_ir_conv_fn": (
            lambda h: make_style_processors(SR, reverb_num_samples=2048, **h)["reverb"].process_normalized(
                x, torch.full((2, 25), 0.5), noise=noise),
            {}, {"reverb_ir_conv_fn": lambda x, ir: fft_conv_causal(x, ir)}, 0),
    }


HOOKS = ["filter_method", "first-order filter_method", "smoother", "spectral_gate", "dynamic_eq", "phaser",
         "auto_wah", "ir_conv_fn", "NoiseShapedReverb ir_conv_fn", "reverb_ir_conv_fn"]


@pytest.mark.parametrize("hook", HOOKS)
def test_hook_takes_a_callable(hook):
    """Bitwise where the wrapper runs the built-in's very call; the WOLA
    effects split under a hook (the power from the hook, one filter pass
    that transforms again) and agree to roundoff."""
    run, builtin, wrapper, tol = _hook_cases()[hook]
    want = run(builtin)
    got = run(wrapper)
    assert got.shape == want.shape
    if tol == 0:
        assert torch.equal(got, want), hook
    else:
        err = float((got - want).abs().max())
        assert err <= tol * max(1.0, float(want.abs().max())), (hook, err)


def test_a_failing_rank_ends_the_world(tmp_path):
    """parallel.spawn: a rank that raises ends the world (its peer, waiting
    in a collective, is terminated) and its traceback is raised here."""
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank one fails"):
        C.spawn_world(1, 2, str(tmp_path), target=C.fails_on_rank_one, args=())
