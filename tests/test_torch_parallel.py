"""dasp_tpu_torch.parallel against dasp_tpu.parallel.

The port's sequence-sharded functions run in gloo CPU ranks
(tests/torch_parallel_cases.py: one world per (dp, sp) shape, every case in
it); the JAX package's run in this process on conftest's 8-device virtual
mesh, over ``jax.devices()[:dp * sp]``. The same numpy inputs go to both,
and rank r = d * sp + j's block (batch slice d, time block j) is held
against JAX's global result at that block. Shapes (dp, sp) in {(1, 2),
(1, 4), (2, 2)}; tolerances are tests/test_parallel.py's for each function
(conv 1e-4; coupled EQ 5e-4, its gradients 1e-5 and 1e-2 of scale;
"parallel" 2e-5 rtol / 2e-4; tv filter 2e-5, its gradients 1e-3; tv power
2e-4 of its peak; the WOLA effects 2e-5 of max(1, scale), their input
gradients 1e-4 relative; the loss 1e-6 rtol, its gradient 1e-3 relative).
The exact relay is bitwise the port's own unsharded ``ballistics_pallas``
(its plain engine here), one forward and one backward a rank, and within
2e-6 of the peak of JAX's (1.3e-6 on this curve: XLA:CPU's FMAs). The gradient of each function is held against
JAX's unsharded gradient where tests/test_parallel.py holds JAX's sharded
one against it (the exact ballistics' at 1e-5 of scale, the bar of the
port's unsharded kernel against JAX's; the loss's in float64, since in fp32
the two packages' gradients of the log-magnitude terms on noise differ by
about 1 % in l2).
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as C

SHAPES = [(1, 2), (1, 4), (2, 2)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"dp{s[0]}sp{s[1]}")
def world(request, tmp_path_factory):
    dp, sp = request.param
    res = C.spawn_world(dp, sp, str(tmp_path_factory.mktemp(f"world{dp}{sp}")))
    return dp, sp, res


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from dasp_tpu import parallel as JP

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return jax, jnp, JP


def jmesh(jx, dp, sp):
    jax, _, JP = jx
    return JP.make_mesh((dp, sp), devices=jax.devices()[: dp * sp])


def assemble(res, get, dp, sp):
    """The global array from the ranks' blocks (batch slices on axis 0,
    time blocks on the last)."""
    return np.concatenate(
        [np.concatenate([get(res[d * sp + j]) for j in range(sp)], axis=-1) for d in range(dp)], axis=0)


def by_dp(res, get, dp, sp):
    """A per-item array that the sp ranks of each dp row hold alike."""
    return np.concatenate([get(res[d * sp]) for d in range(dp)], axis=0)


def close(got, want, atol=0.0, rtol=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    print(f"{what}: max abs err {err.max():.3e}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def scaled(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-6)
    close(np.asarray(got) / scale, np.asarray(want) / scale, atol=tol, what=what)


def test_all_names_have_counterparts():
    from dasp_tpu import parallel as JP

    import dasp_tpu_torch.parallel as PP

    assert sorted(PP.__all__) == sorted(JP.__all__) and len(PP.__all__) == 12
    for name in PP.__all__:
        assert callable(getattr(PP, name)), name


def test_conv(world, jx):
    dp, sp, res = world
    jax, jnp, JP = jx
    mesh = jmesh(jx, dp, sp)
    x, h = C.conv_inputs(2 * dp)
    for method in ("direct", "fft"):
        want = jax.jit(lambda x, h: JP.sharded_fft_conv_causal(x, h, mesh, method=method))(x, h)
        close(assemble(res, lambda r: r["conv"][method]["y"], dp, sp), want, atol=1e-4, what=method)
    from dasp_tpu.ops import fft_conv_causal

    gx, gh = jax.jit(jax.grad(lambda x, h: jnp.sum(fft_conv_causal(x, h) ** 2), argnums=(0, 1)))(x, h)
    for method in ("direct", "fft"):
        scaled(assemble(res, lambda r: r["conv"][method]["gx"], dp, sp), gx, 1e-4, f"{method} dx")
        scaled(by_dp(res, lambda r: r["conv"][method]["gh"], dp, sp), gh, 1e-4, f"{method} dh")
    close(assemble(res, lambda r: r["conv"]["one_tap"], dp, sp), 0.25 * x, atol=1e-6, what="one tap")
    assert "shorter than the halo 255" in res[0]["conv"]["short_block_error"]


def test_coupled(world, jx):
    dp, sp, res = world
    jax, jnp, JP = jx
    from dasp_tpu.ops.biquad import biquad
    from dasp_tpu.ops.iir import sosfilt_coupled

    bs = 2 * dp
    sos = jnp.stack([jnp.concatenate(biquad(jnp.full((bs,), g), jnp.full((bs,), fc), jnp.full((bs,), q), C.SR, ft),
                                     axis=-1) for g, fc, q, ft in C.SOS_BANDS], axis=1)
    mesh = jmesh(jx, dp, sp)
    x = C.coupled_inputs(bs, 8192)
    want = jax.jit(lambda s, x: JP.sharded_sosfilt_coupled(s, x, mesh))(sos, x)
    close(assemble(res, lambda r: r["coupled"]["y"], dp, sp), want, atol=5e-4, what="y")
    x2 = C.coupled_inputs(bs, 2048)
    gs, gx = jax.jit(jax.grad(lambda s, x: jnp.mean(sosfilt_coupled(s, x) ** 2), argnums=(0, 1)))(sos, x2)
    close(assemble(res, lambda r: r["coupled"]["gx"], dp, sp), gx, atol=1e-5, what="dx")
    scaled(by_dp(res, lambda r: r["coupled"]["gs"], dp, sp), gs, 1e-2, "dsos")
    assert "not divisible by block=128" in res[0]["coupled"]["unaligned_error"]


def test_onepole_and_parallel_modes(world, jx):
    dp, sp, res = world
    jax, jnp, JP = jx
    mesh = jmesh(jx, dp, sp)
    b = "dp" if dp > 1 else None
    g, aa, ar = C.curve(2 * dp, 8192)
    want = jax.jit(lambda g, a: JP.sharded_onepole(g, a, mesh, batch_axis_name=b))(g, aa)
    close(assemble(res, lambda r: r["smoothers"]["onepole"], dp, sp), want, atol=2e-4, rtol=2e-5, what="onepole")
    for mode in ("attack_only", "parallel"):
        want = jax.jit(lambda g, a, r: JP.sharded_ballistics_smooth(g, a, r, mesh, mode=mode, batch_axis_name=b))(
            g, aa, ar)
        close(assemble(res, lambda r: r["smoothers"][mode], dp, sp), want, atol=2e-4, rtol=2e-5, what=mode)


def test_gradients_of_the_smoothers(world, jx):
    dp, sp, res = world
    jax, jnp, JP = jx
    from dasp_tpu.ops.iir import ballistics_smooth
    from dasp_tpu.ops.pallas_ballistics import ballistics_pallas

    # "parallel": tests/test_parallel.py's 5e-4; the exact modes at
    # tests/test_torch_kernels.py's bar for the port's ballistics gradient
    # against JAX's (1e-5: XLA:CPU's FMAs); test_exact_relay_is_the_unsharded
    # _kernel holds them to the port's own unsharded gradient
    for mode, tol in (("parallel", 5e-4), ("exact_pallas", 1e-5), ("exact", 1e-5)):
        g, aa, ar = C.curve(2 * dp, 512 if mode == "exact" else 2048)
        if mode == "parallel":
            fn = lambda g, a, r: ballistics_smooth(g, a, r, mode="parallel")  # noqa: E731
        elif mode == "exact":
            fn = lambda g, a, r: ballistics_smooth(g, a, r, mode="exact")  # noqa: E731
        else:
            fn = ballistics_pallas
        want = jax.jit(jax.grad(lambda g, a, r: jnp.mean(fn(g, a, r) ** 2), argnums=(0, 1, 2)))(g, aa, ar)
        got = res_grads = [assemble(res, lambda r: r["smoothers"][f"{mode} grad"]["dg"], dp, sp)]
        for k in ("daa", "dar"):
            res_grads.append(by_dp(res, lambda r: r["smoothers"][f"{mode} grad"][k], dp, sp))
        for name, a, w in zip(("dg", "daa", "dar"), got, want):
            scaled(a, w, tol, f"{mode} {name}")


def test_exact_relay_is_the_unsharded_kernel(world, jx):
    """The relay runs the kernel's wrapper once a rank forward and once
    backward, and its result is bitwise the unsharded wrapper's on the whole
    row (and within 2e-6 of the peak of JAX's relay); its dg is bitwise the
    unsharded backward's (the state's gradient crosses the blocks as dy0)."""
    dp, sp, res = world
    jax, jnp, JP = jx
    from dasp_tpu_torch.ops import ballistics_pallas, ballistics_smooth

    assert all(r["smoothers"]["relay calls"] == {"forward": 1, "backward": 1} for r in res)
    g, aa, ar = C.curve(2 * dp, 4096)
    mine = ballistics_pallas(torch.tensor(g), torch.tensor(aa), torch.tensor(ar)).numpy()
    got = assemble(res, lambda r: r["smoothers"]["relay"], dp, sp)
    assert np.array_equal(got, mine)
    mesh = jmesh(jx, dp, sp)
    want = np.asarray(jax.jit(lambda g, a, r: JP.sharded_ballistics_smooth(
        g, a, r, mesh, batch_axis_name="dp" if dp > 1 else None))(g, aa, ar))
    # JAX's kernel on XLA:CPU rounds the update through FMAs (ROADMAP
    # numerics notes), the port per operation as IEEE does: a few ulps a step,
    # which coefficients near 1 (0.999, 0.9995) carry for thousands of
    # samples; on this curve (peak 15) the two are 1.3e-6 of the peak apart
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    for mode, T in (("exact_pallas", 2048), ("exact", 512)):
        g, aa, ar = C.curve(2 * dp, T)
        gt, a1, a2 = (torch.tensor(v).requires_grad_() for v in (g, aa, ar))
        if mode == "exact":
            y = ballistics_smooth(gt, a1, a2, mode="exact")
        else:
            y = ballistics_pallas(gt, a1, a2)
        dg, daa, dar = torch.autograd.grad(torch.sum(y ** 2) / y.numel(), (gt, a1, a2))
        rec = lambda r: r["smoothers"][f"{mode} grad"]  # noqa: E731
        assert np.array_equal(assemble(res, lambda r: rec(r)["y"], dp, sp), y.detach().numpy()), mode
        assert np.array_equal(assemble(res, lambda r: rec(r)["dg"], dp, sp), dg.numpy()), mode
        scaled(by_dp(res, lambda r: rec(r)["daa"], dp, sp), daa.numpy(), 1e-6, f"{mode} daa")
        scaled(by_dp(res, lambda r: rec(r)["dar"], dp, sp), dar.numpy(), 1e-6, f"{mode} dar")


def test_tv_filter_and_power(world, jx):
    dp, sp, res = world
    jax, jnp, JP = jx
    from dasp_tpu.ops.tv_filter import tv_freq_filter, tv_stft

    mesh = jmesh(jx, dp, sp)
    b = "dp" if dp > 1 else None
    x, H = C.wola_inputs(2 * dp)
    want = jax.jit(lambda x, H: JP.sharded_tv_freq_filter(x, H, C.FS, C.HOP, mesh, batch_axis_name=b))(x, H)
    close(assemble(res, lambda r: r["wola"]["y"], dp, sp), want, atol=2e-5, what="tv filter")
    gx, gH = jax.jit(jax.grad(lambda x, H: jnp.sum(tv_freq_filter(x, H, C.FS, C.HOP) ** 2), argnums=(0, 1)))(x, H)
    close(assemble(res, lambda r: r["wola"]["gx"], dp, sp), gx, atol=1e-3, what="dx")
    # JAX's gradient of a real loss in a complex H is the conjugate of torch's
    close(by_dp(res, lambda r: r["wola"]["gH"], dp, sp), np.conj(np.asarray(gH)), atol=1e-3, what="dH")
    want = jax.jit(lambda x: JP.sharded_tv_power(x, C.FS, C.HOP, 4 * C.FS, mesh, batch_axis_name=b))(x)
    ref = jax.jit(lambda x: jnp.mean(jnp.abs(tv_stft(x, C.FS, C.HOP, 4 * C.FS)) ** 2, axis=1))(x)
    got = by_dp(res, lambda r: r["wola"]["P"], dp, sp)
    for w in (want, ref):
        close(got, w, atol=2e-4 * float(jnp.max(ref)), what="tv power")
    assert "shorter than the halo" in res[0]["wola"]["halo_error"]


@pytest.fixture(scope="module")
def jax_effects(jx):
    """JAX's unsharded WOLA effects, output and input gradient of sum(y**2)."""
    jax, jnp, _ = jx
    import dasp_tpu.functional as JF

    x = C.effect_input()
    out = {}
    for effect in C.EFFECTS:
        fn = lambda x: C.effect_call(effect, JF, x, t=jnp.asarray)  # noqa: E731
        out[effect] = (np.asarray(jax.jit(fn)(x)), np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(fn(x) ** 2)))(x)))
    return out


@pytest.mark.parametrize("effect", C.EFFECTS)
def test_wola_effects_through_sharded_hooks(world, jax_effects, effect):
    """Each WOLA effect with the sharded tv hooks (on the whole signal through
    ``whole_signal``) against JAX's effect: output and input gradient."""
    dp, sp, res = world
    want, gwant = jax_effects[effect]
    for r in res:
        close(r["effects"][effect]["y"], want, atol=2e-5 * max(float(np.abs(want).max()), 1.0), what=effect)
        g = r["effects"][effect]["gx"]
        rel = np.linalg.norm(g - gwant) / (np.linalg.norm(gwant) + 1e-12)
        assert rel < 1e-4, rel
    if dp == 1:  # the dynamic EQ on blocks, its detector on the hooks' frames
        want = jax_effects["dynamic_eq"][0]
        got = assemble(res, lambda r: r["effects"]["dynamic_eq blocks"], dp, sp)
        close(got, want, atol=2e-5 * max(float(np.abs(want).max()), 1.0), what="blocks")


@pytest.mark.parametrize("variant", ["default", "auraloss", "perceptual"])
def test_mrstft_loss(world, jx, variant):
    dp, sp, res = world
    jax, jnp, JP = jx
    from dasp_tpu.utils import multi_resolution_stft_loss

    kw = {"default": {}, "auraloss": dict(auraloss_compat=True),
          "perceptual": dict(perceptual_weighting=True, sample_rate=C.SR, w_lin_mag=1.0)}[variant]
    mesh = jmesh(jx, dp, sp)
    a, y = C.loss_inputs(2 * dp)
    want = jax.jit(lambda a, y: JP.sharded_multi_resolution_stft_loss(
        a, y, mesh, batch_axis_name="dp" if dp > 1 else None, **kw))(a, y)
    ref = jax.jit(lambda a, y: multi_resolution_stft_loss(a, y, cpu_fft_workaround=True, **kw))(a, y)
    for r in res:
        close(r["loss"][variant]["loss"], want, rtol=1e-6, what="loss")
        close(r["loss"][variant]["loss"], ref, rtol=1e-6, what="unsharded loss")
    # the gradient in fp32 against the port's unsharded loss (as
    # tests/test_parallel.py holds JAX's sharded against JAX's unsharded: on
    # noise the log-magnitude terms' 1/|S| amplifies fp32 rounding, and the
    # two packages' fp32 gradients differ by about 1 % in l2), and in float64
    # against JAX's
    from dasp_tpu_torch.utils import multi_resolution_stft_loss as port_loss

    at = torch.tensor(a).requires_grad_()
    (gw,) = torch.autograd.grad(port_loss(at, torch.tensor(y), **kw), at)
    g = assemble(res, lambda r: r["loss"][variant]["g"], dp, sp)
    rel = float(np.linalg.norm(g - gw.numpy()) / np.linalg.norm(gw.numpy()))
    assert rel < 1e-3, rel
    if variant == "default":
        jax.config.update("jax_enable_x64", True)
        try:
            a64, y64 = a.astype(np.float64), y.astype(np.float64)
            l64 = float(multi_resolution_stft_loss(jnp.asarray(a64), jnp.asarray(y64)))
            gw = np.asarray(jax.jit(jax.grad(lambda a: multi_resolution_stft_loss(a, jnp.asarray(y64))))(a64))
        finally:
            jax.config.update("jax_enable_x64", False)
        for r in res:
            close(r["loss"]["float64"]["loss"], l64, rtol=1e-12, what="float64 loss")
        g = assemble(res, lambda r: r["loss"]["float64"]["g"], dp, sp)
        rel = float(np.linalg.norm(g - gw) / np.linalg.norm(gw))
        assert rel < 1e-9, rel
