"""dasp_tpu_torch effects and processors against dasp_tpu.

The same numpy inputs go through the JAX effect (Pallas kernels in
interpret mode) and its PyTorch port (the kernels' plain versions on the
CPU). Tolerances, with their reasons:

* outputs through the biquad cascade: 2e-3 abs, the cascade's bound
  (tests/test_pallas_iir.py); other outputs 1e-5 (fp32 rounding);
* parameter gradients: 1e-4 relative to the largest gradient, the repo's
  parity bar (BASELINE.md);
* golden fixtures of the reference implementation: 1e-4 relative to
  max(1, peak), as tests/test_parity.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu_torch as P
from dasp_tpu_torch import functional as PF

SR = 44100
A_TOL = 2e-3
TOL = 1e-5
GRAD_TOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def load(name):
    return dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))


def rel_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, f"{what}: {actual.shape} vs {expected.shape}"
    scale = max(1.0, float(np.abs(expected).max()))
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} * {scale:.3g}"


def grads_close(grads_t, grads_j, tol=GRAD_TOL, what=""):
    """Every gradient within ``tol`` of the largest JAX gradient."""
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads_j.values())
    for k, gj in grads_j.items():
        err = float(np.abs(grads_t[k] - np.asarray(gj)).max())
        assert err <= tol * scale, f"{what} grad {k}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def torch_params(params):
    return {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in params.items()}


def run_both(jfn, tfn, x, params, **kw):
    """Output and d mean(y^2) / d params of both packages."""
    xj = jnp.asarray(x)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    y_j = np.asarray(jfn(xj, SR, **pj, **kw))
    g_j = jax.grad(lambda p: jnp.mean(jfn(xj, SR, **p, **kw) ** 2))(pj)
    pt = torch_params(params)
    y_t = tfn(torch.tensor(x), SR, **pt, **kw)
    (y_t ** 2).mean().backward()
    # a parameter the output does not use (release_ms of an attack-only
    # smoother) has no torch gradient and a zero JAX one
    g_t = {k: np.zeros_like(params[k]) if v.grad is None else v.grad.numpy() for k, v in pt.items()}
    return y_t.detach().numpy(), y_j, g_t, g_j


def normalized_params(proc, bs, seed, lo=0.05, hi=0.95):
    p = np.random.default_rng(seed).uniform(lo, hi, size=(bs, proc.num_params)).astype(np.float32)
    return {k: np.asarray(v) for k, v in proc.denormalize_param_dict(proc.extract_param_dict(p)).items()}


def test_gain_matches_jax_and_fixture():
    fx = load("gain")
    params = {k[6:]: v for k, v in fx.items() if k.startswith("param_")}
    y_t, y_j, g_t, g_j = run_both(D.gain, PF.gain, fx["x"], params)
    np.testing.assert_allclose(y_t, y_j, atol=TOL)
    grads_close(g_t, g_j, what="gain")
    rel_close(y_t, fx["y"], 1e-4, "gain fixture")
    for k in params:
        rel_close(g_t[k], fx[f"grad_{k}"], 1e-4, f"gain fixture grad {k}")


def test_parametric_eq_pallas_matches_jax():
    bs, T = 2, 1024
    x = (np.random.default_rng(21).standard_normal((bs, 2, T)) * 0.3).astype(np.float32)
    params = normalized_params(D.ParametricEQ(SR), bs, seed=22)
    y_t, y_j, g_t, g_j = run_both(D.parametric_eq, PF.parametric_eq, x, params, filter_method="pallas")
    np.testing.assert_allclose(y_t, y_j, atol=A_TOL)
    grads_close(g_t, g_j, what="parametric_eq")


def test_parametric_eq_exact_is_the_plain_version():
    """"exact" is the plain associative-scan cascade, ``sosfilt_exact`` (as
    in the JAX package); it agrees with the kernel's path within the
    cascade's bound."""
    x = torch.randn(2, 2, 700)
    p = {k: torch.tensor(v) for k, v in normalized_params(D.ParametricEQ(SR), 2, seed=23).items()}
    sos = PF.parametric_eq_sos(2, x.dtype, SR, *p.values())
    y = PF.parametric_eq(x, SR, **p, filter_method="exact")
    assert torch.equal(y, P.ops.sosfilt_exact(sos, x))
    np.testing.assert_allclose(y.numpy(), PF.parametric_eq(x, SR, **p, filter_method="pallas").numpy(),
                               atol=A_TOL)


@pytest.mark.parametrize("smoother", ["exact_pallas", "pallas", "exact"])
def test_compressor_matches_jax(smoother):
    bs, T = 2, 2048
    x = (np.random.default_rng(24).standard_normal((bs, 2, T)) * 0.5).astype(np.float32)
    params = normalized_params(D.Compressor(SR), bs, seed=25)
    y_t, y_j, g_t, g_j = run_both(D.compressor, PF.compressor, x, params, smoother=smoother)
    rel_close(y_t, y_j, 1e-4, f"compressor {smoother}")
    grads_close(g_t, g_j, what=f"compressor {smoother}")


def test_compressor_lookahead_matches_jax():
    x = (np.random.default_rng(26).standard_normal((2, 2, 512)) * 0.5).astype(np.float32)
    params = normalized_params(D.Compressor(SR), 2, seed=27)
    y_t, y_j, _, _ = run_both(D.compressor, PF.compressor, x, params,
                              smoother="exact", lookahead_samples=32)
    rel_close(y_t, y_j, 1e-4, "compressor lookahead")


@pytest.mark.parametrize("mode", ["compressor", "expander", "limiter"])
def test_static_gain_computer_matches_jax(mode):
    rng = np.random.default_rng(28)
    x_db = rng.uniform(-80, 6, (2, 1, 500)).astype(np.float32)
    thr = np.asarray([-20.0, -30.0], np.float32).reshape(2, 1, 1)
    ratio = np.asarray([4.0, 2.0], np.float32).reshape(2, 1, 1)
    knee = np.asarray([6.0, 0.0], np.float32).reshape(2, 1, 1)
    g_j = D.functional.static_gain_computer(*map(jnp.asarray, (x_db, thr, ratio, knee)), mode)
    g_t = PF.static_gain_computer(*map(torch.tensor, (x_db, thr, ratio, knee)), mode)
    rel_close(g_t.numpy(), np.asarray(g_j), TOL, f"gain computer {mode}")  # dB values up to ~60


def test_reverb_with_injected_noise_matches_jax_and_fixture():
    fx = load("reverb")
    params = {k[6:]: v for k, v in fx.items() if k.startswith("param_")}
    kw = dict(num_samples=int(fx["num_samples"]), num_bandpass_taps=int(fx["num_taps"]))
    noise = fx["noise"]
    xj = jnp.asarray(fx["x"])
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    y_j = D.noise_shaped_reverberation(xj, SR, **pj, **kw, noise=jnp.asarray(noise))
    pt = torch_params(params)
    y_t = PF.noise_shaped_reverberation(torch.tensor(fx["x"]), SR, **pt, **kw, noise=torch.tensor(noise))
    (y_t ** 2).mean().backward()
    rel_close(y_t.detach().numpy(), np.asarray(y_j), TOL, "reverb vs jax")
    rel_close(y_t.detach().numpy(), fx["y"], 1e-4, "reverb fixture")
    for k in params:
        rel_close(pt[k].grad.numpy(), fx[f"grad_{k}"], 1e-4, f"reverb fixture grad {k}")


@pytest.mark.parametrize("noise_mode", ["time", "frequency"])
def test_reverb_draws_from_the_generator(noise_mode):
    x = torch.randn(2, 1, 3000)
    p = {k: torch.tensor(v) for k, v in normalized_params(D.NoiseShapedReverb(SR), 2, seed=29).items()}
    kw = dict(num_samples=1024, num_bandpass_taps=63, noise_mode=noise_mode)
    y1 = PF.noise_shaped_reverberation(x, SR, **p, **kw, generator=torch.Generator().manual_seed(3))
    y2 = PF.noise_shaped_reverberation(x, SR, **p, **kw, generator=torch.Generator().manual_seed(3))
    y3 = PF.noise_shaped_reverberation(x, SR, **p, **kw, generator=torch.Generator().manual_seed(4))
    assert y1.shape == (2, 2, 3000) and bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    with pytest.raises(ValueError, match="generator"):
        PF.noise_shaped_reverberation(x, SR, **p, **kw)


@pytest.mark.parametrize("n", [256, 255])
def test_spectral_band_noise_statistics(n):
    """The draw's rfft has per-bin variance n/2 (real and imaginary parts)
    on interior bins, and a real value of variance n at DC and at an even-n
    Nyquist: checked with an identity filter (one tap), so the output is
    the white noise itself."""
    rows = 4000
    delta = torch.ones(1, 1)
    z = torch.fft.rfft(PF.spectral_band_noise(torch.Generator().manual_seed(5), rows, delta, n), dim=-1)[:, 0]
    var_re, var_im = z.real.var(dim=0), z.imag.var(dim=0)
    interior = slice(1, n // 2) if n % 2 == 0 else slice(1, n // 2 + 1)
    # sampling error of a variance over 4000 draws: ~2.2% (1 sigma)
    np.testing.assert_allclose(var_re[interior].mean().item(), n / 2, rtol=0.02)
    np.testing.assert_allclose(var_im[interior].mean().item(), n / 2, rtol=0.02)
    np.testing.assert_allclose(var_re[0].item(), n, rtol=0.1)
    assert var_im[0].item() < 1e-6
    if n % 2 == 0:
        np.testing.assert_allclose(var_re[-1].item(), n, rtol=0.1)
        assert var_im[-1].item() < 1e-6


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


def make_procs():
    return [P.Gain(SR), P.ParametricEQ(SR, filter_method="pallas"),
            P.Compressor(SR, smoother="exact_pallas"), P.NoiseShapedReverb(SR, num_samples=512, num_bandpass_taps=63)]


@pytest.mark.parametrize("idx", range(4))
def test_processor_param_ranges_match_jax(idx):
    jprocs = [D.Gain(SR), D.ParametricEQ(SR), D.Compressor(SR), D.NoiseShapedReverb(SR)]
    assert make_procs()[idx].param_ranges == jprocs[idx].param_ranges


def test_processor_checks_width_and_range():
    eq = P.ParametricEQ(SR, filter_method="pallas")
    x = torch.randn(2, 1, 256)
    with pytest.raises(ValueError, match="18 parameters"):
        eq.process_normalized(x, torch.rand(2, 17))
    bad = torch.rand(2, 18)
    bad[1, 3] = 1.5
    with pytest.raises(ValueError, match="out of range"):
        eq.process_normalized(x, bad)
    y = eq.process_normalized(x, bad, clip_params=True)
    assert torch.equal(y, eq.process_normalized(x, bad.clamp(0, 1)))


def _called(*args):
    raise ValueError("the callable was called")


@pytest.mark.parametrize("make,option", [
    (lambda: P.ParametricEQ(SR, filter_method=_called), "callable filter_method"),
    (lambda: P.Compressor(SR, smoother=_called), "callable smoother"),
])
def test_unported_options_raise(make, option):
    """The callable options (the JAX package's hooks for its sequence-sharded
    filters, ported with the parallel layer) are called with the effect's
    operands: the callable's own error comes through."""
    proc = make()
    with pytest.raises(ValueError, match="the callable was called"):
        proc.process_normalized(torch.randn(1, 1, 256), torch.rand(1, proc.num_params))


def test_processors_match_jax_process_normalized():
    """Each processor of the chain through process_normalized (normalized
    parameters in, audio out), reverb with injected noise."""
    rng = np.random.default_rng(30)
    x = (rng.standard_normal((2, 2, 2048)) * 0.3).astype(np.float32)
    noise = rng.standard_normal((4, 12, 512 + 62)).astype(np.float32)
    jprocs = [D.Gain(SR), D.ParametricEQ(SR, filter_method="pallas"),
              D.Compressor(SR, smoother="exact_pallas"),
              D.NoiseShapedReverb(SR, num_samples=512, num_bandpass_taps=63)]
    for jp, tp in zip(jprocs, make_procs()):
        p = rng.uniform(size=(2, tp.num_params)).astype(np.float32)
        kw_j = {"noise": jnp.asarray(noise)} if jp.stochastic else {}
        kw_t = {"noise": torch.tensor(noise)} if isinstance(tp, P.NoiseShapedReverb) else {}
        y_j = np.asarray(jp.process_normalized(jnp.asarray(x), jnp.asarray(p), **kw_j))
        y_t = tp.process_normalized(torch.tensor(x), torch.tensor(p), **kw_t).numpy()
        rel_close(y_t, y_j, A_TOL, type(tp).__name__)
