"""dasp_tpu_torch signal primitives against their dasp_tpu counterparts.

Inputs come from numpy with a fixed seed and go through the JAX function
(on the CPU) and its PyTorch port. Pointwise design formulas, the cached
filterbank and FFT convolutions agree to float32 rounding: 1e-5 abs.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# modules by import path: the packages' ops/__init__ re-export functions
# under some of the same names
jbiquad, jfft, jfb, jfir, jiir = (
    importlib.import_module(f"dasp_tpu.ops.{m}")
    for m in ("biquad", "fft_filter", "filterbank", "fir", "iir")
)
tbiquad, tfft, tfb, tfir, tiir = (
    importlib.import_module(f"dasp_tpu_torch.ops.{m}")
    for m in ("biquad", "fft_filter", "filterbank", "fir", "iir")
)

SR = 44100
TOL = 1e-5  # float32 rounding of the same formulas / transforms
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize(
    "ftype", ["low_shelf", "peaking", "high_shelf", "low_pass", "high_pass", "band_pass"]
)
def test_biquad_matches_jax(ftype):
    rng = np.random.default_rng(1)
    g = rng.uniform(-20, 20, 5).astype(np.float32)
    f = rng.uniform(20, 20000, 5).astype(np.float32)
    q = rng.uniform(0.1, 6, 5).astype(np.float32)
    bj, aj = jbiquad.biquad(jnp.asarray(g), jnp.asarray(f), jnp.asarray(q), SR, ftype)
    bt, at = tbiquad.biquad(t(g), t(f), t(q), SR, ftype)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=TOL, rtol=TOL)


def test_biquad_rejects_unknown_type():
    with pytest.raises(ValueError):
        tbiquad.biquad(torch.zeros(1), torch.ones(1), torch.ones(1), SR, "notch")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 96, 97, 129, 196607, 196609])
def test_fft_sizes_match_jax(n):
    assert tfft.next_pow2(n) == jfft.next_pow2(n)
    assert tfft.next_fast_len(n) == jfft.next_fast_len(n)


@pytest.mark.parametrize("taps", [63, 1023])
def test_filterbank_matches_jax(taps):
    np.testing.assert_allclose(
        tfb.octave_band_filterbank(taps, SR).numpy(),
        np.asarray(jfb.octave_band_filterbank(taps, SR)), atol=TOL,
    )
    with pytest.raises(ValueError):
        tfb.octave_band_filterbank(taps + 1, SR)


@pytest.mark.parametrize("T,K", [(1000, 65), (777, 777), (4096, 2048)])
def test_fir_matches_jax(T, K):
    rng = np.random.default_rng(T + K)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    h = (rng.standard_normal((2, 2, K)) / np.sqrt(K)).astype(np.float32)
    np.testing.assert_allclose(
        tfir.fft_conv_causal(t(x), t(h)).numpy(),
        np.asarray(jfir.fft_conv_causal(jnp.asarray(x), jnp.asarray(h))), atol=TOL,
    )
    hv = h[0, 0, : min(K, T)]
    np.testing.assert_allclose(
        tfir.fft_correlate_valid(t(x), t(hv)).numpy(),
        np.asarray(jfir.fft_correlate_valid(jnp.asarray(x), jnp.asarray(hv))), atol=TOL,
    )


def _raw_sos():
    rng = np.random.default_rng(3)
    sos = rng.uniform(-2.5, 2.5, (4, 3, 6)).astype(np.float32)
    sos[..., 3] = 1.0
    return sos


def _eq_sos():
    """(4, 6, 6) parametric-EQ cascades from random normalized parameters."""
    import dasp_tpu as D

    eq = D.ParametricEQ(SR)
    p = np.random.default_rng(6).uniform(size=(4, eq.num_params)).astype(np.float32)
    d = eq.denormalize_param_dict(eq.extract_param_dict(jnp.asarray(p)))
    return np.asarray(D.functional.parametric_eq_sos(4, jnp.float32, SR, *d.values()))


def test_stabilize_sos_matches_jax_and_is_straight_through():
    sos = _raw_sos()
    np.testing.assert_allclose(
        tiir.stabilize_sos(t(sos)).numpy(),
        np.asarray(jiir.stabilize_sos(jnp.asarray(sos))), atol=TOL,
    )
    # stable (cookbook) sections pass bit-identical
    ok = _eq_sos()
    np.testing.assert_array_equal(tiir.stabilize_sos(t(ok)).numpy(), ok)
    # straight-through: the gradient of sum(stabilize(sos) * w) is w
    w = np.random.default_rng(4).standard_normal(sos.shape).astype(np.float32)
    st = t(sos).requires_grad_()
    (tiir.stabilize_sos(st) * t(w)).sum().backward()
    gj = jax.grad(lambda s: jnp.sum(jiir.stabilize_sos(s) * w))(jnp.asarray(sos))
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), atol=TOL)
    np.testing.assert_allclose(st.grad.numpy(), w, atol=TOL)


def test_first_order_layouts_match_jax():
    rng = np.random.default_rng(5)
    alpha = rng.uniform(0.5, 0.999, (3,)).astype(np.float32)
    bj, aj = jiir.onepole_ba(jnp.asarray(alpha))
    bt, at = tiir.onepole_ba(t(alpha))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=TOL)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=TOL)
    np.testing.assert_allclose(
        tiir.embed_first_order_sos(bt, at).numpy(),
        np.asarray(jiir.embed_first_order_sos(bj, aj)), atol=TOL,
    )


@pytest.mark.parametrize("block", [8, 128])
def test_block_toeplitz_operators_match_jax(block):
    sos = _eq_sos()
    outs_j = jiir.block_toeplitz_operators(jnp.asarray(sos), block)
    outs_t = tiir.block_toeplitz_operators(t(sos), block)
    for oj, ot in zip(outs_j, outs_t):
        oj = np.asarray(oj)
        # the AR impulse response may grow: compare relative to its scale
        scale = max(1.0, float(np.abs(oj).max()))
        np.testing.assert_allclose(ot.numpy() / scale, oj / scale, atol=TOL)
    h_t = tiir.ar_impulse_response(t(sos[..., 4]), t(sos[..., 5]), 5)
    h_j = jiir.ar_impulse_response(jnp.asarray(sos[..., 4]), jnp.asarray(sos[..., 5]), 5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=TOL)


def test_port_never_imports_jax():
    """The package must run where JAX is absent: import all of it with jax
    and flax blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import dasp_tpu_torch, dasp_tpu_torch.functional, dasp_tpu_torch.modules\n"
        "import dasp_tpu_torch.ops, dasp_tpu_torch.models, dasp_tpu_torch._build\n"
        "import dasp_tpu_torch.models.convert\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'dasp_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
