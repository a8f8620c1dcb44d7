"""The frequency-sampling (FSM) filters of dasp_tpu_torch and the defaults
they serve, against dasp_tpu and the reference's golden fixtures; and the
port's public names against the JAX package's.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances,
with their reasons:

* each FSM function against ``dasp_tpu.ops.fft_filter``: 1e-5 of
  max(1, peak) in float32 (the same FFT sizes and products, rounded by two
  FFT libraries) and 1e-12 in float64;
* the golden fixtures of the reference (output and every parameter
  gradient of mean(y ** 2)): 1e-4 of max(1, peak), tests/test_parity.py's
  bar;
* processors at their defaults against the JAX processors: the same 1e-4
  bar.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.ops.fft_filter as JFFT
import dasp_tpu_torch as P
import dasp_tpu_torch.ops.fft_filter as TFFT
from dasp_tpu_torch import functional as PF

SR = 44100
FSM_TOL = {"float32": 1e-5, "float64": 1e-12}
PARITY_TOL = 1e-4
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# public names of dasp_tpu that the port does not have yet; each PR that
# ports one takes it out (ROADMAP.md Queue 1)
NOT_YET_PORTED = {
    "AdvancedDistortion", "AutoWah", "Bitcrusher", "Chain", "Clipper", "ConvolutionReverb", "DeEsser",
    "Delay", "Distortion", "DynamicEQ", "Exciter", "Expander", "GraphicEQ", "Limiter",
    "MultibandCompressor", "NoiseGate", "Phaser", "PitchShiftPV", "RingModulator", "SidechainCompressor",
    "SpectralGate", "StereoBus", "StereoImager", "StereoPanner", "StereoWidener", "TimeStretch",
    "TransientShaper", "Tremolo", "WowFlutter",
    "advanced_distortion", "auto_wah", "bitcrusher", "clipper", "convolution_reverb", "de_esser", "delay",
    "distortion", "dynamic_eq", "exciter", "expander", "graphic_eq", "limiter", "multiband_compressor",
    "noise_gate", "phaser", "pitch_shift_pv", "ring_modulator", "sidechain_compressor", "spectral_gate",
    "spectral_noise_profile", "stereo_bus", "stereo_imager", "stereo_panner", "stereo_widener",
    "time_stretch", "transient_shaper", "tremolo", "wow_flutter",
}
# subpackages of the port that the JAX package's top level does not name
PORT_ONLY = {"models", "modules", "train", "utils"}


@contextlib.contextmanager
def jax_dtype(dtype):
    """JAX with float64 enabled for the block when ``dtype`` is float64."""
    if dtype != "float64":
        yield
        return
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def load(name):
    return dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))


def assert_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, f"{what}: {actual.shape} vs {expected.shape}"
    scale = max(1.0, float(np.abs(expected).max()))
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} * {scale:.3g}"


# ---------------------------------------------------------------------------
# the FSM functions
# ---------------------------------------------------------------------------


def stable_sections(rng, shape):
    """(*shape, 6) second-order sections [b0, b1, b2, 1, a1, a2] with poles
    of radius 0.3-0.95."""
    r = rng.uniform(0.3, 0.95, shape)
    theta = rng.uniform(0.05, 3.0, shape)
    b = rng.standard_normal((*shape, 3))
    a = np.stack([np.ones(shape), -2 * r * np.cos(theta), r * r], -1)
    return np.concatenate([b, a], -1)


def fsm_inputs(name, chs, T, seed):
    """Positional numpy arguments of FSM function ``name`` at batch 2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, chs, T)) * 0.3
    n_fft = TFFT.fsm_fft_size(T)
    if name == "fft_freqz":
        sos = stable_sections(rng, (2, chs))
        return [sos[..., :3], sos[..., 3:], n_fft]
    if name == "fft_sosfreqz":
        return [stable_sections(rng, (2, 3 * chs)), n_fft]
    if name == "freqdomain_fir":
        H = np.asarray(JFFT.fft_sosfreqz(jnp.asarray(stable_sections(rng, (2, 2))), n_fft))[:, None, :]
        return [x, H, n_fft]
    if name == "lfilter_via_fsm":  # a one-pole on one channel count, a biquad on the other
        sos = stable_sections(rng, (2,))
        if chs == 1:
            alpha = rng.uniform(0.5, 0.999, (2, 1))
            return [x, np.concatenate([1 - alpha, 0 * alpha], -1), np.concatenate([np.ones_like(alpha), -alpha], -1)]
        return [x, sos[..., :3], sos[..., 3:]]
    if name == "lfilter_via_fsm_b_only":
        return [x, rng.standard_normal((2, 7))]
    if name == "sosfilt_via_fsm":
        return [stable_sections(rng, (2, 6)), x]
    if name == "fsm_onepole_step_response":
        return [np.exp(-np.log(9.0) / (SR * rng.uniform(5e-3, 0.1, (2, chs, 1)))), T]
    raise AssertionError(name)


FSM_FUNCTIONS = ["fft_freqz", "fft_sosfreqz", "freqdomain_fir", "lfilter_via_fsm", "lfilter_via_fsm_b_only",
                 "sosfilt_via_fsm", "fsm_onepole_step_response"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("T", [1000, 4096])
@pytest.mark.parametrize("chs", [1, 2])
@pytest.mark.parametrize("name", FSM_FUNCTIONS)
def test_fsm_function_matches_jax(name, chs, T, dtype):
    args = fsm_inputs(name, chs, T, seed=100 * FSM_FUNCTIONS.index(name) + 10 * chs + (T > 1000))
    fn = name.removesuffix("_b_only")
    cdt = {"float32": np.complex64, "float64": np.complex128}[dtype]
    cast = [a.astype(cdt if np.iscomplexobj(a) else dtype) if isinstance(a, np.ndarray) else a for a in args]
    with jax_dtype(dtype):
        want = np.asarray(getattr(JFFT, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in cast)))
    got = getattr(TFFT, fn)(*(torch.tensor(a) if isinstance(a, np.ndarray) else a for a in cast)).numpy()
    assert got.dtype == want.dtype, f"{got.dtype} vs {want.dtype}"
    assert_close(got, want, FSM_TOL[dtype], f"{name} {dtype}")


@pytest.mark.parametrize("T", [1, 2, 1000, 4096, 16384, 131072])
def test_fsm_fft_size_matches_jax(T):
    assert TFFT.fsm_fft_size(T) == JFFT.fsm_fft_size(T)


# ---------------------------------------------------------------------------
# the reference's golden fixtures through the port's default options
# ---------------------------------------------------------------------------


def test_lfilter_fsm_fixture():
    fx = load("lfilter_fsm")
    y = TFFT.lfilter_via_fsm(*(torch.tensor(fx[k]) for k in ("x", "b", "a")))
    assert_close(y.numpy(), fx["y"], PARITY_TOL, "lfilter_fsm")


@pytest.mark.parametrize("fixture,fn,kw", [
    ("parametric_eq", PF.parametric_eq, {}),
    ("compressor", PF.compressor, {}),
    ("compressor_f64", PF.compressor, {}),
    ("compressor_lookahead", PF.compressor, {"lookahead_samples": 32}),
])
def test_effect_fixture_at_default_options(fixture, fn, kw):
    """Output and every parameter gradient of mean(y ** 2), with no option
    given: the "fsm" defaults."""
    fx = load(fixture)
    params = {k[len("param_"):]: torch.tensor(v, requires_grad=True) for k, v in fx.items() if k.startswith("param_")}
    y = fn(torch.tensor(fx["x"]), SR, **params, **kw)
    assert y.dtype == torch.from_numpy(fx["y"]).dtype
    assert_close(y.detach().numpy(), fx["y"], PARITY_TOL, f"{fixture}: output")
    (y ** 2).mean().backward()
    for k, p in params.items():
        # release_ms does not reach the attack-only FSM smoother: no torch
        # gradient, a zero one in the fixture
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert_close(g.numpy(), fx[f"grad_{k}"], PARITY_TOL, f"{fixture}: grad_{k}")


def test_style_chain_fixture_at_default_options():
    """EQ -> compressor -> reverb -> gain through process_normalized with
    the EQ and compressor at their defaults and the reference's reverb
    noise: output and the gradients of mean(y ** 2) with respect to all
    four normalized parameter tensors."""
    fx = load("style_chain")
    eq, comp, gain = P.ParametricEQ(SR), P.Compressor(SR), P.Gain(SR)
    rev = P.NoiseShapedReverb(SR, num_samples=int(fx["num_samples"]), num_bandpass_taps=int(fx["num_taps"]))
    noise = torch.tensor(fx["noise"])
    p = {k: torch.tensor(fx[f"param_{k}"], requires_grad=True) for k in ("eq", "comp", "reverb", "gain")}
    y = eq.process_normalized(torch.tensor(fx["x"]), p["eq"], clip_params=True)
    y = comp.process_normalized(y, p["comp"], clip_params=True)
    y = rev.process_normalized(y, p["reverb"], clip_params=True, noise=noise)
    y = gain.process_normalized(y, p["gain"], clip_params=True)
    assert_close(y.detach().numpy(), fx["y"], PARITY_TOL, "style_chain: output")
    (y ** 2).mean().backward()
    for k, v in p.items():
        assert_close(v.grad.numpy(), fx[f"grad_{k}"], PARITY_TOL, f"style_chain: grad_{k}")


@pytest.mark.parametrize("name", ["ParametricEQ", "Compressor"])
def test_processor_defaults_match_jax(name):
    """process_normalized at the processors' default options (no option
    given in either package): output and the gradient of mean(y ** 2) with
    respect to the normalized parameters."""
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((2, 2, 4096)) * 0.4).astype(np.float32)
    jp, tp = getattr(D, name)(SR), getattr(P, name)(SR)
    p = rng.uniform(0.05, 0.95, (2, tp.num_params)).astype(np.float32)
    xj = jnp.asarray(x)
    y_j = np.asarray(jp.process_normalized(xj, jnp.asarray(p)))
    g_j = np.asarray(jax.grad(lambda q: jnp.mean(jp.process_normalized(xj, q, clip_params=True) ** 2))(jnp.asarray(p)))
    pt = torch.tensor(p, requires_grad=True)
    y_t = tp.process_normalized(torch.tensor(x), pt)
    (tp.process_normalized(torch.tensor(x), pt, clip_params=True) ** 2).mean().backward()
    assert_close(y_t.detach().numpy(), y_j, PARITY_TOL, f"{name}: output")
    assert_close(pt.grad.numpy(), g_j, PARITY_TOL, f"{name}: gradient")


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------


def test_public_names_not_yet_ported_are_listed():
    """What dasp_tpu exports and the port does not is exactly
    NOT_YET_PORTED, so a PR that ports a name must also take it out."""
    assert set(D.__all__) - set(P.__all__) == NOT_YET_PORTED


def test_port_public_names_exist_in_jax_package():
    assert set(P.__all__) - set(D.__all__) == PORT_ONLY
    for name in P.__all__:
        assert hasattr(P, name), name
