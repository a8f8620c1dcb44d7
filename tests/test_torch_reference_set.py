"""The rest of the reference's effect set in dasp_tpu_torch against dasp_tpu
and the reference's golden fixtures: ``distortion``, ``stereo_bus``,
``stereo_widener``, ``stereo_panner``, their processors, ``Chain``, the
constructor records ``_init_spec``, and the signal functions
``one_pole_*``, ``fft_conv_full`` and ``ola_conv_causal``.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances,
with their reasons:

* the golden fixtures of the reference (output and every parameter
  gradient of mean(y ** 2)): 1e-4 of max(1, peak), tests/test_parity.py's
  bar; the biquad and filterbank fixtures 1e-6, as there;
* elementwise effects and processors against JAX: outputs 1e-5 of
  max(1, peak) (fp32 rounding), gradients 1e-4 of the largest (the repo's
  parity bar);
* ``Chain`` through the biquad-cascade kernel's plain version: its output
  2e-3 absolute (the cascade's bound, tests/test_pallas_iir.py), its
  gradient 1e-4 of the largest;
* the one-pole designs 1e-6 of max(1, peak); the FFT convolutions 1e-5 of
  max(1, peak) (two FFT libraries).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.ops as JO
import dasp_tpu_torch as P
import dasp_tpu_torch.ops as TO
from dasp_tpu_torch import functional as PF

SR = 44100
PARITY_TOL = 1e-4
TOL = 1e-5
GRAD_TOL = 1e-4
A_TOL = 2e-3
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def load(name):
    return dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))


def peak_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, f"{what}: {actual.shape} vs {expected.shape}"
    scale = max(1.0, float(np.abs(expected).max()))
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} * {scale:.3g}"


def grad_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    scale = float(np.abs(expected).max())
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} of the largest {scale:.3g}"


def run_both(name, x, params):
    """Output and d mean(y^2) / d params of the effect ``name`` in both
    packages."""
    jfn, tfn = getattr(D, name), getattr(PF, name)
    xj = jnp.asarray(x)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    y_j = np.asarray(jfn(xj, SR, **pj))
    g_j = jax.grad(lambda p: jnp.mean(jfn(xj, SR, **p) ** 2))(pj)
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in params.items()}
    y_t = tfn(torch.tensor(x), SR, **pt)
    (y_t ** 2).mean().backward()
    return y_t.detach().numpy(), y_j, {k: v.grad.numpy() for k, v in pt.items()}, g_j


# ---------------------------------------------------------------------------
# the effects against the fixtures and JAX
# ---------------------------------------------------------------------------

FIXTURE_EFFECTS = [("distortion", "distortion"), ("stereo_bus", "stereo_bus"),
                   ("stereo_panner", "stereo_panner"), ("stereo_widener", "stereo_widener"),
                   ("stereo_widener_bs2", "stereo_widener")]


@pytest.mark.parametrize("fixture,name", FIXTURE_EFFECTS)
def test_effect_matches_fixture_and_jax(fixture, name):
    fx = load(fixture)
    params = {k[len("param_"):]: v for k, v in fx.items() if k.startswith("param_")}
    y_t, y_j, g_t, g_j = run_both(name, fx["x"], params)
    peak_close(y_t, fx["y"], PARITY_TOL, f"{fixture}: output")
    peak_close(y_t, y_j, TOL, f"{fixture}: output against JAX")
    for k in params:
        peak_close(g_t[k], fx[f"grad_{k}"], PARITY_TOL, f"{fixture}: grad_{k}")
        grad_close(g_t[k], g_j[k], GRAD_TOL, f"{fixture}: grad_{k} against JAX")


@pytest.mark.parametrize("drive", ["scalar", "per item", "per channel"])
def test_distortion_drive_broadcasting(drive):
    """A per-item (bs,) drive on stereo input applies to both channels (the
    reference raises there); (bs, chs) is per channel."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 2, 512)) * 0.5).astype(np.float32)
    shape = {"scalar": (), "per item": (3,), "per channel": (3, 2)}[drive]
    d = rng.uniform(0, 24, shape).astype(np.float32)
    y_t, y_j, g_t, g_j = run_both("distortion", x, {"drive_db": d})
    peak_close(y_t, y_j, TOL, drive)
    grad_close(g_t["drive_db"], g_j["drive_db"], GRAD_TOL, drive)
    if drive == "per item":
        want = np.tanh(x * 10.0 ** (d[:, None, None] / 20.0))
        peak_close(y_t, want, TOL, "per item drive on every channel")


@pytest.mark.parametrize("shape", [(), (3,), (3, 1)])
def test_stereo_widener_width_broadcasting(shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 2, 512)) * 0.5).astype(np.float32)
    w = rng.uniform(0, 1, shape).astype(np.float32)
    y_t, y_j, g_t, g_j = run_both("stereo_widener", x, {"width": w})
    assert y_t.shape == (3, 2, 512)
    peak_close(y_t, y_j, TOL, str(shape))
    grad_close(g_t["width"], g_j["width"], GRAD_TOL, str(shape))


def test_stereo_panner_layout():
    """(bs, tracks, T) in, (bs, 2, tracks, T) out; centre pan gives equal
    channels and hard left silences the right."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    pan = np.array([[0.5, 0.0, 0.8], [0.2, 0.5, 1.0]], np.float32)
    y_t, y_j, g_t, g_j = run_both("stereo_panner", x, {"pan": np.clip(pan, 0.01, 0.99)})
    assert y_t.shape == (2, 2, 3, 256)
    peak_close(y_t, y_j, TOL, "panner")
    grad_close(g_t["pan"], g_j["pan"], GRAD_TOL, "panner")
    y = PF.stereo_panner(torch.tensor(x), SR, torch.tensor(pan)).numpy()
    np.testing.assert_allclose(y[0, 0, 0], y[0, 1, 0], rtol=1e-6)
    assert np.abs(y[0, 1, 1]).max() == 0.0


def test_stereo_effects_check_channels():
    with pytest.raises(ValueError, match="bs, 2, T"):
        PF.stereo_widener(torch.zeros(1, 3, 8), SR, 0.5)
    with pytest.raises(ValueError, match="bs, 2, tracks, T"):
        PF.stereo_bus(torch.zeros(1, 1, 2, 8), SR, torch.zeros(1, 2))


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------

PROCESSORS = [
    ("Distortion", (SR,), (2, 2, 512)),
    ("StereoWidener", (SR,), (2, 2, 512)),
    ("StereoPanner", (SR,), (2, 1, 512)),
    ("StereoBus", (SR, 3), (2, 2, 3, 512)),
]


@pytest.mark.parametrize("name,args,shape", PROCESSORS)
def test_processor_matches_jax(name, args, shape):
    """process_normalized: output and the gradient of mean(y ** 2) with
    respect to the normalized parameters."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * 0.4).astype(np.float32)
    jp, tp = getattr(D, name)(*args), getattr(P, name)(*args)
    assert tp.param_ranges == jp.param_ranges
    p = rng.uniform(0.05, 0.95, (2, tp.num_params)).astype(np.float32)
    xj = jnp.asarray(x)
    y_j = np.asarray(jp.process_normalized(xj, jnp.asarray(p)))
    g_j = np.asarray(jax.grad(lambda q: jnp.mean(jp.process_normalized(xj, q) ** 2))(jnp.asarray(p)))
    pt = torch.tensor(p, requires_grad=True)
    y_t = tp.process_normalized(torch.tensor(x), pt)
    (y_t ** 2).mean().backward()
    peak_close(y_t.detach().numpy(), y_j, TOL, name)
    grad_close(pt.grad.numpy(), g_j, GRAD_TOL, f"{name} gradient")


def test_stereo_bus_positional_passthrough():
    """StereoBus.process(x, sr, send_db) takes the (bs, tracks) sends as the
    functional effect does."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 3, 64)).astype(np.float32)
    send = rng.uniform(-20, 6, (2, 3)).astype(np.float32)
    y_j = np.asarray(D.StereoBus(SR, 3).process(jnp.asarray(x), SR, jnp.asarray(send)))
    y_t = P.StereoBus(SR, 3).process(torch.tensor(x), SR, torch.tensor(send)).numpy()
    peak_close(y_t, y_j, TOL, "passthrough")
    peak_close(y_t, PF.stereo_bus(torch.tensor(x), SR, torch.tensor(send)).numpy(), 0.0, "functional")


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------

NOISE_SAMPLES, NOISE_TAPS = 512, 63


def chain_members(pkg):
    return [pkg.Distortion(SR), pkg.ParametricEQ(SR, filter_method="pallas"),
            pkg.Compressor(SR, smoother="exact_pallas"),
            pkg.NoiseShapedReverb(SR, num_samples=NOISE_SAMPLES, num_bandpass_taps=NOISE_TAPS),
            pkg.StereoWidener(SR), pkg.Gain(SR)]


def test_chain_matches_jax_with_noise():
    """Distortion -> EQ -> compressor -> reverb -> widener -> gain from one
    parameter tensor, the reverb's noise injected: output and the gradient
    with respect to the whole tensor."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 2, 2048)) * 0.3).astype(np.float32)
    noise = rng.standard_normal((4, 12, NOISE_SAMPLES + NOISE_TAPS - 1)).astype(np.float32)
    jc, tc = D.Chain(chain_members(D)), P.Chain(chain_members(P))
    assert tc.param_ranges == jc.param_ranges and tc.stochastic and tc.num_params == 52
    p = rng.uniform(0.05, 0.95, (2, tc.num_params)).astype(np.float32)
    xj, nj = jnp.asarray(x), jnp.asarray(noise)
    run_j = jax.jit(lambda q: jc.process_normalized(xj, q, clip_params=True, noise=nj))
    y_j = np.asarray(run_j(jnp.asarray(p)))
    g_j = np.asarray(jax.jit(jax.grad(lambda q: jnp.mean(run_j(q) ** 2)))(jnp.asarray(p)))
    pt = torch.tensor(p, requires_grad=True)
    y_t = tc.process_normalized(torch.tensor(x), pt, clip_params=True, noise=torch.tensor(noise))
    (y_t ** 2).mean().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, atol=A_TOL)
    grad_close(pt.grad.numpy(), g_j, GRAD_TOL, "chain gradient")


def test_style_chain_fixture_through_chain():
    """The reference's style chain (EQ -> compressor -> reverb -> gain at
    the defaults, its reverb noise) as one Chain on the concatenated
    parameter tensor: output and the gradient of each group of columns."""
    fx = load("style_chain")
    chain = P.Chain([P.ParametricEQ(SR), P.Compressor(SR),
                     P.NoiseShapedReverb(SR, num_samples=int(fx["num_samples"]),
                                         num_bandpass_taps=int(fx["num_taps"])), P.Gain(SR)])
    names = ("eq", "comp", "reverb", "gain")
    p = torch.tensor(np.concatenate([fx[f"param_{k}"] for k in names], 1), requires_grad=True)
    y = chain.process_normalized(torch.tensor(fx["x"]), p, clip_params=True, noise=torch.tensor(fx["noise"]))
    peak_close(y.detach().numpy(), fx["y"], PARITY_TOL, "style_chain: output")
    (y ** 2).mean().backward()
    col = 0
    for k in names:
        n = fx[f"param_{k}"].shape[1]
        peak_close(p.grad[:, col : col + n].numpy(), fx[f"grad_{k}"], PARITY_TOL, f"style_chain: grad_{k}")
        col += n


def test_chain_generator_rule():
    """The stochastic members draw from the one generator in chain order:
    the same generator state gives the same output, an advanced one other
    noise, and a member without noise inserted before the reverb leaves
    its noise unchanged."""
    x = torch.randn(1, 2, 256)
    rev = P.NoiseShapedReverb(SR, num_samples=128, num_bandpass_taps=31)
    chain = P.Chain([P.Gain(SR), rev])
    longer = P.Chain([P.Gain(SR), P.Gain(SR), rev])
    p = torch.rand(1, chain.num_params)
    p_longer = torch.cat([p[:, :1], torch.full((1, 1), 0.5), p[:, 1:]], 1)  # the middle gain: 0 dB

    def run(c, q, seed):
        return c.process_normalized(x, q, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(chain, p, 0), run(chain, p, 0))
    assert not torch.equal(run(chain, p, 0), run(chain, p, 1))
    gen = torch.Generator().manual_seed(0)
    first = chain.process_normalized(x, p, generator=gen)
    assert not torch.equal(first, chain.process_normalized(x, p, generator=gen))
    y = run(chain, p, 0)
    direct = rev.process_normalized(P.Gain(SR).process_normalized(x, p[:, :1]), p[:, 1:],
                                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, direct)
    assert torch.equal(run(longer, p_longer, 0), y)


def test_chain_checks():
    chain = P.Chain([P.Gain(SR), P.NoiseShapedReverb(SR, num_samples=128, num_bandpass_taps=31)])
    x = torch.randn(1, 2, 256)
    with pytest.raises(ValueError, match="generator= \\(or noise=\\)"):
        chain.process_normalized(x, torch.rand(1, chain.num_params))
    with pytest.raises(ValueError, match="26 parameters"):
        chain.process_normalized(x, torch.rand(1, 3), generator=torch.Generator())
    with pytest.raises(NotImplementedError):
        chain.process(x, SR)
    with pytest.raises(ValueError, match="at least one"):
        P.Chain([])
    assert not P.Chain([P.Gain(SR), P.Distortion(SR)]).stochastic


# ---------------------------------------------------------------------------
# _init_spec
# ---------------------------------------------------------------------------


def spec(proc):
    """``_init_spec`` with every processor in it replaced by its own spec,
    so specs of the two packages compare."""
    def norm(v):
        if isinstance(v, (D.Processor, P.Processor)):
            return spec(v)
        if isinstance(v, tuple):
            return tuple(norm(a) for a in v)
        if isinstance(v, dict):
            return {k: norm(a) for k, a in v.items()}
        return v

    name, args, kwargs = proc._init_spec
    return name, norm(args), norm(kwargs)


SPECS = [
    lambda pkg: pkg.Gain(SR),
    lambda pkg: pkg.Distortion(SR, 0.0, max_drive_db=12.0),
    lambda pkg: pkg.ParametricEQ(SR, filter_method="block"),
    lambda pkg: pkg.Compressor(SR, smoother="block", max_ratio=8.0),
    lambda pkg: pkg.StereoBus(SR, 4),
    lambda pkg: pkg.StereoBus(SR, num_tracks=2, max_send_db=6.0),
    lambda pkg: pkg.StereoWidener(SR),
    lambda pkg: pkg.StereoPanner(SR, min_pan=0.1),
    lambda pkg: pkg.NoiseShapedReverb(SR, num_samples=1024),
    lambda pkg: pkg.Chorus(SR),
    lambda pkg: pkg.Chain([pkg.Distortion(SR), pkg.Chain([pkg.Gain(SR), pkg.StereoWidener(SR)])]),
    lambda pkg: pkg.Chain(iter([pkg.Gain(SR), pkg.PitchShift(SR, window_ms=40.0)])),
]


@pytest.mark.parametrize("make", SPECS)
def test_init_spec_matches_jax(make):
    s_t, s_j = spec(make(P)), spec(make(D))
    assert s_t == s_j


def test_init_spec_snapshots_sequences():
    procs = [P.Gain(SR)]
    chain = P.Chain(procs)
    procs.append(P.Distortion(SR))
    assert len(chain._init_spec[1][0]) == 1 and isinstance(chain._init_spec[1][0], tuple)


# ---------------------------------------------------------------------------
# signal functions and their fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["one_pole_butter_lowpass", "one_pole_butter_highpass"])
def test_one_pole_butter_matches_jax(fn):
    f_c = np.random.default_rng(7).uniform(20, 18000, (4,)).astype(np.float32)
    want = getattr(JO, fn)(jnp.asarray(f_c), SR)
    got = getattr(TO, fn)(torch.tensor(f_c), SR)
    for g, w in zip(got, want):
        peak_close(g.numpy(), np.asarray(w), 1e-6, fn)


@pytest.mark.parametrize("ftype", ["highpass", "lowpass"])
def test_one_pole_filter_matches_jax(ftype):
    cutoff = np.random.default_rng(8).uniform(0.05, 0.95, (3,)).astype(np.float32)
    want = JO.one_pole_filter(jnp.asarray(cutoff), ftype, 2.0)
    got = TO.one_pole_filter(torch.tensor(cutoff), ftype, 2.0)
    for g, w in zip(got, want):
        peak_close(g.numpy(), np.asarray(w), 1e-6, ftype)
    with pytest.raises(ValueError, match="filter_type"):
        TO.one_pole_filter(torch.tensor(cutoff), "bandpass")


@pytest.mark.parametrize("T,K,block", [(1000, 63, None), (777, 1, 64), (4096, 300, 512)])
def test_fft_convolutions_match_jax(T, K, block):
    rng = np.random.default_rng(9 + K)
    x = rng.standard_normal((2, 2, T)).astype(np.float32)
    h = rng.standard_normal((2, K)).astype(np.float32)
    xj, hj, xt, ht = jnp.asarray(x), jnp.asarray(h), torch.tensor(x), torch.tensor(h)
    full = TO.fft_conv_full(xt, ht).numpy()
    assert full.shape == (2, 2, T + K - 1)
    peak_close(full, np.asarray(JO.fft_conv_full(xj, hj)), TOL, "fft_conv_full")
    ola = TO.ola_conv_causal(xt, ht, block).numpy()
    peak_close(ola, np.asarray(JO.ola_conv_causal(xj, hj, block)), TOL, "ola_conv_causal")
    peak_close(ola, TO.fft_conv_causal(xt, ht).numpy(), TOL, "ola against one FFT")


@pytest.mark.parametrize("ftype", ["high_shelf", "low_shelf", "peaking", "low_pass", "high_pass"])
def test_biquad_fixture(ftype):
    fx = load(f"biquad_{ftype}")
    b, a = TO.biquad(*(torch.tensor(fx[k]) for k in ("gain_db", "cutoff", "q")), SR, ftype)
    peak_close(b.numpy(), fx["b"], 1e-6, f"biquad_{ftype}: b")
    peak_close(a.numpy(), fx["a"], 1e-6, f"biquad_{ftype}: a")


def test_filterbank_fixture():
    peak_close(TO.octave_band_filterbank(1023, SR).numpy(), load("filterbank")["filters"], 1e-6, "filterbank")
