"""The dynamics family of dasp_tpu_torch and the rest of ``ops/iir.py``
against dasp_tpu: the first-order scans, ``ballistics_smooth`` in every mode,
``peak_decay``, ``sosfilt_coupled``, the twelve effects and their processors
(expander, sidechain compressor, noise gate, de-esser, limiter, multiband
compressor, transient shaper, graphic EQ, exciter, advanced distortion,
bitcrusher, clipper), and the mastering-dynamics step.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances,
with their reasons (the rules of tests/test_torch_reference_set.py):

* in fp32 against JAX (the five kernel users' processors at their
  defaults, advanced_distortion's tone-filter methods): outputs 1e-5 of
  max(1, peak) (fp32 rounding; the ballistics kernel's plain loop rounds
  each step where JAX may contract the update into an FMA, and the port's
  "coupled" and "block" filters compute in float64 where JAX's round in
  fp32), gradients 1e-4 of the largest (the repo's parity bar);
* in float64 on both sides (every effect, called directly and through
  its processor, which share one JAX compile; the options): 1e-9 of the
  same scales. Functions that pick a branch per sample from a comparison
  (the "parallel" ballistics, the transient shaper's relu and caps) are
  held there: an ulp's difference flips a branch, and the results then
  differ by much more than an ulp.
  The transient shaper's gradient with respect to the audio is held at
  sustain = 0: where the level rises, both peak-decay followers equal it,
  so relu(pd_slow - pd_fast) sits on its kink and the sign of an ulp-scale
  difference gates the sustain path's gradient. That is a property of the
  reference: its jitted and eager x-gradients differ there by 0.29 of the
  largest (float64, CPU), and the port's equals the eager one (4e-16);
* the first-order scans and ``peak_decay`` in fp32: 1e-6 of max(1, peak)
  (the same combine order as ``lax.associative_scan``; FMAs apart);
* ``sosfilt_coupled`` against float64 ``scipy.signal.sosfilt``: 1e-6 of
  max(1, peak) (one rounding of a float64 result to fp32);
* tie gradients (running maxima on plateaus) exactly: JAX splits a tie's
  gradient by its balanced max, and so does the port;
* the mastering step in float64 (limiter "exact" on both sides): loss and
  the gradient of z 1e-9. In fp32 the gradient of z is ill-conditioned:
  JAX's own sits 7.9e-3 of the largest from its float64 one (the
  crossover frequencies' entries leading), the port's 9.7e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import dasp_tpu as D
import dasp_tpu.functional as JF
import dasp_tpu.ops.iir as JI
import dasp_tpu_torch as P
import dasp_tpu_torch.functional as PF
import dasp_tpu_torch.ops as TO
from dasp_tpu.utils import multi_resolution_stft_loss as j_mrstft
from dasp_tpu_torch import train as TR

from test_torch_fsm import jax_dtype

SR = 44100
TOL = {"float32": 1e-5, "float64": 1e-9}
GRAD_TOL = {"float32": 1e-4, "float64": 1e-9}
SCAN_TOL = 1e-6
B_USERS = ("Expander", "SidechainCompressor", "NoiseGate", "DeEsser", "Limiter")


def peak_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, f"{what}: {actual.shape} vs {expected.shape}"
    scale = max(1.0, float(np.abs(expected).max()))
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} * {scale:.3g}"


def grad_close(actual, expected, tol, what=""):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    assert actual.shape == expected.shape, f"{what}: {actual.shape} vs {expected.shape}"
    scale = float(np.abs(expected).max())
    err = float(np.abs(actual - expected).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol:.0e} of the largest {scale:.3g}"


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def grad_of(leaf):
    """A leaf's gradient, zeros where autograd never reached it."""
    return np.zeros(leaf.shape) if leaf.grad is None else leaf.grad.numpy()


def jit(fn):
    """jax.jit for a program that is compiled once and run once: compiled
    without the backend's (LLVM's) optimizations, which take about a third
    of a compile here. The values differ only in rounding (no multiply-add
    contraction)."""
    return lambda *args: jax.jit(fn).lower(*args).compile({"xla_backend_optimization_level": 0})(*args)


# ---------------------------------------------------------------------------
# the first-order scans
# ---------------------------------------------------------------------------


def gain_curve(rng, shape, dtype=np.float32):
    """A gain-reduction-like curve in dB: a random walk below 0."""
    return (-np.abs(np.cumsum(rng.standard_normal(shape), -1)) - rng.uniform(0, 6, shape)).astype(dtype)


def test_ballistics_default_mode_matches_jax():
    """Both packages' ballistics_smooth with no mode: "parallel" in both
    (the port's default was "exact", 3.79 dB away on this input)."""
    rng = np.random.default_rng(0)
    g = (-np.abs(rng.standard_normal((2, 1, 4096))) * 10).astype(np.float32)
    aa = np.full((2, 1, 1), 0.99, np.float32)
    ar = np.full((2, 1, 1), 0.9995, np.float32)
    y_j = np.asarray(jit(JI.ballistics_smooth)(jnp.asarray(g), jnp.asarray(aa), jnp.asarray(ar)))
    y_t = TO.ballistics_smooth(t(g), t(aa), t(ar)).numpy()
    peak_close(y_t, y_j, SCAN_TOL, "default mode")


@pytest.mark.parametrize("mode", ["parallel", "attack_only", "exact"])
@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_modes_match_jax(mode, with_y0):
    """Every mode in float64 on both sides, with and without a carried
    state: output, final state and the gradients of g, both coefficients
    and y0."""
    rng = np.random.default_rng(1)
    g = gain_curve(rng, (2, 1, 2048), np.float64)
    aa = np.exp(-np.log(9) / (SR * rng.uniform(1e-3, 2e-2, (2, 1, 1))))
    ar = np.exp(-np.log(9) / (SR * rng.uniform(5e-2, 0.5, (2, 1, 1))))
    y0 = (-rng.uniform(0, 12, (2, 1)), -rng.uniform(0, 12, (2, 1))) if with_y0 else None
    w = rng.standard_normal(g.shape)
    with jax_dtype("float64"):
        def jf(g, aa, ar, y0):
            y, (ya, ym) = JI.ballistics_smooth(g, aa, ar, mode=mode, y0=y0, return_yf=True)
            return jnp.sum(y * w) + jnp.sum(ya) + 2.0 * jnp.sum(ym), (y, ya, ym)

        args = [jnp.asarray(g), jnp.asarray(aa), jnp.asarray(ar), None if y0 is None else tuple(map(jnp.asarray, y0))]
        (_, outs_j), grads_j = jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    gt, at, rt = t(g, True), t(aa, True), t(ar, True)
    y0t = None if y0 is None else tuple(t(v, True) for v in y0)
    y, (ya, ym) = TO.ballistics_smooth(gt, at, rt, mode=mode, y0=y0t, return_yf=True)
    ((y * t(w)).sum() + ya.sum() + 2.0 * ym.sum()).backward()
    for got, want, what in zip((y, ya, ym), outs_j, ("y", "ya_f", "ym_f")):
        peak_close(got.detach().numpy(), want, TOL["float64"], f"{mode} {what}")
    leaves = (gt, at, rt) + (() if y0 is None else y0t)
    wants = list(grads_j[:3]) + ([] if y0 is None else list(grads_j[3]))
    for i, (got, want) in enumerate(zip(leaves, wants)):
        want = np.asarray(want)
        if np.abs(want).max() == 0:  # "attack_only" has no release; "exact" and it use only y_main
            assert not np.abs(grad_of(got)).max() > 0
        else:
            grad_close(grad_of(got), want, GRAD_TOL["float64"], f"{mode} grad {i}")


@pytest.mark.parametrize("mode", ["parallel", "attack_only", "exact"])
def test_ballistics_chunk_chained_equals_one_pass(mode):
    """y0 / return_yf carried across three uneven chunks equals one pass:
    bitwise for the loop, within float64 rounding for the scans (whose
    trees differ with the chunk lengths)."""
    rng = np.random.default_rng(2)
    dtype = torch.float32 if mode == "exact" else torch.float64
    g = torch.tensor(gain_curve(rng, (2, 1, 3000), np.float64), dtype=dtype)
    aa, ar = torch.tensor([0.99, 0.995], dtype=dtype), torch.tensor([0.9995, 0.9999], dtype=dtype)
    aa, ar = aa.reshape(2, 1, 1), ar.reshape(2, 1, 1)
    full = TO.ballistics_smooth(g, aa, ar, mode=mode)
    state, parts = None, []
    for a, b in ((0, 1000), (1000, 1777), (1777, 3000)):
        part, state = TO.ballistics_smooth(g[..., a:b], aa, ar, mode=mode, y0=state, return_yf=True)
        parts.append(part)
    chained = torch.cat(parts, dim=-1)
    if mode == "exact":
        assert torch.equal(chained, full)
    else:
        peak_close(chained.numpy(), full.numpy(), 1e-12, mode)


FIRST_ORDER = ["onepole_exact", "onepole_exact_y0", "onepole_varying", "lfilter1_exact"]


@pytest.mark.parametrize("name", FIRST_ORDER)
def test_first_order_scans_match_jax(name):
    """fp32, the associative scan in JAX's combine order: output and the
    gradients of every input."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 4096)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    if name.startswith("onepole_exact"):
        alpha = rng.uniform(0.9, 0.9999, (2, 1, 1)).astype(np.float32)
        args = [x, alpha] + ([rng.standard_normal((2, 2)).astype(np.float32)] if name.endswith("y0") else [])
        jfn, tfn = JI.onepole_exact, TO.onepole_exact
    elif name == "onepole_varying":
        args = [x, rng.uniform(0.9, 0.9999, x.shape).astype(np.float32)]
        jfn, tfn = JI.onepole_varying, TO.onepole_varying
    else:
        a1 = -rng.uniform(0.5, 0.999, (2, 1, 1)).astype(np.float32)
        args = [x, rng.standard_normal((2, 1, 2)).astype(np.float32),
                np.concatenate([np.ones_like(a1), a1], -1)]
        jfn, tfn = JI.lfilter1_exact, TO.lfilter1_exact
    (_, y_j), grads_j = jit(jax.value_and_grad(
        lambda *a: (lambda y: (jnp.sum(y * w), y))(jfn(*a)), argnums=tuple(range(len(args))), has_aux=True))(
        *map(jnp.asarray, args))
    ts = [t(a, True) for a in args]
    y_t = tfn(*ts)
    (y_t * t(w)).sum().backward()
    peak_close(y_t.detach().numpy(), y_j, SCAN_TOL, name)
    for i, (got, want) in enumerate(zip(ts, grads_j)):
        grad_close(got.grad.numpy(), want, GRAD_TOL["float32"], f"{name} grad {i}")


# ---------------------------------------------------------------------------
# running maxima: peak_decay, the noise gate's hold, tie gradients
# ---------------------------------------------------------------------------


def test_tie_gradients_match_jax():
    """The running max's gradient on ties: JAX's lax.cummax splits it (its
    JVP is an associative scan of a balanced max); torch.cummax gives it
    all to the last tied index; the port's running_max gives JAX's."""
    v = np.array([1, 3, 3, 2, 3, 0], np.float32)
    w = np.arange(1, 7, dtype=np.float32)
    want = np.asarray(jit(jax.grad(lambda v: jnp.sum(jax.lax.cummax(v) * w)))(jnp.asarray(v)))
    np.testing.assert_array_equal(want, [1, 8.25, 6.25, 0, 5.5, 0])
    vt = t(v, True)
    (TO.iir.running_max(vt, 0) * t(w)).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), want)
    vc = t(v, True)
    (torch.cummax(vc, 0).values * t(w)).sum().backward()
    assert not np.array_equal(vc.grad.numpy(), want)
    want_rev = np.asarray(jit(jax.grad(lambda v: jnp.sum(jax.lax.cummax(v, reverse=True) * w)))(jnp.asarray(v)))
    vr = t(v, True)
    (TO.iir.running_max(vr, 0, reverse=True) * t(w)).sum().backward()
    np.testing.assert_array_equal(vr.grad.numpy(), want_rev)


@pytest.mark.parametrize("with_y0", [False, True])
def test_peak_decay_matches_jax(with_y0):
    """fp32 on a curve with plateaus (ties in g + delta n): output, final
    state, and the gradients of g, delta and y0."""
    rng = np.random.default_rng(4)
    g = np.round(gain_curve(rng, (2, 1, 4096)) / 3.0) * 3.0
    delta = rng.uniform(0.001, 0.02, (2, 1, 1)).astype(np.float32)
    w = rng.standard_normal(g.shape).astype(np.float32)
    y0 = rng.uniform(-3, 0, (2, 1)).astype(np.float32) if with_y0 else None

    def jf(g, d, y0):
        y, yf = JI.peak_decay(g, d, y0=y0, return_yf=True)
        return jnp.sum(y * w) + jnp.sum(yf), y

    (_, y_j), gr_j = jit(jax.value_and_grad(jf, argnums=(0, 1, 2) if with_y0 else (0, 1), has_aux=True))(
        jnp.asarray(g), jnp.asarray(delta), None if y0 is None else jnp.asarray(y0))
    gt, dt = t(g, True), t(delta, True)
    y0t = None if y0 is None else t(y0, True)
    y, yf = TO.peak_decay(gt, dt, y0=y0t, return_yf=True)
    ((y * t(w)).sum() + yf.sum()).backward()
    peak_close(y.detach().numpy(), y_j, SCAN_TOL, "peak_decay")
    for got, want, what in zip((gt, dt, y0t), gr_j, ("g", "delta", "y0")):
        grad_close(got.grad.numpy(), want, GRAD_TOL["float32"], f"peak_decay d{what}")


def test_peak_decay_chunk_chained_equals_one_pass():
    rng = np.random.default_rng(5)
    g = torch.tensor(gain_curve(rng, (2, 1, 3000), np.float64))
    delta = torch.tensor([0.01, 0.003], dtype=torch.float64).reshape(2, 1, 1)
    full = TO.peak_decay(g, delta)
    state, parts = None, []
    for a, b in ((0, 1200), (1200, 2500), (2500, 3000)):
        part, state = TO.peak_decay(g[..., a:b], delta, y0=state, return_yf=True)
        parts.append(part)
    peak_close(torch.cat(parts, -1).numpy(), full.numpy(), 1e-12, "peak_decay chunks")


@pytest.mark.parametrize("hold", [0, 1, 37, 300])
def test_hold_max_matches_jax(hold):
    """The noise gate's causal moving maximum (van Herk) on a curve with
    plateaus: exact values, and JAX's tie gradients."""
    rng = np.random.default_rng(6)
    g = np.round(gain_curve(rng, (2, 2, 2000)) / 4.0) * 4.0
    w = rng.standard_normal(g.shape).astype(np.float32)
    (_, y_j), gr_j = jit(jax.value_and_grad(
        lambda g: (lambda y: (jnp.sum(y * w), y))(JF._hold_max(g, hold)), has_aux=True))(jnp.asarray(g))
    y_j = np.asarray(y_j)
    gt = t(g, True)
    y_t = PF._hold_max(gt, hold)
    (y_t * t(w)).sum().backward()
    np.testing.assert_array_equal(y_t.detach().numpy(), y_j)
    want = np.lib.stride_tricks.sliding_window_view(np.pad(g, ((0, 0), (0, 0), (hold, 0)),
                                                            constant_values=-np.inf), hold + 1, -1).max(-1)
    np.testing.assert_array_equal(y_j, want)
    grad_close(gt.grad.numpy(), gr_j, 1e-6, f"hold {hold}")


# ---------------------------------------------------------------------------
# sosfilt_coupled
# ---------------------------------------------------------------------------


def graphic_sections(rng, bs=2):
    """The graphic EQ's ten bands (31.5 Hz to 16 kHz) at gains on +-12 dB,
    the first row at +12 dB on every band."""
    gains = rng.uniform(-12, 12, (bs, 10)).astype(np.float32)
    gains[0] = 12.0
    return np.asarray(jit(lambda g: JF.graphic_eq_sos(bs, jnp.float32, SR, g))(jnp.asarray(gains))), gains


def scipy_sosfilt(sos, x):
    return np.stack([np.stack([scipy.signal.sosfilt(sos[b].astype(np.float64), x[b, c].astype(np.float64))
                               for c in range(x.shape[1])]) for b in range(x.shape[0])])


def test_sosfilt_coupled_matches_scipy_and_jax():
    """The graphic EQ's full band set, 31.5 Hz included: fp32 output within
    one rounding of float64 scipy; JAX's fp32 evaluation is further off
    (printed); against JAX in float64, output and the gradients of the
    sections and x."""
    rng = np.random.default_rng(7)
    sos, _ = graphic_sections(rng)
    x = (rng.standard_normal((2, 2, 4096)) * 0.3).astype(np.float32)
    ref = scipy_sosfilt(sos, x)
    y_t = TO.sosfilt_coupled(t(sos), t(x)).numpy()
    assert y_t.dtype == np.float32
    peak_close(y_t, ref, SCAN_TOL, "coupled vs scipy")
    y_j32 = np.asarray(jit(JI.sosfilt_coupled)(jnp.asarray(sos), jnp.asarray(x)))
    print(f"from float64 scipy, of max(1, peak): port {np.abs(y_t - ref).max() / max(1, np.abs(ref).max()):.2e}, "
          f"JAX fp32 {np.abs(y_j32 - ref).max() / max(1, np.abs(ref).max()):.2e}")

    w = rng.standard_normal(x.shape)
    sos64, x64 = sos.astype(np.float64), x.astype(np.float64)
    with jax_dtype("float64"):
        (_, y_j), gr_j = jit(jax.value_and_grad(
            lambda s, x: (lambda y: (jnp.sum(y * w), y))(JI.sosfilt_coupled(s, x)), argnums=(0, 1), has_aux=True))(
            jnp.asarray(sos64), jnp.asarray(x64))
        y_j = np.asarray(y_j)
    st, xt = t(sos64, True), t(x64, True)
    y64 = TO.sosfilt_coupled(st, xt)
    (y64 * t(w)).sum().backward()
    peak_close(y64.detach().numpy(), y_j, TOL["float64"], "coupled vs JAX float64")
    peak_close(y64.detach().numpy(), ref, 1e-12, "coupled float64 vs scipy")
    grad_close(st.grad.numpy(), gr_j[0], GRAD_TOL["float64"], "dsos")
    grad_close(xt.grad.numpy(), gr_j[1], GRAD_TOL["float64"], "dx")


def test_sosfilt_coupled_streaming_equals_one_pass():
    """zi / return_zf carried across chunks (multiples of the block) equals
    one pass; the state is the JAX package's, (bs, chs, S, 2)."""
    rng = np.random.default_rng(8)
    sos, _ = graphic_sections(rng)
    x = torch.tensor(rng.standard_normal((2, 2, 1024)) * 0.3)
    full, zf_full = TO.sosfilt_coupled(torch.tensor(sos), x, return_zf=True)
    zi, parts = None, []
    for a, b in ((0, 256), (256, 640), (640, 1024)):
        part, zi = TO.sosfilt_coupled(torch.tensor(sos), x[..., a:b], zi=zi, return_zf=True)
        parts.append(part)
    assert zi.shape == (2, 2, 10, 2)
    peak_close(torch.cat(parts, -1).numpy(), full.numpy(), 1e-12, "chunks")
    peak_close(zi.numpy(), zf_full.numpy(), 1e-12, "final state")
    with jax_dtype("float64"):
        _, zf_j = jit(lambda s, x: JI.sosfilt_coupled(s, x, return_zf=True))(jnp.asarray(sos, jnp.float64),
                                                                          jnp.asarray(x.numpy()))
    peak_close(zf_full.numpy(), np.asarray(zf_j), 1e-9, "final state against JAX")
    with pytest.raises(ValueError, match="multiple of block"):
        TO.sosfilt_coupled(torch.tensor(sos), x[..., :1000], return_zf=True)


@pytest.mark.parametrize("method", ["coupled", "exact", "block", "fsm"])
def test_first_order_methods_match_jax(method):
    """advanced_distortion's tone filters through every first-order method
    (the coupled cascade on a real pole takes its controller form)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 2, 2048)) * 0.5).astype(np.float32)
    params = {"input_gain_db": np.array([6.0, 18.0], np.float32), "output_gain_db": np.array([-3.0, -9.0], np.float32),
              "tone": np.array([0.3, 0.8], np.float32), "dc_offset": np.array([0.05, -0.02], np.float32)}
    run_effect_case("advanced_distortion", x, params, {"filter_method": method}, "float32")


# ---------------------------------------------------------------------------
# the effects
# ---------------------------------------------------------------------------


def effect_inputs(name, dtype, T=2048, seed=10):
    """x, the denormalized parameters from the JAX processor's ranges, and
    side inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    proc = getattr(D, name)(SR)
    x = (rng.standard_normal((2, 2, T)) * 0.3).astype(dtype)
    p = rng.uniform(0.05, 0.95, (2, proc.num_params))
    params = {k: np.asarray(lo + v * (hi - lo), dtype)
              for (k, (lo, hi)), v in zip(proc.param_ranges.items(), p.T)}
    if name == "GraphicEQ":
        params = {"band_gains_db": np.stack([params[f"band{i}_gain_db"] for i in range(10)], -1)}
    side = {"sidechain": (rng.standard_normal((2, 1, T)) * 0.5).astype(dtype)} if name == "SidechainCompressor" else {}
    return x, params, side


FUNCTIONS = {
    "AdvancedDistortion": "advanced_distortion", "GraphicEQ": "graphic_eq", "Expander": "expander",
    "SidechainCompressor": "sidechain_compressor", "NoiseGate": "noise_gate", "DeEsser": "de_esser",
    "Bitcrusher": "bitcrusher", "TransientShaper": "transient_shaper", "Exciter": "exciter", "Clipper": "clipper",
    "Limiter": "limiter", "MultibandCompressor": "multiband_compressor",
}


def run_effect_case(fn_name, x, params, options, dtype, side=None):
    """Output and the gradient of mean(y ** 2) with respect to x, every
    parameter and the side inputs, in both packages; held to the tolerances
    of ``dtype``."""
    side = side or {}
    jfn, tfn = getattr(JF, fn_name), getattr(PF, fn_name)
    names = ["x", *params, *side]
    arrays = [x, *params.values(), *side.values()]

    def jloss(*arrs):
        kw = dict(zip(names[1:], arrs[1:]))
        y = jfn(arrs[0], SR, **{k: kw[k] for k in params}, **{k: kw[k] for k in side}, **options)
        return jnp.mean(y ** 2), y

    with jax_dtype(dtype):
        vg = jax.value_and_grad(jloss, argnums=tuple(range(len(arrays))), has_aux=True)
        (_, y_j), g_j = jit(vg)(*map(jnp.asarray, arrays))
        y_j, g_j = np.asarray(y_j), [np.asarray(g) for g in g_j]
    ts = [t(a, True) for a in arrays]
    kw = dict(zip(names[1:], ts[1:]))
    y_t = tfn(ts[0], SR, **kw, **options)
    (y_t ** 2).mean().backward()
    assert y_t.dtype == ts[0].dtype
    peak_close(y_t.detach().numpy(), y_j, TOL[dtype], f"{fn_name} {options}: output")
    for n, got, want in zip(names, ts, g_j):
        grad_close(grad_of(got), want, GRAD_TOL[dtype], f"{fn_name} {options}: d{n}")


def processor_inputs(name, T=1024, seed=12):
    """x, normalized parameters and side inputs (float64 numpy arrays) for
    the processor ``name`` (the transient shaper's sustain at 0, see the
    module docstring), and the options of its float64 evaluation: the
    kernel users with smoother "exact", the recursion of their default
    (JAX's Pallas kernel runs only fp32)."""
    rng = np.random.default_rng(seed)
    proc = getattr(D, name)(SR)
    x = rng.standard_normal((2, 2, T)) * 0.3
    p = rng.uniform(0.05, 0.95, (2, proc.num_params))
    if name == "TransientShaper":
        lo, hi = proc.param_ranges["sustain"]
        p[:, list(proc.param_ranges).index("sustain")] = -lo / (hi - lo)
    side = {"sidechain": rng.standard_normal((2, 1, T)) * 0.5} if name == "SidechainCompressor" else {}
    options = {"smoother": "exact"} if name in B_USERS else {}
    return x, p, side, options


@functools.lru_cache(maxsize=None)
def jax_processor(name, dtype):
    """JAX's processor ``name`` on processor_inputs in ``dtype``: the output
    and the gradients of mean(y ** 2) with respect to x, the normalized
    parameters and the side inputs. In float64 with processor_inputs'
    options, in fp32 at the constructor defaults. One compile for each
    (name, dtype), which the tests of the function and of the processor
    share."""
    x, p, side, options = processor_inputs(name)
    proc = getattr(D, name)(SR, **(options if dtype == "float64" else {}))

    def jloss(x, q, *s):
        y = proc.process_normalized(x, q, **dict(zip(side, s)))
        return jnp.mean(y ** 2), y

    arrays = [np.asarray(a, dtype) for a in (x, p, *side.values())]
    with jax_dtype(dtype):
        (_, y_j), g_j = jit(jax.value_and_grad(jloss, argnums=tuple(range(len(arrays))), has_aux=True))(
            *map(jnp.asarray, arrays))
        return np.asarray(y_j), [np.asarray(g) for g in g_j]


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_effect_matches_jax_float64(name):
    """Each effect in float64 on both sides, called with the denormalized
    parameters (the kernel users with smoother "exact"; the transient
    shaper at sustain = 0, see the module docstring), against JAX's
    processor on the same values: a parameter's gradient is the
    normalized one over the width of its range."""
    x, p, side, options = processor_inputs(name)
    y_j, (dx_j, dp_j, *ds_j) = jax_processor(name, "float64")
    ranges = getattr(D, name)(SR).param_ranges
    width = np.array([hi - lo for lo, hi in ranges.values()])
    values = np.array([lo for lo, _ in ranges.values()]) + p * width
    if name == "GraphicEQ":
        params, wants = {"band_gains_db": values}, [dp_j / width]
    else:
        params, wants = dict(zip(ranges, values.T)), list((dp_j / width).T)
    ts = [t(a, True) for a in (x, *params.values(), *side.values())]
    kw = dict(zip([*params, *side], ts[1:]))
    y_t = getattr(PF, FUNCTIONS[name])(ts[0], SR, **kw, **options)
    (y_t ** 2).mean().backward()
    assert y_t.dtype == torch.float64
    peak_close(y_t.detach().numpy(), y_j, TOL["float64"], f"{name}: output")
    for what, got, want in zip(("x", *params, *side), ts, (dx_j, *wants, *ds_j)):
        grad_close(grad_of(got), want, GRAD_TOL["float64"], f"{name}: d{what}")


OPTION_CASES = [
    ("noise_gate", {"smoother": "parallel", "hold_ms": 5.0}),
    ("sidechain_compressor", {"lookahead_samples": 64}),
    ("limiter", {"lookahead_samples": 100, "smoother": "attack_only"}),
    ("de_esser", {"mode": "wideband", "filter_method": "block", "smoother": "parallel"}),
    ("multiband_compressor", {"filter_method": "fsm", "smoother": "fsm"}),
    ("multiband_compressor", {"filter_method": "block", "smoother": "parallel"}),
    ("graphic_eq", {"filter_method": "block"}),
    ("transient_shaper", {"smoother": "exact"}),
]


@pytest.mark.parametrize("fn_name,options", OPTION_CASES, ids=[f"{n}-{'-'.join(map(str, o.values()))}"
                                                               for n, o in OPTION_CASES])
def test_effect_options_match_jax(fn_name, options):
    """The options other than the defaults, in float64 on both sides (the
    kernel users' default smoother as "exact"; the transient shaper at
    sustain = 0)."""
    name = next(k for k, v in FUNCTIONS.items() if v == fn_name)
    x, params, side = effect_inputs(name, "float64", T=512, seed=11)
    if name == "TransientShaper":
        params["sustain"] = np.zeros_like(params["sustain"])
    if name in B_USERS:
        options = {"smoother": "exact", **options}
    run_effect_case(fn_name, x, params, options, "float64", side)


def test_bitcrusher_rounds_half_to_even_with_the_surrogate_gradient():
    """The quantizer's value is round (half to even, as jnp.round) and its
    gradient the surrogate's: at bit depth 2 (scale 2) the inputs +-0.25
    and 0.75 land on the half points 0.5 and 1.5."""
    x = torch.tensor([[[0.25, -0.25, 0.75, 0.1]]], requires_grad=True)
    y = PF.bitcrusher(x, SR, 2.0, float(SR), 1.0)
    np.testing.assert_array_equal(y.detach().numpy()[0, 0], [0.0, 0.0, 1.0, 0.0])
    y.sum().backward()
    u = 2.0 * x.detach().numpy()[0, 0]
    np.testing.assert_allclose(x.grad.numpy()[0, 0], 1.0 - np.cos(2 * np.pi * u), atol=1e-6)


def test_sidechain_compressor_checks_its_key():
    x = torch.zeros(2, 1, 64)
    with pytest.raises(ValueError, match="requires `sidechain`"):
        PF.sidechain_compressor(x, SR, -20.0, 4.0, 5.0, 50.0, 6.0, 0.0)
    with pytest.raises(ValueError, match="does not match"):
        PF.sidechain_compressor(x, SR, -20.0, 4.0, 5.0, 50.0, 6.0, 0.0, sidechain=torch.zeros(2, 1, 32))
    with pytest.raises(ValueError, match="noise_gate smoother"):
        PF.noise_gate(x, SR, -40.0, 4.0, 40.0, 1.0, 50.0, 6.0, smoother="fsm")


# ---------------------------------------------------------------------------
# the processors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_processor_matches_jax(name):
    """process_normalized: ranges, the constructor record and the side
    inputs as JAX's; in float64 (the kernel users with smoother "exact")
    against JAX's processor, output and the gradients of mean(y ** 2) with
    respect to x, the normalized parameters and the side inputs; for the
    five kernel users also in fp32 at the constructor defaults, the
    ballistics kernel's plain loop against JAX's Pallas kernel in
    interpret mode (no branch there is decided by a near-tie)."""
    jp, tp = getattr(D, name)(SR), getattr(P, name)(SR)
    assert tp.param_ranges == jp.param_ranges
    assert tp._init_spec == jp._init_spec
    assert tp.consumes_kwargs == jp.consumes_kwargs
    x, p, side, options = processor_inputs(name)
    for dtype in ("float64", "float32") if name in B_USERS else ("float64",):
        y_j, g_j = jax_processor(name, dtype)
        ts = [t(np.asarray(a, dtype), True) for a in (x, p, *side.values())]
        proc = getattr(P, name)(SR, **(options if dtype == "float64" else {}))
        y_t = proc.process_normalized(ts[0], ts[1], **dict(zip(side, ts[2:])))
        (y_t ** 2).mean().backward()
        assert y_t.dtype == ts[0].dtype
        peak_close(y_t.detach().numpy(), y_j, TOL[dtype], f"{name} {dtype}")
        for what, got, want in zip(("x", "p", *side), ts, g_j):
            grad_close(grad_of(got), want, GRAD_TOL[dtype], f"{name} {dtype} d{what}")


SPECS = [
    lambda pkg: pkg.NoiseGate(SR, hold_ms=10.0, smoother="parallel"),
    lambda pkg: pkg.DeEsser(SR, 1000.0, mode="wideband", filter_method="block"),
    lambda pkg: pkg.Limiter(SR, lookahead_samples=32, max_release_ms=200.0),
    lambda pkg: pkg.MultibandCompressor(SR, smoother="fsm", filter_method="fsm"),
    lambda pkg: pkg.GraphicEQ(SR, -6.0, 6.0),
    lambda pkg: pkg.Chain([pkg.TransientShaper(SR), pkg.Exciter(SR, max_amount=0.5)]),
]


@pytest.mark.parametrize("make", SPECS)
def test_init_spec_and_ranges_match_jax(make):
    p_t, p_j = make(P), make(D)
    assert p_t._init_spec[0] == p_j._init_spec[0]
    assert p_t._init_spec[2] == p_j._init_spec[2] and len(p_t._init_spec[1]) == len(p_j._init_spec[1])
    assert p_t.param_ranges == p_j.param_ranges


def test_graphic_eq_positional_passthrough():
    """GraphicEQ.process(x, sr, gains) takes the (bs, 10) gains as the
    functional effect does, and the filter_method keyword overrides the
    constructor's."""
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((2, 1, 512)).astype(np.float32))
    gains = torch.tensor(rng.uniform(-12, 12, (2, 10)).astype(np.float32))
    eq = P.GraphicEQ(SR)
    y = eq.process(x, SR, gains)
    assert torch.equal(y, PF.graphic_eq(x, SR, gains))
    assert torch.equal(eq.process(x, SR, gains, filter_method="exact"), PF.graphic_eq(x, SR, gains, "exact"))


def test_chain_forwards_the_sidechain():
    """Chain forwards ``sidechain=`` to the SidechainCompressor only."""
    rng = np.random.default_rng(14)
    x = torch.tensor((rng.standard_normal((2, 2, 512)) * 0.3).astype(np.float32))
    key = torch.tensor((rng.standard_normal((2, 1, 512)) * 0.5).astype(np.float32))
    chain = P.Chain([P.Clipper(SR), P.SidechainCompressor(SR), P.Exciter(SR)])
    p = torch.rand((2, chain.num_params), generator=torch.Generator().manual_seed(0))
    y = chain.process_normalized(x, p, sidechain=key)
    y1 = P.Clipper(SR).process_normalized(x, p[:, :2])
    y2 = P.SidechainCompressor(SR).process_normalized(y1, p[:, 2:8], sidechain=key)
    assert torch.equal(y, P.Exciter(SR).process_normalized(y2, p[:, 8:]))


# ---------------------------------------------------------------------------
# the mastering-dynamics step
# ---------------------------------------------------------------------------


def jax_mastering_loss():
    """examples/mastering.py's chain without its dynamic EQ, its limiter
    "exact": a function of (z, mix, target) giving the loss, the render and
    dz."""
    chain = D.Chain([D.TransientShaper(SR), D.MultibandCompressor(SR), D.Exciter(SR),
                     D.Limiter(SR, smoother="exact")])

    def loss(z, mix, target):
        y = chain.process_normalized(mix, jax.nn.sigmoid(z), clip_params=True)
        return j_mrstft(y, target) + 10.0 * jnp.mean((y - target) ** 2), y

    return jit(jax.value_and_grad(loss, has_aux=True))


def test_mastering_step_matches_jax():
    """examples/mastering.py's step without its dynamic EQ, at smoke size
    (bs 2 stereo clips of 4096 samples), in float64 on both sides with the
    limiter "exact" (JAX's kernel is fp32 only; the fp32 kernel path of
    each member is held by test_processor_matches_jax): mastering_step's
    loss, the gradient of z it leaves, and z after its Adam step (optax.adam
    at 2e-2); the render of mastering_loss. JAX's loss and render take the
    port's target (the chain's render from hidden parameters, the same
    function as the render)."""
    rng = np.random.default_rng(15)
    dtype = "float64"
    mix = (rng.standard_normal((2, 2, 4096)) * 0.25).astype(dtype)
    p_true = np.clip(0.5 + 0.25 * rng.standard_normal((2, 29)), 0.05, 0.95).astype(dtype)
    z0 = (0.3 * rng.standard_normal((2, 29))).astype(dtype)

    chain, z, opt = TR.make_mastering(SR, bs=2, device="cpu")
    assert chain.num_params == 47 and z.shape == (2, 47) and not z.detach().abs().max() > 0
    chain = P.Chain([P.TransientShaper(SR), P.MultibandCompressor(SR), P.Exciter(SR), P.Limiter(SR, smoother="exact")])
    with torch.no_grad():
        target = chain.process_normalized(t(mix), t(p_true), clip_params=True).numpy()
    with jax_dtype(dtype):
        (l_j, y_j), g_j = jax_mastering_loss()(*map(jnp.asarray, (z0, mix, target)))
        l_j, y_j, g_j = float(l_j), np.asarray(y_j), np.asarray(g_j)
    # optax.adam's first step: m and v bias-corrected to g and g^2
    z1_j = z0 - 2e-2 * g_j / (np.abs(g_j) + 1e-8)

    with torch.no_grad():
        _, y = TR.mastering_loss(chain, t(z0), t(mix), t(target))
    peak_close(y.numpy(), y_j, TOL[dtype], "render")
    z = t(z0, True)
    opt = torch.optim.Adam([z], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
    loss = TR.mastering_step(chain, z, opt, t(mix), t(p_true))
    assert abs(float(loss) - l_j) <= TOL[dtype] * abs(l_j), f"loss {float(loss)} vs {l_j}"
    grad_close(z.grad.numpy(), g_j, GRAD_TOL[dtype], "dz")
    # the first step moves each logit by the learning rate against dz's sign
    moved = z.detach().numpy() - z0
    big = np.abs(g_j) > 1e-2 * np.abs(g_j).max()
    np.testing.assert_allclose(moved[big], (z1_j - z0)[big], rtol=0, atol=1e-5)


def test_mastering_entry_points_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.make_mastering(SR)
