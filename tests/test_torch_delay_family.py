"""The rest of the delay family of dasp_tpu_torch against dasp_tpu: delay,
ring_modulator, tremolo, stereo_imager, convolution_reverb and wow_flutter,
each called directly and through its processor (Delay, RingModulator,
Tremolo, StereoImager, ConvolutionReverb, WowFlutter), and Chain's
forwarding of their side inputs (``ir=``, ``noise=``).

Inputs are numpy arrays from a seed, bs 2, 4096 samples. Each effect's JAX
reference is one compile of its processor, which the test of the function
(called with the denormalized parameters) and the test of the processor
share. Tolerances, the rules of tests/test_torch_dynamics.py:

* fp32: outputs within 1e-5 of max(1, peak), gradients of mean(y ** 2)
  within 1e-4 of the largest;
* float64 on both sides, 1e-9 of the same scales, where fp32 cannot tell a
  right port from a wrong one. ``wow_flutter``: its fp32 delay curve (a
  one-pole scan of the noise with its pole within 1e-4 of 1, normalized by
  its RMS) is ill-conditioned, so it is held against JAX in float64 from
  the same ``noise=``, and its fp32 path (the fractional-delay kernel's
  plain engine) against the port's float64 by the kernel's rule: at most
  twice JAX's fp32 distance plus the fp32 bars. ``stereo_imager``: its
  crossovers are ``"coupled"``, which the port computes in float64 inside
  and JAX in fp32 (tests/test_torch_dynamics.py). ``delay`` and
  ``ring_modulator``: the port computes the comb's phase ``w D`` and the
  carrier's ``2 pi f t`` in float64 (in fp32 they are off by up to 1e-2
  and 5e-3 rad at full length), where JAX's fp32 rounds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.functional as JF
import dasp_tpu_torch as P
import dasp_tpu_torch.functional as PF
from test_torch_dynamics import grad_close, grad_of, jit, peak_close, t
from test_torch_fsm import jax_dtype

SR = 44100
T = 4096
IR_TAPS = 1024
TOL = {"float32": 1e-5, "float64": 1e-9}
GRAD_TOL = {"float32": 1e-4, "float64": 1e-9}

# processor -> (function, the dtype it is held in)
EFFECTS = {
    "Delay": ("delay", "float64"),
    "RingModulator": ("ring_modulator", "float64"),
    "Tremolo": ("tremolo", "float32"),
    "StereoImager": ("stereo_imager", "float64"),
    "ConvolutionReverb": ("convolution_reverb", "float32"),
    "WowFlutter": ("wow_flutter", "float64"),
}


def inputs(name, dtype):
    """x, normalized parameters and side inputs (numpy, ``dtype``)."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 2, T)) * 0.3
    p = rng.uniform(0.05, 0.95, (2, getattr(D, name)(SR).num_params))
    side = {}
    if name == "ConvolutionReverb":
        side["ir"] = rng.standard_normal((2, IR_TAPS)) * np.exp(-np.arange(IR_TAPS) / 200.0)
    if name == "WowFlutter":
        side["noise"] = rng.standard_normal((2, 2, T))
    return [np.asarray(a, dtype) for a in (x, p)], {k: np.asarray(v, dtype) for k, v in side.items()}


@functools.lru_cache(maxsize=None)
def jax_processor(name, dtype):
    """JAX's processor on ``inputs``: output and the gradients of
    mean(y ** 2) with respect to x, the normalized parameters and the
    differentiable side inputs (the IR; not the noise)."""
    (x, p), side = inputs(name, dtype)
    proc = getattr(D, name)(SR)
    grad_side = [k for k in side if k != "noise"]

    def jloss(x, q, *s):
        kw = dict(zip(grad_side, s))
        kw.update({k: jnp.asarray(v) for k, v in side.items() if k == "noise"})
        y = proc.process_normalized(x, q, **kw)
        return jnp.mean(y ** 2), y

    arrays = [x, p, *(side[k] for k in grad_side)]
    with jax_dtype(dtype):
        (_, y), g = jit(jax.value_and_grad(jloss, argnums=tuple(range(len(arrays))), has_aux=True))(
            *map(jnp.asarray, arrays))
        return np.asarray(y), [np.asarray(v) for v in g]


def check(y_t, leaves, want_y, want_g, dtype, what):
    assert y_t.dtype == leaves[0].dtype
    peak_close(y_t.detach().numpy(), want_y, TOL[dtype], f"{what}: output")
    for i, (leaf, want) in enumerate(zip(leaves, want_g)):
        grad_close(grad_of(leaf), want, GRAD_TOL[dtype], f"{what}: gradient {i}")


@pytest.mark.parametrize("name", list(EFFECTS))
def test_processor_matches_jax(name):
    """process_normalized: ranges, the constructor record, the side inputs
    and stochasticity as JAX's; output and gradients against JAX's
    processor."""
    jp, tp = getattr(D, name)(SR), getattr(P, name)(SR)
    assert tp.param_ranges == jp.param_ranges
    assert tp._init_spec == jp._init_spec
    assert (tp.consumes_kwargs, tp.stochastic) == (jp.consumes_kwargs, jp.stochastic)
    dtype = EFFECTS[name][1]
    (x, p), side = inputs(name, dtype)
    xt, pt = t(x, True), t(p, True)
    side_t = {k: t(v, k != "noise") for k, v in side.items()}
    y = tp.process_normalized(xt, pt, **side_t)
    (y ** 2).mean().backward()
    want_y, want_g = jax_processor(name, dtype)
    check(y, [xt, pt, *(v for k, v in side_t.items() if k != "noise")], want_y, want_g, dtype, name)


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_matches_jax(name):
    """The function called with the denormalized parameters against JAX's
    processor on the same values (a parameter's gradient is the normalized
    one over the width of its range)."""
    fname, dtype = EFFECTS[name]
    (x, p), side = inputs(name, dtype)
    ranges = getattr(D, name)(SR).param_ranges
    width = np.array([hi - lo for lo, hi in ranges.values()])
    values = np.array([lo for lo, _ in ranges.values()]) + p * width
    want_y, (dx, dp, *ds) = jax_processor(name, dtype)
    leaves = [t(x, True)] + [t(v, True) for v in values.T]
    side_t = {k: t(v, k != "noise") for k, v in side.items()}
    y = getattr(PF, fname)(leaves[0], SR, **dict(zip(ranges, leaves[1:])), **side_t)
    (y ** 2).mean().backward()
    leaves += [v for k, v in side_t.items() if k != "noise"]
    check(y, leaves, want_y, [dx, *(dp / width).T, *ds], dtype, fname)


def test_wow_flutter_fp32_against_float64():
    """wow_flutter's processor in fp32 (on a CPU tensor the fractional-delay
    kernel's plain engine) against the port's float64 (the dense plain
    version, held to JAX above) on the same fp32 inputs and noise: its
    distance at most twice JAX's fp32 distance plus the fp32 bars (outputs
    1e-5 of max(1, peak), gradients 1e-4 of the largest). The fp32 delay
    curve is ill-conditioned, a one-pole scan with its pole within 1e-4 of 1
    normalized by its RMS: neither package's fp32 comes within 1e-5 of
    float64 (about 5e-4 here)."""
    (x, p), side = inputs("WowFlutter", "float32")
    proc, jproc = P.WowFlutter(SR), D.WowFlutter(SR)

    def port(dtype):
        leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, p)]
        y = proc.process_normalized(*leaves, noise=torch.tensor(side["noise"], dtype=dtype))
        (y ** 2).mean().backward()
        return [y.detach().numpy()] + [v.grad.numpy() for v in leaves]

    def jloss(x, q, n):
        y = jproc.process_normalized(x, q, noise=n)
        return jnp.mean(y ** 2), y

    (_, y_j), g_j = jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(*map(jnp.asarray, (x, p, side["noise"])))
    jax32 = [np.asarray(v) for v in (y_j, *g_j)]
    truth = port(torch.float64)
    for i, (got, ref, want) in enumerate(zip(port(torch.float32), jax32, truth)):
        scale = max(1.0, float(np.abs(want).max())) if i == 0 else float(np.abs(want).max())
        err, err_j = (float(np.abs(v - want).max()) / scale for v in (got, ref))
        floor = TOL["float32"] if i == 0 else GRAD_TOL["float32"]
        assert err <= 2 * err_j + floor, f"output/gradient {i}: {err:.3e} from float64, JAX fp32 {err_j:.3e}"


def test_wow_flutter_generator_draws_its_noise():
    """With ``generator=`` the effect draws its (bs, 2, T) standard normal
    noise from it, which ``noise=`` reproduces; without either it raises."""
    x = torch.tensor(inputs("WowFlutter", "float32")[0][0])
    y = PF.wow_flutter(x, SR, 0.5, 0.3, generator=torch.Generator().manual_seed(3))
    noise = torch.randn((2, 2, T), generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, PF.wow_flutter(x, SR, 0.5, 0.3, noise=noise))
    with pytest.raises(ValueError, match="stochastic"):
        PF.wow_flutter(x, SR, 0.5, 0.3)


@pytest.mark.parametrize("ir_shape", [(IR_TAPS,), (2, IR_TAPS), (2, 2, IR_TAPS)])
@pytest.mark.parametrize("block", [None, 1000])
def test_convolution_reverb_ir_shapes_and_blocks(ir_shape, block):
    """Every IR layout, one FFT and overlap-save blocks (a block that does
    not divide T), in fp32: output and the gradients of x, mix and the IR."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 2, T)) * 0.3).astype(np.float32)
    ir = (rng.standard_normal(ir_shape) * np.exp(-np.arange(IR_TAPS) / 300.0)).astype(np.float32)
    mix = np.float32([0.3, 0.8])
    (_, y_j), g_j = jit(jax.value_and_grad(
        lambda x, m, h: (lambda y: (jnp.mean(y ** 2), y))(JF.convolution_reverb(x, SR, m, h, block=block)),
        argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (x, mix, ir)))
    leaves = [t(a, True) for a in (x, mix, ir)]
    y = PF.convolution_reverb(*leaves[:1], SR, *leaves[1:], block=block)
    (y ** 2).mean().backward()
    check(y, leaves, np.asarray(y_j), [np.asarray(g) for g in g_j], "float32", f"reverb {ir_shape} {block}")


def test_delay_feedback_clamp_and_stereo_imager_checks():
    """delay clamps feedback at 0.999 as JAX does (float64); stereo_imager
    refuses mono input; an unknown crossover method raises."""
    x = np.random.default_rng(22).standard_normal((2, 1, 1024))
    y_t = PF.delay(torch.tensor(x), SR, 5.0, 1.5, 0.5).numpy()
    with jax_dtype("float64"):
        y_j = np.asarray(jit(lambda x: JF.delay(x, SR, 5.0, 1.5, 0.5))(jnp.asarray(x)))
    peak_close(y_t, y_j, TOL["float64"], "delay at feedback 1.5")
    with pytest.raises(ValueError, match="stereo input"):
        PF.stereo_imager(torch.tensor(x), SR, 200.0, 2000.0, 0.5, 0.5, 0.5)
    with pytest.raises(ValueError, match="Unknown filter_method"):
        PF.stereo_imager(torch.zeros(2, 2, 64), SR, 200.0, 2000.0, 0.5, 0.5, 0.5, filter_method="nope")


def test_chain_forwards_ir_and_noise():
    """Chain gives ``ir=`` to the ConvolutionReverb only and ``noise=`` to
    the WowFlutter only, and a generator to the stochastic WowFlutter."""
    (x, _), side = inputs("ConvolutionReverb", "float32")
    noise = torch.tensor(inputs("WowFlutter", "float32")[1]["noise"])
    xt, ir = torch.tensor(x), torch.tensor(side["ir"])
    chain = P.Chain([P.Tremolo(SR), P.ConvolutionReverb(SR), P.WowFlutter(SR), P.StereoImager(SR)])
    p = torch.rand((2, chain.num_params), generator=torch.Generator().manual_seed(0))
    y = chain.process_normalized(xt, p, ir=ir, noise=noise)
    y1 = P.Tremolo(SR).process_normalized(xt, p[:, :2])
    y2 = P.ConvolutionReverb(SR).process_normalized(y1, p[:, 2:3], ir=ir)
    y3 = P.WowFlutter(SR).process_normalized(y2, p[:, 3:7], noise=noise)
    assert torch.equal(y, P.StereoImager(SR).process_normalized(y3, p[:, 7:]))
    gen = torch.Generator().manual_seed(5)
    y_gen = chain.process_normalized(xt, p, ir=ir, generator=gen)
    drawn = torch.randn((2, 2, T), generator=torch.Generator().manual_seed(5))
    assert torch.equal(y_gen, chain.process_normalized(xt, p, ir=ir, noise=drawn))
    with pytest.raises(ValueError, match="stochastic"):
        chain.process_normalized(xt, p, ir=ir)


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.Delay(SR, 1.0, 500.0),
    lambda pkg: pkg.StereoImager(SR, filter_method="block"),
    lambda pkg: pkg.ConvolutionReverb(SR, block=4096),
    lambda pkg: pkg.WowFlutter(SR, base_ms=8.0),
    lambda pkg: pkg.Tremolo(SR, max_rate_hz=20.0),
    lambda pkg: pkg.RingModulator(SR, 50.0),
])
def test_init_spec_and_ranges_match_jax(make):
    p_t, p_j = make(P), make(D)
    assert p_t._init_spec == p_j._init_spec
    assert p_t.param_ranges == p_j.param_ranges
