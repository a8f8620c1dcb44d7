"""The delay family of dasp_tpu_torch (pitch_shift, modulated_delay and the
Chorus, Flanger and PitchShift processors) against dasp_tpu.

Inputs are numpy arrays from a seed, bs 2, at most 4096 samples. The JAX
package runs its CPU path, the dense tiled contraction ("ad"); the port runs
"auto" (on a CPU tensor the plain engine of the fractional-delay kernel),
"pallas" (the same engine, here in float64) and "ad" (its dense plain
version). Each case compares the values and the gradients of mean(y ** 2)
with respect to every argument.

float64: every path agrees with JAX's float64 to 1e-9 (values) and 1e-9 of
each largest gradient.

float32: the two packages compute the delay curves with their own sin and
pow, which differ in the last bit on a few samples; multiplied by the sample
index that moves read positions by up to ~1e-4 samples, so values agree to
5e-4 absolute (measured up to 2.4e-4), not to the 3e-6 of two JAX paths
that share their delays (tests/test_pallas_interp.py). The gradients with
respect to the effect parameters are long fp32 reductions (the semitones
gradient of both packages sits ~0.23 of its largest value from float64), so
each fp32 gradient is held to float64: the port's error, relative to the
largest float64 gradient, at most twice JAX's plus 1e-3; and to JAX's fp32
gradient within 5e-2 of the largest value, a guard against a dropped or
misrouted term. At an exact integer read position the port (the Pallas
kernel's convention) and JAX's dense autodiff take different one-sided
derivatives, so the modulated-delay parameters below are chosen with no such
position (the pitch shifter's at n = 0 carries no parameter gradient).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.functional as JF
from dasp_tpu_torch import functional as F
from dasp_tpu_torch import modules as M

SR = 44100
RNG_SEED = 11


def _x(chs=2, T=4096, seed=RNG_SEED):
    return (np.random.default_rng(seed).standard_normal((2, chs, T)) * 0.3).astype(np.float32)


def _params(proc):
    return np.random.default_rng(3).uniform(0.05, 0.95, (2, proc.num_params)).astype(np.float32)


MOD_PARAMS = tuple(np.float32(v) for v in ((1.9, 0.6), (6.0, 3.5), (11.0, 2.2), (0.8, 0.5)))

# name -> (port function of the adjoint, JAX function, numpy arguments)
CASES = {
    "pitch_shift": (
        lambda adj: lambda x, st, mix: F.pitch_shift(x, SR, st, mix, window_ms=20.0, adjoint=adj),
        lambda x, st, mix: JF.pitch_shift(x, SR, st, mix, window_ms=20.0, adjoint="ad"),
        (_x(), np.float32([3.1, -5.2]), np.float32([0.8, 0.6])),
    ),
    "modulated_delay": (
        lambda adj: lambda x, *p: F.modulated_delay(x, SR, *p, max_delay_ms=20.0, block=128, adjoint=adj),
        lambda x, *p: JF.modulated_delay(x, SR, *p, max_delay_ms=20.0, block=128, adjoint="ad"),
        (_x(chs=1), *MOD_PARAMS),
    ),
    "pitch_shift_gather": (
        lambda adj: lambda x, st, mix: F.pitch_shift(x, SR, st, mix, window_ms=20.0, matmul=False),
        lambda x, st, mix: JF.pitch_shift(x, SR, st, mix, window_ms=20.0, matmul=False),
        (_x(T=3000), np.float32([4.0, -2.5]), np.float32([1.0, 0.7])),
    ),
}
for _name in ("Chorus", "Flanger", "PitchShift"):
    _proc, _jproc = getattr(M, _name)(SR), getattr(D, _name)(SR)
    CASES[_name] = (
        lambda adj, proc=_proc: lambda x, p: proc.process_normalized(x, p),
        lambda x, p, jproc=_jproc: jproc.process_normalized(x, p),
        (_x(chs=1, T=3000), _params(_proc)),
    )


@functools.lru_cache(maxsize=None)
def jax_result(name, dtype):
    """JAX's values and gradients of mean(y ** 2), as float64 numpy."""
    _, jax_fn, args = CASES[name]
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        jargs = [jnp.asarray(np.asarray(a, dtype)) for a in args]
        y = jax.jit(jax_fn)(*jargs)
        g = jax.jit(jax.grad(lambda *a: jnp.mean(jax_fn(*a) ** 2), argnums=tuple(range(len(args)))))(*jargs)
        return np.asarray(y, np.float64), [np.asarray(v, np.float64) for v in g]
    finally:
        jax.config.update("jax_enable_x64", False)


def port_result(name, adjoint, dtype):
    port_fn, _, args = CASES[name]
    leaves = [torch.tensor(np.asarray(a, dtype), requires_grad=True) for a in args]
    y = port_fn(adjoint)(*leaves)
    assert y.dtype == getattr(torch, dtype)
    torch.mean(y ** 2).backward()
    return y.detach().double().numpy(), [t.grad.double().numpy() for t in leaves]


def check(name, adjoint, dtype):
    y, g = port_result(name, adjoint, dtype)
    y64, g64 = jax_result(name, "float64")
    if dtype == "float64":
        np.testing.assert_allclose(y, y64, atol=1e-9)
        for i, (a, b) in enumerate(zip(g, g64)):
            np.testing.assert_allclose(a / np.abs(b).max(), b / np.abs(b).max(), atol=1e-9, err_msg=f"argument {i}")
        return
    y32, g32 = jax_result(name, "float32")
    np.testing.assert_allclose(y, y32, atol=5e-4)
    for i, (a, b, t) in enumerate(zip(g, g32, g64)):
        scale = np.abs(t).max()
        err, err_jax = np.abs(a - t).max() / scale, np.abs(b - t).max() / scale
        assert err <= 2 * err_jax + 1e-3, f"argument {i}: {err:.3e} vs JAX {err_jax:.3e} from float64"
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-2, err_msg=f"argument {i}")


DTYPE_ADJOINTS = [("float32", "auto"), ("float32", "ad"), ("float64", "pallas"), ("float64", "auto")]


@pytest.mark.parametrize("dtype,adjoint", DTYPE_ADJOINTS)
def test_pitch_shift_matches_jax(dtype, adjoint):
    check("pitch_shift", adjoint, dtype)


@pytest.mark.parametrize("dtype,adjoint", DTYPE_ADJOINTS)
def test_modulated_delay_matches_jax(dtype, adjoint):
    check("modulated_delay", adjoint, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pitch_shift_gather_path_matches_jax(dtype):
    """matmul=False: both taps by global-coordinate gathers."""
    check("pitch_shift_gather", None, dtype)


@pytest.mark.parametrize("name", ["Chorus", "Flanger", "PitchShift"])
def test_processors_match_jax(name):
    """process_normalized from a (bs, num_params) tensor, fp32 and float64."""
    proc, jproc = getattr(M, name)(SR), getattr(D, name)(SR)
    assert proc.param_ranges == {k: tuple(v) for k, v in jproc.param_ranges.items()}
    check(name, None, "float32")
    check(name, None, "float64")


def test_frac_delay_gather_matches_jax():
    """The gather primitive alone, on given delays: fp32 agree to 1e-6."""
    x = _x(T=2000)
    d = (40.0 + 30.0 * np.sin(np.arange(2000) / 97.0)[None, None, :]
         + np.float32([[[0.3]], [[7.1]]])).astype(np.float32)
    y = F._frac_delay_gather(torch.tensor(x), torch.tensor(d))
    np.testing.assert_allclose(y.numpy(), np.asarray(JF._frac_delay_gather(jnp.asarray(x), jnp.asarray(d))),
                               atol=1e-6)


def test_derived_bound_equals_explicit_bound():
    """max_delay_ms=None derives the bound from the parameter values, as
    the JAX package does for concrete ones: the same output as passing it,
    and in float64 the JAX package's output (whose bound it derives)."""
    x = torch.tensor(_x(chs=1, T=6000))
    y_auto = F.modulated_delay(x, SR, 1.5, 6.0, 11.0, 0.5)
    y_exp = F.modulated_delay(x, SR, 1.5, 6.0, 11.0, 0.5, max_delay_ms=17.000001)
    assert torch.equal(y_auto, y_exp)
    y_t = F.modulated_delay(x, SR, *(torch.full((2,), v) for v in (1.5, 6.0, 11.0, 0.5)))
    assert torch.equal(y_t, y_auto)
    jax.config.update("jax_enable_x64", True)
    try:
        y_j = np.asarray(JF.modulated_delay(jnp.asarray(x.double().numpy()), SR, 1.5, 6.0, 11.0, 0.5))
    finally:
        jax.config.update("jax_enable_x64", False)
    y64 = F.modulated_delay(x.double(), SR, 1.5, 6.0, 11.0, 0.5)
    np.testing.assert_allclose(y64.numpy(), y_j, atol=1e-9)


def test_window_samples_and_hybrid_raises():
    assert F.pitch_shift_window_samples(60.0, SR) == JF.pitch_shift_window_samples(60.0, SR) == 2646
    x = torch.zeros(1, 1, 512)
    with pytest.raises(ValueError, match="Not to port"):
        F.pitch_shift(x, SR, 1.0, adjoint="hybrid")
    with pytest.raises(ValueError, match="Not to port"):
        F.modulated_delay(x, SR, 1.0, 2.0, 3.0, 0.5, adjoint="hybrid")
    with pytest.raises(ValueError, match="Unknown adjoint"):
        F.pitch_shift(x, SR, 1.0, adjoint="bogus")
