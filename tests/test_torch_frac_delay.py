"""The fractional-delay contraction of dasp_tpu_torch (ops/frac_delay_kernel.py)
against dasp_tpu's Pallas kernel C (interpret mode), its dense XLA path and
float64.

On CPU tensors ``frac_delay_pallas`` runs its plain engine (two gathers;
``index_add_`` for dx), the formulas of the CUDA kernels. Inputs are numpy
arrays from a seed. As in tests/test_pallas_interp.py the delays carry an
irrational offset so that no read position lands on an interpolation kink,
B = 128, Dm = 896 (a multiple of 128, which the JAX kernel needs), and
values and the three cotangents of ``sum(sin(wet))`` agree to 3e-6 (that
file's bound).

Two faults of the reference kernel are held against float64 here instead:
its ``wraps=False`` row plan, which misses lattice points at a delay slope of
dr/dt = 20 (ROADMAP.md Queue 3), and its output dtype, fixed to float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu.functional as JF
from dasp_tpu.ops.pallas_interp import frac_delay_pallas as jax_frac_delay
from dasp_tpu_torch import functional as F
from dasp_tpu_torch.ops import frac_delay_kernel as FK

B, DM, CHUNK = 128, 896, 4
EPS_IRR = 0.0078125 / 3.0  # kink-avoiding offset
TOL = 3e-6


def _signal(bs=2, chs=2, T=2048, Dm=DM, seed=0):
    nb = -(-T // B)
    Tp = nb * B
    x = (np.random.default_rng(seed).standard_normal((bs, chs, T)) * 0.3).astype(np.float32)
    return np.pad(x, ((0, 0), (0, 0), (Dm, Tp - T))), Tp


def _case(name):
    """(x_ext, d_stk, g_stk) of tests/test_pallas_interp.py's three cases."""
    x_ext, Tp = _signal()
    bs = x_ext.shape[0]
    n = np.arange(Tp, dtype=np.float32)[None, :]
    if name == "sawtooth_wrap":
        W = float(DM - 2)
        d, g = [], []
        for slope, off in ((0.4, 0.0), (-0.3, 0.5)):
            p = (slope * n / W + off + EPS_IRR) % 1.0
            d.append(np.broadcast_to(W * p, (bs, Tp)))
            g.append(np.broadcast_to(np.sin(np.pi * p), (bs, Tp)))
        d, g = np.stack(d), np.stack(g)
    elif name == "lfo":
        lfo = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * n / 44100.0))
        d = np.broadcast_to(20.0 + EPS_IRR + (DM - 42.0) * lfo, (bs, Tp))[None]
        g = np.ones((1, bs, Tp))
    else:  # full range: the t < d mask and both window extremes
        d = np.broadcast_to(np.linspace(DM - 1.2, EPS_IRR, Tp, dtype=np.float32), (bs, Tp))[None]
        g = np.full((1, bs, Tp), 0.7)
    return x_ext, d.astype(np.float32).copy(), g.astype(np.float32).copy()


def ref64(x_ext, d_stk, g_stk, B, Dm):
    """Two-point linear interpolation in float64 numpy, tile-local
    coordinates, lattice points outside the window read as zero."""
    x_ext, d_stk, g_stk = (np.asarray(a, np.float64) for a in (x_ext, d_stk, g_stk))
    nt, bs, Tp = d_stk.shape
    chs = x_ext.shape[1]
    W = Dm + B
    t = np.arange(Tp)
    start = t - t % B
    wet = np.zeros((bs, chs, Tp))
    for i in range(nt):
        r = (t - start + Dm) - d_stk[i]
        i0 = np.floor(r)
        f = r - i0
        gv = np.where(t - d_stk[i] >= 0, g_stk[i], 0.0)
        for k, w in ((i0, 1.0 - f), (i0 + 1.0, f)):
            ok = (k >= 0) & (k < W)
            pos = (start + np.where(ok, k, 0)).astype(np.int64)
            v = np.take_along_axis(x_ext, np.broadcast_to(pos[:, None, :], (bs, chs, Tp)), -1)
            wet += np.where(ok[:, None, :], v, 0.0) * (gv * w)[:, None, :]
    return wet


def port_value_and_grads(x_ext, d, g, dtype=torch.float32, fn=None):
    fn = fn or (lambda xe, d_, g_: FK.frac_delay_pallas(xe, d_, g_, B, DM))
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x_ext, d, g)]
    wet = fn(*leaves)
    torch.sin(wet).sum().backward()
    return wet.detach().numpy(), [t.grad.numpy() for t in leaves]


_JAX = {}


def jax_value_and_grads(name, which):
    """JAX's wet and the cotangents of sum(sin(wet)): the Pallas kernel in
    interpret mode, or the dense XLA path."""
    key = (name, which)
    if key not in _JAX:
        if which == "pallas":
            def f(xe, d, g):
                return jax_frac_delay(xe, d, g, B, DM, True)
        else:
            def f(xe, d, g):
                return JF._frac_delay_tiles_ad(B, DM, xe, d, g, chunk=CHUNK)
        args = tuple(jnp.asarray(a) for a in _case(name))
        wet = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))), argnums=(0, 1, 2)))(*args)
        _JAX[key] = (np.asarray(wet), [np.asarray(v) for v in grads])
    return _JAX[key]


@pytest.mark.parametrize("which", ["pallas", "ad"])
@pytest.mark.parametrize("name", ["sawtooth_wrap", "lfo", "full_range"])
def test_plain_engine_matches_jax(name, which):
    x_ext, d, g = _case(name)
    wet, grads = port_value_and_grads(x_ext, d, g)
    wet_j, grads_j = jax_value_and_grads(name, which)
    np.testing.assert_allclose(wet, wet_j, atol=TOL)
    for label, a, b in zip(("dx", "dd", "dg"), grads, grads_j):
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=label)
    # against the float64 two-point reference both sit up to ~5e-5 away
    # (fp32 read positions r = (j + Dm) - d round by up to 2**-14 at r ~ 900),
    # the port no farther than twice JAX
    truth = ref64(x_ext, d, g, B, DM)
    assert np.abs(wet - truth).max() <= 2 * np.abs(wet_j - truth).max() + 1e-7


@pytest.mark.parametrize("name", ["sawtooth_wrap", "lfo"])
def test_dense_plain_version_matches_jax(name):
    """The port's dense version (_frac_delay_tiles_ad) against JAX's."""
    x_ext, d, g = _case(name)

    def dense(xe, d_, g_):
        return F._frac_delay_tiles_ad(B, DM, xe, d_, g_, chunk=CHUNK)

    wet, grads = port_value_and_grads(x_ext, d, g, fn=dense)
    wet_j, grads_j = jax_value_and_grads(name, "ad")
    np.testing.assert_allclose(wet, wet_j, atol=TOL)
    for label, a, b in zip(("dx", "dd", "dg"), grads, grads_j):
        np.testing.assert_allclose(a, b, atol=TOL, err_msg=label)


def test_kink_convention_is_the_pallas_kernels():
    """At an exact integer delay every read position is a kink. The port
    (like the Pallas kernel, sign(0) = 0) gives dd = 0 there, where autodiff
    of the dense form splits the tie and gives a nonzero dd; values, dx and
    dg agree with both."""
    x_ext, Tp = _signal()
    bs = x_ext.shape[0]
    d = np.full((1, bs, Tp), 100.0, np.float32)
    g = np.ones((1, bs, Tp), np.float32)
    wet, (dx, dd, dg) = port_value_and_grads(x_ext, d, g)
    args = tuple(jnp.asarray(a) for a in (x_ext, d, g))
    for f in (lambda *a: jax_frac_delay(*a, B, DM, True),
              lambda *a: JF._frac_delay_tiles_ad(B, DM, *a, chunk=CHUNK)):
        np.testing.assert_allclose(wet, np.asarray(f(*args)), atol=1e-6)
    pallas = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_frac_delay(*a, B, DM, True))), argnums=(0, 1, 2))(*args)
    dense = jax.grad(lambda *a: jnp.sum(jnp.sin(JF._frac_delay_tiles_ad(B, DM, *a, chunk=CHUNK))),
                     argnums=(0, 1, 2))(*args)
    assert np.all(dd == 0.0)
    np.testing.assert_array_equal(np.asarray(pallas[1]), 0.0)
    assert np.abs(np.asarray(dense[1])).max() > 1e-2  # the tie split
    for label, a, b in (("dx", dx, pallas[0]), ("dg", dg, pallas[2])):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, err_msg=label)


def _ramp(slope=20.0):
    """A delay ramp with dr/dt = ``slope`` inside every tile, smooth within
    each 16-sample block (it restarts at tile edges), on a quarter-sample
    grid so that the fp32 read positions are exact: what differs from
    float64 is coverage and arithmetic, not coordinate rounding. The read
    position r = 20 j + 100.25 starts every other 16-sample block late in a
    128-lane row (at lane 100), where the reference's 3-row plan is short."""
    Dm = 2560  # >= 19 * B: the ramp stays inside every tile's window
    x_ext, Tp = _signal(bs=1, chs=2, T=4096, Dm=Dm, seed=3)
    j = (np.arange(Tp) % B).astype(np.float32)
    d = (Dm - 100.25 - (slope - 1.0) * j)[None, None, :].astype(np.float32)
    return x_ext, d, np.ones_like(d), Dm


def test_steep_ramp_matches_float64():
    """dr/dt = 20: within 1e-5 of float64 relative to the peak. The JAX
    kernel's wraps=False row plan covers spans of about 255 lanes of the
    380 its slope bound claims and misses lattice points here (its error is
    of the order of the signal; ROADMAP.md Queue 3)."""
    x_ext, d, g, Dm = _ramp()
    truth = ref64(x_ext, d, g, B, Dm)
    peak = np.abs(truth).max()
    wet = FK.frac_delay_pallas(*(torch.tensor(a) for a in (x_ext, d, g)), B, Dm, wraps=False).numpy()
    err = np.abs(wet - truth).max() / peak
    jax_wet = np.asarray(jax_frac_delay(*(jnp.asarray(a) for a in (x_ext, d, g)), B, Dm, False))
    jax_err = np.abs(jax_wet - truth).max() / peak
    print(f"dr/dt = 20: port {err:.3e}, dasp_tpu wraps=False {jax_err:.3e} of the peak")
    assert err <= 1e-5
    assert jax_err > 0.1  # the reference fault this test documents


def test_float64_in_float64_out():
    """The reference kernel returns float32 whatever it is given; the port
    keeps the input's dtype and agrees with float64 numpy and with the
    dense version in float64."""
    x_ext, d, g = _case("lfo")
    wet, grads = port_value_and_grads(x_ext, d, g, dtype=torch.float64)
    assert wet.dtype == np.float64 and all(v.dtype == np.float64 for v in grads)
    np.testing.assert_allclose(wet, ref64(x_ext, d, g, B, DM), atol=1e-12)

    def dense(xe, d_, g_):
        return F._frac_delay_tiles_ad(B, DM, xe, d_, g_, chunk=CHUNK)

    wet_d, grads_d = port_value_and_grads(x_ext, d, g, dtype=torch.float64, fn=dense)
    np.testing.assert_allclose(wet, wet_d, atol=1e-12)
    for label, a, b in zip(("dx", "dd", "dg"), grads, grads_d):
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=label)


def test_right_edge_reads_nothing_past_the_window():
    """d = 0 on the last sample of a tile puts r at W - 1 exactly, whose
    second lattice point is one past the window (past the end of x_ext on
    the last tile). It must count zero: a NaN planted there stays out."""
    x_ext, Tp = _signal(bs=1, chs=1, T=512)
    x_ext = np.concatenate([x_ext, np.full((1, 1, 1), np.nan, np.float32)], -1)  # one past the end
    d = np.full((1, 1, Tp), 0.5, np.float32)
    d[..., B - 1 :: B] = 0.0
    g = np.ones_like(d)
    xe = torch.tensor(x_ext[..., :-1].copy())
    wet = FK.frac_delay_pallas(xe, torch.tensor(d), torch.tensor(g), B, DM)
    assert bool(torch.isfinite(wet).all())
    np.testing.assert_allclose(wet.numpy(), ref64(x_ext[..., :-1], d, g, B, DM), atol=1e-6)
    # the edge sample reads exactly the window's last point
    np.testing.assert_array_equal(wet.numpy()[..., -1], x_ext[..., -2])


def test_dx_only_when_asked_and_input_checks():
    x_ext, d, g = _case("lfo")
    xe = torch.tensor(x_ext)
    d_t = torch.tensor(d, requires_grad=True)
    FK.frac_delay_pallas(xe, d_t, torch.tensor(g), B, DM).sum().backward()
    assert d_t.grad is not None and xe.grad is None
    with pytest.raises(ValueError, match="multiple of B"):
        FK.frac_delay_pallas(xe[..., :-1], d_t, torch.tensor(g), B, DM)
    with pytest.raises(ValueError, match="d_stk"):
        FK.frac_delay_pallas(xe, torch.zeros(3, *d.shape[1:]), torch.zeros(3, *d.shape[1:]), B, DM)


def thread_outputs(Tp, B, per_thread=4):
    """The outputs each thread of C-fwd and C-bwd's dd/dg kernel takes
    (csrc/frac_delay.cuh, load_outputs), emulated: t0 = 4 * (thread's
    index in the row), n = min(4, Tp - t0), and j stepped from t0 % B,
    wrapping to 0 at B. Returns (t, j, window start t - j) for each."""
    out = []
    for t0 in range(0, Tp, per_thread):
        j = t0 % B
        for k in range(min(per_thread, Tp - t0)):
            if k > 0:
                j += 1
                if j == B:
                    j = 0
            out.append((t0 + k, j, t0 + k - j))
    return out


@pytest.mark.parametrize("B,nb", [(1, 7), (3, 333), (250, 19), (256, 8)])
def test_kernel_tiling_emulation(B, nb):
    """The kernels' four outputs per thread cover every output sample
    once, with j = t % B and the window start t - j the plain engine uses,
    for any B: groups of four straddle tile edges where B % 4 != 0, and
    B < 4 wraps j inside a group. The 16-byte path (Tp % 4 == 0) leaves no
    thread with a partial group."""
    Tp = nb * B
    got = thread_outputs(Tp, B)
    assert [t for t, _, _ in got] == list(range(Tp))
    start, *_ = FK._coords(torch.zeros(1, 1, Tp), B, DM)
    assert [(j, s) for _, j, s in got] == [(t % B, int(v)) for t, v in zip(range(Tp), start)]
    if Tp % 4 == 0:
        assert all(min(4, Tp - t0) == 4 for t0 in range(0, Tp, 4))
