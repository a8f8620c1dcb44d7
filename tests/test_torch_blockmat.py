"""The block-state and scan-based IIR methods of dasp_tpu_torch against
dasp_tpu: ``sosfilt_blockmat``, ``lfilter1_blockmat``, ``sosfilt_exact``,
``lti_affine_scan``, ``associative_scan``, and the ``"block"`` options of
``ParametricEQ`` and ``Compressor``.

Inputs are numpy arrays from a seed, handed to both packages (the JAX side
jitted). Tolerances, with their reasons:

* well-conditioned sections (poles of radius 0.3-0.95) and the one-pole:
  outputs 1e-5 of max(1, peak) (JAX's fp32 rounding; the port computes
  these filters in float64 and rounds its output once), gradients 1e-4 of
  the largest (the repo's parity bar);
* the EQ-like cascade with a 200 Hz shelf (poles near the unit circle, as
  tests/test_blockmat.py): outputs 2e-3 absolute against JAX, the
  cascade's bound (tests/test_pallas_iir.py), since JAX's fp32 evaluation
  sits up to about 1e-3 from float64 there; the gradients of both fp32
  evaluations sit 1e-3 to 6e-3 of the largest from float64, so the port's
  fp32 output and gradients are held to float64 instead, at 1e-6 of
  max(1, peak) and of the largest gradient (its float64 working precision
  leaves the fp32 rounding of inputs and outputs, about 1e-7), and its
  float64 gradients to JAX's float64 ones at 1e-9;
* the 10-band graphic EQ (poles at |r| ~ 0.9999, where the direct-form
  impulse response cancels in fp32): the port's blockmat error against
  float64 scipy no worse than twice JAX's blockmat error on the same case;
* chunked streaming with ``zi`` / ``return_zf`` against one shot: 1e-5 of
  max(1, peak) (fp32 rounding: the chunk edges move the block grid);
* ``lti_affine_scan``'s backward against ``torch.autograd.gradcheck`` in
  float64 (its default tolerances).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import dasp_tpu as D
import dasp_tpu.ops.iir as JI
import dasp_tpu_torch as P
import dasp_tpu_torch.ops.iir as TI
from dasp_tpu.functional import GRAPHIC_EQ_BANDS
from dasp_tpu.ops.biquad import biquad as jbiquad

SR = 44100
TOL = 1e-5
GRAD_TOL = 1e-4
A_TOL = 2e-3
F32_OF_F64_TOL = 1e-6
F64_TOL = 1e-9


@contextlib.contextmanager
def jax_x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


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


def stable_sections(rng, bs, S):
    """(bs, S, 6) sections [b0, b1, b2, 1, a1, a2], poles of radius 0.3-0.95."""
    r = rng.uniform(0.3, 0.95, (bs, S))
    theta = rng.uniform(0.05, 3.0, (bs, S))
    b = rng.standard_normal((bs, S, 3)) * 0.5
    a = np.stack([np.ones((bs, S)), -2 * r * np.cos(theta), r * r], -1)
    return np.concatenate([b, a], -1).astype(np.float32)


def eq_sections(bs):
    """tests/test_blockmat.py's cascade: a 200 Hz low shelf, a 1 kHz peak
    and an 8 kHz high shelf."""
    secs = []
    for g, fc, q, ft in [(4.0, 200.0, 0.7, "low_shelf"), (-6.0, 1000.0, 2.0, "peaking"),
                         (3.0, 8000.0, 0.7, "high_shelf")]:
        b, a = jbiquad(jnp.full((bs,), g), jnp.full((bs,), fc), jnp.full((bs,), q), SR, ft)
        secs.append(np.concatenate([np.asarray(b), np.asarray(a)], -1))
    return np.stack(secs, 1).astype(np.float32)


def sections(kind, rng, bs):
    return stable_sections(rng, bs, 3) if kind == "stable" else eq_sections(bs)


def scipy_rows(sos, x):
    """float64 scipy.signal.sosfilt of (bs, ..., T) with (bs, S, 6)."""
    sos64, x64 = sos.astype(np.float64), x.astype(np.float64)
    return np.stack([scipy.signal.sosfilt(sos64[i], x64[i], axis=-1) for i in range(x.shape[0])])


_J_BLOCK = jax.jit(JI.sosfilt_blockmat, static_argnames=("block", "stabilize", "return_zf"))
_J_EXACT = jax.jit(JI.sosfilt_exact)
_J_LF1 = jax.jit(JI.lfilter1_blockmat, static_argnames=("block",))


# ---------------------------------------------------------------------------
# sosfilt_blockmat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("kind", ["stable", "eq"])
def test_sosfilt_blockmat_matches_jax(kind, block):
    """Ragged T (777), channels folded into rows."""
    rng = np.random.default_rng(1 + block)
    sos = sections(kind, rng, 3)
    x = (rng.standard_normal((3, 2, 777)) * 0.3).astype(np.float32)
    y_j = np.asarray(_J_BLOCK(jnp.asarray(sos), jnp.asarray(x), block=block))
    y_t = TI.sosfilt_blockmat(torch.tensor(sos), torch.tensor(x), block=block).numpy()
    assert y_t.shape == x.shape
    if kind == "stable":
        peak_close(y_t, y_j, TOL, f"blockmat {block}")
        return
    np.testing.assert_allclose(y_t, y_j, atol=A_TOL)
    peak_close(y_t, scipy_rows(sos, x), F32_OF_F64_TOL, f"blockmat {block} against float64")


def test_sosfilt_blockmat_streaming_matches_one_shot():
    """Chunks of 256 and 384 samples with the state carried through ``zi``
    / ``return_zf`` give the one-shot output, and the same final state as
    the JAX package's."""
    rng = np.random.default_rng(3)
    sos = eq_sections(2)
    x = (rng.standard_normal((2, 2, 1024)) * 0.3).astype(np.float32)
    st, xt = torch.tensor(sos), torch.tensor(x)
    y_one, zf_one = TI.sosfilt_blockmat(st, xt, return_zf=True)
    z, parts = None, []
    for lo, hi in ((0, 256), (256, 640), (640, 1024)):
        part, z = TI.sosfilt_blockmat(st, xt[..., lo:hi], zi=z, return_zf=True)
        parts.append(part)
    assert z.shape == (2, 2, 3, 4)
    peak_close(torch.cat(parts, -1).numpy(), y_one.numpy(), TOL, "chunked output")
    peak_close(z.numpy(), zf_one.numpy(), TOL, "chunked final state")
    _, zf_j = _J_BLOCK(jnp.asarray(sos), jnp.asarray(x), return_zf=True)
    np.testing.assert_allclose(zf_one.numpy(), np.asarray(zf_j), atol=A_TOL)
    # the state layout [x[-1], x[-2], y[-1], y[-2]] of the last section
    y2 = TI.sosfilt_blockmat(st[:, :2], xt)
    np.testing.assert_array_equal(zf_one[..., 2, 0].numpy(), y2[..., -1].numpy())
    np.testing.assert_array_equal(zf_one[..., 2, 2].numpy(), y_one[..., -1].numpy())


def test_sosfilt_blockmat_zi_matches_jax():
    rng = np.random.default_rng(4)
    sos = stable_sections(rng, 2, 3)
    x = (rng.standard_normal((2, 1, 512)) * 0.3).astype(np.float32)
    zi = (rng.standard_normal((2, 1, 3, 4)) * 0.2).astype(np.float32)
    y_j, zf_j = _J_BLOCK(jnp.asarray(sos), jnp.asarray(x), zi=jnp.asarray(zi), return_zf=True)
    y_t, zf_t = TI.sosfilt_blockmat(torch.tensor(sos), torch.tensor(x), zi=torch.tensor(zi), return_zf=True)
    peak_close(y_t.numpy(), np.asarray(y_j), TOL, "output from zi")
    peak_close(zf_t.numpy(), np.asarray(zf_j), TOL, "final state from zi")


def test_sosfilt_blockmat_return_zf_needs_whole_blocks():
    with pytest.raises(ValueError, match="multiple of block"):
        TI.sosfilt_blockmat(torch.tensor(eq_sections(1)), torch.zeros(1, 1, 777), return_zf=True)


def graphic_sections(gains):
    """The 10-band octave graphic EQ cascade (tests/test_blockmat.py)."""
    Q = np.sqrt(2.0)
    secs = []
    for g, fc in zip(gains, GRAPHIC_EQ_BANDS):
        A = 10 ** (g / 40)
        w0 = 2 * np.pi * fc / SR
        al = np.sin(w0) / (2 * Q)
        b = np.array([1 + al * A, -2 * np.cos(w0), 1 - al * A])
        a = np.array([1 + al / A, -2 * np.cos(w0), 1 - al / A])
        secs.append(np.concatenate([b / a[0], a / a[0]]))
    return np.stack(secs)


def test_sosfilt_blockmat_near_unit_circle_against_scipy():
    """Poles at |r| ~ 0.9999 (the graphic EQ's 31 Hz band): the port's
    error against float64 is no worse than twice the JAX blockmat's, so a
    port that made the cancellation worse fails."""
    rng = np.random.default_rng(11)
    sos64 = graphic_sections(rng.uniform(-6, 6, 10))
    x = rng.standard_normal((1, 1, 2048)).astype(np.float32)
    ref = scipy.signal.sosfilt(sos64, x[0, 0].astype(np.float64))
    sos32 = sos64.astype(np.float32)[None]
    err_j = np.abs(np.asarray(_J_BLOCK(jnp.asarray(sos32), jnp.asarray(x)))[0, 0] - ref).max()
    err_t = np.abs(TI.sosfilt_blockmat(torch.tensor(sos32), torch.tensor(x)).numpy()[0, 0] - ref).max()
    print(f"graphic EQ vs float64: port {err_t:.3e}, JAX {err_j:.3e}")
    assert err_t <= 2 * err_j, (err_t, err_j)


# ---------------------------------------------------------------------------
# sosfilt_exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stable", "eq"])
def test_sosfilt_exact_matches_jax(kind):
    rng = np.random.default_rng(5)
    sos = sections(kind, rng, 2)
    x = (rng.standard_normal((2, 2, 777)) * 0.3).astype(np.float32)
    y_j = np.asarray(_J_EXACT(jnp.asarray(sos), jnp.asarray(x)))
    y_t = TI.sosfilt_exact(torch.tensor(sos), torch.tensor(x)).numpy()
    if kind == "stable":
        peak_close(y_t, y_j, TOL, "sosfilt_exact")
        return
    np.testing.assert_allclose(y_t, y_j, atol=A_TOL)
    peak_close(y_t, scipy_rows(sos, x), F32_OF_F64_TOL, "sosfilt_exact against float64")


# ---------------------------------------------------------------------------
# gradients of the cascades
# ---------------------------------------------------------------------------

CASCADES = {"blockmat": (TI.sosfilt_blockmat, JI.sosfilt_blockmat), "exact": (TI.sosfilt_exact, JI.sosfilt_exact)}


def torch_grads(fn, sos, x, dtype=torch.float32):
    s = torch.tensor(sos, dtype=dtype, requires_grad=True)
    z = torch.tensor(x, dtype=dtype, requires_grad=True)
    (fn(s, z) ** 2).mean().backward()
    return s.grad.numpy(), z.grad.numpy()


def jax_grads(fn, sos, x):
    g = jax.jit(jax.grad(lambda s, z: jnp.mean(fn(s, z) ** 2), argnums=(0, 1)))(jnp.asarray(sos), jnp.asarray(x))
    return tuple(np.asarray(v) for v in g)


@pytest.mark.parametrize("name", ["blockmat", "exact"])
def test_cascade_gradients_match_jax(name):
    """Well-conditioned sections: dsos and dx at the parity bar."""
    tfn, jfn = CASCADES[name]
    rng = np.random.default_rng(6)
    sos = stable_sections(rng, 2, 3)
    x = (rng.standard_normal((2, 1, 640)) * 0.3).astype(np.float32)
    for g_t, g_j, what in zip(torch_grads(tfn, sos, x), jax_grads(jfn, sos, x), ("dsos", "dx")):
        grad_close(g_t, g_j, GRAD_TOL, f"{name} {what}")


@pytest.mark.parametrize("name", ["blockmat", "exact"])
def test_cascade_gradients_near_unit_circle(name):
    """The 200 Hz shelf: the fp32 gradients against the port's float64 ones
    (JAX's fp32 gradients sit 1e-3 to 6e-3 of the largest from them), and
    the float64 gradients of the two packages equal."""
    tfn, jfn = CASCADES[name]
    rng = np.random.default_rng(7)
    sos = eq_sections(2)
    x = (rng.standard_normal((2, 1, 640)) * 0.3).astype(np.float32)
    g64 = torch_grads(tfn, sos, x, torch.float64)
    for g_t, g, what in zip(torch_grads(tfn, sos, x), g64, ("dsos", "dx")):
        grad_close(g_t, g, F32_OF_F64_TOL, f"{name} fp32 {what}")
    with jax_x64():
        g_j = jax_grads(jfn, sos.astype(np.float64), x.astype(np.float64))
    for g_t, g, what in zip(g64, g_j, ("dsos", "dx")):
        grad_close(g_t, g, F64_TOL, f"{name} float64 {what}")


# ---------------------------------------------------------------------------
# lfilter1_blockmat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [64, 128])
def test_lfilter1_blockmat_matches_jax(block):
    """The compressor smoother's one-pole on a gain-like curve (tens of
    dB), ragged T, channels folded: output and the gradients with respect
    to x, b and a."""
    rng = np.random.default_rng(8)
    x = (-20.0 + 10.0 * rng.standard_normal((2, 2, 777))).astype(np.float32)
    alpha = rng.uniform(0.9, 0.9995, (2,)).astype(np.float32)
    b, a = (np.asarray(v) for v in JI.onepole_ba(jnp.asarray(alpha)))
    args = [jnp.asarray(v) for v in (x, b, a)]
    y_j = np.asarray(_J_LF1(*args, block=block))
    g_j = jax.jit(jax.grad(lambda *v: jnp.mean(JI.lfilter1_blockmat(*v, block=block) ** 2),
                           argnums=(0, 1, 2)))(*args)
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, b, a)]
    y_t = TI.lfilter1_blockmat(*leaves, block=block)
    (y_t ** 2).mean().backward()
    peak_close(y_t.detach().numpy(), y_j, TOL, "lfilter1_blockmat")
    for leaf, g, what in zip(leaves, g_j, ("dx", "db", "da")):
        grad_close(leaf.grad.numpy(), g, GRAD_TOL, f"lfilter1_blockmat {what}")


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


def test_lti_affine_scan_matches_jax():
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((3, 2, 2)) * 0.5).astype(np.float32)
    u = rng.standard_normal((3, 37, 2)).astype(np.float32)
    ct = rng.standard_normal((3, 37, 2)).astype(np.float32)
    v_j, dA_j, du_j = jax.jit(lambda *a: (lambda v, vjp: (v, *vjp(a[2])))(*jax.vjp(JI.lti_affine_scan, *a[:2])))(
        jnp.asarray(A), jnp.asarray(u), jnp.asarray(ct))
    At, ut = torch.tensor(A, requires_grad=True), torch.tensor(u, requires_grad=True)
    v_t = TI.lti_affine_scan(At, ut)
    v_t.backward(torch.tensor(ct))
    peak_close(v_t.detach().numpy(), np.asarray(v_j), TOL, "v")
    grad_close(At.grad.numpy(), dA_j, GRAD_TOL, "dA")
    grad_close(ut.grad.numpy(), du_j, GRAD_TOL, "du")


def test_lti_affine_scan_backward_is_its_own_function():
    """The backward is the adjoint recurrence of the autograd Function, not
    autograd through the scan (no graph of the scan's ops is kept), and
    gradcheck holds it in float64."""
    A = (torch.randn(2, 2, 2, dtype=torch.float64) * 0.4).requires_grad_()
    u = torch.randn(2, 9, 2, dtype=torch.float64, requires_grad=True)
    v = TI.lti_affine_scan(A, u)
    assert type(v.grad_fn).__name__ == "_LTIAffineScanBackward"
    assert torch.autograd.gradcheck(TI.lti_affine_scan, (A, u))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33])
def test_associative_scan_matches_lax(n):
    """Affine prefixes against lax.associative_scan at odd and even
    lengths."""
    rng = np.random.default_rng(10 + n)
    a = rng.uniform(0.5, 1.0, (2, n)).astype(np.float32)
    u = rng.standard_normal((2, n)).astype(np.float32)

    def comb(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    want = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(u)), axis=1)
    got = TI.associative_scan(comb, (torch.tensor(a), torch.tensor(u)), 1)
    for g, w in zip(got, want):
        peak_close(g.numpy(), np.asarray(w), 1e-6, f"n={n}")


# ---------------------------------------------------------------------------
# the "block" options of the processors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,option", [("ParametricEQ", {"filter_method": "block"}),
                                         ("Compressor", {"smoother": "block"})])
def test_block_processors_match_jax(name, option):
    """process_normalized: output and the gradient of mean(y ** 2) with
    respect to the normalized parameters (the EQ's output through the
    cascade at its bound, the compressor's at 1e-5 of max(1, peak))."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 2, 2048)) * 0.4).astype(np.float32)
    jp, tp = getattr(D, name)(SR, **option), getattr(P, name)(SR, **option)
    p = rng.uniform(0.05, 0.95, (2, tp.num_params)).astype(np.float32)
    xj = jnp.asarray(x)
    run_j = jax.jit(lambda q: jp.process_normalized(xj, q, clip_params=True))
    y_j = np.asarray(run_j(jnp.asarray(p)))
    g_j = np.asarray(jax.jit(jax.grad(lambda q: jnp.mean(run_j(q) ** 2)))(jnp.asarray(p)))
    pt = torch.tensor(p, requires_grad=True)
    y_t = tp.process_normalized(torch.tensor(x), pt, clip_params=True)
    (y_t ** 2).mean().backward()
    if name == "ParametricEQ":
        np.testing.assert_allclose(y_t.detach().numpy(), y_j, atol=A_TOL)
    else:
        peak_close(y_t.detach().numpy(), y_j, TOL, name)
    grad_close(pt.grad.numpy(), g_j, GRAD_TOL, f"{name} gradient")
