"""The kernels' backward in dasp_tpu_torch against dasp_tpu and float64.

On the CPU the autograd Functions of ``sosfilt_pallas`` and
``ballistics_pallas`` run their plain engines: the block-state cascade in
its save-all form and over the (S+1)-section adjoint cascade, and the
ballistics reverse loop. These are the formulas the CUDA kernels compute,
so the tests hold the formulas themselves. JAX runs ``jax.vjp`` of its
Pallas kernels in interpret mode, with the same cotangents (numpy, from a
seed).

Tolerances:

* cascade gradient: 1e-2 of the largest dsos and 1e-3 of the largest dx,
  against JAX's adjoint and against float64 autograd through the plain
  forward (tests/test_pallas_iir.py's bounds; the gradient with respect to
  denominator coefficients is ill-conditioned in fp32); the adjoint
  formulas in float64 against float64 autograd to 1e-9 of the largest value;
* ballistics gradient against JAX: 1e-5 of each gradient's largest value.
  XLA:CPU contracts the adjoint updates into FMAs, and the TPU kernel forms
  dalpha as (y[n-1] - g[n]) * lam where the port forms autograd's
  lam * y[n-1] - lam * g[n];
* ballistics gradient against autograd through the plain forward: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasp_tpu.ops import ballistics_pallas as j_ballistics_pallas
from dasp_tpu.ops import lfilter1_pallas as j_lfilter1_pallas
from dasp_tpu.ops import sosfilt_pallas as j_sosfilt_pallas
from dasp_tpu_torch.ops import ballistics_kernel as BK
from dasp_tpu_torch.ops import iir_kernel as IK

SR = 44100


def eq_sos(bs, seed):
    """Parametric-EQ cascades (bs, 6, 6) from random normalized parameters."""
    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import ParametricEQ

    eq = ParametricEQ(SR)
    p = torch.tensor(np.random.default_rng(seed).uniform(size=(bs, eq.num_params)).astype(np.float32))
    d = eq.denormalize_param_dict(eq.extract_param_dict(p))
    return F.parametric_eq_sos(bs, torch.float32, SR, *d.values())


def torch_vjp(fn, args, ct, dtype=torch.float32):
    leaves = [torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True) for a in args]
    out = fn(*leaves)
    torch.autograd.backward(out, [torch.tensor(np.asarray(c), dtype=dtype) for c in ct])
    return [leaf.grad.numpy() for leaf in leaves], out


def graph_nodes(t, depth=4):
    """Names of the autograd nodes within ``depth`` steps of t's grad_fn."""
    names, frontier = set(), [t.grad_fn]
    for _ in range(depth):
        frontier = [f for f in frontier if f is not None]
        names |= {type(f).__name__ for f in frontier}
        frontier = [n for f in frontier for n, _ in f.next_functions]
    return names


def assert_close(got, want, rel, what):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("case", ["eq", "eq_shared_by_2_channels"])
def test_sosfilt_adjoint_matches_jax_and_float64(case):
    ch, T = (2, 1024) if case == "eq_shared_by_2_channels" else (1, 2048)
    rng = np.random.default_rng(21)
    sos = eq_sos(2, seed=ch).numpy()
    x = (rng.standard_normal((2, ch, T)) * 0.3).astype(np.float32)
    w = rng.standard_normal((2, ch, T)).astype(np.float32)

    (ds_t, dx_t), y = torch_vjp(IK.sosfilt_pallas, (sos, x), (w,))
    assert "_SosfiltKernelBackward" in graph_nodes(y)
    _, vjp = jax.vjp(lambda s, xx: j_sosfilt_pallas(s, xx, block=128, row_tile=4, interpret=True),
                     jnp.asarray(sos), jnp.asarray(x))
    ds_j, dx_j = vjp(jnp.asarray(w))
    (ds_64, dx_64), _ = torch_vjp(IK.sosfilt_plain, (sos, x), (w,), torch.float64)
    for got, name in ((ds_t, "port"), (np.asarray(ds_j), "jax")):
        assert_close(got, ds_64, 1e-2, f"dsos {name} vs float64")
    for got, name in ((dx_t, "port"), (np.asarray(dx_j), "jax")):
        assert_close(got, dx_64, 1e-3, f"dx {name} vs float64")
    assert_close(ds_t, np.asarray(ds_j), 1e-2, "dsos port vs jax")
    assert_close(dx_t, np.asarray(dx_j), 1e-3, "dx port vs jax")

    # the adjoint formulas themselves, in float64
    (ds_a, dx_a), _ = torch_vjp(IK.sosfilt_pallas, (sos, x), (w,), torch.float64)
    assert_close(ds_a, ds_64, 1e-9, "float64 adjoint dsos")
    assert_close(dx_a, dx_64, 1e-9, "float64 adjoint dx")


def test_lfilter1_adjoint_matches_jax_and_float64():
    """The one-pole through the cascade (S = 1, the compressor's
    smoother="pallas"): gradients with respect to x, b and a."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 1, 2048)).astype(np.float32)
    w = rng.standard_normal((2, 1, 2048)).astype(np.float32)
    b = np.asarray([[0.05, 0.0], [0.002, 0.0]], np.float32)
    a = np.asarray([[1.0, -0.95], [1.0, -0.998]], np.float32)
    grads_t, _ = torch_vjp(IK.lfilter1_pallas, (x, b, a), (w,))
    _, vjp = jax.vjp(lambda xx, bb, aa: j_lfilter1_pallas(xx, bb, aa, block=128, row_tile=4, interpret=True),
                     jnp.asarray(x), jnp.asarray(b), jnp.asarray(a))
    grads_j = vjp(jnp.asarray(w))
    grads_64, _ = torch_vjp(
        lambda xx, bb, aa: IK.sosfilt_plain(IK.embed_first_order_sos(bb, aa)[:, None, :], xx),
        (x, b, a), (w,), torch.float64,
    )
    for name, gt, gj, g64 in zip(("dx", "db", "da"), grads_t, grads_j, grads_64):
        assert_close(gt, g64, 1e-3, f"{name} port vs float64")
        assert_close(gt, np.asarray(gj), 1e-3, f"{name} port vs jax")


def make_g(bs=3, T=1000, seed=9):
    return -np.abs(np.random.default_rng(seed).standard_normal((bs, 1, T))).astype(np.float32) * 3


@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_backward_matches_jax(with_y0):
    rng = np.random.default_rng(23)
    g = make_g()
    aa = np.asarray([0.9, 0.85, 0.5], np.float32)
    ar = np.asarray([0.99, 0.995, 0.9], np.float32)
    y0 = (-np.abs(rng.standard_normal((3, 1))) if with_y0 else np.zeros((3, 1))).astype(np.float32)
    ct = rng.standard_normal(g.shape).astype(np.float32)
    ct_f = rng.standard_normal((3, 1)).astype(np.float32)

    def port(gg, a1, a2, yy):
        y, (yf, _) = BK.ballistics_pallas(gg, a1, a2, y0=yy, return_yf=True)
        return y, yf

    grads_t, outs = torch_vjp(port, (g, aa, ar, y0), (ct, ct_f))
    assert "_BallisticsKernelBackward" in graph_nodes(outs[0])
    _, vjp = jax.vjp(
        lambda gg, a1, a2, yy: (lambda r: (r[0], r[1][0]))(
            j_ballistics_pallas(gg, a1, a2, time_block=256, interpret=True, y0=yy, return_yf=True)),
        *(jnp.asarray(v) for v in (g, aa, ar, y0)),
    )
    grads_j = vjp((jnp.asarray(ct), jnp.asarray(ct_f)))
    for name, gt, gj in zip(("dg", "daa", "dar", "dy0"), grads_t, grads_j):
        assert_close(gt, np.asarray(gj), 1e-5, name)


def test_ballistics_backward_is_bitwise_autograd_through_the_plain_loop():
    rng = np.random.default_rng(24)
    g = torch.tensor(make_g(bs=4, T=3000).reshape(4, 3000))
    aa, ar = torch.tensor([0.9, 0.8, 0.5, 0.99]), torch.tensor([0.99, 0.95, 0.9, 0.999])
    y0 = -torch.rand(4, generator=torch.Generator().manual_seed(0))
    ct = torch.tensor(rng.standard_normal((4, 3000)).astype(np.float32))

    leaves = [t.clone().requires_grad_() for t in (g, aa, ar, y0)]
    (BK.ballistics_rows_plain(*leaves) * ct).sum().backward()
    y = BK.ballistics_rows_plain(g, aa, ar, y0)
    for got, leaf in zip(BK.ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct), leaves):
        assert torch.equal(got, leaf.grad)


def test_backward_needs_no_residuals_without_grad():
    """Without a gradient the wrappers run the plain forward only (no
    autograd Function); with one they go through it."""
    sos = eq_sos(2, seed=3)
    x = torch.randn(2, 1, 300)
    with torch.no_grad():
        assert IK.sosfilt_pallas(sos, x).grad_fn is None
    assert "_SosfiltKernelBackward" in graph_nodes(IK.sosfilt_pallas(sos, x.requires_grad_()))
    g = torch.tensor(make_g(bs=2, T=50))
    with torch.no_grad():
        assert BK.ballistics_pallas(g, torch.full((2,), 0.9), torch.full((2,), 0.99)).grad_fn is None
    y = BK.ballistics_pallas(g.requires_grad_(), torch.full((2,), 0.9), torch.full((2,), 0.99))
    assert "_BallisticsKernelBackward" in graph_nodes(y)
