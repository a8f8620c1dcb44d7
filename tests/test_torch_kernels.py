"""The two kernel modules of dasp_tpu_torch against dasp_tpu and float64.

On the CPU the wrappers ``sosfilt_pallas`` / ``lfilter1_pallas`` /
``ballistics_pallas`` run their plain PyTorch versions (and, for gradients,
the kernels' backward formulas through the plain engines; see
tests/test_torch_backward.py); the JAX side runs the Pallas kernels in
interpret mode. Tolerances:

* biquad cascade: 2e-3 abs against ``sosfilt_pallas(interpret=True)``,
  ``sosfilt_exact`` and float64 ``scipy.signal.sosfilt``, the bound of
  tests/test_pallas_iir.py (fp32 state through near-unit-circle poles);
* one-pole through the cascade: 1e-5, as tests/test_pallas_iir.py;
* ballistics: 1e-6 relative to the curve's peak. XLA:CPU contracts the
  update into FMAs, so the JAX reference rounds a few ulps away from the
  per-step IEEE rounding of the plain loop (which the CUDA kernel copies
  bitwise); the test reports whether the two are bitwise equal;
* the ballistics kernels' algorithms, emulated in PyTorch: the forward's
  speculate-and-verify rounds bitwise equal to the plain loop, the
  backward's float64 chunked scan within 1e-12 of the float64 reverse loop.

The CUDA kernels themselves are tested on the card by
tests/test_torch_gpu.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from dasp_tpu.ops import ballistics_pallas as j_ballistics_pallas
from dasp_tpu.ops import lfilter1_exact as j_lfilter1_exact
from dasp_tpu.ops import lfilter1_pallas as j_lfilter1_pallas
from dasp_tpu.ops import sosfilt_exact as j_sosfilt_exact
from dasp_tpu.ops import sosfilt_pallas as j_sosfilt_pallas
from dasp_tpu_torch import trace
from dasp_tpu_torch.ops import ballistics_kernel as BK
from dasp_tpu_torch.ops import iir_kernel as IK
from dasp_tpu_torch.ops.biquad import biquad
from dasp_tpu_torch.ops.iir import block_toeplitz_operators

SR = 44100
A_TOL = 2e-3
LF1_TOL = 1e-5
B_TOL = 1e-6


def make_sos(bs, sections=(("low_shelf", 4.0, 200.0, 0.7), ("peaking", -6.0, 1000.0, 2.0),
                           ("high_shelf", 3.0, 8000.0, 0.7))):
    secs = []
    for ft, g, fc, q in sections:
        b, a = biquad(torch.full((bs,), g), torch.full((bs,), fc), torch.full((bs,), q), SR, ft)
        secs.append(torch.cat([b, a], dim=-1))
    return torch.stack(secs, dim=1)


def eq_sos(bs, seed):
    """Parametric-EQ cascades (bs, 6, 6) from random normalized parameters."""
    from dasp_tpu_torch import functional as F
    from dasp_tpu_torch.modules import ParametricEQ

    eq = ParametricEQ(SR)
    p = torch.tensor(np.random.default_rng(seed).uniform(size=(bs, eq.num_params)).astype(np.float32))
    d = eq.denormalize_param_dict(eq.extract_param_dict(p))
    return F.parametric_eq_sos(bs, torch.float32, SR, *d.values())


def scipy_rows(sos, x):
    """float64 scipy reference of (bs, S, 6) sections on (bs, ch, T)."""
    s64 = sos.double().numpy()
    x64 = x.double().numpy()
    return np.stack([
        np.stack([scipy.signal.sosfilt(s64[b], x64[b, c]) for c in range(x.shape[1])])
        for b in range(x.shape[0])
    ])


# ---------------------------------------------------------------------------
# kernel A's plain version (CPU)
# ---------------------------------------------------------------------------


def test_sosfilt_plain_matches_jax_pallas_and_exact():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 2, 1024)) * 0.3).astype(np.float32)
    sos = make_sos(2)
    y_t = IK.sosfilt_pallas(sos, torch.tensor(x)).numpy()
    y_pal = np.asarray(j_sosfilt_pallas(jnp.asarray(sos.numpy()), jnp.asarray(x),
                                        block=128, row_tile=4, interpret=True))
    y_ex = np.asarray(j_sosfilt_exact(jnp.asarray(sos.numpy()), jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_pal, atol=A_TOL)
    np.testing.assert_allclose(y_t, y_ex, atol=A_TOL)


@pytest.mark.parametrize("bs,ch,T", [(3, 1, 1000), (1, 3, 129), (2, 2, 4096), (1, 1, 1)])
def test_sosfilt_plain_matches_float64(bs, ch, T):
    """Ragged T (no multiple of the 128-sample block) and odd row counts."""
    rng = np.random.default_rng(bs * 1000 + T)
    x = torch.tensor((rng.standard_normal((bs, ch, T)) * 0.25).astype(np.float32))
    sos = eq_sos(bs, seed=T)
    y = IK.sosfilt_pallas(sos, x)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.double().numpy(), scipy_rows(sos, x), atol=A_TOL)


def test_lfilter1_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 1, 768)).astype(np.float32)
    b = np.asarray([[0.2, 0.1], [0.3, 0.05]], np.float32)
    a = np.asarray([[1.0, -0.95], [1.0, -0.8]], np.float32)
    y_t = IK.lfilter1_pallas(torch.tensor(x), torch.tensor(b), torch.tensor(a)).numpy()
    y_e = np.asarray(j_lfilter1_exact(jnp.asarray(x), jnp.asarray(b[:, None, :]), jnp.asarray(a[:, None, :])))
    y_p = np.asarray(j_lfilter1_pallas(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a),
                                       block=128, row_tile=4, interpret=True))
    np.testing.assert_allclose(y_t, y_e, atol=LF1_TOL)
    np.testing.assert_allclose(y_t, y_p, atol=LF1_TOL)


def test_sosfilt_gradients_match_jax():
    """The port's backward (the adjoint cascade through the plain engine, on
    the CPU) and the JAX kernel's custom VJP, each against float64 autograd
    through the plain forward (``sosfilt_plain``). The gradient with respect
    to raw denominator coefficients is ill-conditioned in fp32 (both sit
    ~3e-3 from float64 here), so the bound is tests/test_pallas_iir.py's 1e-2
    relative to the largest sos gradient, and 1e-3 for the signal
    gradient."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 1, 512)) * 0.3).astype(np.float32)
    sos = make_sos(2).numpy()

    def jloss(s, xx):
        return jnp.mean(j_sosfilt_pallas(s, xx, block=128, row_tile=4, interpret=True) ** 2)

    grads_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sos), jnp.asarray(x))

    def torch_grads(fn, dtype):
        st = torch.tensor(sos, dtype=dtype, requires_grad=True)
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        (fn(st, xt) ** 2).mean().backward()
        return st.grad.double().numpy(), xt.grad.double().numpy()

    grads_t = torch_grads(IK.sosfilt_pallas, torch.float32)
    truth = torch_grads(IK.sosfilt_plain, torch.float64)
    for gt, gj, g64, tol in zip(grads_t, grads_j, truth, (1e-2, 1e-3)):
        scale = np.abs(g64).max()
        np.testing.assert_allclose(gt / scale, g64 / scale, atol=tol)
        np.testing.assert_allclose(np.asarray(gj) / scale, g64 / scale, atol=tol)


def chunked_scan64(sos, x, L=32, warp=32, warps=8):
    """The CUDA kernel's algebra (csrc/sosfilt_cascade.cuh) in float64: per
    section, a zero-state pass over each L-sample chunk, the 2x2 carry
    c_{j+1} = M c_j + e_j scanned over a warp's chunks by doubling (M^d),
    chained over warps and tiles, and each chunk walked again from its true
    state. M comes from the port's block_toeplitz_operators."""
    R, T = x.shape
    tile = L * warp * warps
    u = torch.nn.functional.pad(x, (0, -T % tile)).reshape(R, -1, L)
    hist = torch.nn.functional.pad(u[:, :-1, -2:].flip(-1), (0, 0, 1, 0))  # x[-1], x[-2] per chunk
    for s in range(sos.shape[1]):
        b0, b1, b2, _, a1, a2 = sos[:, s, :, None].unbind(1)
        _, _, h1, h2 = block_toeplitz_operators(sos[:, s], L)
        M = torch.stack([torch.stack([h1[:, -1], h2[:, -1]], -1), torch.stack([h1[:, -2], h2[:, -2]], -1)], -2)

        def walk(c):
            xm, ym, out = list(hist.unbind(-1)), list(c.unbind(-1)), []
            for k in range(L):
                out.append(b0 * u[..., k] + b1 * xm[0] + b2 * xm[1] - a1 * ym[0] - a2 * ym[1])
                xm, ym = [u[..., k], xm[0]], [out[-1], ym[0]]
            return torch.stack(out, -1)

        z = walk(torch.zeros_like(hist))
        e = torch.stack([z[..., -1], z[..., -2]], -1).reshape(R, -1, warp, 2)
        Md = M
        for d in (1, 2, 4, 8, 16):
            prev = torch.nn.functional.pad(e, (0, 0, d, 0))[:, :, :warp]
            e = torch.where(torch.arange(warp)[:, None] >= d, e + torch.einsum("rij,rwlj->rwli", Md, prev), e)
            Md = Md @ Md
        c, starts = torch.zeros_like(e[:, 0, 0]), []
        for w in range(e.shape[1]):
            starts.append(c)
            c = torch.einsum("rij,rj->ri", Md, c) + e[:, w, -1]
        powers = [torch.eye(2, dtype=x.dtype).expand_as(M)]
        for _ in range(warp - 1):
            powers.append(powers[-1] @ M)
        excl = torch.nn.functional.pad(e, (0, 0, 1, 0))[:, :, :warp]
        c = torch.einsum("rlij,rwj->rwli", torch.stack(powers, 1), torch.stack(starts, 1)) + excl
        c = c.reshape(R, -1, 2)
        u, hist = walk(c), c  # a section's incoming states are the next one's input history
    return u.reshape(R, -1)[:, :T]


@pytest.mark.parametrize("case", ["eq", "shelf_20hz_q6"])
@pytest.mark.parametrize("reverse", [False, True])
def test_chunked_scan_algebra_matches_scipy(case, reverse):
    """The kernel's chunking algebra reproduces float64 scipy at small size,
    forward and in reversed time (the adjoint's walk), over two tiles and a
    ragged third: within 1e-9 of the peak for the EQ, 1e-6 for the shelf,
    whose poles 2.5e-4 from the unit circle amplify float64 rounding (1.6e-7
    measured; a wrong carry is off by the signal itself)."""
    T = 2 * 8192 + 777
    x = torch.tensor(np.random.default_rng(3).standard_normal((2, 1, T)) * 0.25)
    if case == "eq":
        sos = eq_sos(2, seed=5).double()
    else:
        sos = make_sos(2, sections=(("low_shelf", 12.0, 20.0, 6.0),)).double()
    rows = x[:, 0].flip(-1) if reverse else x[:, 0]
    y = chunked_scan64(sos, rows)
    ref = scipy_rows(sos, rows[:, None])[:, 0]
    tol = 1e-9 if case == "eq" else 1e-6
    np.testing.assert_allclose(y.numpy(), ref, atol=tol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# kernel B's plain version (CPU)
# ---------------------------------------------------------------------------


def make_g(bs=2, T=700, seed=9):
    return -np.abs(np.random.default_rng(seed).standard_normal((bs, 1, T))).astype(np.float32)


@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_plain_matches_jax_pallas(with_y0, record_property):
    g = make_g(bs=3, T=1000)
    aa = np.asarray([0.9, 0.85, 0.5], np.float32)
    ar = np.asarray([0.99, 0.995, 0.9], np.float32)
    y0 = (-np.abs(np.random.default_rng(2).standard_normal((3, 1)))).astype(np.float32) if with_y0 else None
    y_t, (yf_t, _) = BK.ballistics_pallas(
        torch.tensor(g), torch.tensor(aa), torch.tensor(ar),
        y0=None if y0 is None else torch.tensor(y0), return_yf=True,
    )
    y_j, (yf_j, _) = j_ballistics_pallas(
        jnp.asarray(g), jnp.asarray(aa), jnp.asarray(ar), time_block=256, interpret=True,
        y0=None if y0 is None else jnp.asarray(y0), return_yf=True,
    )
    bitwise = bool(np.array_equal(y_t.numpy(), np.asarray(y_j)))
    record_property("bitwise_equal_to_jax", bitwise)
    print(f"ballistics plain vs JAX kernel (interpret): bitwise={bitwise}, "
          f"max diff {np.abs(y_t.numpy() - np.asarray(y_j)).max():.3e}")
    peak = np.abs(g).max()
    np.testing.assert_allclose(y_t.numpy() / peak, np.asarray(y_j) / peak, atol=B_TOL)
    np.testing.assert_array_equal(yf_t.numpy(), y_t.numpy()[..., -1])
    np.testing.assert_allclose(yf_t.numpy() / peak, np.asarray(yf_j) / peak, atol=B_TOL)


def test_ballistics_chunk_chained_is_bitwise_one_pass():
    g = torch.tensor(make_g(bs=2, T=999))
    aa, ar = torch.tensor([0.9, 0.7]), torch.tensor([0.99, 0.98])
    y = BK.ballistics_pallas(g, aa, ar)
    y0, parts = None, []
    for a, b in ((0, 100), (100, 613), (613, 999)):
        part, (y0, _) = BK.ballistics_pallas(g[..., a:b], aa, ar, y0=y0, return_yf=True)
        parts.append(part)
    assert torch.equal(torch.cat(parts, dim=-1), y)


def test_ballistics_gradients_match_jax():
    g = make_g()
    aa, ar = np.full((2,), 0.9, np.float32), np.full((2,), 0.99, np.float32)

    def jloss(g, aa, ar):
        return jnp.mean(j_ballistics_pallas(g, aa, ar, time_block=256, interpret=True) ** 2)

    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(g), jnp.asarray(aa), jnp.asarray(ar))
    ts = [torch.tensor(v, requires_grad=True) for v in (g, aa, ar)]
    (BK.ballistics_pallas(*ts) ** 2).mean().backward()
    for t_, gj in zip(ts, grads_j):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(gj), atol=1e-5)


# ---------------------------------------------------------------------------
# the two CUDA ballistics algorithms, emulated (CPU)
# ---------------------------------------------------------------------------


def alpha_ms(ms):
    """The smoothing coefficient of a time constant (functional._dynamics_common)."""
    return torch.exp(torch.tensor(-math.log(9.0) / (SR * ms / 1e3), dtype=torch.float32))


def bits(t):
    return t.view(torch.int32)


def speculate_and_verify(g, aa, ar, y0, guess="g", L=32):
    """csrc/ballistics.cu's rounds in PyTorch fp32, vectorised over the
    L-sample chunks of (R, T) rows: every chunk walks from a guessed entering
    state (``guess``: the sample of g before it, zero, or noise; y0 for the
    row's first chunk), then in rounds every chunk whose entering state
    differs bit for bit from its predecessor's last output walks again from
    it, until no chunk changes. Returns (y, rounds)."""
    R, T = g.shape
    C = -(-T // L)
    gc = torch.nn.functional.pad(g, (0, C * L - T)).reshape(R, C, L)
    aa, ar = aa[:, None], ar[:, None]

    def walk(e):
        v, out = e, []
        for k in range(L):
            alpha = torch.where(gc[..., k] < v, aa, ar)
            v = (1.0 - alpha) * gc[..., k] + alpha * v
            out.append(v)
        return torch.stack(out, dim=-1)

    e = {"g": torch.nn.functional.pad(gc[:, :-1, -1], (1, 0)), "zero": torch.zeros(R, C),
         "noise": torch.randn(R, C, generator=torch.Generator().manual_seed(0))}[guess]
    e[:, 0] = y0
    y, rounds = walk(e), 0
    while True:
        pred = torch.cat([y0[:, None], y[:, :-1, -1]], dim=1)
        changed = bits(pred) != bits(e)
        if not changed.any():
            return y.reshape(R, -1)[:, :T], rounds
        e = torch.where(changed, pred, e)
        y = torch.where(changed[..., None], walk(e), y)
        rounds += 1


def compressor_curve(R, T, seed):
    """A compressor's gain curve (dB) on 0.25 * randn: threshold -20 dB,
    ratio 4, knee 6 dB."""
    from dasp_tpu_torch import functional as F

    x = torch.tensor((np.random.default_rng(seed).standard_normal((R, T)) * 0.25).astype(np.float32))
    x_db = 20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8))
    return F.static_gain_computer(x_db, -20.0, 4.0, 6.0, "compressor")


def with_ties(g, aa, ar, y0, every=7):
    """g with g[n] set to y[n-1] of the plain loop on every ``every``-th
    sample, so the branch compares equal values there."""
    g = g.clone()
    y_prev = y0
    for n in range(g.shape[-1]):
        if n % every == 3:
            g[:, n] = y_prev
        alpha = torch.where(g[:, n] < y_prev, aa, ar)
        y_prev = (1.0 - alpha) * g[:, n] + alpha * y_prev
    return g


def ballistics_case(name, R=2):
    """(g, aa, ar, y0) of (R, T) rows for the named case."""
    T = {"short": 20, "ragged": 1000}.get(name, 4096)
    g = compressor_curve(R, T, seed=T)
    a5, a100 = alpha_ms(5.0), alpha_ms(100.0)
    aa, ar, y0 = torch.full((R,), float(a5)), torch.full((R,), float(a100)), torch.zeros(R)
    if name == "corner_100_100":
        aa = ar
    elif name == "constant":
        g = torch.full((R, T), -6.0)
    elif name == "step":
        g = torch.zeros(R, T)
        g[:, T // 3 : 2 * T // 3] = -12.0
    elif name == "ties":
        g = with_ties(g, aa, ar, y0)
    elif name == "y0":
        y0 = -torch.rand(R, generator=torch.Generator().manual_seed(1)) * 12.0
    return g, aa, ar, y0


@pytest.mark.parametrize("name", ["corner_100_100", "constant", "step", "ties", "y0", "short", "ragged"])
def test_speculate_and_verify_is_bitwise_the_plain_loop(name):
    """The forward kernel's algorithm reaches the plain loop's result bit for
    bit; at the 100 / 100 ms corner its speculation alone is wrong, so the
    rounds are what make it exact."""
    g, aa, ar, y0 = ballistics_case(name)
    y, rounds = speculate_and_verify(g, aa, ar, y0)
    plain = BK.ballistics_rows_plain(g, aa, ar, y0)
    assert torch.equal(bits(y), bits(plain))
    if name == "ties":
        y_prev = torch.cat([y0[:, None], plain[:, :-1]], dim=1)
        assert int((g == y_prev).sum()) >= g.numel() // 8
    if name == "corner_100_100":
        assert rounds > 10


@pytest.mark.parametrize("guess", ["zero", "noise"])
def test_speculate_and_verify_does_not_depend_on_the_guess(guess):
    g, aa, ar, y0 = ballistics_case("corner_100_100")
    y, _ = speculate_and_verify(g, aa, ar, y0, guess=guess)
    assert torch.equal(bits(y), bits(BK.ballistics_rows_plain(g, aa, ar, y0)))


def chunked_adjoint64(y, g, aa, ar, y0, ct, L=32, warp=32, warps=8):
    """csrc/ballistics_bwd.cu's algebra in float64: in reverse time,
    q -> P q + z over each L-sample chunk (a zero-state walk), the maps
    scanned over a warp's chunks by doubling with (P', z') after (P, z) =
    (P' P, P' z + z'), chained over warps and tiles, and each chunk walked
    again from its true q, writing dg and summing the terms by branch."""
    R, T = g.shape
    tile = L * warp * warps
    Tp = -(-T // tile) * tile
    rev = lambda v: torch.nn.functional.pad(v.flip(-1), (0, Tp - T)).reshape(R, -1, L)  # noqa: E731
    y_prev = torch.cat([y0[:, None], y[:, :-1]], dim=1)
    gr, cr, yr = rev(g), rev(ct), rev(y_prev)
    attack = gr < yr
    a = torch.where(attack, aa[:, None, None], ar[:, None, None])

    P, z = torch.ones_like(gr[..., 0]), torch.zeros_like(gr[..., 0])
    for k in range(L):
        z = a[..., k] * (cr[..., k] + z)
        P = P * a[..., k]
    P, z = P.reshape(R, -1, warp), z.reshape(R, -1, warp)
    for d in (1, 2, 4, 8, 16):
        pP = torch.nn.functional.pad(P, (d, 0), value=1.0)[..., :warp]
        pz = torch.nn.functional.pad(z, (d, 0))[..., :warp]
        P, z = P * pP, z + P * pz
    c, starts = torch.zeros(R, dtype=g.dtype), []
    for w in range(P.shape[1]):  # warps of every tile, in order
        starts.append(c)
        c = P[:, w, -1] * c + z[:, w, -1]
    xP = torch.nn.functional.pad(P, (1, 0), value=1.0)[..., :warp]
    xz = torch.nn.functional.pad(z, (1, 0))[..., :warp]
    q = (xP * torch.stack(starts, dim=1)[..., None] + xz).reshape(R, -1)

    dg, sums = [], torch.zeros(R, 2, dtype=g.dtype)
    for k in range(L):
        lam = cr[..., k] + q
        dg.append((1.0 - a[..., k]) * lam)
        term = lam * (yr[..., k] - gr[..., k])
        sums[:, 0] += torch.where(attack[..., k], term, 0.0).sum(-1)
        sums[:, 1] += torch.where(attack[..., k], 0.0, term).sum(-1)
        q = a[..., k] * lam
        if k == (T - 1) % L:
            dy0 = q[:, (T - 1) // L]
    dg = torch.stack(dg, dim=-1).reshape(R, -1)[:, :T].flip(-1)
    return dg, sums[:, 0], sums[:, 1], dy0


@pytest.mark.parametrize("T", [20, 1000, 2 * 8192 + 777])
def test_chunked_adjoint_algebra_matches_the_float64_loop(T):
    """The backward kernel's reverse chunked scan reproduces the plain reverse
    loop in float64, over tiles and a ragged last one, within 1e-12 of each
    gradient's largest value (a wrong carry is off by the gradient itself)."""
    R = 2
    g, aa, ar, y0 = (v.double() for v in ballistics_case("y0", R=R))
    g = compressor_curve(R, T, seed=T).double()
    y = BK.ballistics_rows_plain(g, aa, ar, y0)
    ct = torch.tensor(np.random.default_rng(T).standard_normal((R, T)))
    got = chunked_adjoint64(y, g, aa, ar, y0, ct)
    ref = BK.ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct)
    for name, a, b in zip(("dg", "daa", "dar", "dy0"), got, ref):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), name


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def launches():
    counts = trace.snapshot()["counts"]
    return counts.get("kernel_a.forward", 0), counts.get("kernel_b.forward", 0)


# the coefficient shapes the exact ballistics' callers pass: per item, or
# per channel or band (the streams' per-band coefficients)
COEF_SHAPES = {"(bs,)": (2,), "(bs, 1, 1)": (2, 1, 1), "(bs, ch, 1)": (2, 3, 1)}


def coefs(shape):
    """Attack and release coefficients of ``shape``, different in every
    row they reach."""
    n = math.prod(shape)
    aa = torch.linspace(0.5, 0.9, n).reshape(shape)
    return aa, (0.99 - 0.05 * torch.linspace(0, 1, n)).reshape(shape)


@pytest.mark.parametrize("shape", list(COEF_SHAPES))
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(shape):
    """Both wrappers on a CPU tensor run their plain versions and count no
    launch; the exact ballistics fold each coefficient shape and a (bs, ch)
    state into the rows ``ballistics_rows_plain`` takes, bitwise."""
    a0, b0 = launches()
    x = torch.randn(2, 1, 300)
    assert torch.equal(IK.sosfilt_pallas(make_sos(2), x), IK.sosfilt_plain(make_sos(2), x))
    g = torch.tensor(make_g(bs=6, T=700)).reshape(2, 3, 700)
    y0 = -torch.rand(2, 3, generator=torch.Generator().manual_seed(4))
    aa, ar = coefs(COEF_SHAPES[shape])
    y = BK.ballistics_pallas(g, aa, ar, y0=y0)
    assert torch.equal(y, BK.ballistics_plain(g, aa, ar, y0=y0))
    rows = [torch.broadcast_to(a.reshape(2, -1, 1) if a.ndim == 1 else a, (2, 3, 1)).reshape(6) for a in (aa, ar)]
    assert torch.equal(y.reshape(6, 700), BK.ballistics_rows_plain(g.reshape(6, 700), *rows, y0.reshape(6)))
    assert launches() == (a0, b0)


@pytest.mark.parametrize("shape", list(COEF_SHAPES))
def test_ballistics_smooth_exact_is_the_plain_loop(shape):
    """``ballistics_smooth(mode="exact")`` is ``ballistics_plain`` on the
    same rows: value, final state and every gradient bitwise."""
    from dasp_tpu_torch.ops.iir import ballistics_smooth

    g0 = torch.tensor(make_g(bs=6, T=500, seed=3)).reshape(2, 3, 500)
    y0 = -torch.rand(2, 3, generator=torch.Generator().manual_seed(5))
    aa, ar = coefs(COEF_SHAPES[shape])
    w = torch.randn(g0.shape, generator=torch.Generator().manual_seed(6))
    got = []
    for smooth in (lambda *a: ballistics_smooth(*a[:3], mode="exact", y0=(a[3], a[3]), return_yf=True),
                   lambda *a: BK.ballistics_plain(*a, return_yf=True)):
        leaves = [t.clone().requires_grad_() for t in (g0, aa, ar, y0)]
        y, (ya, ym) = smooth(*leaves)
        ((y * w).sum() + ya.sum() + 2.0 * ym.sum()).backward()
        got.append([y, ym] + [t.grad for t in leaves])
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wrapper", ["sosfilt_pallas", "ballistics_pallas", "frac_delay_pallas"])
def test_other_devices_raise(wrapper):
    from dasp_tpu_torch.ops import frac_delay_kernel as FK

    x = torch.empty(2, 1, 64, device="meta")
    calls = {
        "sosfilt_pallas": lambda: IK.sosfilt_pallas(make_sos(2).to("meta"), x),
        "ballistics_pallas": lambda: BK.ballistics_pallas(x, torch.ones(2), torch.ones(2)),
        "frac_delay_pallas": lambda: FK.frac_delay_pallas(x, torch.empty(1, 2, 32, device="meta"),
                                                          torch.empty(1, 2, 32, device="meta"), 32, 32),
    }
    with pytest.raises(ValueError, match=f"{wrapper} runs on CPU or CUDA"):
        calls[wrapper]()
