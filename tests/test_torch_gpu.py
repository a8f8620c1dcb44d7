"""The hand-written CUDA kernels of dasp_tpu_torch, on the card.

Every test here needs a CUDA device, is marked ``gpu`` and skips without
one. The file imports neither JAX nor dasp_tpu, so it runs where only
PyTorch is installed: ``python -m pytest -m gpu tests/test_torch_gpu.py``
from the repository root on a machine with the card and ``nvcc``.

Tolerances: the biquad-cascade kernel within 2e-3 abs of float64
``scipy.signal.sosfilt`` (the bound of tests/test_pallas_iir.py) and at most
2x its plain version's error; its gradient (save-all forward and adjoint
launches) within 1e-2 (dsos) and 1e-3 (dx) of the largest float64 gradient
(autograd through the plain version in float64), and at most 2x the error
of the plain fp32 adjoint plus 2e-4 of that largest gradient: on rows of
32768 samples both fp32 recursions sit near 1e-4 of it and either may be
the closer (measured on an H100: kernel 6.6e-5, plain 2.5e-5 for dsos),
while at the path's 131072 samples the plain version's block carries
dominate (chip_smoke.py phase 5 holds the strict 2x rule there: kernel
1.2e-4, plain 1.7e-2); the ballistics forward bitwise equal to its plain
loop, and its backward (a float64 scan) against the plain reverse loop run
in float64, within B_BWD_TOL of each gradient's scale and at most 2x the
fp32 loop's own distance plus B_BWD_TOL (b_bwd_errors); a smoke-width
training step through all kernel uses within
1e-3 (loss) and 1e-2 (gradient norm) of the plain path. The
fractional-delay kernels (C-fwd, C-bwd) against their plain engine on the
same card tensors: the forward, dd and dg bitwise equal (the same fp32
operations in the same order, channels summed in order), dx within 1e-6 of
its largest value (both sum by atomics, in an order that changes from run
to run), on edge shapes too (B % 4 != 0, ragged T, odd Dm, one to three
channels, misaligned rows, delays drawn at random).
"""

import numpy as np
import pytest
import scipy.signal
import torch

from dasp_tpu_torch import functional as F
from dasp_tpu_torch.modules import ParametricEQ
from dasp_tpu_torch.ops import ballistics_kernel as BK
from dasp_tpu_torch.ops import frac_delay_kernel as FK
from dasp_tpu_torch.ops import iir_kernel as IK
from dasp_tpu_torch.ops.biquad import biquad

SR = 44100
A_TOL = 2e-3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu tests/test_torch_gpu.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def eq_sos(bs, seed):
    eq = ParametricEQ(SR)
    p = torch.tensor(np.random.default_rng(seed).uniform(size=(bs, eq.num_params)).astype(np.float32))
    d = eq.denormalize_param_dict(eq.extract_param_dict(p))
    return F.parametric_eq_sos(bs, torch.float32, SR, *d.values())


def make_g(bs, T, seed=9):
    return torch.tensor(-np.abs(np.random.default_rng(seed).standard_normal((bs, 1, T))).astype(np.float32))


@pytest.mark.parametrize("bs,ch,T", [(8, 1, 1), (3, 2, 1000), (8, 1, 131072)])
def test_sosfilt_kernel_matches_float64_and_plain(cuda, bs, ch, T):
    x = torch.tensor((np.random.default_rng(T).standard_normal((bs, ch, T)) * 0.25).astype(np.float32))
    sos = eq_sos(bs, seed=1)
    before = IK.sosfilt_pallas.launches
    y_k = IK.sosfilt_pallas(sos.to(cuda), x.to(cuda)).cpu()
    assert IK.sosfilt_pallas.launches == before + 1
    s64, x64 = sos.double().numpy(), x.double().numpy()
    ref = np.stack([[scipy.signal.sosfilt(s64[b], x64[b, c]) for c in range(ch)] for b in range(bs)])
    err_k = np.abs(y_k.double().numpy() - ref).max()
    err_p = np.abs(IK.sosfilt_plain(sos, x).double().numpy() - ref).max()
    assert err_k <= A_TOL
    assert err_k <= 2 * err_p + 1e-7


def shelf_sos(bs, gain_db=12.0):
    """The EQ's hardest corner: a low shelf at 20 Hz with Q 6 (poles about
    2.5e-4 from the unit circle), as one section per row."""
    b, a = biquad(torch.full((bs,), gain_db), torch.full((bs,), 20.0), torch.full((bs,), 6.0), SR, "low_shelf")
    return torch.cat([b, a], dim=-1)[:, None, :]


def mild_sos(bs, S, seed):
    """S peaking sections of +-3 dB, 100 Hz-15 kHz, Q 0.5-2 per row."""
    rng = np.random.default_rng(seed)
    g, fc, q = (torch.tensor(v.astype(np.float32)) for v in (
        rng.uniform(-3, 3, (S, bs)), np.exp(rng.uniform(np.log(100), np.log(15000), (S, bs))),
        rng.uniform(0.5, 2.0, (S, bs))))
    secs = [torch.cat(biquad(g[i], fc[i], q[i], SR, "peaking"), dim=-1) for i in range(S)]
    return torch.stack(secs, dim=1)


def planes64(sos, x, reverse=False):
    """Every section's output in float64 (S, R, T); with ``reverse`` the
    cascade runs in flipped time and the planes are given in forward time."""
    s64, x64 = sos.double().numpy(), x.double().numpy()
    y = x64[:, ::-1] if reverse else x64
    out = []
    for i in range(s64.shape[1]):
        y = np.stack([scipy.signal.sosfilt(s64[r, i : i + 1], y[r]) for r in range(y.shape[0])])
        out.append(y[:, ::-1] if reverse else y)
    return np.stack(out)


@pytest.mark.parametrize("R,S,T,kind", [
    (8, 6, 131072 - 1234, "eq"),  # the EQ's width, T no multiple of the 32-sample chunk
    (8, 6, 2 * 8192 + 1, "eq"),  # a last tile of one sample
    (3, 6, 20, "eq"),  # T < one chunk
    (8, 6, 1, "eq"),
    (1, 1, 50000, "shelf"),  # R = 1, S = 1
    (8, 1, 131072, "shelf"),
    (24, 16, 20005, "mild"),  # R = 24, S = kMaxSections
])
def test_sosfilt_kernel_uses_on_edge_shapes(cuda, R, S, T, kind):
    """All three uses of the chunked-scan kernel (forward, save-all, adjoint
    with its reversed walk, whose last chunk is the ragged one) against
    float64 scipy, every section, and against the plain version: within
    A_TOL and at most 2x the plain version's error (+1e-7)."""
    sos = {"eq": lambda: eq_sos(R, seed=T), "shelf": lambda: shelf_sos(R), "mild": lambda: mild_sos(R, S, T)}[kind]()
    sos = IK.stabilize_sos(sos).contiguous()
    x = torch.tensor((np.random.default_rng(T).standard_normal((R, T)) * 0.25).astype(np.float32))
    sc, xc = sos.to(cuda), x.to(cuda)
    ref, ref_rev = planes64(sos, x), planes64(sos, x, reverse=True)
    uses = {
        "forward": (IK._CudaEngine.forward(sc, xc)[None], IK._PlainEngine.forward(sos, x)[None], ref[-1:]),
        "save_all": (IK._CudaEngine.save_all(sc, xc), IK._PlainEngine.save_all(sos, x), ref),
        "adjoint": (IK._CudaEngine.adjoint(sc, xc), IK._PlainEngine.adjoint(sos, x), ref_rev),
    }
    for use, (got, plain, truth) in uses.items():
        err_k = np.abs(got.double().cpu().numpy() - truth).max(axis=(1, 2))
        err_p = np.abs(plain.double().numpy() - truth).max(axis=(1, 2))
        assert (err_k <= A_TOL).all(), (use, err_k)
        assert (err_k <= 2 * err_p + 1e-7).all(), (use, err_k, err_p)


def test_lfilter1_kernel_matches_plain(cuda):
    x = torch.randn(4, 1, 5000)
    b = torch.tensor([[0.2, 0.1], [0.3, 0.05], [0.01, 0.0], [1.0, -1.0]])
    a = torch.tensor([[1.0, -0.95], [1.0, -0.8], [1.0, -0.99], [1.0, 0.5]])
    y_k = IK.lfilter1_pallas(x.to(cuda), b.to(cuda), a.to(cuda)).cpu()
    np.testing.assert_allclose(y_k.numpy(), IK.lfilter1_pallas(x, b, a).numpy(), atol=1e-5)


@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_kernel_bitwise_plain(cuda, with_y0):
    g = make_g(8, 5000)
    aa, ar = torch.linspace(0.5, 0.95, 8), torch.linspace(0.9, 0.999, 8)
    y0 = -torch.rand(8, 1) if with_y0 else None
    before = BK.ballistics_pallas.launches
    y_k, (yf, _) = BK.ballistics_pallas(
        g.to(cuda), aa.to(cuda), ar.to(cuda), y0=None if y0 is None else y0.to(cuda), return_yf=True
    )
    assert BK.ballistics_pallas.launches == before + 1
    assert torch.equal(y_k.cpu(), BK.ballistics_plain(g, aa, ar, y0=y0))
    assert torch.equal(yf.cpu(), y_k.cpu()[..., -1])


def test_ballistics_kernel_chunk_chained_is_bitwise_one_pass(cuda):
    g = make_g(4, 3001).to(cuda)
    aa, ar = torch.full((4,), 0.9, device=cuda), torch.full((4,), 0.995, device=cuda)
    y = BK.ballistics_pallas(g, aa, ar)
    y0, parts = None, []
    for a, b in ((0, 1), (1, 1500), (1500, 3001)):
        part, (y0, _) = BK.ballistics_pallas(g[..., a:b].contiguous(), aa, ar, y0=y0, return_yf=True)
        parts.append(part)
    assert torch.equal(torch.cat(parts, dim=-1), y)


def test_kernel_wrappers_check_inputs(cuda):
    x = torch.randn(2, 1, 256, device=cuda)
    sos = eq_sos(2, seed=2).to(cuda)
    with pytest.raises(TypeError):
        IK.sosfilt_pallas(sos.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        IK.sosfilt_pallas(sos, torch.randn(2, 1, 512, device=cuda)[..., ::2])
    with pytest.raises(ValueError, match="sections"):
        IK.sosfilt_pallas(torch.cat([sos] * 3, dim=1), x)
    with pytest.raises(TypeError):
        BK.ballistics_pallas(x.double(), torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        BK.ballistics_pallas((-torch.rand(2, 1, 512, device=cuda))[..., ::2], torch.ones(2), torch.ones(2))


def counts():
    return (IK.sosfilt_pallas.launches, IK.sosfilt_pallas.save_all_launches,
            IK.sosfilt_pallas.adjoint_launches, BK.ballistics_pallas.launches,
            BK.ballistics_pallas.bwd_launches)


def one_pole_sos(bs):
    alpha = torch.linspace(0.9, 0.9995, bs)
    b = torch.stack([1.0 - alpha, torch.zeros(bs)], dim=-1)
    a = torch.stack([torch.ones(bs), -alpha], dim=-1)
    return IK.embed_first_order_sos(b, a)[:, None, :]


@pytest.mark.parametrize("case", ["eq", "one_pole", "eq_shared_by_2_channels", "shelf_20hz_q6"])
def test_sosfilt_gradient_matches_float64_and_plain_adjoint(cuda, case):
    bs, ch, T = 8, 2 if case == "eq_shared_by_2_channels" else 1, 32768
    sos = {"one_pole": one_pole_sos, "shelf_20hz_q6": shelf_sos}.get(case, lambda n: eq_sos(n, seed=4))(bs)
    rng = np.random.default_rng(5)
    x = torch.tensor((rng.standard_normal((bs, ch, T)) * 0.25).astype(np.float32))
    w = torch.tensor(rng.standard_normal((bs, ch, T)).astype(np.float32))

    def grads(fn, dev, dtype):
        s_ = sos.detach().to(dev, dtype).requires_grad_()
        x_ = x.detach().to(dev, dtype).requires_grad_()
        (fn(s_, x_) * w.to(dev, dtype)).sum().backward()
        return s_.grad.double().cpu(), x_.grad.double().cpu()

    before = counts()
    got = grads(IK.sosfilt_pallas, cuda, torch.float32)
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 1, 0, 0)
    truth = grads(IK.sosfilt_plain, cuda, torch.float64)
    sos_rows = IK.stabilize_sos(sos).repeat_interleave(ch, dim=0).to(cuda)
    dsos_p, dx_p = IK.sosfilt_rows_grad_plain(sos_rows, x.to(cuda).reshape(bs * ch, T),
                                              w.to(cuda).reshape(bs * ch, T))
    plain = (dsos_p.reshape(bs, ch, -1, 6).sum(1).double().cpu(), dx_p.reshape(x.shape).double().cpu())
    for k, p, t, bound in zip(got, plain, truth, (1e-2, 1e-3)):
        err_k, err_p = float((k - t).abs().max()), float((p - t).abs().max())
        assert err_k <= bound * float(t.abs().max())
        assert err_k <= 2 * err_p + 2e-4 * float(t.abs().max())


def b_bwd_errors(got, y, g, aa, ar, y0, ct):
    """The ballistics backward's (dg, daa, dar, dy0) against the plain
    reverse loop in float64 on float64 copies of the same fp32 inputs (so its
    branches are the kernel's): per gradient, the distance of ``got`` and of
    the plain fp32 loop, relative to the largest float64 value (dg, dy0) or
    to the sum of |terms| of the branch (daa, dar)."""
    y, g, aa, ar, y0, ct = (t.cpu() for t in (y, g, aa, ar, y0, ct))
    ref = BK.ballistics_bwd_rows_plain(*(t.double() for t in (y, g, aa, ar, y0, ct)))
    plain = BK.ballistics_bwd_rows_plain(y, g, aa, ar, y0, ct)
    y_prev = torch.cat([y0[:, None], y[:, :-1]], dim=1).double()
    attack = g.double() < y_prev
    alpha = torch.where(attack, aa[:, None], ar[:, None]).double()
    terms = (ref[0] / (1.0 - alpha) * (y_prev - g.double())).abs()
    scale = [ref[0].abs().max(), (terms * attack).sum(-1), (terms * ~attack).sum(-1), ref[3].abs().max()]
    out = {}
    for i, name in enumerate(("dg", "daa", "dar", "dy0")):
        s = torch.clamp(scale[i], min=1e-300)  # a branch never taken sums nothing, exactly
        dist = [float(((v[i].cpu().double() - ref[i]).abs() / s).max()) for v in (got, plain)]
        out[name] = tuple(dist)
    return out


# the ballistics backward against float64 (b_bwd_errors): within B_BWD_TOL,
# and at most 2x the plain fp32 loop's distance plus B_BWD_TOL. The kernel
# rounds each float64 result to fp32 once (at most 6e-8 of it); the plain
# fp32 loop sits 1e-7 to 2.2e-6 from float64 at these shapes
B_BWD_TOL = 2e-7


def assert_b_bwd(errors):
    for name, (k, p) in errors.items():
        assert k <= B_BWD_TOL and k <= 2 * p + B_BWD_TOL, (name, k, p)


@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_backward_bitwise_plain(cuda, with_y0):
    """B-bwd through autograd: one launch of each kernel, and the gradient
    held to float64 (b_bwd_errors). The kernel was bitwise equal to the fp32
    reverse loop while it walked each row serially in fp32; its time-parallel
    form scans in float64 and rounds each result once, so it is held against
    the same loop run in float64 instead, within B_BWD_TOL and at most twice
    the fp32 loop's own distance from it plus B_BWD_TOL. The forward stays
    bitwise."""
    g = make_g(8, 5000)
    aa, ar = torch.linspace(0.5, 0.95, 8), torch.linspace(0.9, 0.999, 8)
    y0 = -torch.rand(8, 1) if with_y0 else torch.zeros(8, 1)
    ct = torch.randn(8, 1, 5000)
    leaves = [t.detach().to(cuda).requires_grad_() for t in (g, aa, ar, y0)]
    before = counts()
    y = BK.ballistics_pallas(*leaves[:3], y0=leaves[3])
    (y * ct.to(cuda)).sum().backward()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 1, 1)
    rows = (g.reshape(8, 5000), aa, ar, y0.reshape(8))
    assert torch.equal(y.detach().cpu().reshape(8, 5000), BK.ballistics_rows_plain(*rows))
    got = [leaf.grad.reshape(-1, 5000) if i == 0 else leaf.grad.reshape(-1) for i, leaf in enumerate(leaves)]
    assert_b_bwd(b_bwd_errors(got, y.detach().reshape(8, 5000), *rows, ct.reshape(8, 5000)))


def alpha_ms(ms):
    return torch.exp(-torch.log(torch.tensor(9.0)) / (SR * torch.as_tensor(ms, dtype=torch.float32) / 1e3))


def compressor_curve(R, T, seed):
    """A compressor's gain curve (dB) on 0.25 * randn: threshold -20 dB,
    ratio 4, knee 6 dB."""
    x = torch.tensor((np.random.default_rng(seed).standard_normal((R, T)) * 0.25).astype(np.float32))
    x_db = 20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8))
    return F.static_gain_computer(x_db, -20.0, 4.0, 6.0, "compressor")


def ballistics_rows(case, R, T):
    """(g, aa, ar, y0) of (R, T) rows: a compressor curve with attack and
    release drawn from the Compressor's 5-100 ms per row ("curve", and with
    a drawn y0 "y0"), or at the 100 / 100 and 5 / 100 ms corners."""
    rng = np.random.default_rng(R * T)
    g = compressor_curve(R, T, seed=T)
    ms = {"corner_100_100": (100.0, 100.0), "corner_5_100": (5.0, 100.0)}.get(case)
    a_ms, r_ms = (torch.full((R,), v) for v in ms) if ms else (
        torch.tensor(rng.uniform(5.0, 100.0, (2, R)).astype(np.float32)))
    y0 = torch.tensor(-rng.uniform(0.0, 12.0, R).astype(np.float32)) if case == "y0" else torch.zeros(R)
    return g, alpha_ms(a_ms), alpha_ms(r_ms), y0


@pytest.mark.parametrize("R,T,case", [
    (1, 1, "curve"),
    (3, 31, "y0"),  # T < one chunk
    (24, 8191, "curve"),  # one tile short of a sample; R = 24
    (8, 8193, "corner_100_100"),  # a last tile of one sample
    (1, 50000, "corner_5_100"),  # R = 1, ragged
    (8, 20000, "y0"),
    (2, 262144, "corner_100_100"),  # the corruption's length
])
def test_ballistics_kernels_on_edge_shapes(cuda, R, T, case):
    """B-fwd bitwise equal to the plain loop and B-bwd held to float64
    (b_bwd_errors), one launch each, on edge shapes and at the corners."""
    g, aa, ar, y0 = ballistics_rows(case, R, T)
    ct = torch.tensor(np.random.default_rng(T).standard_normal((R, T)).astype(np.float32))
    gc, ac, rc, y0c, ctc = (t.to(cuda) for t in (g, aa, ar, y0, ct))
    before = counts()
    y = BK._CudaEngine.forward(gc, ac, rc, y0c)
    got = BK._CudaEngine.backward(y, gc, ac, rc, y0c, ctc)
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 1, 1)
    assert torch.equal(y.cpu(), BK.ballistics_rows_plain(g, aa, ar, y0))
    assert_b_bwd(b_bwd_errors(got, y, g, aa, ar, y0, ct))


def test_ballistics_backward_is_reproducible(cuda):
    """daa and dar are summed per tile and then over tiles in a fixed order,
    with no float atomics: bitwise equal from run to run (as dg and dy0)."""
    g, aa, ar, y0 = (t.to(cuda) for t in ballistics_rows("y0", 8, 131072))
    ct = torch.randn(8, 131072, device=cuda)
    y = BK._CudaEngine.forward(g, aa, ar, y0)
    runs = [BK._CudaEngine.backward(y, g, aa, ar, y0, ct) for _ in range(3)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)


def test_training_step_through_all_kernel_uses(cuda):
    """A smoke-width training step on the card: each kernel use launches as
    the step needs it, the loss is finite and the parameters move; the same
    step's gradients on the plain path (EQ "exact", compressor "exact")
    agree within 1e-3 (loss) and 1e-2 (gradient norm)."""
    from dasp_tpu_torch import train as TR

    torch.manual_seed(0)
    net, procs, opt = TR.make_style_training(SR, smoke=True, device=cuda)
    _, plain, _ = TR.make_style_training(SR, smoke=True, device=cuda, eq_filter_method="exact",
                                         compressor_smoother="exact")
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = 0.25 * torch.randn((2, 1, 16384), generator=gen, device=cuda)
    rand = TR.random_corruption(gen, 2, procs, device=cuda)
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    before = counts()
    loss = TR.train_step(net, procs, opt, x, rand, generator=gen)
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 2, 1)
    assert bool(torch.isfinite(loss))
    assert all(not torch.equal(start[k], p) for k, p in net.named_parameters())

    batch = TR.corrupt(procs, x, rand, generator=gen)
    state = gen.get_state()
    results = []
    for processors in (procs, plain):
        net.load_state_dict(start)
        net.zero_grad(set_to_none=True)
        gen.set_state(state)
        loss = TR.render_loss(net, processors, *batch, generator=gen)
        loss.backward()
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in net.parameters()))
        results.append((float(loss.detach()), float(norm)))
    (loss_k, norm_k), (loss_p, norm_p) = results
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    assert abs(norm_k - norm_p) <= 1e-2 * norm_p


def test_render_runs_through_both_kernels(cuda):
    """A small render on the card launches each kernel once and agrees with
    the plain path (the A bound relative to the output's peak, for each of
    kernel and plain)."""
    from dasp_tpu_torch.models import StyleTransferNet, apply_style_chain, make_style_processors

    torch.manual_seed(0)
    net = StyleTransferNet(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4)).to(cuda).eval()
    kw = dict(reverb_num_samples=2048, reverb_noise_mode="frequency")
    procs = make_style_processors(SR, eq_filter_method="pallas", compressor_smoother="exact_pallas", **kw)
    plain = make_style_processors(SR, eq_filter_method="exact", compressor_smoother="exact", **kw)
    x = torch.randn(2, 1, 8192, device=cuda) * 0.1
    with torch.inference_mode():
        params = net(x, x.flip(-1))
        a0, b0 = IK.sosfilt_pallas.launches, BK.ballistics_pallas.launches
        y_k = apply_style_chain(procs, x, params, generator=torch.Generator(device=cuda).manual_seed(1))
        assert (IK.sosfilt_pallas.launches - a0, BK.ballistics_pallas.launches - b0) == (1, 1)
        y_p = apply_style_chain(plain, x, params, generator=torch.Generator(device=cuda).manual_seed(1))
    assert y_k.shape == (2, 2, 8192) and bool(torch.isfinite(y_k).all())
    assert float((y_k - y_p).abs().max()) <= 2 * A_TOL * float(y_p.abs().max())


def frac_delay_case(nt, chs, T, B, Dm, seed=0, edge=False, drawn=False):
    """x_ext, d_stk, g_stk for the kernel: LFO or sawtooth delays in [0,
    Dm - 1), gains in (0, 1); ``edge`` puts d = 0 on the last sample of
    every tile (read position W - 1, whose second point is past the
    window); ``drawn`` draws every delay uniformly on [0, Dm - 1]."""
    rng = np.random.default_rng(seed)
    nb = -(-T // B)
    Tp = nb * B
    x = np.pad(rng.standard_normal((2, chs, T)).astype(np.float32) * 0.3, ((0, 0), (0, 0), (Dm, Tp - T)))
    n = np.arange(Tp)[None, :]
    d, g = [], []
    for i in range(nt):
        p = ((0.3 - 0.7 * i) * n / (Dm - 2) + 0.5 * i + rng.uniform(0, 1, (2, 1))) % 1.0
        d.append((Dm - 2) * p)
        g.append(np.sin(np.pi * p))
    d = np.stack(d).astype(np.float32)
    if drawn:
        d = rng.uniform(0.0, Dm - 1.0, d.shape).astype(np.float32)
    if edge:
        d[..., B - 1 :: B] = 0.0
    return [torch.tensor(a) for a in (x, d, np.stack(g).astype(np.float32))]


def c_counts():
    return FK.frac_delay_pallas.launches, FK.frac_delay_pallas.bwd_launches


@pytest.mark.parametrize("nt,chs,T,B,Dm,edge", [
    (1, 1, 4096, 512, 1986, False),
    (2, 2, 4096, 256, 2647, False),
    (2, 1, 5000, 256, 300, True),  # T is not a multiple of B; d = 0 at tile ends
    (1, 2, 131072, 512, 1986, True),
])
def test_frac_delay_kernels_match_plain_engine(cuda, nt, chs, T, B, Dm, edge):
    x_ext, d, g = (a.to(cuda) for a in frac_delay_case(nt, chs, T, B, Dm, edge=edge))
    ct = torch.randn(2, chs, d.shape[-1], device=cuda)
    before = c_counts()
    leaves = [a.clone().requires_grad_() for a in (x_ext, d, g)]
    wet = FK.frac_delay_pallas(*leaves, B, Dm)
    (wet * ct).sum().backward()
    assert tuple(a - b for a, b in zip(c_counts(), before)) == (1, 1)
    assert bool(torch.isfinite(wet).all())
    assert torch.equal(wet, FK.frac_delay_plain(x_ext, d, g, B, Dm))
    dx_p, dd_p, dg_p = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm)
    assert torch.equal(leaves[1].grad, dd_p) and torch.equal(leaves[2].grad, dg_p)
    assert float((leaves[0].grad - dx_p).abs().max()) <= 1e-6 * float(dx_p.abs().max())


@pytest.mark.parametrize("nt,chs,T,B,Dm,kind", [
    (2, 2, 4700, 250, 2647, "smooth"),  # B % 4 != 0, Tp % 4 != 0: the scalar path; groups straddle tiles
    (1, 3, 3001, 256, 301, "edge"),  # ragged T, odd Dm, three channels
    (2, 1, 4096, 256, 1999, "misaligned"),  # Tp % 4 == 0 but d, g 4 bytes off 16-byte alignment
    (1, 1, 20000, 512, 12001, "drawn"),  # delays drawn on [0, Dm - 1]: scattered dx
    (2, 3, 8192, 256, 4001, "drawn"),
])
def test_frac_delay_kernels_on_edge_shapes(cuda, nt, chs, T, B, Dm, kind):
    """C-fwd bitwise equal to the plain engine, C-bwd's dd and dg bitwise
    (with and without dx) and dx within 1e-6 of its largest value."""
    x_ext, d, g = (a.to(cuda) for a in frac_delay_case(nt, chs, T, B, Dm, edge=kind == "edge",
                                                           drawn=kind == "drawn"))
    if kind == "misaligned":
        d, g = (torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:].view(a.shape) for a in (d, g))
        assert d.data_ptr() % 16 == 4 and d.is_contiguous()
    ct = torch.randn(2, chs, d.shape[-1], device=cuda)
    wet = FK.frac_delay_pallas(x_ext, d, g, B, Dm)
    assert torch.equal(wet, FK.frac_delay_plain(x_ext, d, g, B, Dm))
    dx, dd, dg = FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm)
    dx_p, dd_p, dg_p = FK.frac_delay_bwd_plain(x_ext, d, g, ct, B, Dm)
    assert torch.equal(dd, dd_p) and torch.equal(dg, dg_p)
    assert float((dx - dx_p).abs().max()) <= 1e-6 * float(dx_p.abs().max())
    _, dd_n, dg_n = FK._CudaEngine.backward(x_ext, d, g, ct, B, Dm, need_dx=False)
    assert torch.equal(dd_n, dd_p) and torch.equal(dg_n, dg_p)


def test_frac_delay_right_edge_reads_nothing_past_the_window(cuda):
    """d = 0 on the last sample of the last tile: the second lattice point
    is one past the end of x_ext, where a NaN is planted; it must count
    zero."""
    B, Dm = 256, 300
    x_ext, d, g = frac_delay_case(1, 1, 1024, B, Dm, edge=True)
    buf = torch.cat([x_ext[:1], torch.full((1, 1, 1), float("nan"))], dim=-1).to(cuda)
    xe = buf[..., :-1]
    assert xe.is_contiguous()
    d, g = d[:, :1].to(cuda), g[:, :1].to(cuda)
    wet = FK.frac_delay_pallas(xe, d, g, B, Dm)
    assert bool(torch.isfinite(wet).all())
    ct = torch.ones_like(wet)
    dx, dd, dg = FK._CudaEngine.backward(xe, d, g, ct, B, Dm)
    assert all(bool(torch.isfinite(v).all()) for v in (dx, dd, dg))
    assert torch.equal(wet.cpu(), FK.frac_delay_plain(xe.cpu(), d.cpu(), g.cpu(), B, Dm))


def test_frac_delay_backward_dd_dg_are_reproducible(cuda):
    x_ext, d, g = (a.to(cuda) for a in frac_delay_case(2, 2, 131072, 256, 2647))
    ct = torch.randn(2, 2, d.shape[-1], device=cuda)
    runs = [FK._CudaEngine.backward(x_ext, d, g, ct, 256, 2647) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])
    scale = float(runs[0][0].abs().max())
    assert float((runs[0][0] - runs[1][0]).abs().max()) <= 1e-6 * scale
    # dx is skipped when not asked for
    assert FK._CudaEngine.backward(x_ext, d, g, ct, 256, 2647, need_dx=False)[0] is None


def test_frac_delay_wrapper_checks_inputs(cuda):
    x_ext, d, g = (a.to(cuda) for a in frac_delay_case(1, 1, 1024, 256, 300))
    with pytest.raises(TypeError):
        FK.frac_delay_pallas(x_ext.double(), d.double(), g.double(), 256, 300)
    with pytest.raises(ValueError, match="contiguous"):
        FK.frac_delay_pallas(x_ext, torch.cat([d, d], -1)[..., ::2], g, 256, 300)


@pytest.mark.parametrize("name", ["PitchShift", "Chorus"])
def test_blind_estimation_step_through_kernel_c(cuda, name):
    """A smoke-size blind-estimation step on the card: C-fwd twice and C-bwd
    once, neither A nor B; finite loss; the parameters move; the loss is
    that of the same step on the CPU within 2e-3 relative (the two devices'
    sin and pow move fp32 read positions by up to 1e-4 samples, as between
    the two packages in tests/test_torch_blind.py)."""
    from dasp_tpu_torch import modules as M
    from dasp_tpu_torch import train as TR

    proc = getattr(M, name)(SR)
    x = torch.tensor((np.random.default_rng(3).standard_normal((2, 1, 16384)) * 0.25).astype(np.float32))
    rp = torch.tensor(np.random.default_rng(4).uniform(size=(2, proc.num_params)).astype(np.float32))
    torch.manual_seed(0)
    net, opt = TR.make_blind_estimation(proc, device=cuda)
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    before, before_ab = c_counts(), counts()
    loss, _ = TR.blind_estimation_step(net, proc, opt, x.to(cuda), rp.to(cuda))
    assert tuple(a - b for a, b in zip(c_counts(), before)) == (2, 1)
    assert counts() == before_ab
    assert bool(torch.isfinite(loss))
    assert all(not torch.equal(start[k], p) for k, p in net.named_parameters())
    net_cpu, opt_cpu = TR.make_blind_estimation(proc, device="cpu")
    net_cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    loss_cpu, _ = TR.blind_estimation_step(net_cpu, proc, opt_cpu, x, rp)
    assert abs(float(loss) - float(loss_cpu)) <= 2e-3 * float(loss_cpu)
