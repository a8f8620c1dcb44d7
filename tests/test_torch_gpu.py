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
1.2e-4, plain 1.7e-2); the ballistics kernels bitwise equal to their
plain loops; a smoke-width training step through all kernel uses within
1e-3 (loss) and 1e-2 (gradient norm) of the plain path.
"""

import numpy as np
import pytest
import scipy.signal
import torch

from dasp_tpu_torch import functional as F
from dasp_tpu_torch.modules import ParametricEQ
from dasp_tpu_torch.ops import ballistics_kernel as BK
from dasp_tpu_torch.ops import iir_kernel as IK

SR = 44100
A_TOL = 2e-3

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu tests/test_torch_gpu.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
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


@pytest.mark.parametrize("case", ["eq", "one_pole", "eq_shared_by_2_channels"])
def test_sosfilt_gradient_matches_float64_and_plain_adjoint(cuda, case):
    bs, ch, T = 8, 2 if case == "eq_shared_by_2_channels" else 1, 32768
    sos = one_pole_sos(bs) if case == "one_pole" else eq_sos(bs, seed=4)
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


@pytest.mark.parametrize("with_y0", [False, True])
def test_ballistics_backward_bitwise_plain(cuda, with_y0):
    g = make_g(8, 5000)
    aa, ar = torch.linspace(0.5, 0.95, 8), torch.linspace(0.9, 0.999, 8)
    y0 = -torch.rand(8, 1) if with_y0 else torch.zeros(8, 1)
    ct = torch.randn(8, 1, 5000)
    leaves = [t.detach().to(cuda).requires_grad_() for t in (g, aa, ar, y0)]
    before = counts()
    (BK.ballistics_pallas(*leaves[:3], y0=leaves[3]) * ct.to(cuda)).sum().backward()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 1, 1)
    y = BK.ballistics_rows_plain(g.reshape(8, 5000), aa, ar, y0.reshape(8))
    ref = BK.ballistics_bwd_rows_plain(y, g.reshape(8, 5000), aa, ar, y0.reshape(8), ct.reshape(8, 5000))
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad.cpu(), r.reshape(leaf.shape))


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
