"""The coupled cascade's stream step (``ops/iir_stream_kernel.py``) on the
CPU: the plain version of kernel D, and the engine each call takes.

The plain version (a per-sample float64 loop of the realization's
recursion, in the kernel's wavefront order) is held against the
block-state loop (``ops.iir._sosfilt_coupled_rows``) to 1e-12 of the peak
in float64, output and carried state, chunk after chunk: resonant,
real-pole and first-order sections drawn at random, the EQ's 20 Hz / Q 6
shelf and the 10-section graphic EQ. A call on a CPU tensor, a stream
step, an offline call or one that requires grad, stays on the block-state
path bit for bit and launches nothing. The kernel itself runs only on the
card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from dasp_tpu_torch import functional as F
from dasp_tpu_torch import trace
from dasp_tpu_torch.ops import iir as I
from dasp_tpu_torch.ops import iir_stream_kernel as K
from dasp_tpu_torch.ops.biquad import biquad

SR = 44100
CHUNK = 256
F64 = torch.float64


def resonant(bs, rng):
    """Six peaking sections of +-12 dB, 30 Hz-16 kHz, Q 0.5-8."""
    g, fc, q = (torch.tensor(v) for v in (rng.uniform(-12, 12, (6, bs)),
                                           np.exp(rng.uniform(np.log(30), np.log(16000), (6, bs))),
                                           rng.uniform(0.5, 8.0, (6, bs))))
    return torch.stack([torch.cat(biquad(g[i], fc[i], q[i], SR, "peaking"), dim=-1) for i in range(6)], dim=1)


def real_poles(bs, rng):
    """Four sections with two real poles each in (-0.99, 0.99) and random zeros."""
    p = rng.uniform(-0.99, 0.99, (bs, 4, 2))
    a = np.stack([np.ones((bs, 4)), -(p[..., 0] + p[..., 1]), p[..., 0] * p[..., 1]], axis=-1)
    b = rng.uniform(-1, 1, (bs, 4, 3))
    return torch.tensor(np.concatenate([b, a], axis=-1))


def first_order(bs, rng):
    """Three one-poles embedded as biquads (b2 = a2 = 0), poles up to 0.999."""
    secs = []
    for _ in range(3):
        b = torch.tensor(rng.uniform(-1, 1, (bs, 2)))
        a = torch.cat([torch.ones(bs, 1, dtype=F64), torch.tensor(rng.uniform(-0.999, 0.5, (bs, 1)))], dim=-1)
        secs.append(I.embed_first_order_sos(b, a))
    return torch.stack(secs, dim=1)


def shelf(bs, rng):
    """The EQ's hardest corner: the low shelf at 20 Hz, Q 6, +12 dB."""
    b, a = biquad(*(torch.full((bs,), v, dtype=F64) for v in (12.0, 20.0, 6.0)), SR, "low_shelf")
    return torch.cat([b, a], dim=-1)[:, None, :]


def graphic(bs, rng):
    return F.graphic_eq_sos(bs, F64, SR, torch.tensor(rng.uniform(-12, 12, (bs, 10))))


CASES = {"resonant": resonant, "real_poles": real_poles, "first_order": first_order, "shelf_20hz_q6": shelf,
         "graphic_eq": graphic}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_step_matches_the_block_state_cascade_over_four_chunks(case):
    rng = np.random.default_rng(len(case))
    bs, chs = 1, 2
    sos = CASES[case](bs, rng)
    x = torch.tensor(0.25 * rng.standard_normal((bs, chs, 4 * CHUNK)))
    ops = I.coupled_operators(sos, x.shape)
    real, blocks = ops.get("realization"), ops.get("blocks")
    R, S = bs * chs, sos.shape[1]
    assert real.shape == (R, S, 9) and real.dtype == F64
    rows = x.reshape(R, -1)
    zi = 0.1 * torch.tensor(rng.standard_normal((R, S, 2)))  # a stream already under way
    z_p = z_b = zi
    ys_p, ys_b = [], []
    for c in rows.split(CHUNK, dim=-1):
        y_p, z_p = K.coupled_step_plain(real, c, z_p)
        y_b, z_b = I._sosfilt_coupled_rows(blocks, c, z_b)
        ys_p.append(y_p)
        ys_b.append(y_b)
        peak = max(1e-300, float(y_b.abs().max()))
        assert float((y_p - y_b).abs().max()) <= 1e-12 * peak, case
        assert float((z_p - z_b).abs().max()) <= 1e-12 * max(1e-300, float(z_b.abs().max())), case
    y_one, _ = I._sosfilt_coupled_rows(blocks, rows, zi)  # the four chunks in one pass
    assert float((torch.cat(ys_p, dim=-1) - y_one).abs().max()) <= 1e-12 * float(y_one.abs().max())


def test_plain_step_from_rest_and_on_float32_rows():
    rng = np.random.default_rng(3)
    sos = resonant(2, rng)
    x = torch.tensor(0.25 * rng.standard_normal((2, 1, CHUNK)), dtype=torch.float32)
    ops = I.coupled_operators(sos, x.shape)
    y_p, z_p = K.coupled_step_plain(ops.get("realization"), x.reshape(2, -1))
    y_b, z_b = I._sosfilt_coupled_rows(ops.get("blocks"), x.reshape(2, -1).to(F64), x.new_zeros((2, 6, 2), dtype=F64))
    assert y_p.dtype == F64
    assert float((y_p - y_b).abs().max()) <= 1e-12 * float(y_b.abs().max())
    assert float((z_p - z_b).abs().max()) <= 1e-12 * float(z_b.abs().max())


def block_state(sos, x, zi=None, return_zf=False):
    """The block-state path written out: the cascade's body before kernel D."""
    ops = I.coupled_operators(sos, x.shape)
    R, T, S = ops.sos_rows.shape[0], x.shape[-1], sos.shape[1]
    zi_rows = torch.zeros((R, S, 2), dtype=F64) if zi is None else zi.to(F64).reshape(R, S, 2)
    y, zf = I._sosfilt_coupled_rows(I._coupled_operators(ops.sos_rows, 128), x.to(F64).reshape(R, T), zi_rows)
    y = y.reshape(x.shape).to(x.dtype)
    return (y, zf.reshape(*x.shape[:-1], S, 2).to(x.dtype)) if return_zf else y


@pytest.mark.parametrize("kind", ["stream", "offline", "stream_with_grad"])
def test_cpu_calls_stay_on_the_block_state_path_bitwise(kind):
    rng = np.random.default_rng(7)
    sos = resonant(2, rng).float()
    x = torch.tensor(0.25 * rng.standard_normal((2, 2, 2 * CHUNK)), dtype=torch.float32)
    zi = torch.tensor(0.1 * rng.standard_normal((2, 2, 6, 2)), dtype=torch.float32)
    kw = {} if kind == "offline" else dict(zi=zi, return_zf=True)
    if kind == "stream_with_grad":
        sos.requires_grad_(True)
    trace.reset()
    got = I.sosfilt_coupled(sos, x, **kw)
    want = block_state(sos.detach(), x, **kw)
    for a, b in zip(got if kw else [got], want if kw else [want]):
        assert torch.equal(a, b)
    assert trace.snapshot()["counts"].get("kernel_d.forward", 0) == 0
    if kind == "stream_with_grad":
        assert got[0].requires_grad
        got[0].square().sum().backward()
        assert torch.isfinite(sos.grad).all()


def test_operators_make_each_form_once():
    sos = resonant(1, np.random.default_rng(0))
    ops = I.coupled_operators(sos, (1, 2, CHUNK))
    assert ops.get("blocks") is ops.get("blocks")
    assert ops.get("realization") is ops.get("realization")
    A, bvec, cvec, d = I._coupled_state_space(ops.sos_rows)
    assert torch.equal(ops.get("realization"), torch.cat([A.flatten(-2), bvec, cvec, d[..., None]], dim=-1))


def test_cpu_tensors_never_take_the_kernel():
    sos_rows = torch.zeros((2, 6, 6), dtype=F64)
    x = torch.zeros((1, 2, CHUNK))
    assert I._coupled_form(x, None, True, None, sos_rows) == "blocks"


@pytest.mark.parametrize("what", ["dtype", "sections", "zi", "realization"])
def test_kernel_wrapper_checks_inputs(what):
    R, S, T = 2, 6, CHUNK
    real, rows, zi = torch.zeros((R, S, 9), dtype=F64), torch.zeros((R, T)), None
    if what == "dtype":
        rows, err = rows.half(), TypeError
    elif what == "sections":
        real, err = torch.zeros((R, K.MAX_SECTIONS + 1, 9), dtype=F64), ValueError
    elif what == "zi":
        zi, err = torch.zeros((R, S + 1, 2)), ValueError
    else:
        real, err = real.float(), ValueError
    with pytest.raises(err):
        K.coupled_step(real, rows, zi)
