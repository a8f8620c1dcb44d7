"""The MR-STFT loss of dasp_tpu_torch against dasp_tpu and the golden
fixtures.

Same numpy inputs into ``dasp_tpu.utils.loss`` (its rfft path, as on the
CPU) and ``dasp_tpu_torch.utils.loss``. Tolerances:

* magnitudes and losses: 1e-5 relative (fp32 FFTs of two libraries);
* loss gradients against JAX: 5e-4 of max(1, largest gradient), the bound
  tests/test_utils.py holds JAX's fp32 auto-EQ gradient to against the
  torch golden: the log-magnitude term's 1/mag amplifies FFT roundoff in
  quiet bins (measured here: about 5e-5, and 1.5e-4 with auraloss's hard
  magnitude clamp);
* the ``mrstft_auraloss_*`` fixtures: the bounds tests/test_utils.py holds
  the JAX package to (1e-4 for the loss and the default-config gradient,
  5e-4 for the fp32 auto-EQ gradient, 1e-6 in float64).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasp_tpu.utils import loss as JL
from dasp_tpu_torch.utils import loss as TL

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
GRAD_TOL = 5e-4
AUTOEQ = dict(
    fft_sizes=(128, 256, 512, 1024, 2048, 4096, 8192),
    hop_sizes=(64, 128, 256, 512, 1024, 2048, 4096),
    win_lengths=(128, 256, 512, 1024, 2048, 4096, 8192),
    w_sc=0.0, w_log_mag=1.0, w_lin_mag=1.0, perceptual_weighting=True, sample_rate=44100,
)


def pair(seed=0, shape=(2, 2, 8192)):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fft,hop,win", [(1024, 256, 600), (512, 128, 512), (2048, 512, 1200)])
@pytest.mark.parametrize("smooth", [False, True])
def test_stft_magnitude_matches_jax(fft, hop, win, smooth):
    a, _ = pair()
    m_t = TL.stft_magnitude(torch.tensor(a), fft, hop, win, smooth_floor=smooth).numpy()
    m_j = np.asarray(JL.stft_magnitude(jnp.asarray(a), fft, hop, win, smooth_floor=smooth, use_dft=False))
    assert m_t.shape == m_j.shape
    np.testing.assert_allclose(m_t, m_j, rtol=1e-5, atol=1e-5 * np.abs(m_j).max())


LOSS_CASES = {
    "default": dict(),
    "auraloss_compat": dict(auraloss_compat=True),
    "perceptual": dict(perceptual_weighting=True, sample_rate=44100),
    "perceptual_compat": dict(perceptual_weighting=True, sample_rate=44100, auraloss_compat=True),
    "lin_mag": dict(w_lin_mag=1.0, w_sc=0.5),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_mrstft_loss_and_gradient_match_jax(case):
    kw = LOSS_CASES[case]
    a, b = pair(seed=1)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x, y: JL.multi_resolution_stft_loss(x, y, **kw)))(jnp.asarray(a), jnp.asarray(b))
    at = torch.tensor(a, requires_grad=True)
    loss_t = TL.multi_resolution_stft_loss(at, torch.tensor(b), **kw)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    grad_j = np.asarray(grad_j)
    scale = max(1.0, float(np.abs(grad_j).max()))
    err = float(np.abs(at.grad.numpy() - grad_j).max())
    assert err <= GRAD_TOL * scale


def test_auto_eq_mrstft_matches_jax():
    a, b = pair(seed=2, shape=(2, 1, 16384))
    loss_t = TL.auto_eq_mrstft(torch.tensor(a), torch.tensor(b))
    loss_j = JL.auto_eq_mrstft(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_a_weighting_and_prefilter_match_jax():
    np.testing.assert_array_equal(TL.a_weighting_fir_taps(44100), JL.a_weighting_fir_taps(44100))
    freqs = np.fft.rfftfreq(1024, 1 / 44100)
    np.testing.assert_array_equal(TL.a_weighting(freqs), JL.a_weighting(freqs))
    a, _ = pair(seed=3, shape=(2, 2, 4096))
    taps = TL.a_weighting_fir_taps(44100)
    y_t = TL.fir_prefilter(torch.tensor(a), taps).numpy()
    y_j = np.asarray(JL.fir_prefilter(jnp.asarray(a), taps))
    np.testing.assert_allclose(y_t, y_j, atol=1e-5 * np.abs(y_j).max())


def load(name, dtype=torch.float32):
    fx = dict(np.load(os.path.join(FIXTURES, f"{name}.npz")))
    return torch.tensor(fx["y_hat"], dtype=dtype, requires_grad=True), torch.tensor(fx["y"], dtype=dtype), fx


@pytest.mark.parametrize("name,kw,loss_tol,grad_tol,dtype", [
    ("mrstft_auraloss_default", dict(auraloss_compat=True), 1e-4, 1e-4, torch.float32),
    ("mrstft_auraloss_autoeq", dict(AUTOEQ, hop_sizes=tuple(n // 2 for n in AUTOEQ["fft_sizes"]),
                                    auraloss_compat=True), 1e-4, 5e-4, torch.float32),
    ("mrstft_auraloss_autoeq_f64", dict(AUTOEQ, hop_sizes=tuple(n // 2 for n in AUTOEQ["fft_sizes"]),
                                        auraloss_compat=True), 1e-9, 1e-6, torch.float64),
])
def test_auraloss_golden_fixtures(name, kw, loss_tol, grad_tol, dtype):
    y_hat, y, fx = load(name, dtype)
    loss = TL.multi_resolution_stft_loss(y_hat, y, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(fx["loss"]), rtol=loss_tol, atol=loss_tol)
    scale = max(1.0, float(np.abs(fx["grad_y_hat"]).max()))
    assert float(np.abs(y_hat.grad.numpy() - fx["grad_y_hat"]).max()) <= grad_tol * scale


def test_loss_runs_in_the_input_dtype():
    a, b = pair(seed=4, shape=(1, 2, 4096))
    for dtype in (torch.float32, torch.float64):
        loss = TL.multi_resolution_stft_loss(torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype))
        assert loss.dtype == dtype and loss.ndim == 0 and bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="sample_rate"):
        TL.stft_loss(torch.tensor(a), torch.tensor(b), perceptual_weighting=True)
