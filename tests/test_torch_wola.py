"""The time-varying (WOLA) family of dasp_tpu_torch against dasp_tpu:
``ops.tv_filter`` (the analysis window, frame count and centres,
``tv_stft``, ``tv_istft``, ``tv_freq_filter``), the phaser, auto-wah,
spectral gate and noise profile, dynamic EQ, phase-vocoder time stretch and
pitch shift, each called directly and through its processor (Phaser,
AutoWah, SpectralGate, DynamicEQ, TimeStretch, PitchShiftPV); the full
mastering step (examples/mastering.py's chain with its dynamic EQ) and the
denoising step (examples/denoise.py); ``synthetic_batch``.

Inputs are numpy arrays from a seed, bs 2, at most 8192 samples (each
effect's default frames give at least 19 of them). Each effect's JAX
reference is one compile of its processor, which the test of the function
(called with the denormalized parameters) and the test of the processor
share. Tolerances, the rules of tests/test_torch_dynamics.py:

* fp32 (the phaser, the noise profile, the transforms): outputs within
  1e-5 of max(1, peak), gradients of mean(y ** 2) within 1e-4 of the
  largest;
* float64 on both sides, 1e-9 of the same scales, where a branch depends on
  a comparison: the ``"parallel"`` ballistics in the spectral gate, the
  dynamic EQ and the auto-wah, and the gate's quantile (an ulp's difference
  flips a branch or reorders the sort, and the results then differ by much
  more than an ulp); and the phase vocoder, whose phases are sums over
  frames of ``angle`` of bin products, each moved by its rounding over the
  bin's magnitude: two correct fp32 evaluations differ by up to 5e-4 of
  the peak where a bin is small. The mastering and denoising steps too;
* ``synthetic_batch`` bitwise, from the same ``np.random.Generator``.

The phase vocoder's reference fault (ROADMAP.md Queue 3): JAX's gradient of
``angle`` at 0 is NaN, so on digital silence (STFT bins exactly 0) its
x-gradient is NaN there; the port's is finite and equals JAX's wherever
JAX's is finite.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.functional as JF
import dasp_tpu.ops.tv_filter as JTV
import dasp_tpu_torch as P
import dasp_tpu_torch.functional as PF
import dasp_tpu_torch.ops as TO
from dasp_tpu.utils import multi_resolution_stft_loss as j_mrstft
from dasp_tpu.utils import synthetic_batch as j_synthetic_batch
from dasp_tpu_torch import train as TR
from dasp_tpu_torch.utils import synthetic_batch
from test_torch_dynamics import grad_close, grad_of, jit, peak_close, t
from test_torch_fsm import jax_dtype

SR = 44100
T = 8192
TOL = {"float32": 1e-5, "float64": 1e-9}
GRAD_TOL = {"float32": 1e-4, "float64": 1e-9}

# processor -> (function, the dtype it is held in, the function's options
# that the processor sets from its constructor)
EFFECTS = {
    "Phaser": ("phaser", "float32", {}),
    "AutoWah": ("auto_wah", "float64", {}),
    "SpectralGate": ("spectral_gate", "float64", {}),
    "DynamicEQ": ("dynamic_eq", "float64", {}),
    "TimeStretch": ("time_stretch", "float64", {"out_len": T}),
    "PitchShiftPV": ("pitch_shift_pv", "float64", {"max_semitones": 12.0}),
}


def audio(rng, chs=2, T=T):
    """Noise under a slow swell: the gate and the dynamic EQ see both
    sides of their thresholds."""
    env = 0.05 + np.sin(np.linspace(0.0, 3.0 * np.pi, T)) ** 2
    return rng.standard_normal((2, chs, T)) * 0.3 * env


def inputs(name, dtype):
    rng = np.random.default_rng(30)
    x = audio(rng)
    p = rng.uniform(0.05, 0.95, (2, getattr(D, name)(SR).num_params))
    return [np.asarray(a, dtype) for a in (x, p)]


@functools.lru_cache(maxsize=None)
def jax_processor(name, dtype):
    """JAX's processor on ``inputs``: output and the gradients of
    mean(y ** 2) with respect to x and the normalized parameters."""
    proc = getattr(D, name)(SR)

    def jloss(x, q):
        y = proc.process_normalized(x, q)
        return jnp.mean(y ** 2), y

    with jax_dtype(dtype):
        (_, y), g = jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(*map(jnp.asarray, inputs(name, dtype)))
        return np.asarray(y), [np.asarray(v) for v in g]


def check(y_t, leaves, want_y, want_g, dtype, what):
    assert y_t.dtype == leaves[0].dtype
    peak_close(y_t.detach().numpy(), want_y, TOL[dtype], f"{what}: output")
    for i, (leaf, want) in enumerate(zip(leaves, want_g)):
        grad_close(grad_of(leaf), want, GRAD_TOL[dtype], f"{what}: gradient {i}")


# ---------------------------------------------------------------------------
# ops.tv_filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T_,frame,hop", [(8192, 2048, 512), (1000, 512, 128), (3001, 96, 48), (64, 256, 64)])
def test_tv_helpers_match_jax(T_, frame, hop):
    np.testing.assert_array_equal(TO.tv_analysis_window(frame, hop), JTV.tv_analysis_window(frame, hop))
    assert TO.tv_frame_count(T_, frame, hop) == JTV.tv_frame_count(T_, frame, hop)
    np.testing.assert_array_equal(TO.tv_frame_centers(T_, frame, hop), JTV.tv_frame_centers(T_, frame, hop))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tv_transforms_match_jax(dtype):
    """tv_stft, tv_istft and tv_freq_filter (a random per-frame response,
    passed as real and imaginary parts) at a T no multiple of the hop, and
    n_fft = 4 x frame: outputs and the gradients with respect to x and the
    response; the round trip tv_istft(tv_stft(x)) == x to the window's
    roundoff."""
    frame, hop, T_ = 512, 128, 3001
    n_fft = 4 * frame
    rng = np.random.default_rng(31)
    nf = TO.tv_frame_count(T_, frame, hop)
    x = rng.standard_normal((2, 2, T_)).astype(dtype)
    hr, hi = (rng.standard_normal((2, nf, n_fft // 2 + 1)).astype(dtype) for _ in range(2))
    w = rng.standard_normal((2, 2, T_)).astype(dtype)

    def jf(x, hr, hi):
        X = JTV.tv_stft(x, frame, hop, n_fft)
        y = JTV.tv_freq_filter(x, jax.lax.complex(hr, hi), frame, hop)
        back = JTV.tv_istft(X, T_, frame, hop)
        return jnp.sum(y * w) + jnp.sum(jnp.abs(X) ** 2), (X, y, back)

    with jax_dtype(dtype):
        (_, outs_j), g_j = jit(jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (x, hr, hi)))
        outs_j = [np.asarray(v) for v in outs_j]
    leaves = [t(a, True) for a in (x, hr, hi)]
    X = TO.tv_stft(leaves[0], frame, hop, n_fft)
    y = TO.tv_freq_filter(leaves[0], torch.complex(leaves[1], leaves[2]), frame, hop)
    back = TO.tv_istft(X, T_, frame, hop)
    ((y * t(w)).sum() + (X.abs() ** 2).sum()).backward()
    assert X.shape == outs_j[0].shape and y.dtype == leaves[0].dtype
    peak_close(torch.view_as_real(X).detach().numpy(), np.stack([outs_j[0].real, outs_j[0].imag], -1),
               TOL[dtype], "tv_stft")
    peak_close(y.detach().numpy(), outs_j[1], TOL[dtype], "tv_freq_filter")
    peak_close(back.detach().numpy(), outs_j[2], TOL[dtype], "tv_istft")
    # to the window's roundoff: it is fp32 in both packages, even for float64 audio
    peak_close(back.detach().numpy(), x, 1e-6, "round trip")
    for i, (leaf, want) in enumerate(zip(leaves, g_j)):
        grad_close(leaf.grad.numpy(), want, GRAD_TOL[dtype], f"gradient {i}")


def test_tv_rules_raise():
    x = torch.zeros(1, 1, 1024)
    with pytest.raises(ValueError, match="for COLA"):
        TO.tv_stft(x, 384, 128, 1024)
    with pytest.raises(ValueError, match="n_fft"):
        TO.tv_stft(x, 512, 128, 768)
    with pytest.raises(ValueError, match="n_fft"):
        TO.tv_stft(x, 512, 128, 1088)
    with pytest.raises(ValueError, match="H has shape"):
        TO.tv_freq_filter(x, torch.zeros(1, 3, 1025, dtype=torch.complex64), 512, 128)
    # the tv hooks (ported with the parallel layer) are called: their own
    # error comes through
    def hook(*args):
        raise ValueError("the hook was called")

    for call in (lambda: PF.spectral_gate(x, SR, 6.0, 20.0, 5.0, 50.0, tv_filter_fn=hook),
                 lambda: PF.dynamic_eq(x, SR, 1000.0, 1.0, -20.0, 2.0, 5.0, 50.0, tv_power_fn=hook),
                 lambda: PF.phaser(x, SR, 1.0, 0.5, 500.0, 0.3, 0.5, tv_filter_fn=hook),
                 lambda: PF.auto_wah(x, SR, 5.0, 5.0, 50.0, 200.0, 2000.0, 2.0, 0.5, tv_filter_fn=hook),
                 lambda: P.SpectralGate(SR, tv_power_fn=hook).process(x, SR, 6.0, 20.0, 5.0, 50.0)):
        with pytest.raises(ValueError, match="the hook was called"):
            call()


# ---------------------------------------------------------------------------
# the effects and their processors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(EFFECTS))
def test_processor_matches_jax(name):
    """process_normalized: ranges, the constructor record and the side
    inputs as JAX's; output and gradients against JAX's processor."""
    jp, tp = getattr(D, name)(SR), getattr(P, name)(SR)
    assert tp.param_ranges == jp.param_ranges
    assert tp._init_spec == jp._init_spec
    assert tp.consumes_kwargs == jp.consumes_kwargs
    dtype = EFFECTS[name][1]
    leaves = [t(a, True) for a in inputs(name, dtype)]
    y = tp.process_normalized(*leaves)
    (y ** 2).mean().backward()
    check(y, leaves, *jax_processor(name, dtype), dtype, name)


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_matches_jax(name):
    """The function called with the denormalized parameters (the dynamic
    EQ's stacked per band, (bs, n_bands)) against JAX's processor on the
    same values (a parameter's gradient is the normalized one over the
    width of its range)."""
    fname, dtype, options = EFFECTS[name]
    x, p = inputs(name, dtype)
    ranges = getattr(D, name)(SR).param_ranges
    width = np.array([hi - lo for lo, hi in ranges.values()])
    values = np.array([lo for lo, _ in ranges.values()]) + p * width
    want_y, (dx, dp) = jax_processor(name, dtype)
    dp = dp / width
    if name == "DynamicEQ":
        names = P.DynamicEQ._NAMES
        params = {n: values[:, i::6] for i, n in enumerate(names)}
        wants = [dp[:, i::6] for i in range(6)]
    else:
        params, wants = dict(zip(ranges, values.T)), list(dp.T)
    leaves = [t(x, True)] + [t(v, True) for v in params.values()]
    y = getattr(PF, fname)(leaves[0], SR, **dict(zip(params, leaves[1:])), **options)
    (y ** 2).mean().backward()
    check(y, leaves, want_y, [dx, *wants], dtype, fname)


def gate_profile(rng):
    return np.asarray(jit(JF.spectral_noise_profile)(jnp.asarray(0.05 * rng.standard_normal((2, 1, T)), jnp.float32)))


# function, dtype, positional parameters (after x and the sample rate),
# options; each a case of its own JAX compile
OPTION_CASES = {
    "gate_profile_exact_causal": ("spectral_gate", "float64", [np.array([6.0, 12.0]), np.array([30.0, 12.0]),
                                                               np.array([5.0, 20.0]), np.array([80.0, 200.0])],
                                  {"smoother": "exact", "det_smooth_mode": "causal", "freq_smooth_bins": 1}),
    "gate_profile": ("spectral_gate", "float64", [np.array([6.0, 12.0]), np.array([30.0, 12.0]),
                                                  np.array([5.0, 20.0]), np.array([80.0, 200.0])],
                     {"sharpness_db": np.array([2.0, 5.0]), "noise_quantile": 0.3}),
    "dynamic_eq_exact": ("dynamic_eq", "float64", [np.array([[150.0, 3000.0], [400.0, 8000.0]]), np.array(2.0),
                                                   np.array([-40.0, -30.0]), np.array([[3.0, 6.0], [2.0, 4.0]]),
                                                   np.array([[5.0, 10.0], [2.0, 30.0]]), np.array(100.0)],
                         {"smoother": "exact", "knee_db": 3.0, "max_cut_db": 12.0}),
    "phaser_odd_stages": ("phaser", "float32", [np.array([0.5, 3.0]), np.array([0.8, 0.3]), np.array([300.0, 1500.0]),
                                                np.array([0.6, -0.5]), np.array([0.5, 0.9])],
                          {"stages": 3, "lfo_phase": 1.0, "frame_size": 256, "hop": 64}),
    "time_stretch_1.25": ("time_stretch", "float64", [], {"rate": 1.25}),
    "time_stretch_0.8": ("time_stretch", "float64", [], {"rate": 0.8, "frame_size": 1024, "hop": 256}),
    "pitch_shift_pv_3": ("pitch_shift_pv", "float64", [], {"semitones": 3.0}),
    "pitch_shift_pv_-5": ("pitch_shift_pv", "float64", [], {"semitones": -5.0}),
    "noise_profile": ("spectral_noise_profile", "float32", [], {}),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_option_cases_match_jax(case):
    """The options the processors do not set: the gate with a measured
    profile (whose gradient is held too), the "exact" frame ballistics and
    the causal detector; the dynamic EQ's per-band and broadcast
    parameters; odd phaser stages; the static phase vocoder (constant-index
    reads, the output length following the rate); the noise profile."""
    fname, dtype, params, options = OPTION_CASES[case]
    rng = np.random.default_rng(32)
    x = audio(rng)
    kw = {"noise_profile_db": gate_profile(rng)} if case.startswith("gate_profile") else {}
    kw.update({k: v for k, v in options.items() if isinstance(v, np.ndarray)})
    static = {k: v for k, v in options.items() if k not in kw}
    arrays = [np.asarray(a, dtype) for a in (x, *params, *kw.values())]
    sr = () if fname == "spectral_noise_profile" else (SR,)

    def run(fn, a):
        n = len(a) - len(kw)
        return fn(a[0], *sr, *a[1:n], **dict(zip(kw, a[n:])), **static)

    def jloss(*a):
        y = run(getattr(JF, fname), a)
        return jnp.mean(y ** 2), y

    with jax_dtype(dtype):
        (_, y_j), g_j = jit(jax.value_and_grad(jloss, argnums=tuple(range(len(arrays))), has_aux=True))(
            *map(jnp.asarray, arrays))
        y_j, g_j = np.asarray(y_j), [np.asarray(g) for g in g_j]
    leaves = [t(a, True) for a in arrays]
    y = run(getattr(PF, fname), leaves)
    (y ** 2).mean().backward()
    check(y, leaves, y_j, g_j, dtype, case)


@pytest.mark.parametrize("fname,options", [("time_stretch", {"rate": 1.25}), ("pitch_shift_pv", {"semitones": 3.0}),
                                           ("time_stretch", {"rate": 0.9, "out_len": T})])
def test_phase_vocoder_gradient_on_silence(fname, options):
    """The reference's fault (ROADMAP.md Queue 3), in float64: on digital
    silence (STFT bins exactly 0) JAX's x-gradient is NaN (``angle``'s
    gradient at 0); the port's is finite. The phase of a silent bin is 0 or
    +-pi in JAX by the signs its FFT and products leave on the zeros, 0 in
    the port, and the phase vocoder carries it into the frames after the
    silence (and, at rates below 1, into the frame before it), so the two
    outputs are compared only where it does not reach: a clip whose first
    half is silent: JAX's gradient has NaN, the port's is finite
    everywhere; a clip whose second half is silent, the loss on the first
    quarter of the output: JAX's gradient has NaN; the port's output there
    equals JAX's, and its gradient is finite and equals JAX's wherever
    JAX's is finite."""
    x = audio(np.random.default_rng(33), chs=1)
    with jax_dtype("float64"):
        for half in ("head", "tail"):
            clip = x.copy()
            clip[..., slice(0, T // 2) if half == "head" else slice(T // 2, T)] = 0.0

            def jloss(x):
                y = getattr(JF, fname)(x, SR, **options)
                y = y[..., : y.shape[-1] // 4] if half == "tail" else y
                return jnp.sum(y ** 2), y

            (_, y_j), g_j = jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(clip))
            y_j, g_j = np.asarray(y_j), np.asarray(g_j)
            xt = t(clip, True)
            y = getattr(PF, fname)(xt, SR, **options)
            y = y[..., : y.shape[-1] // 4] if half == "tail" else y
            (y ** 2).sum().backward()
            nan = np.isnan(g_j)
            assert nan.any(), f"{half}: JAX's gradient is finite: the fault this test documents is gone"
            assert np.isfinite(xt.grad.numpy()).all(), half
            if half == "tail":
                peak_close(y.detach().numpy(), y_j, TOL["float64"], f"{fname}: output")
                grad_close(np.where(nan, 0.0, xt.grad.numpy()), np.where(nan, 0.0, g_j), GRAD_TOL["float64"],
                           f"{fname}: gradient where JAX's is finite")


def test_quantile_tie_gradients_match_jax():
    """The gate's noise-floor estimate on ties (a silent bin's detector is
    floored at eps): torch.quantile's gradient splits between tied values
    as jnp.quantile's does (both sort stably)."""
    v = np.array([3.0, 1.0, 1.0, 2.0, 1.0, 5.0, 2.0, 2.0, 0.0])[None, :, None]
    v = np.concatenate([v, v[:, ::-1]], -1)
    w = np.array([[[1.0, 2.0]]])
    for q in (0.15, 0.3, 0.5):
        with jax_dtype("float64"):
            want = np.asarray(jax.grad(lambda v: jnp.sum(w * jnp.quantile(v, q, axis=1, keepdims=True)))(
                jnp.asarray(v)))
        vt = t(v, True)
        (t(w) * torch.quantile(vt, q, dim=1, keepdim=True)).sum().backward()
        np.testing.assert_allclose(vt.grad.numpy(), want, rtol=0, atol=1e-15)


def test_dynamic_eq_positional_passthrough_and_chain_forwards_the_profile():
    """DynamicEQ.process(x, sr, frequency_hz, ...) passes (bs, n_bands)
    tensors straight through; Chain forwards ``noise_profile_db=`` to the
    SpectralGate only."""
    rng = np.random.default_rng(34)
    x = torch.tensor(audio(rng).astype(np.float32))
    args = [torch.tensor(a, dtype=torch.float32) for a in ([[200.0, 2000.0], [500.0, 5000.0]], [[1.0, 2.0], [3.0, 0.7]],
                                                           [[-30.0, -20.0], [-25.0, -35.0]], 3.0, 10.0, 100.0)]
    assert torch.equal(P.DynamicEQ(SR, num_bands=2).process(x, SR, *args), PF.dynamic_eq(x, SR, *args))
    prof = torch.tensor(gate_profile(rng))
    chain = P.Chain([P.Tremolo(SR), P.SpectralGate(SR), P.Phaser(SR)])
    p = torch.rand((2, chain.num_params), generator=torch.Generator().manual_seed(0))
    y = chain.process_normalized(x, p, noise_profile_db=prof)
    y1 = P.Tremolo(SR).process_normalized(x, p[:, :2])
    y2 = P.SpectralGate(SR).process_normalized(y1, p[:, 2:6], noise_profile_db=prof)
    assert torch.equal(y, P.Phaser(SR).process_normalized(y2, p[:, 6:]))


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.DynamicEQ(SR, num_bands=5, max_q=4.0, frame_size=512, hop=128),
    lambda pkg: pkg.SpectralGate(SR, sharpness_db=6.0, smoother="exact"),
    lambda pkg: pkg.Phaser(SR, stages=4, hop=64),
    lambda pkg: pkg.AutoWah(SR, max_q_factor=5.0),
    lambda pkg: pkg.TimeStretch(SR, 0.8, 1.25, frame_size=1024, hop=256),
    lambda pkg: pkg.PitchShiftPV(SR, max_semitones=7.0),
])
def test_init_spec_and_ranges_match_jax(make):
    p_t, p_j = make(P), make(D)
    assert p_t._init_spec == p_j._init_spec
    assert p_t.param_ranges == p_j.param_ranges


# ---------------------------------------------------------------------------
# the steps and synthetic_batch
# ---------------------------------------------------------------------------


def test_synthetic_batch_is_jax_packages_bitwise():
    for kind in ("mixed", "pluck", "chirp"):
        a = synthetic_batch(np.random.default_rng(35), 3, 4096, SR, kind)
        b = j_synthetic_batch(np.random.default_rng(35), 3, 4096, SR, kind)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_mastering_step_matches_jax():
    """examples/mastering.py's whole chain (TransientShaper, DynamicEQ(3),
    MultibandCompressor, Exciter, Limiter) at smoke size (bs 2 stereo clips
    of 4096 samples) in float64 on both sides, the limiter "exact" (JAX's
    kernel runs fp32 only): mastering_step's loss, the gradient of z it
    leaves and z after Adam (optax.adam at 2e-2); the render. JAX takes
    the port's target."""
    rng = np.random.default_rng(36)
    mix = np.repeat(synthetic_batch(rng, 2, 4096, SR), 2, axis=1).astype(np.float64)
    chain, z, opt = TR.make_mastering(SR, bs=2, device="cpu")
    assert chain.num_params == 47 and z.shape == (2, 47) and not z.detach().abs().max() > 0
    assert [type(p).__name__ for p in chain.processors] == [
        "TransientShaper", "DynamicEQ", "MultibandCompressor", "Exciter", "Limiter"]
    chain = P.Chain([P.TransientShaper(SR), P.DynamicEQ(SR, num_bands=3), P.MultibandCompressor(SR), P.Exciter(SR),
                     P.Limiter(SR, smoother="exact")])
    p_true = np.clip(0.5 + 0.25 * rng.standard_normal((2, 47)), 0.05, 0.95)
    z0 = 0.3 * rng.standard_normal((2, 47))
    with torch.no_grad():
        target = chain.process_normalized(t(mix), t(p_true), clip_params=True).numpy()
    jchain = D.Chain([D.TransientShaper(SR), D.DynamicEQ(SR, num_bands=3), D.MultibandCompressor(SR), D.Exciter(SR),
                      D.Limiter(SR, smoother="exact")])

    def jloss(z, mix, target):
        y = jchain.process_normalized(mix, jax.nn.sigmoid(z), clip_params=True)
        return j_mrstft(y, target) + 10.0 * jnp.mean((y - target) ** 2), y

    with jax_dtype("float64"):
        (l_j, y_j), g_j = jit(jax.value_and_grad(jloss, has_aux=True))(*map(jnp.asarray, (z0, mix, target)))
        l_j, y_j, g_j = float(l_j), np.asarray(y_j), np.asarray(g_j)
    with torch.no_grad():
        _, y = TR.mastering_loss(chain, t(z0), t(mix), t(target))
    peak_close(y.numpy(), y_j, TOL["float64"], "render")
    z = t(z0, True)
    opt = torch.optim.Adam([z], lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
    loss = TR.mastering_step(chain, z, opt, t(mix), t(p_true))
    assert abs(float(loss) - l_j) <= TOL["float64"] * abs(l_j), f"loss {float(loss)} vs {l_j}"
    grad_close(z.grad.numpy(), g_j, GRAD_TOL["float64"], "dz")
    # optax.adam's first step: m and v bias-corrected to g and g^2
    np.testing.assert_allclose(z.detach().numpy() - z0, -2e-2 * g_j / (np.abs(g_j) + 1e-8), rtol=0, atol=1e-9)


def test_denoise_step_matches_jax():
    """examples/denoise.py's step at smoke size (bs 2 mono clips of 8192
    samples, noise at -30 dB) in float64 on both sides: make_denoise's
    logits (logit of the example's starting point), the noise profile,
    denoise_step's loss, the gradient of z it leaves and z after Adam
    (optax.adam at 3e-2)."""
    rng = np.random.default_rng(37)
    clean = synthetic_batch(rng, 2, T, SR).astype(np.float64)
    amp = 10.0 ** (-30.0 / 20.0)
    noisy = clean + amp * rng.standard_normal(clean.shape)
    noise_only = amp * rng.standard_normal(clean.shape)
    gate, z, opt = TR.make_denoise(SR, bs=2, device="cpu")
    p0 = jnp.asarray([TR.DENOISE_P0] * 2, jnp.float32)
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(jnp.log(p0 / (1.0 - p0))))
    assert gate._init_spec == D.SpectralGate(SR)._init_spec
    z0 = z.detach().numpy().astype(np.float64)
    jgate = D.SpectralGate(SR)

    def jloss(z, noisy, clean, noise_only):
        prof = jax.lax.stop_gradient(D.spectral_noise_profile(noise_only))
        y = jgate.process_normalized(noisy, jax.nn.sigmoid(z), clip_params=True, noise_profile_db=prof)
        return jnp.mean((y - clean) ** 2), prof

    with jax_dtype("float64"):
        (l_j, prof_j), g_j = jit(jax.value_and_grad(jloss, has_aux=True))(*map(jnp.asarray, (z0, noisy, clean, noise_only)))
        l_j, prof_j, g_j = float(l_j), np.asarray(prof_j), np.asarray(g_j)
    peak_close(PF.spectral_noise_profile(t(noise_only)).numpy(), prof_j, TOL["float64"], "profile")
    z = t(z0, True)
    opt = torch.optim.Adam([z], lr=3e-2, betas=(0.9, 0.999), eps=1e-8)
    loss = TR.denoise_step(gate, z, opt, t(noisy), t(clean), t(noise_only))
    assert abs(float(loss) - l_j) <= TOL["float64"] * abs(l_j), f"loss {float(loss)} vs {l_j}"
    grad_close(z.grad.numpy(), g_j, GRAD_TOL["float64"], "dz")
    np.testing.assert_allclose(z.detach().numpy() - z0, -3e-2 * g_j / (np.abs(g_j) + 1e-8), rtol=0, atol=1e-9)


@pytest.mark.parametrize("make", [TR.make_mastering, TR.make_denoise])
def test_entry_points_build_on_the_card_by_default(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(SR)
