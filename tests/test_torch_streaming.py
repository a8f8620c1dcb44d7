"""The serving layer of dasp_tpu_torch (``streaming``) against dasp_tpu's.

Every stream of ``dasp_tpu.streaming.__all__`` and ``StreamChain``: the same
numpy inputs (bs 2, 3 or 4 chunks of 128-2560 samples) go through JAX's stream
and the port's, chunk by chunk with the state carried. Each case's JAX
reference is one compile of all its chunks (``jit`` of a function that
loops over them). Tolerances:

* float64 on both sides, 1e-9 of max(1, peak), wherever both compute the
  same formula: every case but the fp32 ones below. A branch that depends
  on a comparison (the ballistics, the gate's hold, the bitcrusher's
  ticks, the delays' floors) would flip on an ulp in fp32 and then differ by
  much more than an ulp;
* fp32 where the formula is the same up to rounding and has no such
  branch: the EQs, the attack-only compressor and expander, the reverbs,
  at tests/test_streaming.py's atol for the effect. There the port's
  block-state filters compute in float64 and round once where JAX's
  compute in fp32, so JAX's fp32 rounding sets the bound.

Besides: each stream chunked against the port's own offline effect at
tests/test_streaming.py's atol (the same bound as JAX's chunked against its
offline, since the port's offline effects agree with JAX's at or below
it); the streams' ``"exact"`` ballistics through the kernel's wrapper
(``ballistics_pallas``), once a chunk, bitwise equal to
``ops.ballistics_smooth(mode="exact")``; ``state=None`` equal to an
explicit state at rest; the reverb with JAX's IR carried into the port's
state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dasp_tpu.streaming as JS
import dasp_tpu_torch.functional as PF
import dasp_tpu_torch.streaming as PS
from dasp_tpu_torch.ops import ballistics_smooth, sosfilt_blockmat, sosfilt_coupled
from dasp_tpu_torch.ops import biquad as p_biquad
from test_torch_dynamics import jit, peak_close
from test_torch_fsm import jax_dtype

SR = 44100
BS = 2
TOL64 = 1e-9


def full(v, dtype, n=BS):
    return np.full((n,), v, dtype)


def signal(kind, chs, T, dtype, seed=0):
    """Test audio from a seed: noise, a burst between quiet noise, a gated
    swell, or sibilance (a 300 Hz tone with an 8 kHz burst)."""
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    if kind == "noise":
        x = 0.3 * rng.standard_normal((BS, chs, T))
    elif kind == "burst":
        x = 0.05 * rng.standard_normal((BS, chs, T))
        x[..., T // 4 : T // 2] *= 20.0
    elif kind == "gate":
        x = rng.standard_normal((BS, chs, T)) * np.where((n // (T // 6)) % 2 == 0, 0.4, 0.002)
    elif kind == "sib":
        s = 0.3 * np.sin(2 * np.pi * 300 * n / SR) + 0.4 * np.sin(2 * np.pi * 8000 * n / SR) * (n > T // 2)
        x = np.broadcast_to(s, (BS, chs, T)) + 0.01 * rng.standard_normal((BS, chs, T))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x, dtype)


def eq_params(dtype):
    return [full(v, dtype) for v in (2.0, 200.0, 0.7, 3.0, 400.0, 1.0, -2.0, 3000.0, 2.0,
                                      1.0, 9000.0, 1.0, 2.0, 13000.0, 1.0, -3.0, 8000.0, 0.7)]


def cascade(dtype):
    """A cascade with a near-unit-circle resonant band (40 Hz, Q 2)."""
    secs = []
    for g, fc, q, ft in ((4.0, 200.0, 0.7, "low_shelf"), (6.0, 40.0, 2.0, "peaking"),
                         (-6.0, 1000.0, 2.0, "peaking"), (3.0, 8000.0, 0.7, "high_shelf")):
        b, a = p_biquad(*(torch.full((BS,), v, dtype=torch.float64) for v in (g, fc, q)), SR, ft)
        secs.append(torch.cat([b, a], -1))
    return torch.stack(secs, 1).numpy().astype(dtype)


def dyn(dtype, *vals):
    return [full(v, dtype) for v in vals]


COMP = (-24.0, 4.0, 10.0, 60.0, 6.0, 1.0)
LIM = (-12.0, 2.0, 80.0, 3.0, 1.5)
GATE = dict(threshold_db=-30.0, ratio=10.0, range_db=50.0, attack_ms=0.5, release_ms=20.0, knee_db=1.0)
DEESS = dict(frequency_hz=5000.0, threshold_db=-40.0, ratio=8.0, attack_ms=1.0, release_ms=50.0, knee_db=3.0)
MULTIBAND = dict(
    crossover_low_hz=250.0, crossover_high_hz=2500.0,
    low_threshold_db=-25.0, low_ratio=4.0, low_attack_ms=5.0, low_release_ms=60.0, low_makeup_gain_db=1.0,
    mid_threshold_db=-20.0, mid_ratio=3.0, mid_attack_ms=5.0, mid_release_ms=60.0, mid_makeup_gain_db=0.5,
    high_threshold_db=-15.0, high_ratio=2.0, high_attack_ms=5.0, high_release_ms=60.0, high_makeup_gain_db=0.0,
    knee_db=4.0,
)
WAH = dict(sensitivity=5.0, attack_ms=5.0, release_ms=50.0, min_frequency_hz=200.0, max_frequency_hz=2000.0,
           q_factor=4.0, mix=1.0)
PHASER = dict(rate_hz=1.3, depth=0.8, centre_frequency_hz=700.0, feedback=0.4, mix=0.5)
DEQ = dict(frequency_hz=[[200.0, 1500.0, 6000.0]] * BS, q_factor=2.0, threshold_db=-30.0, ratio=4.0,
           attack_ms=5.0, release_ms=80.0)
SGATE = dict(threshold_db=6.0, range_db=40.0, attack_ms=5.0, release_ms=80.0)


def kw(A, dtype, d):
    return {k: A(np.asarray(v, dtype) if isinstance(v, list) else full(v, dtype)) for k, v in d.items()}


def noise_profile(dtype):
    """A measured floor (the port's spectral_noise_profile: the JAX
    references call this while they trace)."""
    noise = 0.01 * np.random.default_rng(7).standard_normal((BS, 1, 8192))
    return PF.spectral_noise_profile(torch.from_numpy(noise.astype(np.float32))).numpy().astype(dtype)


# name -> (input kind, channels, T, chunk, dtypes, step maker). A maker takes
# the streaming module, the array converter (jnp.asarray or
# torch.from_numpy) and the dtype and returns step(chunk, state).
CASES = {
    "sosfilt_coupled": ("noise", 2, 1536, 512, ("float64",),
                        lambda S, A, dt: lambda c, s: S.sosfilt_stream(A(cascade(dt)), c, zi=s)),
    "sosfilt_block": ("noise", 2, 1536, 512, ("float64",),
                      lambda S, A, dt: lambda c, s: S.sosfilt_stream(A(cascade(dt)), c, zi=s, filter_method="block")),
    "parametric_eq": ("noise", 2, 768, 256, ("float32", "float64"),
                      lambda S, A, dt: lambda c, s: S.parametric_eq_stream(c, SR, *map(A, eq_params(dt)), zi=s)),
    "graphic_eq": ("noise", 2, 768, 256, ("float64",),
                   lambda S, A, dt: lambda c, s: S.graphic_eq_stream(
                       c, SR, A(np.linspace(-6, 6, 2 * 10).reshape(2, 10).astype(dt)), zi=s)),
    "compressor_block": ("burst", 2, 1536, 512, ("float32", "float64"),
                         lambda S, A, dt: lambda c, s: S.compressor_stream(c, SR, *map(A, dyn(dt, *COMP)), zi=s)),
    "compressor_parallel": ("burst", 2, 1536, 512, ("float64",),
                            lambda S, A, dt: lambda c, s: S.compressor_stream(
                                c, SR, *map(A, dyn(dt, *COMP)), zi=s, smoother="parallel")),
    "compressor_exact": ("burst", 2, 1536, 512, ("float64",),
                         lambda S, A, dt: lambda c, s: S.compressor_stream(
                             c, SR, *map(A, dyn(dt, *COMP)), zi=s, smoother="exact")),
    "expander_block": ("gate", 2, 1536, 512, ("float32",),
                       lambda S, A, dt: lambda c, s: S.expander_stream(c, SR, *map(A, dyn(dt, *COMP)), zi=s)),
    "sidechain_compressor": ("burst", 3, 1536, 512, ("float64",),
                             lambda S, A, dt: lambda c, s: S.sidechain_compressor_stream(
                                 c[:, :2], SR, *map(A, dyn(dt, -30.0, 8.0, 5.0, 60.0, 3.0, 0.0)), zi=s,
                                 sidechain=c[:, 2:])),
    "limiter_parallel": ("burst", 2, 1536, 512, ("float64",),
                         lambda S, A, dt: lambda c, s: S.limiter_stream(c, SR, *map(A, dyn(dt, *LIM)), zi=s)),
    "limiter_exact": ("burst", 2, 1536, 512, ("float64",),
                      lambda S, A, dt: lambda c, s: S.limiter_stream(
                          c, SR, *map(A, dyn(dt, *LIM)), zi=s, smoother="exact")),
    "limiter_block": ("burst", 2, 1536, 512, ("float64",),
                      lambda S, A, dt: lambda c, s: S.limiter_stream(
                          c, SR, *map(A, dyn(dt, *LIM)), zi=s, smoother="block")),
    "noise_gate": ("gate", 1, 3072, 1024, ("float64",),
                   lambda S, A, dt: lambda c, s: S.noise_gate_stream(c, SR, **kw(A, dt, GATE), state=s)),
    "noise_gate_hold_exact": ("gate", 1, 3072, 1024, ("float64",),
                              lambda S, A, dt: lambda c, s: S.noise_gate_stream(
                                  c, SR, **kw(A, dt, GATE), hold_ms=12.0, state=s, smoother="exact")),
    "de_esser": ("sib", 1, 3072, 1024, ("float64",),
                 lambda S, A, dt: lambda c, s: S.de_esser_stream(c, SR, **kw(A, dt, DEESS), state=s)),
    "de_esser_wideband_exact": ("sib", 1, 3072, 1024, ("float64",),
                                lambda S, A, dt: lambda c, s: S.de_esser_stream(
                                    c, SR, **kw(A, dt, DEESS), mode="wideband", state=s, smoother="exact")),
    "bitcrusher": ("noise", 2, 1536, 512, ("float32", "float64"),
                   lambda S, A, dt: lambda c, s: S.bitcrusher_stream(
                       c, SR, *map(A, dyn(dt, 5.0, 3000.0, 0.9)), state=s)),
    "exciter": ("noise", 2, 1536, 512, ("float64",),
                lambda S, A, dt: lambda c, s: S.exciter_stream(c, SR, *map(A, dyn(dt, 3000.0, 15.0, 0.8)), zi=s)),
    "transient_shaper": ("burst", 2, 1536, 512, ("float64",),
                         lambda S, A, dt: lambda c, s: S.transient_shaper_stream(
                             c, SR, *map(A, dyn(dt, 0.8, -0.5)), state=s)),
    "transient_shaper_exact": ("burst", 2, 1536, 512, ("float64",),
                               lambda S, A, dt: lambda c, s: S.transient_shaper_stream(
                                   c, SR, *map(A, dyn(dt, 0.8, -0.5)), state=s, smoother="exact")),
    "multiband_compressor": ("noise", 2, 1536, 512, ("float64",),
                             lambda S, A, dt: lambda c, s: S.multiband_compressor_stream(
                                 c, SR, **kw(A, dt, MULTIBAND), state=s)),
    "multiband_compressor_block": ("noise", 2, 1536, 512, ("float64",),
                                   lambda S, A, dt: lambda c, s: S.multiband_compressor_stream(
                                       c, SR, **kw(A, dt, MULTIBAND), state=s, filter_method="block")),
    "delay": ("noise", 2, 1536, 512, ("float64",),
              lambda S, A, dt: lambda c, s: S.delay_stream(c, SR, 300, *map(A, dyn(dt, 0.6, 0.7)), state=s)),
    "delay_short_chunks": ("noise", 1, 512, 128, ("float64",),
                           lambda S, A, dt: lambda c, s: S.delay_stream(c, SR, 256, *map(A, dyn(dt, 0.5, 1.0)),
                                                                        state=s)),
    "modulated_delay": ("noise", 2, 1536, 512, ("float64",),
                        lambda S, A, dt: lambda c, s: S.modulated_delay_stream(
                            c, SR, *map(A, dyn(dt, 1.3, 6.0, 12.0, 0.8)), 797, state=s, lfo_phase=0.3)),
    "ring_modulator": ("noise", 2, 1536, 512, ("float64",),
                       lambda S, A, dt: lambda c, s: S.ring_modulator_stream(
                           c, SR, *map(A, dyn(dt, 440.0, 0.7)), state=s, lfo_phase=0.2)),
    "pitch_shift": ("noise", 2, 1536, 512, ("float64",),
                    lambda S, A, dt: lambda c, s: S.pitch_shift_stream(
                        c, SR, *map(A, dyn(dt, 5.0, 0.9)), window_ms=30.0, state=s)),
    "tremolo": ("noise", 1, 1536, 512, ("float64",),
                lambda S, A, dt: lambda c, s: S.tremolo_stream(c, SR, *map(A, dyn(dt, 4.5, 0.9)), state=s)),
    "spectral_gate": ("sib", 1, 3072, 1024, ("float64",),
                      lambda S, A, dt: lambda c, s: S.spectral_gate_stream(
                          c, SR, **kw(A, dt, SGATE), noise_profile_db=A(noise_profile(dt)), state=s)),
    "spectral_gate_exact": ("sib", 1, 3072, 1024, ("float64",),
                            lambda S, A, dt: lambda c, s: S.spectral_gate_stream(
                                c, SR, **kw(A, dt, SGATE), noise_profile_db=A(noise_profile(dt)), state=s,
                                smoother="exact")),
    "dynamic_eq": ("sib", 2, 3072, 1024, ("float64",),
                   lambda S, A, dt: lambda c, s: S.dynamic_eq_stream(c, SR, **kw(A, dt, DEQ), state=s)),
    "phaser": ("noise", 2, 1536, 512, ("float64",),
               lambda S, A, dt: lambda c, s: S.phaser_stream(c, SR, **kw(A, dt, PHASER), state=s)),
    "auto_wah": ("gate", 1, 3072, 1024, ("float64",),
                 lambda S, A, dt: lambda c, s: S.auto_wah_stream(c, SR, **kw(A, dt, WAH), state=s)),
    "time_stretch": ("noise", 1, 3 * 2560, 2560, ("float64",),
                     lambda S, A, dt: lambda c, s: S.time_stretch_stream(c, SR, 1.25, 1024, 256, state=s)),
    "time_stretch_slow": ("noise", 1, 3 * 2048, 2048, ("float64",),
                          lambda S, A, dt: lambda c, s: S.time_stretch_stream(c, SR, 0.8, 1024, 256, state=s)),
    "pitch_shift_pv": ("noise", 1, 3 * 2048, 2048, ("float64",),
                       lambda S, A, dt: lambda c, s: S.pitch_shift_pv_stream(
                           c, SR, 12.0 * np.log2(1.5), 1024, 256, state=s)),
    "stream_chain": ("burst", 2, 1536, 512, ("float64",),
                     lambda S, A, dt: S.StreamChain([
                         ("eq", lambda c, s: S.parametric_eq_stream(c, SR, *map(A, eq_params(dt)), zi=s)),
                         ("comp", lambda c, s: S.compressor_stream(c, SR, *map(A, dyn(dt, *COMP)), zi=s,
                                                                  smoother="exact")),
                         ("lim", lambda c, s: S.limiter_stream(c, SR, *map(A, dyn(dt, *LIM)), zi=s)),
                     ])),
}
# tests/test_streaming.py's atol for the fp32 cases (chunked against offline)
FP32_ATOL = {"parametric_eq": 5e-4, "compressor_block": 1e-5, "expander_block": 1e-5, "bitcrusher": 1e-6}


def run_chunks(step, x, chunk, cat, state=None):
    outs = []
    for i in range(0, x.shape[-1], chunk):
        y, state = step(x[..., i : i + chunk], state)
        outs.append(y)
    return cat(outs), state


def jax_stream(name, dtype):
    kind, chs, T, chunk, _, make = CASES[name]
    x = signal(kind, chs, T, dtype)
    with jax_dtype(dtype):
        def run(x):
            return run_chunks(make(JS, jnp.asarray, dtype), x, chunk, lambda ys: jnp.concatenate(ys, -1))[0]

        return x, np.asarray(jit(run)(jnp.asarray(x)))


def port_stream(name, x, dtype, state=None):
    _, _, _, chunk, _, make = CASES[name]
    return run_chunks(make(PS, torch.from_numpy, dtype), torch.from_numpy(x), chunk,
                      lambda ys: torch.cat(ys, -1), state)


@pytest.mark.parametrize("name,dtype", [(n, d) for n, case in CASES.items() for d in case[4]])
def test_stream_matches_jax(name, dtype):
    x, want = jax_stream(name, dtype)
    got, _ = port_stream(name, x, dtype)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL64 if dtype == "float64" else FP32_ATOL[name]
    if dtype == "float64":
        peak_close(got.numpy(), want, tol, name)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0, err_msg=name)


def test_every_stream_is_held():
    """Each of JAX's 28 names has a port counterpart under test here."""
    assert sorted(PS.__all__) == sorted(JS.__all__)
    held = {"sosfilt_stream", "parametric_eq_stream", "graphic_eq_stream", "compressor_stream", "expander_stream",
            "sidechain_compressor_stream", "limiter_stream", "noise_gate_stream", "de_esser_stream",
            "bitcrusher_stream", "exciter_stream", "transient_shaper_stream", "multiband_compressor_stream",
            "delay_stream", "modulated_delay_stream", "ring_modulator_stream", "pitch_shift_stream",
            "tremolo_stream", "spectral_gate_stream", "dynamic_eq_stream", "phaser_stream", "auto_wah_stream",
            "time_stretch_stream", "pitch_shift_pv_stream", "StreamChain",
            # test_reverb_streams_match_jax
            "reverb_stream_init", "reverb_stream", "convolution_reverb_stream_init", "convolution_reverb_stream"}
    assert held == set(JS.__all__)


# ---------------------------------------------------------------------------
# the reverbs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_len", [None, 128])
def test_reverb_streams_match_jax(chunk_len):
    """JAX's filtered-noise IR carried into the port's state (its
    convolution init takes any IR), then both reverb streams in fp32 at
    tests/test_streaming.py's 1e-4; ``chunk_len`` 128 under 256-sample
    chunks takes the exact branch for an oversized chunk."""
    rng = np.random.default_rng(3)
    gains, decays = (rng.uniform(0.2, 0.9, (BS, 12)).astype(np.float32) for _ in range(2))
    x = signal("noise", 2, 1024, np.float32)
    mono = x[:, :1]

    def run(x, mono):
        st = JS.reverb_stream_init(SR, jnp.asarray(gains), jnp.asarray(decays), 0.7, jax.random.PRNGKey(5),
                                   num_samples=1024, chunk_len=chunk_len)
        y, _ = run_chunks(JS.reverb_stream, x, 256, lambda ys: jnp.concatenate(ys, -1), st)
        conv = JS.convolution_reverb_stream_init(st["ir"], 0.4, BS, 1, chunk_len=chunk_len)
        ym, _ = run_chunks(JS.convolution_reverb_stream, mono, 256, lambda ys: jnp.concatenate(ys, -1), conv)
        return y, ym, st["ir"]

    want, want_mono, ir = (np.asarray(a) for a in jit(run)(jnp.asarray(x), jnp.asarray(mono)))
    st = PS.convolution_reverb_stream_init(ir, 0.7, BS, 2, chunk_len=chunk_len, device="cpu")
    got, st = run_chunks(PS.reverb_stream, torch.from_numpy(x), 256, lambda ys: torch.cat(ys, -1), st)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert st["hist"].shape == (BS, 2, 1023)
    conv = PS.convolution_reverb_stream_init(torch.from_numpy(ir), 0.4, BS, 1, chunk_len=chunk_len, device="cpu")
    got_mono, _ = run_chunks(PS.convolution_reverb_stream, torch.from_numpy(mono), 256,
                             lambda ys: torch.cat(ys, -1), conv)
    np.testing.assert_allclose(got_mono.numpy(), want_mono, atol=1e-4, rtol=0)
    # mono into the filtered-noise reverb is duplicated to stereo
    y, _ = PS.reverb_stream(torch.from_numpy(mono[..., :256]), PS.convolution_reverb_stream_init(
        ir, 0.7, BS, 2, device="cpu"))
    assert y.shape == (BS, 2, 256)


def test_reverb_stream_matches_offline():
    """The port's init draws the IR from a generator as the offline effect
    does: the same generator state renders the same reverb (1e-4)."""
    gains = torch.from_numpy(np.random.default_rng(4).uniform(0.2, 0.9, (BS, 12)).astype(np.float32))
    decays = torch.flip(gains, (1,))
    x = torch.from_numpy(signal("noise", 2, 2048, np.float32))
    offline = PF.noise_shaped_reverberation(
        x, SR, *gains.unbind(1), *decays.unbind(1), 0.7, num_samples=1024,
        generator=torch.Generator().manual_seed(5), noise_mode="frequency")
    st = PS.reverb_stream_init(SR, gains, decays, 0.7, torch.Generator().manual_seed(5), num_samples=1024,
                               device="cpu")
    y, _ = run_chunks(PS.reverb_stream, x, 256, lambda ys: torch.cat(ys, -1), st)
    np.testing.assert_allclose(y.numpy(), offline.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# chunked against the port's own offline effects (fp32)
# ---------------------------------------------------------------------------


def _offline(name, x):
    """The port's offline effect that the stream ``name`` reproduces, at
    its fp32 parameters, and tests/test_streaming.py's atol for it."""
    f32 = "float32"
    P = lambda *vals: [torch.from_numpy(v) for v in dyn(f32, *vals)]  # noqa: E731
    K = lambda d: kw(torch.from_numpy, f32, d)  # noqa: E731
    t = torch.from_numpy
    return {
        "sosfilt_coupled": (lambda: sosfilt_coupled(t(cascade(f32)), x), 5e-4),
        "sosfilt_block": (lambda: sosfilt_blockmat(t(cascade(f32)), x), 5e-4),
        "parametric_eq": (lambda: PF.parametric_eq(x, SR, *map(t, eq_params(f32)), filter_method="coupled"), 5e-4),
        "graphic_eq": (lambda: PF.graphic_eq(x, SR, t(np.linspace(-6, 6, 20).reshape(2, 10).astype(f32))), 5e-4),
        "compressor_block": (lambda: PF.compressor(x, SR, *P(*COMP), smoother="block"), 1e-5),
        "compressor_parallel": (lambda: PF.compressor(x, SR, *P(*COMP), smoother="parallel"), 5e-4),
        "compressor_exact": (lambda: PF.compressor(x, SR, *P(*COMP), smoother="exact"), 5e-4),
        "expander_block": (lambda: PF.expander(x, SR, *P(*COMP), smoother="block"), 1e-5),
        "sidechain_compressor": (lambda: PF.sidechain_compressor(
            x[:, :2], SR, *P(-30.0, 8.0, 5.0, 60.0, 3.0, 0.0), smoother="parallel", sidechain=x[:, 2:]), 2e-5),
        "limiter_parallel": (lambda: PF.limiter(x, SR, *P(*LIM), smoother="parallel"), 5e-4),
        "limiter_exact": (lambda: PF.limiter(x, SR, *P(*LIM), smoother="exact"), 5e-4),
        "limiter_block": (lambda: PF.limiter(x, SR, *P(*LIM), smoother="block"), 5e-4),
        "noise_gate": (lambda: PF.noise_gate(x, SR, **K(GATE), smoother="parallel"), 2e-5),
        "noise_gate_hold_exact": (lambda: PF.noise_gate(x, SR, **K(GATE), hold_ms=12.0, smoother="exact"), 2e-5),
        "de_esser": (lambda: PF.de_esser(x, SR, **K(DEESS), smoother="parallel"), 3e-5),
        "de_esser_wideband_exact": (lambda: PF.de_esser(x, SR, **K(DEESS), mode="wideband", smoother="exact"), 3e-5),
        "bitcrusher": (lambda: PF.bitcrusher(x, SR, *P(5.0, 3000.0, 0.9)), 1e-6),
        "exciter": (lambda: PF.exciter(x, SR, *P(3000.0, 15.0, 0.8)), 2e-4),
        "transient_shaper": (lambda: PF.transient_shaper(x, SR, *P(0.8, -0.5)), 2e-4),
        "transient_shaper_exact": (lambda: PF.transient_shaper(x, SR, *P(0.8, -0.5), smoother="exact"), 2e-4),
        "multiband_compressor": (lambda: PF.multiband_compressor(x, SR, **K(MULTIBAND)), 1e-3),
        "multiband_compressor_block": (lambda: PF.multiband_compressor(
            x, SR, **K(MULTIBAND), filter_method="block"), 1e-3),
        "delay": (lambda: PF.delay(x, SR, *P(300 / SR * 1e3, 0.6, 0.7)), 2e-4),
        "modulated_delay": (lambda: PF.modulated_delay(x, SR, *P(1.3, 6.0, 12.0, 0.8), lfo_phase=0.3), 5e-4),
        # the offline carrier's phase is float64 and the stream's the
        # wrapped fp32 phase: the stream's rounding sets the bound,
        # tremolo's (the same wrapped LFO)
        "ring_modulator": (lambda: PF.ring_modulator(x, SR, *P(440.0, 0.7), lfo_phase=0.2), 1e-5),
        "tremolo": (lambda: PF.tremolo(x, SR, *P(4.5, 0.9)), 1e-5),
    }[name]


@pytest.mark.parametrize("name", [
    "sosfilt_coupled", "sosfilt_block", "parametric_eq", "graphic_eq", "compressor_block", "compressor_parallel", "compressor_exact", "expander_block",
    "sidechain_compressor", "limiter_parallel", "limiter_exact", "limiter_block", "noise_gate",
    "noise_gate_hold_exact", "de_esser", "de_esser_wideband_exact", "bitcrusher", "exciter", "transient_shaper",
    "transient_shaper_exact", "multiband_compressor", "multiband_compressor_block", "delay", "modulated_delay",
    "ring_modulator", "tremolo",
])
def test_stream_matches_offline(name):
    kind, chs, T, _, _, _ = CASES[name]
    # the offline comb's circular tail, fb^(n_fft / D), is 9e-4 at 2048
    # samples: the delay at tests/test_streaming.py's 8192
    T = 8192 if name == "delay" else T
    x = signal(kind, chs, T, np.float32)
    got, _ = port_stream(name, x, "float32")
    fn, atol = _offline(name, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), fn().numpy(), atol=atol, rtol=0)


def test_delay_stream_chunk_sizes_agree():
    """Chunks shorter and longer than the delay take the block recursion's
    two regimes; both equal one call over the whole signal (1e-5)."""
    x = torch.from_numpy(signal("noise", 1, 4096, np.float32))
    args = (SR, 256, torch.full((BS,), 0.5), torch.full((BS,), 1.0))
    one, _ = PS.delay_stream(x, *args)
    for chunk in (128, 1024):
        y, _ = run_chunks(lambda c, s: PS.delay_stream(c, *args, state=s), x, chunk, lambda ys: torch.cat(ys, -1))
        np.testing.assert_allclose(y.numpy(), one.numpy(), atol=1e-5, rtol=0)


def test_pitch_shift_stream_matches_offline():
    """Against the offline gather path without latency compensation, with
    tests/test_streaming.py's budget of kink outliers (near-integer read
    positions whose floor the two accumulations round apart)."""
    x = signal("noise", 2, 8192, np.float32)
    st, mix = torch.full((BS,), 5.0), torch.full((BS,), 0.9)
    offline = PF.pitch_shift(torch.from_numpy(x), SR, st, mix, window_ms=30.0, compensate_latency=False,
                             matmul=False)
    y, _ = run_chunks(lambda c, s: PS.pitch_shift_stream(c, SR, st, mix, window_ms=30.0, state=s),
                      torch.from_numpy(x), 512, lambda ys: torch.cat(ys, -1))
    diff = np.abs(y.numpy() - offline.numpy())
    assert int((diff > 5e-4).sum()) <= diff.size * 5e-4
    assert float(diff.max()) < 5e-2


@pytest.mark.parametrize("name,left,edge,atol", [
    ("phaser", 384, 0, 2e-5), ("auto_wah", 384, 512, 3e-5), ("spectral_gate", 1536, 0, 5e-5),
    ("dynamic_eq", 768, 0, 5e-5)])
def test_wola_stream_matches_offline(name, left, edge, atol):
    """The stream is the offline render delayed by frame_size - hop (the
    auto-wah away from the offline clip's clipped edge frames; the gate
    against the causal detector), at tests/test_streaming.py's atol (the
    dynamic EQ, which that file does not stream, at the spectral gate's:
    the other WOLA effect with frame ballistics)."""
    f32 = "float32"
    T = 16384 if name in ("phaser", "auto_wah") else 8192
    x = signal({"phaser": "noise", "auto_wah": "gate"}.get(name, "sib"), 1, T, np.float32)
    xt = torch.from_numpy(x)
    K = lambda d: kw(torch.from_numpy, f32, d)  # noqa: E731
    if name == "phaser":
        offline = PF.phaser(xt, SR, **K(PHASER))
        step = lambda c, s: PS.phaser_stream(c, SR, **K(PHASER), state=s)  # noqa: E731
    elif name == "auto_wah":
        offline = PF.auto_wah(xt, SR, **K(WAH))
        step = lambda c, s: PS.auto_wah_stream(c, SR, **K(WAH), state=s)  # noqa: E731
    elif name == "dynamic_eq":
        offline = PF.dynamic_eq(xt, SR, **K(DEQ))
        step = lambda c, s: PS.dynamic_eq_stream(c, SR, **K(DEQ), state=s)  # noqa: E731
    else:
        prof = torch.from_numpy(noise_profile(f32))
        offline = PF.spectral_gate(xt, SR, **K(SGATE), noise_profile_db=prof, det_smooth_mode="causal")
        step = lambda c, s: PS.spectral_gate_stream(c, SR, **K(SGATE), noise_profile_db=prof, state=s)  # noqa: E731
    y, _ = run_chunks(step, xt, 2048, lambda ys: torch.cat(ys, -1))
    np.testing.assert_allclose(y.numpy()[..., left + edge : T - edge],
                               offline.numpy()[..., edge : T - left - edge], atol=atol, rtol=0)


@pytest.mark.parametrize("rate,k_in", [(1.25, 10), (0.8, 8)])
def test_time_stretch_stream_matches_offline(rate, k_in):
    """Both phase vocoders compute in float64 inside and round once: the
    stream is the offline render delayed by frame_size - hop + D hop within
    tests/test_streaming.py's 1e-4 (measured far below it)."""
    L, hop = 1024, 256
    x = signal("noise", 2, 4 * k_in * hop, np.float32)
    offline = PF.time_stretch(torch.from_numpy(x), SR, rate, L, hop)
    y, _ = run_chunks(lambda c, s: PS.time_stretch_stream(c, SR, rate, L, hop, state=s), torch.from_numpy(x),
                      k_in * hop, lambda ys: torch.cat(ys, -1))
    delay = (L - hop) + max(1, int(np.ceil(2.0 / rate - 1.0))) * hop
    n = min(offline.shape[-1], y.shape[-1] - delay) - L
    np.testing.assert_allclose(y.numpy()[..., delay : delay + n], offline.numpy()[..., :n], atol=1e-4, rtol=0)


def test_pitch_shift_pv_stream_moves_the_tone():
    n = np.arange(40960) / SR
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440.0 * n)).astype(np.float32))[None, None, :]
    y, _ = run_chunks(lambda c, s: PS.pitch_shift_pv_stream(c, SR, 12.0 * np.log2(1.5), 2048, 512, state=s), x,
                      8 * 512, lambda ys: torch.cat(ys, -1))
    assert y.shape == x.shape
    seg = y[0, 0, 16384:32768].numpy() * np.hanning(16384)
    assert abs(np.abs(np.fft.rfft(seg)).argmax() * SR / 16384 - 660.0) < 8.0


# ---------------------------------------------------------------------------
# the exact ballistics through the kernel's wrapper, states, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coef_shape", [(BS, 1, 1), (BS, 3, 1)])
def test_exact_ballistics_through_the_kernel_wrapper(coef_shape):
    """The streams' helper evaluates "exact" by ballistics_pallas (its
    plain engine here), with per-row coefficients folded into rows: bitwise
    equal to ops.ballistics_smooth(mode="exact") chunk after chunk."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(-np.abs(np.cumsum(rng.standard_normal((BS, 3, 1024)), -1)).astype(np.float32))
    aa = torch.from_numpy(rng.uniform(0.9, 0.99, coef_shape).astype(np.float32))
    ar = torch.from_numpy(rng.uniform(0.99, 0.9999, coef_shape).astype(np.float32))
    s_k = s_p = None
    for i in range(0, 1024, 256):
        y_k, s_k = PS._ballistics_stream(g[..., i : i + 256], aa, ar, "exact", s_k)
        y_p, s_p = ballistics_smooth(g[..., i : i + 256], aa, ar, mode="exact", y0=s_p, return_yf=True)
        assert torch.equal(y_k, y_p)
        assert all(torch.equal(a, b) for a, b in zip(s_k, s_p))


def test_exact_streams_call_the_kernel_once_a_chunk(monkeypatch):
    """One ballistics_pallas call a chunk, on the rows the kernel takes."""
    calls = []
    kernel = PS.ballistics_pallas

    def counting(g, *args, **kwargs):
        calls.append(tuple(g.shape))
        return kernel(g, *args, **kwargs)

    monkeypatch.setattr(PS, "ballistics_pallas", counting)
    for name in ("stream_chain", "noise_gate_hold_exact"):
        kind, chs, T, _, _, _ = CASES[name]
        port_stream(name, signal(kind, chs, T, np.float64), "float64")
    assert calls == [(BS, 1, 512)] * 3 + [(BS, 1, 1024)] * 3


@pytest.mark.parametrize("name,rest", [
    ("parametric_eq", lambda dt: torch.zeros((BS, 2, 6, 2), dtype=dt)),
    ("compressor_block", lambda dt: torch.zeros((BS, 1, 1, 4), dtype=dt)),
    ("compressor_exact", lambda dt: (torch.zeros((BS, 1), dtype=dt),) * 2),
    ("limiter_parallel", lambda dt: (torch.zeros((BS, 1), dtype=dt),) * 2),
    ("bitcrusher", lambda dt: {"c0": torch.zeros((BS, 1, 1), dtype=dt), "held": torch.zeros((BS, 2, 1), dtype=dt)}),
    ("tremolo", lambda dt: {"ph": torch.zeros((BS, 1, 1), dtype=dt)}),
])
def test_state_none_is_rest(name, rest):
    kind, chs, T, _, _, _ = CASES[name]
    x = signal(kind, chs, T, np.float64)
    y0, s0 = port_stream(name, x, "float64")
    y1, s1 = port_stream(name, x, "float64", state=rest(torch.float64))
    assert torch.equal(y0, y1)


def test_stream_errors():
    with pytest.raises(ValueError, match="multiple of block"):
        PS.sosfilt_stream(torch.from_numpy(cascade(np.float32)), torch.zeros((BS, 2, 200)))
    with pytest.raises(ValueError, match="at least one"):
        PS.StreamChain([])
    with pytest.raises(ValueError, match="Duplicate"):
        PS.StreamChain([("a", lambda c, s: (c, s)), ("a", lambda c, s: (c, s))])
    with pytest.raises(ValueError, match="smoother"):
        PS.noise_gate_stream(torch.zeros((1, 1, 512)), SR, -30.0, 4.0, 40.0, 1.0, 20.0, 1.0, smoother="block")
    with pytest.raises(ValueError, match="integer"):
        PS.time_stretch_stream(torch.zeros((1, 1, 5 * 512)), SR, 1.3, 2048, 512)
    with pytest.raises(ValueError, match="sidechain"):
        PS.sidechain_compressor_stream(torch.zeros((1, 1, 512)), SR, -30.0, 4.0, 1.0, 20.0, 1.0, 0.0)
    with pytest.raises(ValueError, match="smoother"):
        PS.compressor_stream(torch.zeros((1, 1, 512)), SR, -30.0, 4.0, 1.0, 20.0, 1.0, 0.0, smoother="fsm")


def test_serving_loads_no_training_module():
    """``import dasp_tpu_torch.streaming`` leaves the training steps (and the
    models, losses and parallel layer they pull in) unloaded; the package's
    ``train`` attribute still loads them on first use."""
    import subprocess
    import sys

    code = ("import sys, dasp_tpu_torch.streaming\n"
            "assert 'dasp_tpu_torch.train' not in sys.modules\n"
            "import dasp_tpu_torch\n"
            "assert dasp_tpu_torch.train.train_step\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
