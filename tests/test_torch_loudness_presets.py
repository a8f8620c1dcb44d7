"""BS.1770 loudness and presets of dasp_tpu_torch (``utils.loudness``,
``utils.presets``) against dasp_tpu's.

Loudness: the same numpy audio (bs 2, 1-5 channels, 3 s at 44.1 kHz)
through both packages' ``integrated_loudness``: in fp32 within 1e-4 LU
(the K-weighting filters and one cumulative sum of 132300 squares, each
rounded in fp32), in float64 within 1e-9 LU; the port's ``"pallas"``
K-weighting (the biquad-cascade kernel's plain engine here) against the
float64 reading; ``loudness_normalize``'s output within 1e-4 of max(1,
peak) and its gradient in float64 within 1e-9 of the largest; the 997 Hz
calibration.

Presets: a chain written by ``dasp_tpu.utils.save_preset`` loads with the
port's ``load_preset`` and renders JAX's output within 1e-4 of max(1, peak)
(float64 on both sides), and the reverse; the same JSON format; an
argument that JSON cannot hold raises, naming it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasp_tpu as D
import dasp_tpu.utils as JU
import dasp_tpu_torch as P
import dasp_tpu_torch.utils as PU
from dasp_tpu_torch.modules import Gain, Processor
from dasp_tpu_torch.utils.presets import processor_from_config, processor_to_config
from test_torch_dynamics import grad_close, jit, peak_close
from test_torch_fsm import jax_dtype

SR = 44100
LU_TOL = 1e-4
PALLAS_LU_TOL = 1e-3


def program(chs=2, T=SR * 3, seed=0, dtype=np.float32):
    """Noise under a swell with a quiet stretch: blocks on both sides of
    the relative gate, and a silent tail below the absolute gate."""
    rng = np.random.default_rng(seed)
    env = 0.02 + np.sin(np.linspace(0.0, 2.0 * np.pi, T)) ** 2
    x = 0.3 * rng.standard_normal((2, chs, T)) * env
    x[..., -SR // 2 :] = 0.0
    return x.astype(dtype)


def test_k_weighting_sos_matches_jax():
    with jax_dtype("float64"):
        want = np.asarray(JU.k_weighting_sos(2, jnp.float64, SR))
    peak_close(PU.k_weighting_sos(2, torch.float64, SR).numpy(), want, 1e-12, "k_weighting_sos")


def jax_loudness(x, dtype="float32"):
    with jax_dtype(dtype):
        return np.asarray(jit(lambda x: JU.integrated_loudness(x, SR))(jnp.asarray(x)))


@pytest.mark.parametrize("chs,method", [(2, "coupled"), (5, "coupled"), (1, "block")])
def test_integrated_loudness_matches_jax(chs, method):
    x = program(chs)
    got = PU.integrated_loudness(torch.from_numpy(x), SR, filter_method=method)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_loudness(x), atol=LU_TOL, rtol=0)


def test_integrated_loudness_float64_and_pallas():
    """In float64 both packages compute the same formula: 1e-9 LU. The
    port's fp32 readings against that: "coupled" (float64 inside, one
    fp32 cumulative sum) within 1e-4 LU, "pallas" (the kernel's fp32
    recursion; its plain engine here) within PALLAS_LU_TOL: its direct-form
    38 Hz high-pass strays 2.7e-4 LU here. (JAX's own fp32 "coupled"
    reading of the 997 Hz sine strays 1.7e-4 LU from its float64 one, so
    the sine is held in float64.)"""
    n = np.arange(SR * 3) / SR
    sine = np.sin(2 * np.pi * 997.0 * n)[None, None, :]
    for x in (program(2, dtype=np.float64), sine):
        want = jax_loudness(x, "float64")
        np.testing.assert_allclose(PU.integrated_loudness(torch.from_numpy(x), SR).numpy(), want, atol=1e-9, rtol=0)
        x32 = torch.from_numpy(x.astype(np.float32))
        np.testing.assert_allclose(PU.integrated_loudness(x32, SR).numpy(), want, atol=LU_TOL, rtol=0)
        got = PU.integrated_loudness(x32, SR, filter_method="pallas").numpy()
        np.testing.assert_allclose(got, want, atol=PALLAS_LU_TOL, rtol=0)


def test_loudness_normalize_matches_jax():
    """fp32 outputs within 1e-4 of max(1, peak); in float64 the output and
    the gradient of mean(y ** 2) with respect to x and the target within
    1e-9."""
    x = program(2, SR * 2)
    target = np.asarray([-14.0, -23.0], np.float32)
    want = np.asarray(jit(lambda x, t: JU.loudness_normalize(x, SR, t))(jnp.asarray(x), jnp.asarray(target)))
    got = PU.loudness_normalize(torch.from_numpy(x), SR, torch.from_numpy(target))
    peak_close(got.numpy(), want, 1e-4, "loudness_normalize fp32")
    np.testing.assert_allclose(PU.integrated_loudness(got, SR).numpy(), target, atol=1e-3)

    x64, t64 = x.astype(np.float64), target.astype(np.float64)
    with jax_dtype("float64"):
        def jloss(x, t):
            y = JU.loudness_normalize(x, SR, t)
            return jnp.mean(y ** 2), y

        (_, y_j), g_j = jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x64),
                                                                                        jnp.asarray(t64))
    xt, tt = (torch.tensor(a, requires_grad=True) for a in (x64, t64))
    y_t = PU.loudness_normalize(xt, SR, tt)
    torch.mean(y_t ** 2).backward()
    peak_close(y_t.detach().numpy(), np.asarray(y_j), 1e-9, "loudness_normalize float64")
    grad_close(xt.grad.numpy(), np.asarray(g_j[0]), 1e-9, "d/dx")
    grad_close(tt.grad.numpy(), np.asarray(g_j[1]), 1e-9, "d/dtarget")


def test_997hz_calibration_and_gates():
    """A 0 dBFS 997 Hz sine in one channel reads JAX's float64 reading
    within 1e-4 LU, and -3.01 within tests/test_utils.py's 0.1 (the
    cookbook K-weighting both packages use reads -3.052 at 44.1 kHz);
    silence appended to an 8 s program leaves the reading within that
    test's 0.2; gain is
    linear above the gates."""
    n = np.arange(SR * 3) / SR
    sine = np.sin(2 * np.pi * 997.0 * n)[None, None, :]
    want = float(jax_loudness(sine, "float64")[0])
    sine = torch.from_numpy(sine.astype(np.float32))
    got = float(PU.integrated_loudness(sine, SR)[0])
    assert abs(got - want) <= LU_TOL
    assert abs(got - (-3.01)) < 0.1
    long = torch.from_numpy(0.25 * np.sin(2 * np.pi * 997.0 * np.arange(SR * 8) / SR).astype(np.float32))[None, None]
    padded = torch.cat([long, torch.zeros_like(long)], -1)
    assert abs(float(PU.integrated_loudness(padded, SR)[0]) - float(PU.integrated_loudness(long, SR)[0])) < 0.2
    quiet = float(PU.integrated_loudness(0.1 * sine, SR)[0])
    assert abs((got - quiet) - 20.0) < 1e-3


def test_loudness_rejects_six_channels():
    with pytest.raises(ValueError, match="<= 5 channels"):
        PU.integrated_loudness(torch.zeros((1, 6, SR)), SR)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def chain_of(M):
    """A chain in the JAX package's or the port's classes, with options set
    (filter method, smoothers, a range) so that they must survive the file."""
    return M.Chain([M.ParametricEQ(SR, filter_method="coupled"), M.Compressor(SR, smoother="parallel"),
                    M.Exciter(SR), M.Limiter(SR, smoother="parallel"), M.Gain(SR, min_gain_db=-12.0)])


def render_jax(chain, x, p):
    with jax_dtype("float64"):
        return np.asarray(jit(lambda x, p: chain.process_normalized(x, p))(jnp.asarray(x), jnp.asarray(p)))


def inputs():
    rng = np.random.default_rng(12)
    x = 0.3 * rng.standard_normal((2, 2, 4096))
    p = rng.uniform(0.1, 0.9, (2, chain_of(P).num_params))
    return x, p


def test_jax_preset_loads_in_the_port(tmp_path):
    x, p = inputs()
    path = str(tmp_path / "jax.json")
    chain = chain_of(D)
    JU.save_preset(path, chain, p.astype(np.float32), metadata={"from": "dasp_tpu"})
    want = render_jax(chain, x, p.astype(np.float32).astype(np.float64))
    proc, params = PU.load_preset(path)
    assert isinstance(proc, P.Chain) and params.dtype == torch.float32
    assert [type(q).__name__ for q in proc.processors] == [type(q).__name__ for q in chain.processors]
    assert proc.processors[-1].param_ranges == {"gain_db": (-12.0, 24.0)}
    got = proc.process_normalized(torch.from_numpy(x), params.double())
    peak_close(got.numpy(), want, 1e-4, "port render of JAX's preset")


def test_port_preset_loads_in_jax(tmp_path):
    x, p = inputs()
    path = str(tmp_path / "port.json")
    chain = chain_of(P)
    PU.save_preset(path, chain, torch.from_numpy(p.astype(np.float32)))
    got = chain.process_normalized(torch.from_numpy(x), torch.from_numpy(p.astype(np.float32)).double())
    proc, params = JU.load_preset(path)
    want = render_jax(proc, x, params.astype(np.float64))
    peak_close(got.numpy(), want, 1e-4, "JAX render of the port's preset")
    with open(path) as f:
        doc = json.load(f)
    assert doc["format"] == "dasp_tpu.preset.v1"
    assert doc["param_names"] == list(chain.param_ranges)
    assert doc["params_denormalized"][0]["p4.gain_db"] == pytest.approx(-12.0 + 36.0 * float(np.float32(p[0, -1])))


def test_same_file_from_both_packages(tmp_path):
    """The same configuration and parameters write the same document."""
    _, p = inputs()
    p = p.astype(np.float32)
    docs = []
    for save, chain, params in ((JU.save_preset, chain_of(D), p), (PU.save_preset, chain_of(P), torch.from_numpy(p))):
        path = tmp_path / f"{len(docs)}.json"
        save(str(path), chain, params, metadata={"song": "a"})
        docs.append(json.loads(path.read_text()))
    assert docs[0] == docs[1]


def test_unserializable_constructor_arg_raises(tmp_path):
    class Custom(Processor):
        def __init__(self, sample_rate, shaper=None, generator=None):
            self.sample_rate = sample_rate
            self.process_fn = lambda x, sr, gain_db: x
            self.param_ranges = {"gain_db": (-1.0, 1.0)}

    with pytest.raises(TypeError, match=r"Custom\(shaper=\)"):
        PU.save_preset(str(tmp_path / "a.json"), Custom(SR, shaper=torch.tanh))
    with pytest.raises(TypeError, match=r"Custom\(generator=\)"):
        PU.save_preset(str(tmp_path / "b.json"), P.Chain([Gain(SR), Custom(SR, generator=torch.Generator())]))
    cfg = processor_to_config(Custom(SR))
    with pytest.raises(KeyError, match="Custom"):
        processor_from_config(cfg)
    assert isinstance(processor_from_config(cfg, extra_types=[Custom]), Custom)


def test_preset_errors(tmp_path):
    path = str(tmp_path / "junk.json")
    with open(path, "w") as f:
        json.dump({"format": "something-else"}, f)
    with pytest.raises(ValueError, match="not a dasp_tpu preset"):
        PU.load_preset(path)
    with pytest.raises(ValueError, match="columns"):
        PU.save_preset(path, Gain(SR), np.zeros((1, 2), np.float32))
    PU.save_preset(path, Gain(SR))
    proc, params = PU.load_preset(path)
    assert isinstance(proc, Gain) and params is None
