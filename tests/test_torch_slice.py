"""The whole style-transfer render, dasp_tpu_torch against dasp_tpu.

Same converted weights, same numpy clips and the same injected reverb
noise: the net (eval mode), then the four processors' process_normalized
(EQ filter_method="pallas", compressor smoother="exact_pallas", reverb
with noise=, gain) at T = 8192 with a 2048-sample IR. JAX runs its Pallas
kernels in interpret mode, the port its kernels' plain versions.

Tolerances: the projected parameters 1e-5 (the encoder's fp32 sums);
the audio 2e-3 relative to max(1, peak), the biquad cascade's bound
(tests/test_pallas_iir.py) carried through a chain that is linear in the
EQ output apart from the compressor's smooth gain and whose gain stage
scales by at most 24 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dasp_tpu as D
from dasp_tpu.models import StyleTransferNet as FlaxNet
from dasp_tpu_torch.models import (
    StyleTransferNet,
    apply_style_chain,
    make_style_processors,
    style_net_from_flax,
)

SR = 44100
T = 8192
IR = 2048
TAPS = 1023
SMALL = dict(embed_dim=32, ch_dim=8, encoder_dilations=(1, 2, 4))
PARAM_TOL = 1e-5
AUDIO_TOL = 2e-3


def test_style_render_matches_jax():
    rng = np.random.default_rng(7)
    inp = (rng.standard_normal((2, 1, T)) * 0.3).astype(np.float32)
    ref = (rng.standard_normal((2, 1, T)) * 0.3).astype(np.float32)
    noise = rng.standard_normal((4, 12, IR + TAPS - 1)).astype(np.float32)

    fnet = FlaxNet(**SMALL)
    variables = jax.device_get(fnet.init(jax.random.PRNGKey(3), jnp.asarray(inp), jnp.asarray(ref), train=False))
    # redraw the BatchNorm statistics so eval mode is exercised
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"]
    )
    variables = {"params": variables["params"], "batch_stats": stats}

    params_j = fnet.apply(variables, jnp.asarray(inp), jnp.asarray(ref), train=False)
    jp = D.models.make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="pallas", compressor_smoother="exact_pallas"
    )
    xj = jnp.asarray(inp)
    y = jp["equalizer"].process_normalized(xj, params_j["equalizer"], clip_params=True)
    y = jp["compressor"].process_normalized(y, params_j["compressor"], clip_params=True)
    y = jp["reverb"].process_normalized(y, params_j["reverb"], clip_params=True, noise=jnp.asarray(noise))
    y_j = np.asarray(jp["gain"].process_normalized(y, params_j["gain"], clip_params=True))

    tnet = StyleTransferNet(**SMALL)
    tnet.load_state_dict(style_net_from_flax(variables, tnet), strict=True)
    tnet.eval()
    tp = make_style_processors(
        SR, reverb_num_samples=IR, eq_filter_method="pallas", compressor_smoother="exact_pallas"
    )
    with torch.inference_mode():
        params_t = tnet(torch.tensor(inp), torch.tensor(ref))
        y_t = apply_style_chain(tp, torch.tensor(inp), params_t, noise=torch.tensor(noise)).numpy()

    for k in params_j:
        np.testing.assert_allclose(params_t[k].numpy(), np.asarray(params_j[k]), atol=PARAM_TOL, err_msg=k)
    assert y_t.shape == y_j.shape == (2, 2, T)
    assert np.isfinite(y_t).all()
    scale = max(1.0, float(np.abs(y_j).max()))
    err = float(np.abs(y_t - y_j).max())
    print(f"style render: max abs diff {err:.3e}, peak {np.abs(y_j).max():.3f}")
    assert err <= AUDIO_TOL * scale, f"{err:.3e} > {AUDIO_TOL} * {scale:.3g}"


def test_style_render_with_generator_on_cpu():
    """The serving entry point with a torch.Generator (the JAX package's key):
    (bs, 2, T) finite output, reproducible from the seed."""
    torch.manual_seed(0)
    net = StyleTransferNet(**SMALL).eval()
    procs = make_style_processors(SR, reverb_num_samples=IR, eq_filter_method="pallas",
                                  compressor_smoother="exact_pallas")
    x = torch.randn(2, 1, T) * 0.1
    with torch.inference_mode():
        params = net(x, x.flip(-1))
        y1 = apply_style_chain(procs, x, params, generator=torch.Generator().manual_seed(1))
        y2 = apply_style_chain(procs, x, params, generator=torch.Generator().manual_seed(1))
    assert y1.shape == (2, 2, T) and bool(torch.isfinite(y1).all())
    assert torch.equal(y1, y2)
