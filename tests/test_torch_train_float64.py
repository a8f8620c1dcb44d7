"""The training step in float64: dasp_tpu_torch against dasp_tpu.

The same step, weights, batch and injected noise as tests/test_torch_train.py,
with every tensor in float64 on both sides: JAX runs its float64 paths (EQ
``"exact"``, the scan-based cascade, and compressor ``"exact"``, the
lax.scan ballistics; its Pallas kernels compute in fp32), the port its
kernels' plain engines and adjoint formulas in float64. What fp32 rounding
hides in the fp32 comparison shows here.

Tolerances: the corruption output 1e-10 absolute; the loss 1e-8 relative;
each parameter's gradient 1e-5 of its largest value (the EQ's gradients
with respect to poles near the unit circle keep float64 to about 2e-6
here); the new BatchNorm statistics 1e-10 absolute; the Adam-updated
parameters 1e-9 absolute on all but at most 0.1% of the elements (tiny
gradients of either sign, which Adam's first step maps to +-lr), and at
most 2 lr on those.
"""

import numpy as np
import torch

import jax

from dasp_tpu_torch.models import style_net_from_flax
from test_torch_train import LR, JaxStep, flax_variables, make_batch, torch_step


def test_train_step_matches_jax_in_float64():
    jax.config.update("jax_enable_x64", True)
    try:
        x, rand, noise = make_batch(dtype=np.float64)
        fnet, variables = flax_variables(cast=np.float64)
        loss_j, grads_j, stats_j, params_j = JaxStep(eq="exact", comp="exact")(
            fnet, variables, x, rand, noise
        )
    finally:
        jax.config.update("jax_enable_x64", False)
    loss_t, grads_t, net = torch_step(variables, x, rand, noise, dtype=None, torch_dtype=torch.float64)

    loss_rel = abs(loss_t - float(loss_j)) / abs(float(loss_j))
    gj = style_net_from_flax({"params": grads_j}, dtype=torch.float64)
    worst = max(float((grads_t[k] - g).abs().max() / g.abs().max()) for k, g in gj.items())
    new = style_net_from_flax({"params": params_j, "batch_stats": stats_j}, dtype=torch.float64)
    state = net.state_dict()
    stats_err = max(float((state[k] - v).abs().max()) for k, v in new.items() if "running" in k)
    moved, n = 0, 0
    for k in gj:
        d = (state[k] - new[k]).abs()
        assert float(d.max()) <= 2 * LR + 1e-9, k
        moved += int((d > 1e-9).sum())
        n += d.numel()
    print(f"float64 step: loss rel {loss_rel:.3e}, worst gradient {worst:.3e} of its max, "
          f"batch stats {stats_err:.3e}, Adam {moved} of {n} elements > 1e-9 apart")
    assert loss_rel <= 1e-8
    assert worst <= 1e-5
    assert stats_err <= 1e-10
    assert moved <= 1e-3 * n

