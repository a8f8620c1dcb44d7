"""Multi-rank parallelism on ``torch.distributed``: the (dp, sp) mesh, batch
slices and the sequence-sharded DSP functions (PyTorch counterpart of
``dasp_tpu/parallel``). Every name of the JAX package's ``__all__`` is
here; torch has no global arrays, so each rank holds its own block (see
:mod:`~dasp_tpu_torch.parallel.mesh`). :func:`spawn` (outside ``__all__``,
which keeps the JAX package's names) starts a world of ranks on this
host."""

from .launch import spawn
from .mesh import (
    Mesh,
    Sharding,
    all_gather,
    batch_sharding,
    make_mesh,
    psum,
    replicate,
    replicated_sharding,
    shard_batch,
    shift,
    sum_gradients,
)
from .sharded import (
    sharded_ballistics_smooth,
    sharded_fft_conv_causal,
    sharded_multi_resolution_stft_loss,
    sharded_onepole,
    sharded_sosfilt_coupled,
    sharded_tv_freq_filter,
    sharded_tv_power,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "sharded_fft_conv_causal",
    "sharded_sosfilt_coupled",
    "sharded_tv_freq_filter",
    "sharded_tv_power",
    "sharded_multi_resolution_stft_loss",
    "sharded_ballistics_smooth",
    "sharded_onepole",
]
