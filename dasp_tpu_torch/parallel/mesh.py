"""The (dp, sp) layout of a ``torch.distributed`` world, and its collectives.

PyTorch counterpart of ``dasp_tpu/parallel/mesh.py``. The JAX package lays
its devices out as a ``jax.sharding.Mesh`` with a data-parallel axis "dp"
(the batch) and a sequence-parallel axis "sp" (the time axis). Here the
same layout is drawn over the ranks of an initialised ``torch.distributed``
world: rank = dp_index * sp + sp_index, the row-major order of
``np.asarray(devices).reshape(dp, sp)``. :class:`Mesh` keeps this rank's
process group along each axis.

Torch has no global arrays. Each rank holds its own block: its dp slice of
the batch (:func:`shard_batch`), its sp block of the time axis
(:class:`Sharding` with "sp" on the last axis), or a whole tensor that every
rank holds alike (:func:`replicate`). :func:`batch_sharding` and
:func:`replicated_sharding` name these layouts, as the JAX package's
``NamedSharding`` s do, and cut a tensor that every rank built alike down to
this rank's block. The sequence-sharded functions
(:mod:`~dasp_tpu_torch.parallel.sharded`) take and return such blocks: what
the body of the JAX package's ``shard_map`` sees.

The collectives live here, each an autograd Function with its transpose
written out:

  * :func:`shift`, the neighbour shift along an axis (``lax.ppermute`` of
    the JAX package's halo exchanges): the ranks at the edge receive zeros;
    its transpose is the shift the other way;
  * :func:`all_gather` (``lax.all_gather``): its transpose sums the
    cotangent over the ranks and keeps this rank's slice;
  * :func:`psum` (``lax.psum``): a sum that every rank then holds and only
    the replicated loss consumes, so its transpose is the identity (each
    rank holds the whole cotangent of the one sum);
  * :func:`relay_recv` / :func:`relay_send`, the state relay of the exact
    sequence-sharded ballistics.

Gradients follow one rule: on every rank a tensor's gradient is the part of
the loss's gradient that flows through this rank's own computation. For a
tensor that every rank holds alike (the parameters, a net's output on the
ranks of one sp group) the whole gradient is the sum over the ranks, which
:func:`sum_gradients` takes after the backward; for the sp blocks and dp
slices the collectives' transposes have already routed every rank's part
to the rank that holds it.

Backends: NCCL where each rank has a card of its own, gloo for CPU ranks
and for several ranks that share one card (NCCL refuses two ranks on one
device). gloo takes CUDA tensors in ``all_reduce`` and ``broadcast``; the
other operations (``all_gather``, send and receive) are staged through host
memory here. That staging is the gloo backend's path on CUDA tensors, not a
fallback; under NCCL the same helpers call NCCL's own operations.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharding",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "shift",
    "all_gather",
    "psum",
    "relay_recv",
    "relay_send",
    "sum_gradients",
]

# the gloo operations that take CUDA tensors in place (torch.distributed's
# backend table); the others go through host memory
_GLOO_CUDA_OPS = ("all_reduce", "broadcast")


class Mesh:
    """This rank's place in a (dp, sp) layout of the world's ranks.

    ``shape`` maps each axis name to its size (``mesh.shape["dp"]``, as the
    JAX mesh's), ``index(name)`` gives this rank's position along an axis,
    ``group(name)`` the process group of the ranks that share this rank's
    other coordinate, and ``ranks(name)`` their global ranks in axis order.
    ``device`` is where this rank computes.
    """

    def __init__(self, axis_names: Tuple[str, str], shape: Tuple[int, int], rank: int,
                 groups: Dict[str, object], ranks: Dict[str, Tuple[int, ...]], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.rank = rank
        self._groups = groups
        self._ranks = ranks
        self.device = device

    def index(self, name: str) -> int:
        return self._ranks[name].index(self.rank)

    def group(self, name: str):
        return self._groups[name]

    def ranks(self, name: str) -> Tuple[int, ...]:
        return self._ranks[name]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "sp"),
    device=None,
) -> Mesh:
    """Lay the initialised world's ranks out as a (dp, sp) mesh.

    Every rank calls this in the same order (it makes one process group per
    row and per column of the layout, which every rank must join).

    Args:
        shape: (dp_size, sp_size). Default: every rank on dp, sp = 1.
        axis_names: the axes' names; ("dp", "sp") by convention.
        device: where this rank computes. Default: under NCCL the card
            ``rank % device_count``; under gloo that card too if CUDA is
            available, else the CPU.

    Raises:
        ValueError: when dp * sp is not the world's size, or a size is < 1.
        RuntimeError: under NCCL, when the world has more ranks than this
            host has cards (NCCL refuses two ranks on one card: initialise
            the world with ``backend="gloo"``).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world (init_process_group)")
    n = dist.get_world_size()
    rank = dist.get_rank()
    if shape is None:
        shape = (n, 1)
    dp, sp = shape
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh shape {shape} must have positive axis sizes")
    if dp * sp != n:
        raise ValueError(
            f"mesh shape (dp={dp}, sp={sp}) needs dp*sp={dp * sp} devices but "
            f"{n} were given; pass shape=({n}, 1) / ({n // sp if sp and n % sp == 0 else '?'}, {sp}) "
            f"or a world of {dp * sp} ranks"
        )
    backend = dist.get_backend()
    if backend == "nccl":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        if local > cards:
            raise RuntimeError(
                f"NCCL world of {local} ranks on a host with {cards} CUDA card(s): NCCL refuses two ranks "
                f'on one card; initialise the world with backend="gloo" to share a card'
            )
    if device is None:
        if torch.cuda.is_available():
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"NCCL ranks compute on CUDA cards, not {device}")
    groups, ranks = {}, {}
    dp_name, sp_name = axis_names
    # every rank creates every group, in the same order
    for i in range(dp):
        row = tuple(i * sp + j for j in range(sp))
        g = dist.new_group(list(row))
        if rank in row:
            groups[sp_name], ranks[sp_name] = g, row
    for j in range(sp):
        col = tuple(i * sp + j for i in range(dp))
        g = dist.new_group(list(col))
        if rank in col:
            groups[dp_name], ranks[dp_name] = g, col
    return Mesh(axis_names, (dp, sp), rank, groups, ranks, device)


class Sharding:
    """Which mesh axis splits each leading dimension of a tensor, as the JAX
    package's ``NamedSharding(mesh, PartitionSpec(*spec))``: ``spec[i]`` is an
    axis name or None. Torch has no global arrays; :meth:`block` cuts a
    tensor that every rank holds alike down to this rank's block."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            n = self.mesh.shape[name]
            if x.shape[dim] % n:
                what = "batch size" if name == self.mesh.axis_names[0] else f"axis {dim} of length"
                raise ValueError(
                    f"{what} {x.shape[dim]} is not divisible by the mesh's {name} axis "
                    f"({n} devices); pad it to a multiple of {n} or use a mesh with {name} dividing it"
                )
            size = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.index(name) * size, size)
        return x


def batch_sharding(mesh: Mesh, batch_axis: int = 0) -> Sharding:
    """The layout that splits ``batch_axis`` over the mesh's dp axis."""
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = mesh.axis_names[0]
    return Sharding(mesh, spec)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """The layout in which every rank holds the whole tensor."""
    return Sharding(mesh, ())


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's dp slice of a (batch, ...) tensor that every rank built
    alike (e.g. from the same seed).

    Raises ValueError when the batch does not divide over the dp axis.
    """
    dp = mesh.shape[mesh.axis_names[0]]
    if x.shape[0] % dp != 0:
        raise ValueError(
            f"batch size {x.shape[0]} is not divisible by the mesh's dp axis "
            f"({dp} devices); pad the batch to a multiple of {dp} or use a "
            f"mesh with dp dividing the batch"
        )
    return batch_sharding(mesh).block(x)


def _tensors(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(tree, mesh: Mesh, src: int = 0):
    """Make every rank hold rank ``src``'s values of a module's parameters
    and buffers, or of the tensors of a pytree (dicts, lists, tuples), in
    place; returns ``tree``."""
    with torch.no_grad():
        for t in _tensors(tree):
            _broadcast_raw(t, src)
    return tree


# ---------------------------------------------------------------------------
# raw operations (no autograd), gloo's CUDA tensors staged through the host
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group, op: str) -> bool:
    return t.is_cuda and op not in _GLOO_CUDA_OPS and dist.get_backend(group) == "gloo"


def _broadcast_raw(t: torch.Tensor, src: int) -> None:
    if _staged(t, None, "broadcast"):
        h = t.detach().cpu()
        dist.broadcast(h, src)
        t.copy_(h)
    else:
        dist.broadcast(t.data, src)


def _all_reduce_raw(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of a fresh copy of ``t``."""
    out = t.detach().clone().contiguous()
    if _staged(out, group, "all_reduce"):
        h = out.cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    dist.all_reduce(out, group=group)
    return out


def _all_gather_raw(t: torch.Tensor, group) -> list:
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src, group, "all_gather"):
        h = src.cpu()
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def _p2p(send: Optional[torch.Tensor], dst: Optional[int], recv_like: Optional[torch.Tensor],
         src: Optional[int], group) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive a tensor shaped as
    ``recv_like`` from global rank ``src`` (either may be None), both
    posted before either is waited on."""
    ops, out, stage = [], None, None
    if send is not None:
        payload = send.detach().contiguous()
        if _staged(payload, group, "send"):
            payload = payload.cpu()
        ops.append(dist.P2POp(dist.isend, payload, dst, group=group))
    if recv_like is not None:
        out = torch.empty_like(recv_like, memory_format=torch.contiguous_format)
        stage = out.cpu() if _staged(out, group, "recv") else out
        ops.append(dist.P2POp(dist.irecv, stage, src, group=group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if out is not None and stage is not out:
        out.copy_(stage)
    return out


def _neighbour(group, offset: int) -> Optional[int]:
    """The global rank ``offset`` places along the group's order, or None
    past its edges."""
    k = dist.get_rank(group) + offset
    if 0 <= k < dist.get_world_size(group):
        return dist.get_global_rank(group, k)
    return None


# ---------------------------------------------------------------------------
# the collectives, with their transposes
# ---------------------------------------------------------------------------


def _shift_raw(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Rank k's x lands on rank k + offset; ranks with no source get zeros."""
    dst, src = _neighbour(group, offset), _neighbour(group, -offset)
    got = _p2p(x if dst is not None else None, dst, x if src is not None else None, src, group)
    return got if got is not None else torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift_raw(x, group, offset)

    @staticmethod
    def backward(ctx, ct):
        return _shift_raw(ct, ctx.group, -ctx.offset), None, None


def shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """Each rank's ``x`` moved ``offset`` places along ``group`` (+1: to the
    right neighbour, as the JAX package's halo ``ppermute``); the ranks with
    no neighbour on that side receive zeros. Transpose: the shift back."""
    if dist.get_world_size(group) == 1:
        return torch.zeros_like(x)
    return _Shift.apply(x, group, offset)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(_all_gather_raw(x, group), dim=dim)

    @staticmethod
    def backward(ctx, ct):
        total = _all_reduce_raw(ct, ctx.group)
        k = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, k * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along ``group``, in rank order: stacked on a new
    leading axis, or with ``tiled`` concatenated along ``dim`` (the JAX
    package's ``lax.all_gather(..., tiled=True)``). Transpose: the
    cotangent summed over the ranks, this rank's slice."""
    if not tiled:
        return _AllGather.apply(x.unsqueeze(0), group, 0)
    return _AllGather.apply(x, group, dim % x.ndim)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, which every rank then holds.

    The sum is the one value that a replicated loss is made of: every rank
    differentiates the same scalar from the same seed, so the gradient of
    the sum with respect to each rank's term is the sum's own cotangent, not
    the world's size and not a second all-reduce (the JAX package's psum
    into a replicated output). Where a rank consumes a sum in its own
    computation (a batch statistic), sum :func:`all_gather`'s result
    instead, whose transpose sums the ranks' parts."""
    return _Psum.apply(x, group)


# the state relay of the exact sequence-sharded ballistics: rank k waits for
# rank k-1's final state, runs its block, and hands its own final state on


class _RelayRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, like, group, *anchors):
        ctx.group, ctx.n_anchors = group, len(anchors)
        src = _neighbour(group, -1)
        if src is None:
            return torch.zeros_like(like)
        return _p2p(None, None, like, src, group)

    @staticmethod
    def backward(ctx, dy0):
        dst = _neighbour(ctx.group, -1)
        if dst is not None:
            _p2p(dy0, dst, None, None, ctx.group)
        return (None, None) + (None,) * ctx.n_anchors


class _RelaySend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, yf, group):
        ctx.group = group
        dst = _neighbour(group, 1)
        if dst is not None:
            _p2p(yf, dst, None, None, group)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, ct):
        src = _neighbour(ctx.group, 1)
        if src is not None:
            ct = ct.clone()
            ct[..., -1] += _p2p(None, None, ct[..., -1], src, ctx.group)
        return ct, None, None


def relay_recv(like: torch.Tensor, group, *anchors: torch.Tensor) -> torch.Tensor:
    """The state that rank k-1 of ``group`` sends with :func:`relay_send`
    (zeros on rank 0), shaped as ``like``. Its gradient is sent back to rank
    k-1, which adds it to its final sample's. ``anchors`` are the tensors
    the state's consumer differentiates with respect to: they tie this step
    into the graph, so that autograd runs the send back."""
    return _RelayRecv.apply(like, group, *anchors)


def relay_send(y: torch.Tensor, yf: torch.Tensor, group) -> torch.Tensor:
    """Send the final state ``yf`` to rank k+1 of ``group`` (nothing from
    the last rank) and return ``y`` unchanged. The send has no output of its
    own, so it rides on ``y``: its backward receives the gradient of rank
    k+1's incoming state and adds it to ``y[..., -1]``'s cotangent."""
    return _RelaySend.apply(y, yf, group)


def sum_gradients(params, group=None) -> None:
    """Sum each parameter's ``.grad`` over ``group`` (None: the world), in
    place: the whole gradient of a tensor that every rank holds alike, the
    transpose of its replication (see the module docstring). Parameters
    without a gradient are skipped alike on every rank."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():  # one all-reduce per dtype
        total = _all_reduce_raw(torch.cat([g.reshape(-1) for g in grads]), group)
        offset = 0
        for g in grads:
            g.copy_(total[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
