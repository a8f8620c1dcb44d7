"""Host input pipeline: threaded batch production and staged copies to the
card.

PyTorch counterpart of ``dasp_tpu/utils/pipeline.py``. Two composable
pieces:

* :func:`threaded_iterator` — N daemon threads each run their own batch
  source (host-side numpy work: synthesis, wav decode, slicing) into a
  bounded queue. Threads suffice: the hot host work is numpy and the native
  loader, which release the GIL.
* :func:`device_prefetch` — keeps the next ``size`` batches in flight to
  the card: each batch is staged in pinned host memory and copied with
  ``non_blocking=True`` on a side CUDA stream, so the copy overlaps the
  current step's compute.

Typical use::

    it = device_prefetch(threaded_iterator(make_source, num_workers=4))
    for batch in it:          # batch is already on the card
        step(batch)

Batches are pytrees: dicts, lists and tuples of arrays (numpy arrays, numpy
scalars or torch tensors). Ordering across workers is first-come
(nondeterministic under load); give each worker an independently seeded RNG.

Wire formats shrink the bytes of the host-to-device copy. Audio datasets
are 16-bit PCM on disk, so an int16 wire is bit-exact for file-backed
training at half the fp32 bytes; bf16 halves the bytes of synthetic float
sources at about 3 significant digits. Encode runs on the host (numpy),
decode on the card. :class:`BatchPacker` ships a whole batch as one int16
buffer whose layout is the JAX package's, bit for bit, so either package
decodes the other's buffer.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

__all__ = ["threaded_iterator", "device_prefetch", "wire_encode",
           "wire_decode", "wire_i16_parts", "BatchPacker", "reservoir_put",
           "reservoir_sample"]

# Wire markers live in dict keys (the tree's structure), never as string
# leaves, so an encoded tree moves to the device leaf by leaf unchanged.
_WIRE_BF16 = "__dasp_wire_bf16__"
_WIRE_I16 = "__dasp_wire_i16__"
_WIRE_MIN_BYTES = 1 << 14  # leaves under 16 KiB are not re-encoded


# ---------------------------------------------------------------------------
# pytrees: dicts (keys in sorted order, as JAX flattens them), lists and
# tuples; None is an empty subtree; anything else is a leaf


def _tree_map(fn: Callable, tree, is_leaf: Optional[Callable] = None):
    """``fn`` applied to every leaf of ``tree``, the structure kept."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _flatten(tree, leaves: list):
    """Append the leaves of ``tree`` to ``leaves`` in JAX's order; return its
    structure (the tree with every leaf replaced by ``...``)."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return ...


def _unflatten(structure, leaves: Iterator):
    if isinstance(structure, dict):
        return {k: _unflatten(v, leaves) for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(v, leaves) for v in structure)
    if structure is None:
        return None
    return next(leaves)


def _is_wire_leaf(x) -> bool:
    return isinstance(x, dict) and (_WIRE_BF16 in x or _WIRE_I16 in x)


# ---------------------------------------------------------------------------
# wire formats


def _encode_leaf(x, wire: str):
    if not (isinstance(x, np.ndarray) and x.dtype == np.float32
            and x.nbytes >= _WIRE_MIN_BYTES):
        return x
    if wire == "bf16":
        # torch's float -> bfloat16 conversion rounds to nearest even, as
        # the JAX package's ml_dtypes cast does
        return {_WIRE_BF16: torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)}
    if wire == "i16":
        q, inv = _quantize_i16(x)
        return {_WIRE_I16: q, "inv_scale": inv}
    raise ValueError(f"unknown wire format {wire!r} (use 'f32', 'bf16', 'i16')")


def _quantize_i16(x: np.ndarray):
    """(int16 payload, f32 inverse scale) for a float32 array.

    PCM-grid scales, chosen so that 16-bit-PCM-sourced audio round-trips
    bit-exactly: wav loaders divide by 32768 (ours, utils.audio.load_wav;
    a power of two, so m/32768 and the encode m/32768*32768 are both exact
    in fp32) or by 32767 (m/32767 re-rounds to the same f32 after the round
    trip). Pick 32768 when the data fits its grid, else 32767 when it fits
    [-1, 1]; larger-range floats fall back to a per-array max-abs scale
    (error <= peak/65534). The inverse scale ships and decode divides by it:
    multiplying by a rounded reciprocal would be off in the last ulp.
    """
    mx = float(np.max(x)) if x.size else 0.0
    mn = float(np.min(x)) if x.size else 0.0
    peak = max(mx, -mn)
    if mx <= 32767.0 / 32768.0 and mn >= -1.0:
        inv = np.float32(32768.0)  # int16 is asymmetric: -32768 fits
    elif peak <= 1.0:
        inv = np.float32(32767.0)
    else:
        inv = np.float32(32767.0 / peak * (1 - 1e-7))
    return np.round(x * inv).astype(np.int16), inv


def wire_encode(batch, wire: str = "i16"):
    """Re-encode the large float32 numpy leaves of a batch pytree for the
    copy to the card.

    Host-side. ``wire='i16'`` halves the bytes and is bit-exact for
    16-bit-PCM-sourced audio; ``'bf16'`` halves them at reduced mantissa (a
    CPU ``torch.bfloat16`` tensor, rounded to nearest even); ``'f32'`` is
    the identity. Leaves under 16 KiB, and leaves that are not float32
    numpy arrays, pass through unchanged. Decode with :func:`wire_decode`.
    """
    if wire == "f32":
        return batch
    return _tree_map(lambda x: _encode_leaf(x, wire), batch)


def wire_i16_parts(leaf):
    """(int16 payload, f32 inverse scale) of an ``'i16'``-wire-encoded leaf.

    For consumers that keep the quantized form on the card (e.g. an int16
    clip reservoir, half the memory of f32) instead of decoding on arrival:
    dequantize later with ``payload.float() / inv_scale``, with
    ``inv_scale`` a tensor on the payload's device (a Python or CPU scalar
    divisor lets PyTorch multiply by its reciprocal on the card instead).
    """
    if not (_is_wire_leaf(leaf) and _WIRE_I16 in leaf):
        raise ValueError("leaf is not an 'i16' wire-encoded leaf")
    return leaf[_WIRE_I16], leaf["inv_scale"]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def wire_decode(batch):
    """Decode a :func:`wire_encode`'d pytree back to float32 tensors, on the
    device its leaves lie on (numpy leaves decode on the CPU)."""
    def dec(x):
        if not _is_wire_leaf(x):
            return x
        if _WIRE_BF16 in x:
            return _as_tensor(x[_WIRE_BF16]).to(torch.float32)
        q = _as_tensor(x[_WIRE_I16])
        # a true divide by a tensor on q's device (see wire_i16_parts)
        return q.to(torch.float32) / _as_tensor(x["inv_scale"]).to(q.device)
    return _tree_map(dec, batch, is_leaf=_is_wire_leaf)


_RAW32 = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint32): torch.uint32}


class BatchPacker:
    """Pack a whole batch pytree into ONE contiguous int16 wire buffer.

    The per-leaf wire (:func:`wire_encode`) still copies each leaf as its
    own buffer, so one training batch costs several copies a step. Packing
    makes the whole batch one copy of one contiguous buffer.

    Layout (int16 units), the JAX package's bit for bit: leaves in the
    order JAX flattens the tree (dict keys sorted). float32 leaves >=
    ``quantize_min_bytes`` are int16-quantized (bit-exact for PCM16-grid
    audio, see :func:`_quantize_i16`) and prefixed with their f32 inverse
    scale (2 slots); smaller float32, int32 and uint32 leaves are bit-cast
    raw (2 slots an element); int16 leaves pass through. No padding: after
    a quantized leaf of odd size, the next leaf starts at an odd offset.
    The structure, shapes and offsets are fixed at construction from an
    example batch.

    Usage::

        packer = BatchPacker(example_batch)
        pipe = device_prefetch(it, size=3, wire=packer, decode_on_yield=False)
        for buf in pipe:
            batch = packer.decode(buf)
    """

    def __init__(self, example, quantize_min_bytes: int = _WIRE_MIN_BYTES):
        leaves: list = []
        self.structure = _flatten(example, leaves)
        spec = []
        off = 0
        for i, leaf in enumerate(leaves):
            x = np.asarray(leaf)
            if x.dtype == np.float32 and x.nbytes >= quantize_min_bytes:
                mode, n = "q16", 2 + x.size
            elif x.dtype in (np.float32, np.int32, np.uint32):
                mode, n = "raw32", 2 * x.size
            elif x.dtype == np.int16:
                mode, n = "raw16", x.size
            else:
                raise TypeError(
                    f"BatchPacker: unsupported leaf {i} dtype {x.dtype} "
                    "(supported: float32, int32, uint32, int16)")
            spec.append((x.shape, x.dtype, mode, off, n))
            off += n
        self.spec = tuple(spec)
        self.num_i16 = off
        self.nbytes = 2 * off

    def encode(self, batch) -> np.ndarray:
        """Host-side: batch pytree -> one (num_i16,) int16 numpy buffer."""
        leaves: list = []
        if _flatten(batch, leaves) != self.structure:
            raise ValueError("BatchPacker: the batch's tree structure differs from the example's")
        buf = np.empty(self.num_i16, np.int16)
        for leaf, (shape, dtype, mode, off, n) in zip(leaves, self.spec):
            x = np.asarray(leaf, order="C")  # keeps 0-d leaves 0-d
            if x.shape != shape or x.dtype != dtype:
                raise ValueError(
                    f"BatchPacker: leaf changed from example: got "
                    f"{x.dtype}{x.shape}, spec says {dtype}{shape}")
            if mode == "q16":
                q, inv = _quantize_i16(x)
                buf[off:off + 2] = inv.reshape(1).view(np.int16)
                buf[off + 2:off + n] = q.ravel()
            elif mode == "raw32":
                buf[off:off + n] = x.ravel().view(np.int16)
            else:  # raw16
                buf[off:off + n] = x.ravel()
        return buf

    def decode(self, buf):
        """int16 wire buffer (a tensor on any device, or numpy) -> the batch
        pytree, as tensors on the buffer's device.

        float32 leaves come back exactly for PCM16-grid data (q16) and
        bit-exactly for raw32 leaves. A 32-bit value at an odd int16 offset
        cannot be viewed in place (a float32 view needs an even storage
        offset), so such a segment is copied first.
        """
        buf = _as_tensor(buf)
        leaves = []
        for shape, dtype, mode, off, n in self.spec:
            seg = buf[off:off + n]
            if mode == "q16":
                inv = _bits32(seg[:2], torch.float32)  # a 1-element tensor on buf's device
                leaves.append((seg[2:].to(torch.float32) / inv).reshape(shape))
            elif mode == "raw32":
                leaves.append(_bits32(seg, _RAW32[np.dtype(dtype)]).reshape(shape))
            else:  # raw16
                leaves.append(seg.reshape(shape))
        return _unflatten(self.structure, iter(leaves))


def _bits32(seg: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The int16 pairs of ``seg`` read as 32-bit values (little-endian
    halves, as the encoder wrote them)."""
    if seg.storage_offset() % 2 or not seg.is_contiguous():
        seg = seg.clone()
    return seg.view(dtype)


# ---------------------------------------------------------------------------
# A clip reservoir on the card: stream a fraction of each batch fresh.
#
# Where the host-to-device link limits training, shipping every sample of
# every batch caps the step rate at link bandwidth / batch bytes however
# well copies overlap compute. A device-side shuffle buffer keeps R clips
# resident (int16: half the bytes of f32), streams F fresh clips a step
# into a rotating window, and gathers each batch from random rows: the
# bytes copied a step drop by bs / F, and each clip is used about bs / F
# times before it is evicted (after R / F steps). For self-supervised
# corruption training the corruption is redrawn each step, so a re-sampled
# clip never gives the same training pair twice.
# ---------------------------------------------------------------------------


def reservoir_put(store: torch.Tensor, fresh: torch.Tensor, ptr):
    """Rotate ``fresh`` (F leading rows) into the ring buffer at ``ptr``.

    Args:
        store: the ring buffer, shape ``(R, ...)`` (any dtype; int16 for PCM
            audio). Updated in place.
        fresh: newly streamed rows, shape ``(F, ...)``, F <= R, on
            ``store``'s device. R must be a multiple of F so the rotating
            window never wraps.
        ptr: the current write offset: an int, or an integer tensor (on the
            card too: no host sync). As JAX's ``dynamic_update_slice`` takes
            its start: a negative offset counts from the end, and the start
            is clamped to [0, R - F].

    Returns:
        ``(store, ptr)``: the updated buffer and the next write offset,
        ``(ptr + F) % R``.
    """
    rows, f = store.shape[0], fresh.shape[0]
    if rows % f:
        # a clamped wrapping write would land at row R - F and overwrite
        # the wrong rows; both shapes are known, so reject the layout
        raise ValueError(
            f"reservoir size {rows} must be a multiple of the "
            f"fresh-rows count {f} (the rotating write window "
            f"must never wrap)")
    start = torch.as_tensor(ptr, device=store.device)
    start = torch.where(start < 0, start + rows, start).clamp(0, rows - f)
    idx = start + torch.arange(f, device=store.device)
    store.index_copy_(0, idx, fresh)
    return store, (ptr + f) % rows


def reservoir_sample(store: torch.Tensor, generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """Gather ``batch_size`` uniformly random rows from the reservoir.

    ``generator`` must live on ``store``'s device (a CUDA generator for a
    reservoir on the card: ``torch.randint`` refuses a CPU generator for a
    CUDA draw). The JAX package takes a PRNG key here.
    """
    idx = torch.randint(0, store.shape[0], (batch_size,), generator=generator, device=store.device)
    return store.index_select(0, idx)


# ---------------------------------------------------------------------------
# iterators


def threaded_iterator(
    source_factory: Callable[[int], Iterator],
    num_workers: int = 2,
    prefetch: int = 4,
) -> Iterator:
    """Merge batches from ``num_workers`` threaded sources into one stream.

    Args:
        source_factory: called once per worker with the worker id; must
            return an iterator of batches. Seed any RNG from the id so
            workers don't duplicate data.
        num_workers: number of producer threads.
        prefetch: max batches buffered ahead of the consumer.

    Yields:
        Batches in arrival order. A worker whose source raises re-raises
        the exception at the consumer on the next pull; a worker whose
        source is exhausted just stops contributing (iteration ends once
        all workers are done and the buffer drains).
    """
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _DONE = object()

    def worker(wid: int):
        try:
            for b in source_factory(wid):
                q.put(b)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
            q.put((_DONE, e))
            return
        q.put((_DONE, None))

    for w in range(num_workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()

    done = 0
    while done < num_workers:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _DONE:
            done += 1
            if item[1] is not None:
                raise item[1]
            continue
        yield item


def _prefetch_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name one, or pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class _Staged:
    """One batch in flight: its tree on the device, the event that marks the
    end of its copies (None on the CPU), and the pinned host buffers, kept
    alive until that event has completed."""

    def __init__(self, tree, event, pinned):
        self.tree, self.event, self.pinned = tree, event, pinned


def _stage(batch, device: torch.device, stream) -> _Staged:
    """Start the copy of ``batch``'s array leaves to ``device``.

    On a CUDA device each leaf is staged in pinned host memory and copied
    with ``non_blocking=True`` on ``stream``; an event recorded there after
    the copies marks their end. On the CPU the leaves are copied at once.
    """
    pinned: list = []

    def put(x):
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)  # keeps 0-d leaves 0-d
            x = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
        elif not isinstance(x, torch.Tensor):
            return x
        if device.type != "cuda":
            return x.to(device, copy=True)
        if x.device.type == "cpu":
            x = x.pin_memory()
            pinned.append(x)
        return x.to(device, non_blocking=True)

    if device.type != "cuda":
        return _Staged(_tree_map(put, batch), None, pinned)
    with torch.cuda.stream(stream):
        tree = _tree_map(put, batch)
        event = torch.cuda.Event()
        event.record(stream)
    return _Staged(tree, event, pinned)


def device_prefetch(it: Iterator, size: int = 2, device=None,
                    wire="f32", decode_on_yield: bool = True,
                    upload_thread: bool = False) -> Iterator:
    """Keep ``size`` batches in flight to the device ahead of the consumer.

    On the card each batch's leaves go through pinned host memory and are
    copied with ``non_blocking=True`` on a side CUDA stream, so the copies
    overlap the consumer's work. Before a batch is yielded, the consumer's
    current stream waits on the event recorded after its copies, and every
    tensor of the batch is marked with ``record_stream`` for the consumer's
    stream, so the caching allocator does not hand its memory out again
    while the consumer may still read it. Each pinned staging buffer is
    kept until its copy's event has completed. Works on arrays and pytrees
    of arrays.

    ``device``: where the batches go; None means the current CUDA card
    (raises without one); ``"cpu"`` copies on the host.

    ``wire`` selects the copy's encoding (see :func:`wire_encode`): ``'i16'``
    halves the bytes and is bit-exact for 16-bit-PCM-sourced audio; a
    :class:`BatchPacker` ships the whole batch as one contiguous buffer
    (the fewest copies). With ``decode_on_yield`` (the default) the batch
    is decoded on the device (plain PyTorch, on the consumer's stream), so
    consumers receive float32 pytrees whatever the wire. With
    ``decode_on_yield=False`` the consumer gets the encoded tree and calls
    :func:`wire_decode` (or ``packer.decode``) itself.

    ``upload_thread`` moves the encode and the staging onto a dedicated
    daemon thread (bounded at ``size`` staged batches), so the consumer
    thread never spends time in the copy path; with one host core it
    contends with the consumer for the GIL.
    """
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    device = _prefetch_device(device)
    if isinstance(wire, BatchPacker):
        encode, dec_fn = wire.encode, wire.decode
    elif wire != "f32":
        encode, dec_fn = (lambda b: wire_encode(b, wire)), wire_decode
    else:
        encode = dec_fn = None
    decode = dec_fn if encode is not None and decode_on_yield else (lambda b: b)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    retired: "collections.deque" = collections.deque()

    def hand_over(staged: _Staged):
        if staged.event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(staged.event)
            _tree_map(lambda t: t.record_stream(consumer) if isinstance(t, torch.Tensor) else None,
                      staged.tree)
            retired.append(staged)
            while retired and retired[0].event.query():
                retired.popleft()  # its copies are done: release the pinned buffers
        return decode(staged.tree)

    def stage(b) -> _Staged:
        return _stage(encode(b) if encode is not None else b, device, stream)

    if upload_thread:
        _DONE = object()
        q: "queue.Queue" = queue.Queue(maxsize=size)

        def uploader():
            try:
                for b in it:
                    q.put(stage(b))
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put((_DONE, e))
                return
            q.put((_DONE, None))

        threading.Thread(target=uploader, daemon=True).start()
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _DONE:
                if item[1] is not None:
                    raise item[1]
                return
            yield hand_over(item)

    buf: "collections.deque" = collections.deque()
    for b in it:
        buf.append(stage(b))
        if len(buf) >= size:
            yield hand_over(buf.popleft())
    while buf:
        yield hand_over(buf.popleft())
