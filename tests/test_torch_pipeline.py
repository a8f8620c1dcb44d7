"""dasp_tpu_torch.utils.pipeline against dasp_tpu.utils.pipeline.

The wire encodings are bitwise the JAX package's: the i16 payload and its
inverse scale, and the bf16 bits (round to nearest even), on PCM-grid and
general float leaves. ``BatchPacker``'s buffer is bitwise JAX's on a tree
whose odd-sized quantized leaf puts the raw32, int16 and 0-d leaves after it
at odd offsets, and each package decodes the other's buffer (the PCM leaf
exactly, the raw leaves bitwise). ``reservoir_put`` equals JAX's
``dynamic_update_slice`` at several write offsets, the clamped one included.
``device_prefetch`` runs here with ``device="cpu"``: its batches equal its
input for every wire.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasp_tpu.utils import pipeline as JP
from dasp_tpu_torch.utils import pipeline as TP


def pcm(rng, shape):
    return (rng.integers(-32768, 32768, shape) / 32768.0).astype(np.float32)


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "audio": pcm(rng, (1, 1, 8193)),                        # q16, odd size
        "b": [rng.standard_normal(5).astype(np.float32),        # raw32 at an odd offset
              rng.integers(-9, 9, 7).astype(np.int16)],         # raw16
        "c": np.float32(rng.standard_normal()),                 # 0-d raw32
        "d": rng.integers(0, 2 ** 31, 3).astype(np.int32),
        "e": rng.integers(0, 2 ** 32, 3, dtype=np.uint32),
    }


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_tree_equal(a, b)
    else:
        a, b = as_np(got), np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["pcm", "peak<=1", "wide"])
def test_wire_i16_bitwise(kind):
    rng = np.random.default_rng(1)
    x = {"pcm": pcm(rng, (3, 4096)), "peak<=1": np.tanh(rng.standard_normal((3, 4096))).astype(np.float32),
         "wide": (rng.standard_normal((3, 4096)) * 4).astype(np.float32)}[kind]
    b = {"x": x, "small": np.ones(8, np.float32)}
    ej, et = JP.wire_encode(b, "i16"), TP.wire_encode(b, "i16")
    np.testing.assert_array_equal(et["x"][TP._WIRE_I16], ej["x"][JP._WIRE_I16])
    assert et["x"]["inv_scale"].tobytes() == ej["x"]["inv_scale"].tobytes()
    assert et["small"] is b["small"]
    dt, dj = TP.wire_decode(ej)["x"].numpy(), np.asarray(JP.wire_decode(et)["x"])
    np.testing.assert_array_equal(dt, dj)
    if kind == "pcm":
        np.testing.assert_array_equal(dt, x)
    q, inv = TP.wire_i16_parts(et["x"])
    np.testing.assert_array_equal((torch.tensor(q).float() / torch.tensor(inv)).numpy(), dt)
    with pytest.raises(ValueError, match="not an 'i16'"):
        TP.wire_i16_parts({"x": x})


def test_wire_bf16_bitwise_round_to_nearest_even():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 4096)).astype(np.float32)
    # ties: the low 16 bits exactly 0x8000, with even and odd upper halves
    x.view(np.uint32)[0, :8] = (np.arange(8, dtype=np.uint32) + 0x3F80) << 16 | 0x8000
    et, ej = TP.wire_encode({"x": x}, "bf16"), JP.wire_encode({"x": x}, "bf16")
    bt = et["x"][TP._WIRE_BF16]
    assert bt.dtype == torch.bfloat16
    np.testing.assert_array_equal(bt.view(torch.int16).numpy(), ej["x"][JP._WIRE_BF16].view(np.int16))
    np.testing.assert_array_equal(TP.wire_decode(et)["x"].numpy(), np.asarray(JP.wire_decode(ej)["x"]))
    assert TP.wire_encode({"x": x}, "f32")["x"] is x
    with pytest.raises(ValueError, match="unknown wire"):
        TP.wire_encode({"x": x}, "f16")


def test_batch_packer_buffer_bitwise_and_cross_decode():
    b = tree()
    pj, pt = JP.BatchPacker(b), TP.BatchPacker(b)
    assert pt.spec == pj.spec and pt.num_i16 == pj.num_i16 and pt.nbytes == pj.nbytes
    # leaves in JAX's order (dict keys sorted): the raw32 and int16 leaves
    # after the odd-sized quantized one start at odd offsets
    assert [(mode, off) for _, _, mode, off, _ in pt.spec] == [
        ("q16", 0), ("raw32", 8195), ("raw16", 8205), ("raw32", 8212), ("raw32", 8214), ("raw32", 8220)]
    buf_j, buf_t = pj.encode(b), pt.encode(b)
    np.testing.assert_array_equal(buf_t, buf_j)
    assert_tree_equal(pt.decode(torch.from_numpy(buf_j)), b)
    assert_tree_equal(pt.decode(buf_j), b)
    assert_tree_equal({k: v for k, v in pj.decode(jnp.asarray(buf_t)).items()}, b)


def test_batch_packer_errors():
    b = tree()
    pt = TP.BatchPacker(b)
    bad = dict(b, audio=b["audio"][:, :, :-1])
    with pytest.raises(ValueError, match="leaf changed"):
        pt.encode(bad)
    with pytest.raises(ValueError, match="structure"):
        pt.encode({k: v for k, v in b.items() if k != "c"})
    with pytest.raises(TypeError, match="unsupported leaf"):
        TP.BatchPacker({"x": np.zeros(3, np.float64)})


@pytest.mark.parametrize("ptr", [0, 2, 4, 6, 7, -1])
def test_reservoir_put_matches_jax(ptr):
    store = np.arange(8 * 3, dtype=np.int16).reshape(8, 3)
    fresh = -np.arange(1, 7, dtype=np.int16).reshape(2, 3)
    sj, pj = JP.reservoir_put(jnp.asarray(store), jnp.asarray(fresh), ptr)
    st, pt = TP.reservoir_put(torch.tensor(store), torch.tensor(fresh), ptr)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert int(pt) == int(pj)
    st2, pt2 = TP.reservoir_put(torch.tensor(store), torch.tensor(fresh), torch.tensor(ptr))
    np.testing.assert_array_equal(st2.numpy(), np.asarray(sj))
    assert int(pt2) == int(pj)


def test_reservoir_layout_error_and_sample():
    with pytest.raises(ValueError, match="multiple of the fresh-rows count"):
        TP.reservoir_put(torch.zeros(8, 2), torch.zeros(3, 2), 0)
    store = torch.arange(10.0)[:, None].expand(10, 4).contiguous()
    gen = torch.Generator().manual_seed(0)
    out = TP.reservoir_sample(store, gen, 6)
    assert out.shape == (6, 4) and torch.equal(out[:, :1].expand(6, 4), out)
    assert set(out[:, 0].tolist()) <= set(range(10))
    again = TP.reservoir_sample(store, torch.Generator().manual_seed(0), 6)
    assert torch.equal(out, again)


def test_threaded_iterator_values_and_error():
    got = list(TP.threaded_iterator(lambda wid: iter(range(5)), num_workers=1))
    assert got == list(range(5)) == list(JP.threaded_iterator(lambda wid: iter(range(5)), num_workers=1))
    merged = sorted(TP.threaded_iterator(lambda wid: iter(range(wid * 10, wid * 10 + 3)), num_workers=3))
    assert merged == [0, 1, 2, 10, 11, 12, 20, 21, 22]

    def boom(wid):
        yield 1
        raise RuntimeError("worker failed")

    it = TP.threaded_iterator(boom, num_workers=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="worker failed"):
        next(it)


def _batches(n=4):
    return [tree(seed) for seed in range(n)]


@pytest.mark.parametrize("wire", ["f32", "i16", "bf16", "packer"])
@pytest.mark.parametrize("upload_thread", [False, True])
def test_device_prefetch_on_cpu_equals_input(wire, upload_thread):
    src = _batches()
    w = TP.BatchPacker(src[0]) if wire == "packer" else wire
    out = list(TP.device_prefetch(iter(src), size=3, device="cpu", wire=w, upload_thread=upload_thread))
    assert len(out) == len(src)
    for got, want in zip(out, src):
        if wire == "bf16":
            want = dict(want, audio=torch.from_numpy(want["audio"]).bfloat16().float().numpy())
        assert_tree_equal(got, want)
    raw = list(TP.device_prefetch(iter(src), size=2, device="cpu", wire=w, decode_on_yield=False))
    if wire == "packer":
        assert all(r.dtype == torch.int16 and r.shape == (w.num_i16,) for r in raw)
        assert_tree_equal(w.decode(raw[1]), src[1])


def test_device_prefetch_errors():
    def bad():
        yield _batches(1)[0]
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        list(TP.device_prefetch(bad(), device="cpu", upload_thread=True))
    with pytest.raises(ValueError, match="size"):
        next(TP.device_prefetch(iter([]), size=0, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(TP.device_prefetch(iter(_batches(1))))
