"""dasp_tpu_torch.utils' host side against dasp_tpu.utils: wav I/O, dataset
indexing, clip loading, metrics, checkpoints, debug checks, datasets and the
exported names.

Wav files written by either package (and by scipy in 16-, 24- and 32-bit
PCM and 32- and 64-bit float) are read by the other bitwise, whole and in
ranges past EOF (zero fill), on the native path and on the Python fallback
(``native.available`` patched to False in both packages). Indexing, chunk
peaks and batch loading (mono mix; stereo with ``pad_mode="repeat"``) equal
the JAX package's bitwise. The datasets tests are tests/test_datasets.py's,
run on both packages' modules against the same local HTTP server on
127.0.0.1 (nothing is downloaded); a manifest written by one package
verifies in the other without re-hashing.
"""

import json
import os

import numpy as np
import pytest
import torch

import dasp_tpu.utils as JU
import dasp_tpu_torch.utils as TU
from dasp_tpu import native as jnative
from dasp_tpu.utils import audio as jaudio
from dasp_tpu.utils import datasets as jdatasets
from dasp_tpu.utils import debug as jdebug
from dasp_tpu.utils import logging as jlogging
from dasp_tpu_torch import native as tnative
from dasp_tpu_torch.utils import audio as taudio
from dasp_tpu_torch.utils import datasets as tdatasets
from dasp_tpu_torch.utils import debug as tdebug
from dasp_tpu_torch.utils import logging as tlogging
from test_datasets import _body, _zip_bytes, server  # noqa: F401 - the local HTTP server fixture
from test_native import _write_wav24

SR = 44100
PATHS = ["native", "fallback"]


def use_path(path, monkeypatch):
    if path == "native":
        assert jnative.available() and tnative.available()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)


def test_native_library_builds_outside_the_source_tree():
    assert tnative.available()
    lib = tnative.lib_path()
    assert lib.exists() and lib.parent.name == "_build" and lib.parent.parent.name == "dasp_tpu_torch"
    assert tnative._get().dasp_abi_version() == tnative._ABI == 1


def test_exported_names_match():
    assert sorted(TU.__all__) == sorted(JU.__all__) and len(TU.__all__) == 40
    for name in TU.__all__:
        assert getattr(TU, name) is not None
    fields = lambda d: {k: (v.name, v.files, v.sha256, v.sizes, v.archives) for k, v in d.items()}  # noqa: E731
    assert fields(TU.DATASETS) == fields(JU.DATASETS)


def _pcm(rng, frames, ch, scale=0.5):
    return np.clip(rng.standard_normal((frames, ch)) * scale, -1, 1)


def _write(path, kind, rng, frames=3000, ch=2):
    """A wav of ``kind`` written by scipy (or the 24-bit writer)."""
    from scipy.io import wavfile

    x = _pcm(rng, frames, ch)
    if kind == "int16":
        wavfile.write(path, SR, np.round(x * 32767).astype(np.int16))
    elif kind == "int32":
        wavfile.write(path, SR, np.round(x * 2147483647).astype(np.int32))
    elif kind == "pcm24":
        _write_wav24(path, x.astype(np.float32), SR)
    elif kind == "float32":
        wavfile.write(path, SR, x.astype(np.float32))
    else:
        wavfile.write(path, SR, x)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kind", ["int16", "pcm24", "int32", "float32", "float64"])
def test_load_wav_bitwise(tmp_path, kind, path, monkeypatch):
    use_path(path, monkeypatch)
    p = str(tmp_path / f"{kind}.wav")
    _write(p, kind, np.random.default_rng(0))
    (a, sa), (b, sb) = jaudio.load_wav(p), taudio.load_wav(p)
    assert sa == sb == SR and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", PATHS)
def test_save_wav_read_by_the_other_package(tmp_path, path, monkeypatch):
    use_path(path, monkeypatch)
    x = (np.random.default_rng(1).standard_normal((2, 5000)) * 0.6).astype(np.float32)  # clips past 1
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jaudio.save_wav(pj, x, SR)
    taudio.save_wav(pt, x, SR)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for p in (pj, pt):
        np.testing.assert_array_equal(jaudio.load_wav(p)[0], taudio.load_wav(p)[0])
    y = taudio.load_wav(pt)[0]
    assert np.array_equal(y * 32768, np.round(y * 32768))  # on the 16-bit grid


def test_range_reads_and_zero_fill_at_eof(tmp_path):
    p = str(tmp_path / "r.wav")
    _write(p, "int16", np.random.default_rng(2), frames=4000)
    for off, n in ((0, 4000), (500, 1000), (3500, 1000), (5000, 100)):
        a, _ = jnative.wav_read(p, offset=off, frames=n)
        b, _ = tnative.wav_read(p, offset=off, frames=n)
        np.testing.assert_array_equal(a, b)
        assert np.all(b[:, max(0, 4000 - off):] == 0.0)
    assert tnative.wav_info(p) == jnative.wav_info(p)
    with pytest.raises(RuntimeError, match="cannot open"):
        tnative.wav_info(str(tmp_path / "missing.wav"))


def _dataset(root, rng):
    """Mono and stereo int16 files, one with a silent chunk, in a subdir too."""
    os.makedirs(os.path.join(root, "sub"))
    x = _pcm(rng, 10240, 1)
    x[2048:4096] = 0.0
    from scipy.io import wavfile

    wavfile.write(os.path.join(root, "a.wav"), SR, np.round(x * 32767).astype(np.int16))
    wavfile.write(os.path.join(root, "sub", "b.wav"), SR, np.round(_pcm(rng, 9000, 2) * 32767).astype(np.int16))


@pytest.mark.parametrize("path", PATHS)
def test_index_peaks_and_clip_batches_equal_jax(tmp_path, path, monkeypatch):
    root = str(tmp_path / "ds")
    _dataset(root, np.random.default_rng(3))
    use_path(path, monkeypatch)
    idx_j, idx_t = jaudio.index_wav_dataset(root, 2048), taudio.index_wav_dataset(root, 2048)
    assert idx_j == idx_t and len(idx_t) == 8  # a.wav's chunk 1 is silent
    if path == "native":
        for f in (os.path.join(root, "a.wav"), os.path.join(root, "sub", "b.wav")):
            np.testing.assert_array_equal(jnative.chunk_peaks(f, 1024), tnative.chunk_peaks(f, 1024))
    examples = idx_t + [(idx_t[-1][0], 8000)]  # the last runs past EOF
    np.testing.assert_array_equal(jaudio.load_clip(examples[-1], 2048), taudio.load_clip(examples[-1], 2048))
    for kw in (dict(channels=1, mono_mix=True), dict(channels=2, mono_mix=False, pad_mode="repeat"),
               dict(channels=2, mono_mix=False)):
        a = jaudio.load_clip_batch(examples, 2048, **kw)
        b = taudio.load_clip_batch(examples, 2048, **kw)
        assert b.shape == (len(examples), kw["channels"], 2048)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pad_mode"):
        taudio.load_clip_batch(examples, 512, pad_mode="wrap")


def test_native_and_fallback_agree(tmp_path, monkeypatch):
    root = str(tmp_path / "ds")
    _dataset(root, np.random.default_rng(4))
    idx = taudio.index_wav_dataset(root, 1024)
    batch = taudio.load_clip_batch(idx, 1024, channels=2, mono_mix=False, pad_mode="repeat")
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert taudio.index_wav_dataset(root, 1024) == idx
    np.testing.assert_allclose(taudio.load_clip_batch(idx, 1024, channels=2, mono_mix=False, pad_mode="repeat"),
                               batch, atol=1e-7)


def test_metrics_logger_records_match_jax(tmp_path):
    lj, lt = jlogging.MetricsLogger(str(tmp_path / "j")), tlogging.MetricsLogger(str(tmp_path / "t"))
    for step, loss in ((0, 1.5), (10, 0.25)):
        lj.log(step, loss=np.float32(loss), param_l1=np.float32(loss / 2), note="x")
        lt.log(step, loss=torch.tensor(loss), param_l1=torch.tensor(loss / 2), note="x")
    rj = [json.loads(s) for s in open(lj.path)]
    rt = [json.loads(s) for s in open(lt.path)]
    assert os.path.basename(lt.path) == os.path.basename(lj.path) == "metrics.jsonl"
    assert [sorted(r) for r in rt] == [sorted(r) for r in rj]
    for a, b in zip(rj, rt):
        assert {k: v for k, v in a.items() if k != "time_s"} == {k: v for k, v in b.items() if k != "time_s"}
        assert isinstance(b["time_s"], float)


def test_checkpoint_round_trip(tmp_path):
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(net.parameters())
    net(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = {"net": net.state_dict(), "opt": opt.state_dict(), "step": 7, "extra": [np.arange(3), (1.5, None)]}
    path = str(tmp_path / "run" / "ckpt.pkl")
    assert tlogging.load_checkpoint(path) is None
    tlogging.save_checkpoint(path, state)
    assert not os.path.exists(path + ".tmp")
    back = tlogging.load_checkpoint(path)
    assert back["step"] == 7 and back["extra"][1] == (1.5, None)
    np.testing.assert_array_equal(back["extra"][0], np.arange(3))
    for k, v in net.state_dict().items():
        assert back["net"][k].device.type == "cpu" and torch.equal(back["net"][k], v)
    opt2 = torch.optim.Adam(torch.nn.Linear(3, 2).parameters())
    opt2.load_state_dict(back["opt"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"], opt.state_dict()["state"][0]["exp_avg"])
    # the JAX package's loader reads the port's file (a pickle of the same layout)
    assert jlogging.load_checkpoint(path)["step"] == 7


@pytest.mark.parametrize("bad", ["input", "output"])
def test_checked_raises_on_nan_with_jax_messages(bad):
    x = np.ones((1, 1, 64), np.float32)
    if bad == "input":
        x[0, 0, 5] = np.nan
        fn_j, fn_t = (lambda a: a * 2), (lambda a: a * 2)
    else:
        fn_j, fn_t = (lambda a: a / 0.0 * 0.0), (lambda a: a / 0.0 * 0.0)
    import jax.numpy as jnp

    with pytest.raises(Exception, match=f"{bad} contains NaN/Inf") as ej:
        jdebug.checked(fn_j)(jnp.asarray(x))
    with pytest.raises(tdebug.NumericsError, match=f"{bad} contains NaN/Inf") as et:
        tdebug.checked(fn_t)(torch.tensor(x))
    assert str(et.value) in str(ej.value)


@pytest.mark.parametrize("check,value", [("assert_normalized", [0.5, 1.5]), ("assert_normalized", [-0.1]),
                                         ("assert_finite", [1.0, float("inf")])])
def test_asserts_raise_jax_messages(check, value):
    import jax.numpy as jnp
    from jax.experimental import checkify

    err, _ = checkify.checkify(lambda p: getattr(jdebug, check)(p), errors=checkify.user_checks)(jnp.asarray(value))
    with pytest.raises(Exception) as ej:
        err.throw()
    with pytest.raises(tdebug.NumericsError) as et:
        getattr(tdebug, check)(torch.tensor(value))
    assert str(et.value) in str(ej.value)
    getattr(tdebug, check)(torch.tensor([0.25, 0.75]))  # in range and finite: no error


def test_debug_checks_pass_clean_and_catch_range():
    y = tdebug.checked(lambda a, g: a * g)(torch.ones(2, 1, 8), 0.5)
    assert torch.equal(y, torch.full((2, 1, 8), 0.5))
    tdebug.assert_finite(torch.zeros(3))
    tdebug.assert_normalized(torch.tensor([0.0, 0.5, 1.0]))
    for p in ([0.5, 1.5], [-0.1], [float("nan")]):
        with pytest.raises(tdebug.NumericsError, match="params outside \\[0, 1\\]"):
            tdebug.assert_normalized(torch.tensor(p))
    with pytest.raises(tdebug.NumericsError, match="output contains NaN/Inf"):
        tdebug.assert_finite(torch.tensor([float("inf")]))


# ---------------------------------------------------------------------------
# datasets: tests/test_datasets.py on both packages' modules

import hashlib  # noqa: E402

MODS = pytest.mark.parametrize("ds", [jdatasets, tdatasets], ids=["jax", "torch"])


@MODS
def test_fetch_full_sha256_and_skip(ds, server, tmp_path):
    body = _body()
    server.files["a.bin"] = body
    dest = str(tmp_path / "a.bin")
    assert ds.fetch(f"{server.base}/a.bin", dest, sha256=hashlib.sha256(body).hexdigest(), size=len(body)) == dest
    assert open(dest, "rb").read() == body and not os.path.exists(dest + ".partial")
    server.requests.clear()
    ds.fetch(f"{server.base}/a.bin", dest, sha256=hashlib.sha256(body).hexdigest())
    assert server.requests == []


@MODS
def test_fetch_resumes_partial_and_midstream_drop(ds, server, tmp_path):
    body = _body()
    server.files["a.bin"] = body
    (tmp_path / "a.bin.partial").write_bytes(body[:40_000])
    ds.fetch(f"{server.base}/a.bin", str(tmp_path / "a.bin"), sha256=hashlib.sha256(body).hexdigest())
    assert (tmp_path / "a.bin").read_bytes() == body and ("a.bin", "bytes=40000-") in server.requests
    server.files["b.bin"] = body
    server.drop_after["b.bin"] = 30_000
    ds.fetch(f"{server.base}/b.bin", str(tmp_path / "b.bin"), retries=3, backoff=0.0,
             sha256=hashlib.sha256(body).hexdigest())
    assert (tmp_path / "b.bin").read_bytes() == body
    assert [r for (k, r) in server.requests if k == "b.bin" and r]


@MODS
def test_fetch_errors(ds, server, tmp_path):
    server.files["a.bin"] = b"not the expected content"
    with pytest.raises(ds.DownloadError, match="sha256|failed"):
        ds.fetch(f"{server.base}/a.bin", str(tmp_path / "a.bin"), retries=2, backoff=0.0, sha256="0" * 64)
    assert not (tmp_path / "a.bin").exists()
    with pytest.raises(ds.DownloadError, match="manually"):
        ds.fetch(f"{server.base}/nope.bin", str(tmp_path / "n.bin"), retries=2, backoff=0.0)


@MODS
def test_extract_zip_and_escape(ds, tmp_path):
    arc = tmp_path / "x.zip"
    arc.write_bytes(_zip_bytes({"audio/a.wav": b"AA", "audio/sub/b.wav": b"BB"}))
    out = ds.extract_zip(str(arc), str(tmp_path / "data"))
    assert sorted(os.path.basename(p) for p in out) == ["a.wav", "b.wav"]
    assert (tmp_path / "data/audio/sub/b.wav").read_bytes() == b"BB"
    evil = tmp_path / "evil.zip"
    evil.write_bytes(_zip_bytes({"../evil.txt": b"X"}))
    with pytest.raises(ds.DownloadError, match="unsafe"):
        ds.extract_zip(str(evil), str(tmp_path / "data"))


@MODS
def test_acquire_subset_manifest_and_archives(ds, server, tmp_path):
    bodies = {f: _body(5_000 + i, seed=i) for i, (f, _u) in enumerate(ds.DATASETS["idmt-amps"].files[:3])}
    server.files.update(bodies)
    root = str(tmp_path / "amps")
    paths = ds.acquire("idmt-amps", root, files=list(bodies), base_url=server.base)
    assert [os.path.basename(p) for p in paths] == list(bodies)
    assert set(json.load(open(os.path.join(root, ".dasp_manifest.json")))) == set(bodies)
    server.requests.clear()
    ds.acquire("idmt-amps", root, files=list(bodies), base_url=server.base)
    assert server.requests == []
    server.files["audio_mono-mic.zip"] = _zip_bytes({"audio_mono-mic/00_BN1.wav": b"WAV"})
    ds.acquire("guitarset-mono-mic", str(tmp_path / "gs"), base_url=server.base)
    assert (tmp_path / "gs/audio_mono-mic/00_BN1.wav").read_bytes() == b"WAV"


@MODS
def test_acquire_offline_and_unknown(ds, tmp_path):
    rel = "idmt-rock-input-varying-gain.wav"
    with pytest.raises(KeyError, match="unknown files"):
        ds.acquire("idmt-amps", str(tmp_path), files=["nope.wav"], offline=True)
    with pytest.raises(ds.DownloadError, match="offline"):
        ds.acquire("idmt-amps", str(tmp_path), files=[rel], offline=True)
    (tmp_path / rel).write_bytes(b"RIFFdata")
    assert ds.acquire("idmt-amps", str(tmp_path), files=[rel], offline=True) == [str(tmp_path / rel)]


@MODS
def test_verify_and_cli(ds, server, tmp_path, capsys):
    rel = "idmt-rock-input-varying-gain.wav"
    assert ds.verify("idmt-amps", str(tmp_path))[rel] is False
    assert ds._cli(["idmt-amps", "--root", str(tmp_path), "--verify"]) == 1
    (tmp_path / rel).write_bytes(b"RIFF")
    assert ds.verify("idmt-amps", str(tmp_path))[rel] is True
    assert ds._cli(["idmt-amps", "--root", str(tmp_path), "--verify"]) == 1
    assert rel in capsys.readouterr().out


@pytest.mark.parametrize("writer,reader", [(jdatasets, tdatasets), (tdatasets, jdatasets)], ids=["jax-torch", "torch-jax"])
def test_manifest_written_by_one_verifies_in_the_other(writer, reader, server, tmp_path, monkeypatch):
    body = _body(3_000)
    spec = tdatasets.DatasetSpec(name="pinned", files=(("p.bin", "http://unused/p.bin"),),
                                 sha256={"p.bin": hashlib.sha256(body).hexdigest()})
    for mod in (jdatasets, tdatasets):
        monkeypatch.setitem(mod.DATASETS, "pinned", spec)
    server.files["p.bin"] = body
    root = str(tmp_path / "pin")
    writer.acquire("pinned", root, base_url=server.base)

    def no_rehash(*a, **k):
        raise AssertionError("the manifest's hash should have been used")

    monkeypatch.setattr(reader, "sha256_file", no_rehash)
    assert reader.verify("pinned", root) == {"p.bin": True}
    assert tdatasets.verify is TU.verify_dataset
