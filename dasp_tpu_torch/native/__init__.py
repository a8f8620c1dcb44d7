"""ctypes bindings for the native host runtime (``native/dasp_io.cpp``).

The port's own copy of the JAX package's host runtime: wav codec, range
reads, the thread-pool batch loader and dataset indexing, in dependency-free
C++ with a C ABI. This module compiles the source with the system C++
compiler at first use (about 1 s) into ``dasp_tpu_torch/_build/`` under a
name that carries a hash of the source and flags, never beside the source,
and binds it with ctypes. Every caller in :mod:`dasp_tpu_torch.utils.audio`
falls back to the pure-Python path when no compiler is available or
``DASP_TPU_NO_NATIVE=1``. This is host file I/O; nothing here touches the
card.

Public surface (all return numpy, raise RuntimeError on codec errors):

* :func:`available` — True iff the library is built and loaded.
* :func:`wav_info`  — header-only probe.
* :func:`wav_read`  — range decode -> float32 (channels, frames).
* :func:`wav_write` — float32 (channels, frames) -> 16-bit PCM.
* :func:`load_batch` — thread-pool clip loader -> (batch, ch, frames).
* :func:`chunk_peaks` — streaming per-chunk |peak| for silence indexing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "available", "build", "wav_info", "wav_read", "wav_write",
    "load_batch", "chunk_peaks",
]

_SRC = Path(__file__).resolve().parent / "dasp_io.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> Optional[str]:
    for cc in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cc:
            continue
        try:
            subprocess.run([cc, "--version"], capture_output=True, timeout=30)
            return cc
        except (OSError, subprocess.TimeoutExpired):
            continue
    return None


def lib_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"_dasp_io_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile ``dasp_io.cpp`` into :func:`lib_path` (skipped when that file
    exists, unless ``force``).

    Returns True on success, False on any failure (no compiler, no writable
    directory, a compile error), so callers degrade to the pure-Python path.
    The build is atomic: compile to a temporary file, then rename it.
    """
    out = lib_path()
    if out.exists() and not force:
        return True
    cc = _compiler()
    if cc is None:
        return False
    tmp = None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        r = subprocess.run([cc, *_FLAGS, str(_SRC), "-o", tmp], capture_output=True, timeout=300)
        if r.returncode != 0:
            sys.stderr.write(f"dasp_tpu_torch.native: build failed:\n{r.stderr.decode(errors='replace')}\n")
            return False
        os.replace(tmp, out)
        tmp = None
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"dasp_tpu_torch.native: build failed: {e}\n")
        return False
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    f32_p = ctypes.POINTER(ctypes.c_float)
    i64_p = ctypes.POINTER(ctypes.c_int64)
    i32_p = ctypes.POINTER(ctypes.c_int32)
    lib.dasp_abi_version.restype = ctypes.c_int
    lib.dasp_strerror.restype = ctypes.c_char_p
    lib.dasp_strerror.argtypes = [ctypes.c_int]
    lib.dasp_wav_info.restype = ctypes.c_int
    lib.dasp_wav_info.argtypes = [ctypes.c_char_p, i32_p, i32_p, i64_p, i32_p, i32_p]
    lib.dasp_wav_read.restype = ctypes.c_int64
    lib.dasp_wav_read.argtypes = [ctypes.c_char_p, f32_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int32]
    lib.dasp_wav_write.restype = ctypes.c_int
    lib.dasp_wav_write.argtypes = [ctypes.c_char_p, f32_p, ctypes.c_int32,
                                   ctypes.c_int64, ctypes.c_int32]
    lib.dasp_load_batch.restype = ctypes.c_int
    lib.dasp_load_batch.argtypes = [c_char_pp, i64_p, ctypes.c_int32,
                                    ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, f32_p, ctypes.c_int32]
    lib.dasp_chunk_peaks.restype = ctypes.c_int64
    lib.dasp_chunk_peaks.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32_p,
                                     ctypes.c_int64]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried or os.environ.get("DASP_TPU_NO_NATIVE") == "1":
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(str(lib_path()))
            if lib.dasp_abi_version() != _ABI:
                sys.stderr.write("dasp_tpu_torch.native: ABI version mismatch\n")
                return None
            _lib = _bind(lib)
        except OSError as e:
            sys.stderr.write(f"dasp_tpu_torch.native: load failed: {e}\n")
            return None
    return _lib


def available() -> bool:
    """True iff the native library is built, loaded and ABI-compatible."""
    return _get() is not None


def _need() -> ctypes.CDLL:
    lib = _get()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _check(lib: ctypes.CDLL, code: int, path: str) -> None:
    if code < 0:
        msg = lib.dasp_strerror(int(code)).decode()
        raise RuntimeError(f"dasp_tpu_torch.native: {msg}: {path!r}")


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str) -> Tuple[int, int, int, int, bool]:
    """-> (sample_rate, channels, num_frames, bits, is_float)."""
    lib = _need()
    sr, ch, nf, bits, isf = (ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64(),
                             ctypes.c_int32(), ctypes.c_int32())
    rc = lib.dasp_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(nf), ctypes.byref(bits), ctypes.byref(isf))
    _check(lib, rc, path)
    return sr.value, ch.value, nf.value, bits.value, bool(isf.value)


def wav_read(path: str, offset: int = 0, frames: Optional[int] = None,
             channels: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Range-decode -> (float32 (channels, frames), sample_rate).

    Reads exactly the requested byte range (one header parse, one seek, one
    read); frames past EOF are zero-filled.
    """
    lib = _need()
    sr, file_ch, nf, _, _ = wav_info(path)
    if frames is None:
        frames = max(0, nf - offset)
    if channels is None or channels <= 0 or channels > file_ch:
        channels = file_ch
    out = np.empty((channels, frames), dtype=np.float32)
    rc = lib.dasp_wav_read(path.encode(), _f32(out), int(offset), int(frames), int(channels))
    _check(lib, int(rc), path)
    return out, sr


def wav_write(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 (channels, frames) (or (frames,)) as 16-bit PCM."""
    lib = _need()
    audio = np.ascontiguousarray(np.atleast_2d(np.asarray(audio, np.float32)))
    rc = lib.dasp_wav_write(path.encode(), _f32(audio), int(audio.shape[0]),
                            int(audio.shape[1]), int(sample_rate))
    _check(lib, rc, path)


def load_batch(examples: Sequence[Tuple[str, int]], frames: int,
               channels: int = 1, mono_mix: bool = True,
               num_threads: int = 0) -> np.ndarray:
    """Thread-pool clip loader -> float32 (batch, channels, frames).

    Clip i is frames [offset_i, offset_i + frames) of file i, mono-mixed over
    the source channels (and duplicated across the output channels) when
    ``mono_mix``, else the first ``channels`` channels. The pool runs
    entirely outside the GIL; ``num_threads=0`` uses the hardware count.
    """
    lib = _need()
    batch = len(examples)
    out = np.empty((batch, channels, frames), dtype=np.float32)
    if batch == 0:
        return out
    c_paths = (ctypes.c_char_p * batch)(*[p.encode() for p, _ in examples])
    c_offsets = (ctypes.c_int64 * batch)(*[int(o) for _, o in examples])
    rc = lib.dasp_load_batch(c_paths, c_offsets, batch, int(frames), int(channels),
                             1 if mono_mix else 0, _f32(out), int(num_threads))
    # the C side reports the first error code across the pool, not which file
    _check(lib, rc, f"one of {batch} files (first: {examples[0][0]!r})")
    return out


def chunk_peaks(path: str, chunk_frames: int) -> np.ndarray:
    """Streaming per-chunk |peak| (max over all channels) -> (num_chunks,)."""
    lib = _need()
    _, _, nf, _, _ = wav_info(path)
    n = max(0, nf // int(chunk_frames))
    out = np.empty((n,), dtype=np.float32)
    if n == 0:
        return out
    rc = lib.dasp_chunk_peaks(path.encode(), int(chunk_frames), _f32(out), int(n))
    _check(lib, int(rc), path)
    return out
