"""Build and load the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` as plain C entry points. At first use
this module compiles all of them with ``nvcc`` into one shared library for
Hopper (``sm_90a``), stores it in ``_build/`` beside this file under a name
that carries a hash of the sources and flags, and loads it with ``ctypes``.
A later call in the same process reuses the loaded library; a later process
finds the cached file and skips the compile. Nothing here runs at import
time, and nothing needs PyTorch's C++ headers, so a build takes seconds.

The CPU tests never reach this module: the kernel wrappers call
:func:`library` only for tensors on a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "check", "build_log"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
)

_P = ctypes.c_void_p
# entry point -> (argtypes, restype)
_SIGNATURES = {
    "sosfilt_cascade_f32": ([_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P], ctypes.c_int),
    "sosfilt_cascade_max_sections": ([], ctypes.c_int),
    "ballistics_f32": ([_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P], ctypes.c_int),
}

_log = {"nvcc": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (if not cached) and load the kernel library, once per process."""
    srcs = _sources()
    out = BUILD_DIR / f"dasp_kernels_{_digest(srcs)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _log["nvcc"] = proc.stdout + proc.stderr
        (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + _log["nvcc"])
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_log['nvcc']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_log() -> str:
    """nvcc's output from this process's compile ('' when it was cached)."""
    return _log["nvcc"]


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (a cudaError_t value)")
