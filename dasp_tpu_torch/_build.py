"""Build, load and launch the hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` as plain C entry points. At first use
this module compiles each source with its own ``nvcc`` process, all started
together, links the objects into one shared library for Hopper
(``sm_90a``), stores it in ``_build/`` beside this file under a name that
carries a hash of the sources and flags, and loads it with ``ctypes``. A
later call in the same process reuses the loaded library; a later process
finds the cached file and skips the compile. Nothing here runs at import
time, and nothing needs PyTorch's C++ headers, so a build takes seconds.

The kernel wrappers in ``ops/`` share two more decisions, made here once:
:func:`engine`, which of a wrapper's two engines runs a call (the plain
PyTorch one on a CPU tensor, the CUDA one on a CUDA tensor), and
:func:`launch`, how a CUDA engine calls an entry point (on the current
stream of its tensors' device, with the error checked). The CPU tests never
reach :func:`library`: only the CUDA engines launch.
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

import torch

__all__ = ["library", "launch", "engine", "build_log"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_T = ctypes.c_longlong
_F = ctypes.c_float
# entry point -> (argtypes, restype)
_SIGNATURES = {
    "sosfilt_cascade_f32": ([_P, _P, _P, _I, _I, _T, _P, _P, _P], _I),
    "sosfilt_cascade_save_all_f32": ([_P, _P, _P, _I, _I, _T, _P, _P, _P], _I),
    "sosfilt_cascade_adjoint_f32": ([_P, _P, _P, _I, _I, _T, _P, _P, _P], _I),
    "sosfilt_cascade_max_sections": ([], _I),
    "sosfilt_cascade_tile": ([], _I),
    "ballistics_f32": ([_P] * 5 + [_I, _T, _P, _P], _I),
    "ballistics_bwd_f32": ([_P] * 10 + [_I, _T, _P, _P, _P], _I),
    "ballistics_tile": ([], _I),
    "frac_delay_f32": ([_P] * 4 + [_I, _I, _I, _T, _I, _I, _P], _I),
    "frac_delay_bwd_f32": ([_P] * 7 + [_I, _I, _I, _T, _I, _I, _P], _I),
    "sosfilt_coupled_step_f32": ([_P] * 5 + [_I, _I, _T, _P], _I),
    "sosfilt_coupled_step_f64": ([_P] * 5 + [_I, _I, _T, _P], _I),
    "tcn_layer_bf16": ([_P] * 9 + [_F] + [_I] * 7 + [_P], _I),
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
        # compile into a private directory, then rename the library: a
        # concurrent process never loads a half-written one
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            _compile_and_link(srcs, Path(tmp), out)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _compile_and_link(srcs, tmp: Path, out: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link."""
    nvcc = _nvcc()
    objs = [tmp / f"{src.stem}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)] for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, *GENCODE, "-shared", "-o", str(tmp / "lib.so"), *map(str, objs)]
    failed = [" ".join(c) for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode != 0:
            failed.append(" ".join(link))
    _log["nvcc"] = "\n".join(" ".join(c) + "\n" + log for c, log in zip(cmds + [link], logs))
    (BUILD_DIR / "build.log").write_text(_log["nvcc"])
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{_log['nvcc']}")
    os.replace(tmp / "lib.so", out)


def build_log() -> str:
    """nvcc's output from this process's compile ('' when it was cached)."""
    return _log["nvcc"]


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the entry point ``entry`` with ``args`` and the current stream of
    ``device`` (made the current device first only when it is not), and
    raise if it reports a CUDA error."""
    fn = getattr(library(), entry)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} (a cudaError_t value)")


def engine(entry: str, device: torch.device, plain, cuda, check, *args):
    """The engine the wrapper ``entry`` runs a call on: ``plain`` for a CPU
    tensor, ``cuda`` for a CUDA one once ``check(*args)`` has passed, and a
    ValueError for any other device."""
    if device.type == "cpu":
        return plain
    if device.type == "cuda":
        check(*args)
        return cuda
    raise ValueError(f"{entry} runs on CPU or CUDA tensors, not {device}")
