"""Start a ``torch.distributed`` world of processes on this host.

:func:`spawn` is the one launcher of the package: the examples' ``--dp`` /
``--sp`` runs (outside torchrun), the tests' gloo CPU ranks and the card
checks all start their ranks through it. A world of one runs in the
calling process; a larger one in processes started by the ``spawn``
method, so the target must be a module-level function of a module that
imports without side effects (and without JAX).
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["spawn"]

# how long a rank waits in one collective before it gives up (a rank that
# dies leaves its peers there; gloo's own default is half an hour)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _in_world(rank: int, world: int, init_method: str, backend: str, target: Callable, args: tuple):
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        return target(rank, *args)
    finally:
        dist.destroy_process_group()


def _child(rank, world, init_method, backend, threads, out_dir, target, args):
    torch.set_num_threads(threads)
    try:
        res = {"result": _in_world(rank, world, init_method, backend, target, args)}
    except BaseException:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    if "error" in res:
        sys.exit(1)


def spawn(world: int, target: Callable, args: tuple = (), backend: str = "gloo",
          threads: Optional[int] = None, tmp_dir: Optional[str] = None,
          timeout: Optional[float] = None) -> List:
    """Run ``target(rank, *args)`` on every rank of a new world of ``world``
    ranks; returns the ranks' results in rank order.

    Each rank joins the world through a ``file://`` rendezvous in a new
    directory under ``tmp_dir`` (default: the system's temporary directory)
    and leaves it when ``target`` returns. A world of one runs in this
    process, and an exception of ``target`` propagates as it is. A larger
    world runs in new processes with ``threads`` intra-op threads each
    (default: this process's threads shared out); their results come back
    pickled. When a rank raises or dies, the others are terminated and this
    raises a ``RuntimeError`` with that rank's traceback; so it does, after
    terminating them, when ranks are still running ``timeout`` seconds in
    (None: no limit).
    """
    import torch.multiprocessing as mp

    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        if world == 1:
            return [_in_world(0, 1, init_method, backend, target, args)]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child, args=(r, world, init_method, backend, threads, tmp, target, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        alive = list(procs)
        while alive and not any(p.exitcode for p in procs):
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            wait([p.sentinel for p in alive], left)
            alive = [p for p in alive if p.exitcode is None]
        for p in alive:
            p.terminate()
        for p in procs:
            p.join()
        out, failed, lost = [], [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            res = {}
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res = pickle.load(f)
            if "error" in res:
                failed.append(f"rank {r} failed:\n{res['error']}")
            elif "result" not in res:
                lost.append(f"rank {r} exited with code {p.exitcode} and no result")
            out.append(res.get("result"))
        if failed:
            raise RuntimeError("\n".join(failed))
        if alive:
            raise RuntimeError(f"ranks {[procs.index(p) for p in alive]} still running after {timeout} s")
        if lost:
            raise RuntimeError("\n".join(lost))
        return out
