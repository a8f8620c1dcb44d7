"""Spans and counters of the program's own parts, on the profiler's clock.

``span(name)`` marks a part of the work (``with span("stream.chunk"):``).
While no torch profiler records, it returns one shared no-op context: the
cost is one read of the flag torch keeps for such checks
(``torch.autograd.profiler._is_profiler_enabled``). There is no other
switch: run any entry under ``torch.profiler.profile`` and the spans turn
on. A span that is on

- opens ``torch.profiler.record_function("dasp." + name)``, so the part
  shows on the profiler's timeline (host and device) by that name;
- adds its host time (``time.perf_counter_ns``) to an in-memory table by
  name: calls, total, self (total less the time of the spans opened inside
  it on the same thread; the autograd engine's device threads keep stacks
  of their own) and the names of the spans seen around it;
- where CUDA is initialised, records a CUDA event pair on the current
  stream; the pairs are resolved to device milliseconds in order, a batch
  at a time as they finish and the rest by :func:`snapshot`, and their
  events are recorded again by later spans.

``count(name, n)`` is always on: one integer add under a lock (the
autograd engine's threads count too). The kernel engines count
their launches with it (``kernel_a.forward``, ``kernel_a.save_all``,
``kernel_a.adjoint``, ``kernel_b.forward``, ``kernel_b.backward``,
``kernel_c.forward``, ``kernel_c.backward``, ``kernel_d.forward``,
``kernel_e.forward``), ``TCNBlock`` its layer calls on either path
(``encoder.conv_layer``) and ``functional._frac_delay_matmul`` its calls
on either adjoint (``frac_delay.call``).

:func:`snapshot` returns both tables, :func:`reset` clears them. Nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["span", "count", "snapshot", "reset"]

PREFIX = "dasp."
# pending CUDA event pairs beyond which the finished ones are resolved as
# spans close (without a synchronize), and their events recorded again by
# later spans: thousands of live events stalled the host 0.15-0.3 s once in
# a profiled window on an H100 host, and creating events costs runtime calls
_RESOLVE_AT = 256


# the context every span returns while no profiler records
_OFF = contextlib.nullcontext()


class _Stat:
    __slots__ = ("calls", "total_ns", "self_ns", "parents", "device_ms")

    def __init__(self):
        self.calls = self.total_ns = self.self_ns = 0
        self.parents = set()
        self.device_ms = None


_spans: dict = {}
_counts: dict = {}
_pending: list = []  # (name, start event, end event)
_free: list = []  # resolved events, for later spans to record again
_local = threading.local()
_lock = threading.Lock()  # guards the four lists and tables above


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stat(name: str) -> _Stat:
    st = _spans.get(name)
    if st is None:
        st = _spans[name] = _Stat()
    return st


class _Span:
    __slots__ = ("name", "rf", "ev0", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0
        self.ev0 = None

    def __enter__(self):
        stack = _stack()
        if stack:
            with _lock:
                _stat(self.name).parents.add(stack[-1].name)
        stack.append(self)
        self.rf = record_function(PREFIX + self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.ev0 = _record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        ev1 = None
        if self.ev0 is not None:
            ev1 = _record()
        self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        with _lock:
            st = _stat(self.name)
            st.calls += 1
            st.total_ns += dt
            st.self_ns += dt - self.child_ns
            if ev1 is not None:
                _pending.append((self.name, self.ev0, ev1))
                if len(_pending) >= _RESOLVE_AT:
                    _resolve(wait=False)
        return False


def _record():
    """A CUDA event recorded on the current stream, taken from the resolved
    ones where there is one."""
    with _lock:
        ev = _free.pop() if _free else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name: str):
    """A context that marks one part of the program (see the module
    docstring): a shared no-op while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def _resolve(wait: bool) -> None:
    """Add the device time of the pending event pairs to their spans: all
    of them after one synchronize (``wait``), else those finished, in
    order, up to the first that is not. The caller holds ``_lock``."""
    if not _pending:
        return
    if wait:
        torch.cuda.synchronize()
    done = 0
    for name, ev0, ev1 in _pending:
        if not wait and not ev1.query():
            break
        st = _stat(name)
        st.device_ms = (st.device_ms or 0.0) + ev0.elapsed_time(ev1)
        _free.extend((ev0, ev1))
        done += 1
    del _pending[:done]


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "host_ms", "host_self_ms", "device_ms",
    "parents"}}, "counts": {name: n}}``. ``device_ms`` is None for a span
    that recorded no CUDA events; ``parents`` lists the names of the spans
    a span was opened inside."""
    with _lock:
        _resolve(wait=True)
        spans = {
            name: {"calls": st.calls, "host_ms": st.total_ns / 1e6, "host_self_ms": st.self_ns / 1e6,
                   "device_ms": st.device_ms, "parents": sorted(st.parents)}
            for name, st in _spans.items()
        }
        return {"spans": spans, "counts": dict(_counts)}


def reset() -> None:
    """Clear the spans' table and the counters."""
    with _lock:
        _spans.clear()
        _counts.clear()
        _pending.clear()
