"""Spans, work counts and the profiler's device trace of one traced window.

A traced run wraps the program's kernel entries from outside (each forward
call opens a ``record_function`` span and counts the call's work), takes
CUDA-event and host-clock spans where a driver asks for them, and keeps
the profiler's events in memory. :meth:`Tracer.reduce` then takes from the
events: the device's busy time in the window (the union of every kernel,
copy and fill), the device time of the work launched inside each span, the
operations that took most device time and the longest idle gaps with what
the host was doing. Nothing is written to disk.
"""

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "h100bench.window"
PREFIX = "h100bench."


class Tracer:
    """One traced window. ``entries``: (module, attribute, span, work) for
    each kernel entry to wrap, ``work(*args, **kwargs) -> (bytes, ops)``."""

    def __init__(self, entries: List[Tuple[str, str, str, Callable]]):
        self.entries = entries
        self.work: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])  # span -> calls, bytes, ops
        self.host_ms: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)
        self._saved: List[Tuple[object, str, object]] = []
        self._prof = None
        self._window = None

    # -- wrapping the program's entries (traced runs only)

    def install(self):
        for mod_name, attr, span, work in self.entries:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, span, work))

    def uninstall(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, fn, span, work):
        counts = self.work[span]

        def wrapped(*args, **kwargs):
            nbytes, ops = work(*args, **kwargs)
            counts[0] += 1
            counts[1] += nbytes
            counts[2] += ops
            with torch.profiler.record_function(PREFIX + span):
                return fn(*args, **kwargs)

        return wrapped

    # -- spans a driver takes

    @contextlib.contextmanager
    def mark(self, name: str):
        """A CUDA event pair around a part of the work: ``with mark(name)``."""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with torch.profiler.record_function(PREFIX + name):
            yield
        b.record()
        self._events[name].append((a, b))

    def event_pair(self, name: str, a, b):
        """Record a pair of CUDA events already taken around ``name``."""
        self._events[name].append((a, b))

    @contextlib.contextmanager
    def host(self, name: str):
        """Host clock around a part, with the device drained on both sides."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        torch.cuda.synchronize()
        self.host_ms[name].append((time.perf_counter() - t0) * 1e3)

    def cuda_ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._events.items()}

    # -- the profiler

    @contextlib.contextmanager
    def window(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.install()
        torch.cuda.synchronize()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW):
                    yield
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        finally:
            self.uninstall()
        self.stop_s = time.perf_counter() - t0
        self._prof = prof

    def reduce(self, top: int = 10) -> dict:
        """The trace's numbers (see the module docstring)."""
        t0 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        out = reduce_events(events, top)
        out["cost_s"] = {"stop": self.stop_s, "events": t1 - t0, "reduce": time.perf_counter() - t1,
                         "n_events": len(events)}
        return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


class _Spans:
    """Intervals of one span name on each thread, for point lookups."""

    def __init__(self):
        self.by_tid: Dict[int, List[Tuple[int, int]]] = defaultdict(list)

    def add(self, tid, s, e):
        self.by_tid[tid].append((s, e))

    def freeze(self):
        for v in self.by_tid.values():
            v.sort()
        self.starts = {t: [s for s, _ in v] for t, v in self.by_tid.items()}

    def contains(self, tid, t) -> bool:
        v = self.by_tid.get(tid)
        if not v:
            return False
        i = bisect.bisect_right(self.starts[tid], t) - 1
        return i >= 0 and v[i][0] <= t <= v[i][1]


def reduce_events(events, top: int = 10) -> dict:
    cpu_ops: Dict[int, Tuple[int, int]] = {}
    launches: Dict[int, Tuple[int, int]] = {}
    spans: Dict[str, _Spans] = defaultdict(_Spans)
    main_ops: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str, int, int]] = []
    window: Optional[Tuple[int, int, int]] = None
    for e in events:
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIX):
                continue  # a span's shadow on the device timeline, not work
            device.append((s, s + d, name, e.correlation_id(), e.linked_correlation_id()))
            continue
        tid = e.start_thread_id()
        if name == WINDOW:
            window = (s, s + d, tid)
        elif name.startswith(PREFIX):
            spans[name[len(PREFIX):]].add(tid, s, s + d)
        elif name.startswith("cuda") or name.startswith("cu"):
            launches[e.correlation_id()] = (s, tid)
        else:
            cpu_ops[e.correlation_id()] = (s, tid)
            main_ops.append((s, s + d, name, tid))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    for sp in spans.values():
        sp.freeze()
    w0, w1, main_tid = window
    device = [ev for ev in device if ev[1] > w0 and ev[0] < w1]
    if not device:
        raise RuntimeError("the trace holds no device work in the window")

    by_span: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, corr, link in device:
        dur = (e - s) / 1e9
        by_name[name] += dur
        host = launches.get(corr) or cpu_ops.get(link)
        if host is None:
            continue
        for span, sp in spans.items():
            if sp.contains(host[1], host[0]):
                by_span[span] += dur

    busy = _union([(max(s, w0), min(e, w1)) for s, e, *_ in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = [(b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])]
    gaps.sort(reverse=True)
    main_ops = sorted(op for op in main_ops if op[3] == main_tid)
    starts = [op[0] for op in main_ops]

    def host_at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        best = None
        for j in range(i, max(-1, i - 5000), -1):
            s, e, name, _ = main_ops[j]
            if e >= t:
                best = name  # the innermost op running at t on the main thread
                break
        return best or "host idle between ops"

    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "device_s_by_span": dict(by_span),
        "device_ops": sorted(([n[:160], v] for n, v in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": [[host_at(t), g / 1e9] for g, t in gaps[:top]],
    }
