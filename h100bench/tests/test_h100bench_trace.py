"""The reduction of a profiler trace, on a hand-made one."""

import pytest
import torch

from h100bench.work import roofline
from h100bench.work.trace import reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, dur, dev=CPU, tid=1, corr=0, link=0, annotation=False):
        self._v = (name, start, dur, dev, tid, corr, link, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def trace():
    # a 1000 ns window on thread 1; a kernel-B span from 100 to 300 with one
    # launch at 150 (correlation 7) whose kernel runs 400-450 on the device;
    # an aten op (440-580) launching at 500 (correlation 8) a kernel 600-800 on the
    # device; the window's shadow on the device timeline is no work
    return [
        Ev("h100bench.window", 0, 1000),
        Ev("h100bench.kernel_b", 100, 200),
        Ev("cudaLaunchKernel", 150, 5, corr=7),
        Ev("aten::mul", 440, 140, corr=99),
        Ev("cudaLaunchKernel", 500, 5, corr=8),
        Ev("ballistics_kernel", 400, 50, dev=CUDA, corr=7),
        Ev("elementwise", 600, 200, dev=CUDA, corr=8),
        Ev("h100bench.window", 0, 1000, dev=CUDA, annotation=True),
    ]


def test_busy_spans_ops_and_gaps():
    out = reduce_events(trace())
    assert out["window_s"] == pytest.approx(1e-6) and out["busy_s"] == pytest.approx(250e-9)
    assert out["device_s_by_span"] == {"kernel_b": pytest.approx(50e-9)}
    assert [n for n, _ in out["device_ops"]] == ["elementwise", "ballistics_kernel"]
    assert out["idle_gaps"][0] == ["aten::mul", pytest.approx(150e-9)]


def test_a_window_without_device_work_raises():
    with pytest.raises(RuntimeError):
        reduce_events([Ev("h100bench.window", 0, 1000)])


class FakeRun:
    def __init__(self):
        self.trace = reduce_events(trace())
        self.work = {"kernel_b": (1, 3.35e12 * 25e-9, 0.0)}  # 25 ns of bytes at the HBM rate


def test_roofline_and_idle_share():
    run = FakeRun()
    assert roofline.roofline_share(run, "kernel_b") == pytest.approx(50.0)
    assert roofline.roofline_share(run, "kernel_a") is None
    assert roofline.idle_share(run) == pytest.approx(75.0)
