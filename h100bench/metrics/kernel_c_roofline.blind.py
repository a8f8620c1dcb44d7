"""Kernel C's forward share of its roofline in the blind-estimation cell:
the least time of its calls' work (x_ext read once, each tap's delays and
gains read once, wet written once; 5 operations a tap and sample and 6 a
tap, channel and sample), the larger of bytes over 3.35 TB/s and operations
over 67 TFLOP/s, over the device time of all work launched inside the span
the traced run opens around each call of the program's entry
frac_delay_pallas (both renders of a step)."""

from h100bench.work.blind import frac_delay_work
from h100bench.work.roofline import roofline_share

ENTRIES = [("dasp_tpu_torch.functional", "frac_delay_pallas", "kernel_c",
            lambda x_ext, d_stk, *a, **k: frac_delay_work(tuple(x_ext.shape), tuple(d_stk.shape)))]


def read(run):
    return roofline_share(run, "kernel_c")
