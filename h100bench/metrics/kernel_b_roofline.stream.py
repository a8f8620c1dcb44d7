"""Kernel B's share of its roofline in the stream cells: the least time of
its forward calls' work (g read once, y written once; 4 operations a
sample), the larger of bytes over 3.35 TB/s and operations over 67
TFLOP/s, over the device time of all work launched inside the span the
traced run opens around each call of the program's entry
ballistics_pallas."""

from h100bench.work.roofline import KERNEL_B, roofline_share

ENTRIES = KERNEL_B


def read(run):
    return roofline_share(run, "kernel_b")
