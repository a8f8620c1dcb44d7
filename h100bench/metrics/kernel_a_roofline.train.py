"""Kernel A's share of its roofline in the train cell: the least time of its
forward calls' work (x read once, y written once, the sections read once;
9 operations a sample and section), the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s, over the device time of all work launched
inside the span the traced run opens around each call of the program's
entry sosfilt_pallas."""

from h100bench.work.roofline import KERNEL_A, roofline_share

ENTRIES = KERNEL_A


def read(run):
    return roofline_share(run, "kernel_a")
