"""Kernel C's backward share of its roofline in the blind-estimation cell:
the least time of its calls' work (x_ext, each tap's delays and gains and
the cotangent read once, dd and dg written once, dx too where a call asks
for it), the larger of bytes over 3.35 TB/s and operations over 67
TFLOP/s, over the device time of the work launched inside the span the
traced window opens around each call of the backward's engine, on the
autograd thread that makes it (``drivers/blind_train.py``
``kernel_c_bwd_span``)."""

from h100bench.work.roofline import roofline_share


def read(run):
    return roofline_share(run, "kernel_c_bwd")
