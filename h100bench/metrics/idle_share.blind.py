"""The share of the traced window in the blind-estimation cell in which no
kernel, copy or fill ran on the device (the union of the profiler's device
intervals)."""

from h100bench.work.roofline import idle_share


def read(run):
    return idle_share(run)
