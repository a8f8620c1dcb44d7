"""The EQ stage of the live chain (parametric_eq_stream), host clock with
the device drained on both sides, mean a chunk over the traced chunks."""

from h100bench.work.roofline import mean


def read(run):
    return mean(run.host_ms.get("eq", []))
