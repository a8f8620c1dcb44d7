"""The 95th percentile (nearest rank) of every render batch's latency in
the window: host clock from the call to the output ready."""

from h100bench.work.stats import percentile


def read(run):
    return percentile(run.record["latency_ms"], 95)
