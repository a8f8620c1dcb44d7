"""Training steps completed in the window over the window's length (closed
loop, each step ends in a synchronize)."""


def read(run):
    return run.record["steps"] / run.record["window_s"]
