"""The render's model FLOPs (both encoder passes and the projectors,
forward, counted from shapes) times the batches of the traced window, over
the window and the H100's bf16 dense peak."""

from h100bench.work.flops import style_forward_flops
from h100bench.work.roofline import mfu


def read(run):
    mix = run.cell["mix"]
    flops = style_forward_flops(run.cfg["net"], mix["batch"], mix["clip_samples"])
    return mfu(flops, len(run.record["latency_ms"]), run.trace["window_s"])
