"""The training step's model FLOPs (both encoder passes and the
projectors, forward and backward, counted from shapes) times the steps of
the traced window, over the window and the H100's bf16 dense peak."""

from h100bench.work.flops import style_train_flops
from h100bench.work.roofline import mfu


def read(run):
    mix = run.cell["mix"]
    flops = style_train_flops(run.cfg["net"], mix["batch"], mix["clip_samples"] // 2)
    return mfu(flops, run.record["steps"], run.trace["window_s"])
