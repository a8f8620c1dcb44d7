"""The blind-estimation step's model FLOPs (the net's convolutions and head,
forward and backward, counted from shapes) times the steps of the traced
window, over the window and the H100's dense peak in the precision the
configuration states for the convolutions (TF32: 495 TFLOP/s)."""

from h100bench.work.blind import DENSE_FLOPS_PER_S, blind_train_flops


def read(run):
    mix = run.cell["mix"]
    flops = blind_train_flops(run.cfg["net"], mix["batch"], mix["clip_samples"])
    peak = DENSE_FLOPS_PER_S[run.cfg["precision"]["convolutions"]]
    return 100.0 * flops * run.record["steps"] / run.trace["window_s"] / peak
