"""The host's time to issue one training step: the program's span
train.step (train_step, from the corruption to the end of Adam's update,
no synchronize inside), host clock, over its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["train.step"], "train.step")
