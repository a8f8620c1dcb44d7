"""The EQ stage of the live chain (parametric_eq_stream), host clock of
the program's span stream.parametric_eq, with no synchronize inside, over
its calls in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["stream.parametric_eq"], "stream.parametric_eq")
