"""The EQ stage's per-chunk rebuild from fixed parameters: the host time of
the program's spans eq.design (parametric_eq_sos) and iir.coupled.operators
(stabilize, fold, state space, matrix powers, Toeplitz operators), over the
calls of stream.parametric_eq in the traced window."""

from h100bench.work.spans import per_call


def read(run):
    return per_call(["eq.design", "iir.coupled.operators"], "stream.parametric_eq")
