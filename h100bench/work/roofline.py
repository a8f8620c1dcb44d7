"""Kernel rooflines and model FLOP shares read from a traced run."""

from .flops import ballistics_work, sosfilt_work
from .peaks import BF16_FLOPS_PER_S, bound

# the program's public kernel entries, wrapped from outside in a traced run
KERNEL_A = [("dasp_tpu_torch.functional", "sosfilt_pallas", "kernel_a",
             lambda sos, x, *a, **k: sosfilt_work(tuple(sos.shape), tuple(x.shape)))]
KERNEL_B = [(mod, "ballistics_pallas", "kernel_b", lambda g, *a, **k: ballistics_work(tuple(g.shape)))
            for mod in ("dasp_tpu_torch.functional", "dasp_tpu_torch.streaming")]


def roofline_share(run, span: str):
    """The least time of the span's counted work over the device time of
    the work launched inside it, in %; None where the span ran nothing."""
    calls, nbytes, ops = run.work.get(span, (0, 0.0, 0.0))
    device_s = run.trace["device_s_by_span"].get(span, 0.0)
    if not calls or device_s <= 0:
        return None
    return 100.0 * bound(nbytes, ops)["bound_ms"] / 1e3 / device_s


def mfu(flops_per_item: float, items: int, window_s: float) -> float:
    """Model FLOPs done over the window against the bf16 dense peak, in %."""
    return 100.0 * flops_per_item * items / window_s / BF16_FLOPS_PER_S


def idle_share(run) -> float:
    """The share of the traced window with nothing running on the device."""
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mean(values):
    return sum(values) / len(values) if values else None
