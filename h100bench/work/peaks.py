"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W) and the least time a piece of work can take.

``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``SECTION_OPS`` and :func:`bound`
are frozen copies of ``chip_smoke.py:390-402``.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# bf16 and fp16 on the tensor cores, dense (no sparsity)
BF16_FLOPS_PER_S = 989e12
# fp32 operations per sample of a biquad section (5 multiplies, 4 adds)
SECTION_OPS = 9


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over HBM's rate, or operations over the
    fp32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
