"""apply_style_chain in a render batch (EQ on kernel A, compressor on
kernel B, reverb, gain), CUDA events around the benchmark's call, mean
over the traced batches."""

from h100bench.work.roofline import mean


def read(run):
    return mean(run.cuda_ms.get("chain", []))
