"""The benchmark of dasp_tpu_torch on one NVIDIA H100 (see BENCHMARK.json at
the repository's root and ``run.py``)."""
