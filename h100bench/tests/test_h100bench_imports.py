"""What the harness loads: never JAX, flax or the JAX package, and the
reference nothing of the program."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "dasp_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_loads_no_jax_nor_the_jax_package():
    code = ("import h100bench.run, h100bench.calibrate, h100bench.work.trace, h100bench.work.roofline\n"
            "from h100bench.run import load_module, HERE\n"
            "for d in ('style_train', 'style_render', 'stream_chain'):\n"
            "    load_module(HERE / 'drivers' / f'{d}.py', 'd_' + d)\n"
            "for p in (HERE / 'metrics').glob('*.py'):\n"
            "    load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
            "import dasp_tpu_torch.train, dasp_tpu_torch.streaming, dasp_tpu_torch.models")
    found = loaded_after(code)
    assert "dasp_tpu_torch" in found  # the port's name begins with the JAX package's
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    found = loaded_after("import h100bench.reference.style, h100bench.reference.stream, h100bench.reference.dsp")
    assert not found & (FORBIDDEN | {"dasp_tpu_torch"}), found & (FORBIDDEN | {"dasp_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from h100bench.run import forbidden_modules

    assert "dasp_tpu" not in forbidden_modules() or "dasp_tpu" in {m.split(".")[0] for m in sys.modules}
