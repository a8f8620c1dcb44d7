"""Run one cell of the benchmark of dasp_tpu_torch once, on this machine.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's file (``h100bench/workloads/<cell>.json``)
names its configuration (``h100bench/configs/``), the driver of the entry its
window drives (``h100bench/drivers/``) and its traffic; ``BENCHMARK.json``
at the root alone declares the metrics each cell reports and their units,
each read by its own file (``h100bench/metrics/<metric>.py``). With ``--trace 0`` the run prints the
cell's end-to-end metrics; with ``--trace 1`` it traces a window of at most
``TRACED_SECONDS`` and prints the per-layer ones, and the device's busy time,
the traced window and a breakdown of both. Either way it then compares what the window produced with
the plain reference (``h100bench/reference/``) and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``breakdown``), and last
``compared``, each compared number with its limit.

It needs a CUDA card (as many as the cell asks for), and exits with another
code than 0, printing no result, without one, or when JAX or the JAX package
has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "dasp_tpu")
# a traced run's window: long enough for the per-layer metrics, short enough
# that the profiler's events (millions a minute on the serving path) are
# read within the run's time
TRACED_SECONDS = 15.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The names of the metrics this cell reports in this kind of run."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moved)]


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What a metric's reader reads: the driver's record, the set-up time,
    and in a traced run the reduced trace, the spans and the work counts."""

    def __init__(self, cfg, cell, record, setup_s, tracer=None, trace=None):
        self.cfg, self.cell, self.record, self.setup_s, self.trace = cfg, cell, record, setup_s, trace
        self.work = dict(tracer.work) if tracer else {}
        self.cuda_ms = tracer.cuda_ms() if tracer else {}
        self.host_ms = dict(tracer.host_ms) if tracer else {}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, bench: dict = None, cell: dict = None,
             cfg: dict = None, program=None):
    """One run of cell ``name`` on ``device``: set-up, the window, the
    metrics and the comparison. Returns the result's dict, or None when JAX
    or the JAX package was loaded (named on standard error). ``bench``,
    ``cell``, ``cfg`` and ``program`` replace what the files and the port
    give (the tests run it on the CPU at a tiny size, or with the timed path
    broken)."""
    import torch

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = cell or load_json(HERE / "workloads" / f"{name}.json")
    cfg = cfg or load_json(HERE / "configs" / f"{cell['config']}.json")
    on_card = device.type == "cuda"
    driver = load_module(HERE / "drivers" / f"{cell['driver']}.py", f"h100bench_driver_{cell['driver']}")
    names = cell_metrics(bench, name, trace)
    readers = {n: load_module(HERE / "metrics" / f"{n}.py", "h100bench_metric_" + n.replace(".", "_"))
               for n in names}

    state = driver.setup(cfg, cell, seed, device, program)
    sync(device)
    setup_s = time.perf_counter() - T0

    tracer = trace_out = None
    if trace:
        from h100bench.work.trace import Tracer

        entries = {(m, a): (m, a, s, w) for r in readers.values() for (m, a, s, w) in getattr(r, "ENTRIES", ())}
        tracer = Tracer(list(entries.values()))
        with tracer.window():
            record = driver.window(state, min(seconds, TRACED_SECONDS), tracer)
        trace_out = tracer.reduce()
    else:
        record = driver.window(state, seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        print(f"h100bench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return None

    run = Run(cfg, cell, record, setup_s, tracer, trace_out)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for n, r in readers.items():
        v = r.read(run)
        if v is not None:
            metrics[n] = {"value": v, "unit": units[n]}
    del run, tracer

    numbers, info = driver.check(state, record, cell["limits"])
    found = forbidden_modules()
    if found:
        print(f"h100bench: loaded: {', '.join(found)}", file=sys.stderr)
        return None
    correct = record["failed"] == 0 and all(math.isfinite(v) and v <= lim for v, lim in numbers.values())

    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                   "count": cell["chips"], "memory_peak_bytes": peak,
                   "power_limit_w": power_limit_w() if on_card else None}
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device_info}
    if trace_out is not None:
        device_info.update(busy_s=trace_out["busy_s"], window_s=trace_out["window_s"])
        out["breakdown"] = {"device_ops": trace_out["device_ops"], "idle_gaps": trace_out["idle_gaps"]}
    out["info"] = info if trace_out is None else {**info, "trace_cost_s": trace_out["cost_s"]}
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return out


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"h100bench: needs {cell['chips']} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, cell=cell)
    if out is None:
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
