"""Readings that set a cell's limits, on the chip at the cell's own size.

    python3 h100bench/calibrate.py --workload <cell> --seeds <n> [<n> ...] --kinds program control [fault_half]

For each seed and each kind, one JSON line with the numbers the cell
compares (a training cell's also those it reports and does not hold):

- ``program``: the program as a run sets it up and checks it, without a
  measured window for training (its checked steps are set-up's), with a
  short one (``--seconds``) for the others;
- ``control``: the reference computed in the precision below the one the
  configuration states, put in the program's place (the driver's
  ``control``);
- ``fault_half`` (training): the program's step on half of each batch,
  the mean taken over that half.

Lines go to standard output and to ``chiprun_out/calibrate.jsonl``. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from h100bench.run import load_json, load_module  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["program", "control"])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    driver = load_module(HERE / "drivers" / f"{cell['driver']}.py", f"h100bench_driver_{cell['driver']}")
    device = torch.device("cuda", 0)
    out_path = HERE.parent / "chiprun_out" / "calibrate.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    for seed in args.seeds:
        for kind in args.kinds:
            t0 = time.perf_counter()
            numbers, info = driver.calibrate(kind, cfg, cell, seed, device, args.seconds)
            line = {"workload": args.workload, "seed": seed, "kind": kind, "numbers": numbers, "info": info,
                    "s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            with open(out_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
