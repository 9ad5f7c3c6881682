"""The program's readings of every number a cell's judge reads, for setting
its limits: one run of the cell per seed, in one process, with a short
window at the cell's own load, each number reported whatever the cell's
limits.

    python3 bench_port/tools/readings.py --workload <cell> --seeds 11 12 ... [--seconds 3]

Prints one JSON line a seed: the numbers, ``correct`` at the cell's own
limits, and the run's end-to-end metrics. Needs a CUDA card; the
benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             root: Path = ROOT) -> dict:
    from bench_port.harness.judge import decide
    from bench_port.harness.manifest import find_cell
    from bench_port.harness.reference_run import NUMBERS
    from bench_port.harness.runner import run_cell

    cell = find_cell(root, workload)
    limits = cell.traffic["limits"]
    cell.traffic = dict(cell.traffic, limits=dict.fromkeys(NUMBERS, math.inf))
    r = run_cell(cell, seed, seconds, False, device)
    numbers = {k: v["value"] for k, v in r["checks"].items() if v["value"] is not None}
    return {"workload": workload, "seed": seed, "numbers": numbers,
            "correct_at_limits": decide(numbers, limits)[0], "units": r["attempted"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port.run import set_environment

    set_environment()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
