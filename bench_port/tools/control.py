"""The control of a cell's comparison: the frozen reference put in the
program's place at the nearest precision below the configuration's (float32
products in TF32, the backbone's bf16 products from fp8 operands;
``harness/agents.py:precision``), held against the reference at the
configuration's own.

    python3 bench_port/tools/control.py --workload <cell> --seeds 11 12 13 [--units N] [--tf32_only]

For each seed it prints one JSON line with every number the cell's judge
reads, for the control, on the cell's own inputs (units 0..N-1 of the seed,
N the cell's ``judge_units`` by default). The stages after the backbone take
the control's own backbone output, on both sides (``run_unit``), so their
numbers read TF32 alone and ``vit_gap`` reads fp8 alone; ``--tf32_only``
keeps the backbone at the configuration's bf16. The limits are set between
the program's readings (``tools/readings.py``) and these (PERF.md). Needs a
CUDA card; the benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(workload: str, seed: int, units=None, tf32_only: bool = False,
             device: str = "cuda", root: Path = ROOT) -> dict:
    """{number: the control's reading} of ``workload`` at ``seed``."""
    from bench_port.harness.manifest import find_cell, load_driver
    from bench_port.harness.reference_run import gaps, worst
    from bench_port.harness.runner import Context
    from bench_port.harness.trace import Spans

    cell = find_cell(root, workload)
    driver = load_driver(cell.traffic["driver"])
    ctx = Context(cell, seed, 0.0, False, device, Spans(False))
    units = list(range(units or int(cell.traffic["judge_units"])))
    ctrl = driver.reference(ctx, units, control="tf32_only" if tf32_only else True)
    ref = driver.reference(ctx, units, program=dict(zip(units, ctrl)))
    return worst([gaps(c, r) for c, r in zip(ctrl, ref)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--tf32_only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port.run import set_environment

    set_environment()
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed, args.units, args.tf32_only)
        print(json.dumps({"workload": args.workload, "seed": seed, "tf32_only": args.tf32_only,
                          "control": r, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
