"""Run one cell of the benchmark of ``genpose2_tpu_torch`` once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files by name (``BENCHMARK.json``: the configuration; the
cell's traffic, which names its entry driver; the metrics' readers), sets
the program up and warms up every shape the cell uses (set-up), runs the
entry in a closed loop for ``--seconds`` (the window), reads the peak
memory, frees the program's state, holds a sample of what the window
produced against the frozen plain reference, and prints one JSON line last
on standard output. With ``--trace 0`` the line holds the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` with
the drivers' spans on, and the line holds the per-layer metrics, ``busy_s``,
``window_s`` and the ``breakdown``.

Exits non-zero without a result when there is no CUDA card or fewer than
the cell asks for, when the program is not beside this directory, or when a
forbidden module (JAX, or the JAX package ``genpose2_tpu``, compared by whole
top-level names) is loaded once the window has closed."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"


def set_environment() -> None:
    """Compile caches at fixed paths inside the checkout; libraries kept
    from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    from bench_port.harness.manifest import find_cell
    from bench_port.harness.runner import Refusal, device_info, run_cell

    try:
        cell = find_cell(ROOT, args.workload)
        device_info(cell.chips)  # refuses without enough CUDA cards
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                          t_start=T_START, root=ROOT)
    except Refusal as e:
        print(f"bench_port: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
