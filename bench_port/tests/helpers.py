"""Tiny cells for CPU runs: the port's plain versions against the frozen
reference at the tiny configurations."""

from __future__ import annotations

import json
from pathlib import Path

from bench_port.harness.manifest import BENCH_DIR, Cell

TINY = {"eval_streaming": ("tiny_flagship_config", {"sampler.sampling_steps": 5},
                           {"objects": 3, "pool": 2}),
        "serve_batch": ("tiny_test_config", {}, {"objects": 3, "pool": 2, "num_steps": 5})}


def tiny_cell(name: str, exact: bool = False) -> Cell:
    """The manifest's cell ``name`` at a tiny size: its driver and traffic,
    the tiny configuration of its driver, a few objects and steps; the
    cell's own limits, or with ``exact`` every limit 0."""
    from bench_port.harness.manifest import find_cell

    real = find_cell(BENCH_DIR.parent, name)
    base, changes, sizes = TINY[real.traffic["driver"]]
    traffic = dict(real.traffic, judge_units=2, **sizes)
    if exact:
        traffic["limits"] = dict.fromkeys(traffic["limits"], 0.0)
    spec = {"base": base, "changes": changes}
    return Cell(name, real.config_name, spec, traffic, 1, real.end_to_end, real.per_layer)


def manifest() -> dict:
    return json.loads((Path(BENCH_DIR).parent / "BENCHMARK.json").read_text())
