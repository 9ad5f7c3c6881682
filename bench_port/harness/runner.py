"""One run of one cell: set-up and warm-up, the window, the peak memory,
the comparison with the reference, the metrics, the import check, and the
result line.

A driver module (``drivers/<entry>.py``) defines ``Session(ctx)``, whose
constructor sets the program up, with:

- ``warmup()``: every shape the cell's window uses, once;
- ``window(t0, seconds, record)``: the closed loop; ``record(start, end,
  work)`` after each unit completes (results read back on the host), where
  ``work`` counts what the unit did ({"candidates": 6400}); the loop stops
  at the first unit that ends ``seconds`` or more after ``t0``;
- ``release()``: drops the program's state;
- ``judge(units)``: {number: value} comparing the units' outputs with the
  frozen reference (and, in a traced run, fills ``ctx.costs``)."""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench_port.harness.imports import PORT, forbidden_loaded
from bench_port.harness.judge import decide, print_checks
from bench_port.harness.manifest import BENCH_DIR, Cell, load_driver, load_reader
from bench_port.harness.trace import WINDOW, DeviceTrace, Spans, from_profiler


class Refusal(RuntimeError):
    """The run cannot give a result: it prints none and exits non-zero."""


@dataclass
class Unit:
    start: float
    end: float
    work: Dict[str, float]

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Context:
    """What a driver and a reader see of a run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    spans: Spans
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[Unit] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)   # the program's counters
    costs: Dict[str, float] = field(default_factory=dict)      # the work the shapes need
    device_trace: Optional[DeviceTrace] = None

    @property
    def params(self) -> dict:
        return self.cell.traffic

    def work(self, key: str) -> float:
        return sum(u.work.get(key, 0.0) for u in self.units)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()


def device_info(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refusal("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refusal(f"the cell asks for {chips} cards, {torch.cuda.device_count()} seen")


def _check_program(root: Optional[Path]) -> None:
    try:
        import genpose2_tpu_torch
    except ImportError as e:
        raise Refusal(f"the program ({PORT}) is not importable: {e}") from e
    if root is not None and Path(genpose2_tpu_torch.__file__).resolve().parents[1] != root:
        raise Refusal(f"{PORT} was imported from {genpose2_tpu_torch.__file__}, "
                      f"not from the checkout at {root}")


def closed_loop(step: Callable[[int], Dict[str, float]], t0: float, seconds: float,
                record: Callable) -> None:
    """Units one after another from t0 until one ends ``seconds`` after it;
    ``step(i)`` runs unit i to its host read and returns its work."""
    i = 0
    start = t0
    while True:
        work = step(i)
        end = time.perf_counter()
        record(start, end, work)
        if end - t0 >= seconds:
            return
        start = end
        i += 1


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _priority(seed: int, i: int) -> float:
    """Unit i's place in the seed's draw of units to judge (lowest first)."""
    return random.Random(f"{seed}:{i}").random()


def judge_sample(units: List[Unit], seed: int, count: int) -> List[int]:
    """``count`` completed units drawn from the seed, the longest among
    them: the longest, and the ``count`` - 1 others of lowest priority."""
    n = len(units)
    longest = max(range(n), key=lambda i: units[i].seconds)
    rest = sorted((i for i in range(n) if i != longest), key=lambda i: _priority(seed, i))
    return sorted([longest] + rest[:count - 1])


def judgeable(units: List[Unit], seed: int, count: int) -> set:
    """The units completed so far that ``judge_sample`` may still pick once
    the window has closed: the longest so far and the ``count`` of lowest
    priority. A driver may drop what it keeps of any other unit."""
    n = len(units)
    if n == 0:
        return set()
    longest = max(range(n), key=lambda i: units[i].seconds)
    return {longest, *sorted(range(n), key=lambda i: _priority(seed, i))[:count]}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: Optional[float] = None, root: Optional[Path] = None,
             bench_dir: Path = BENCH_DIR) -> dict:
    """One run; returns the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    _check_program(root)
    from genpose2_tpu_torch.ops import _cuda

    driver = load_driver(cell.traffic["driver"], bench_dir)
    ctx = Context(cell, seed, seconds, trace, device, Spans(trace))
    session = driver.Session(ctx)
    session.warmup()
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start

    def record(start, end, work):
        ctx.units.append(Unit(start, end, dict(work)))

    _cuda.reset_launch_counts()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            session.window(t0, seconds, record)
            ctx.sync()
        prof.stop()
    else:
        t0 = time.perf_counter()
        session.window(t0, seconds, record)
    ctx.window_s = ctx.units[-1].end - t0
    ctx.counters = {f"launches.{k}": float(v) for k, v in _cuda.launch_counts.items()}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if prof is not None:
        ctx.device_trace = from_profiler(prof)
        del prof
    session.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    units = judge_sample(ctx.units, seed, int(cell.traffic["judge_units"]))
    numbers = session.judge(units)
    ok, checks = decide(numbers, cell.traffic["limits"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"], bench_dir).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_loaded()
    if bad:
        print(f"bench_port: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        raise Refusal(f"forbidden modules loaded: {', '.join(bad)}")

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device != "cpu":
        dev["name_and_power_limit"] = _power_limit()
    result = {"correct": ok, "attempted": len(ctx.units), "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and ctx.device_trace is not None:
        dt = ctx.device_trace
        dev.update(busy_s=dt.busy_s, window_s=dt.window_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in dt.device_ops],
                               "idle_gaps": [[k, v] for k, v in dt.idle_gaps]}
    result["setup_and_window"] = {"setup_s": ctx.setup_s, "window_s": ctx.window_s,
                                  "units": len(ctx.units), "judged": units}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print_checks(checks)
    return result
