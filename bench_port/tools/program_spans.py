"""Where a cell's window spends its time by the program's own spans, and
what the spans cost: one set-up of the cell, then one window per mode in
turn, in one process.

    python3 bench_port/tools/program_spans.py --workload <cell> --seed <n> --seconds <s> \
        --modes off recorder off recorder
    python3 bench_port/tools/program_spans.py --workload <cell> --seed <n> --seconds <s> \
        --modes profiler

Modes: ``off`` (no span on, as a ``--trace 0`` run), ``recorder`` (the
program's in-memory recorder, ``profiling.recording()``), ``profiler``
(``torch.profiler`` over the window with the spans of ``drivers/`` on, as
a ``--trace 1`` run; not mixed with the other modes, since those spans are
put in place at set-up). Prints one JSON line a window: the units and
candidates a second; with the recorder, each span's total and self time a
unit; with the profiler, the device idle seconds inside each program span
(``harness/span_idle.py``), those inside no program span and those inside no
span at all, and the program's unit counters. A program without spans (an
older commit) reads no program span. Needs a CUDA card; the benchmark's own
runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MODES = ("off", "recorder", "profiler")


def _window(session, ctx, mode: str):
    """One window in ``mode``; returns (t0, the recorder or None, the
    profiler's events or None)."""
    from genpose2_tpu_torch.utils import profiling

    from bench_port.harness.runner import Unit
    from bench_port.harness.span_idle import profiler_events
    from bench_port.harness.trace import WINDOW

    def record(start, end, work):
        ctx.units.append(Unit(start, end, dict(work)))

    if mode == "off":
        t0 = time.perf_counter()
        session.window(t0, ctx.seconds, record)
        ctx.sync()
        return t0, None, None
    if mode == "recorder":
        with profiling.recording() as timer:
            t0 = time.perf_counter()
            session.window(t0, ctx.seconds, record)
            ctx.sync()
        return t0, timer, None
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = [ProfilerActivity.CUDA] if ctx.device != "cpu" else []
    prof = profile(activities=[ProfilerActivity.CPU] + cuda)
    prof.start()
    with record_function(WINDOW):
        t0 = time.perf_counter()
        session.window(t0, ctx.seconds, record)
        ctx.sync()
    prof.stop()
    return t0, None, profiler_events(prof, WINDOW)


def _idle(events, entry_spans, units: int) -> dict:
    from bench_port.harness.span_idle import idle_intervals, idle_outside_s, span_idle_s

    device, host, window = events
    names = {n for n, _, _, is_span in host if is_span} - set(entry_spans)
    idle = sum(e - s for s, e in idle_intervals(device, window)) * 1e-9
    outside_program = idle_outside_s(device, host, window, names)
    outside_all = idle_outside_s(device, host, window, names | set(entry_spans))
    by_span = span_idle_s(device, host, window, names)
    return {"window_s": (window[1] - window[0]) * 1e-9, "idle_s": idle,
            "idle_ms_a_unit_by_span": {k: 1e3 * v / units for k, v in
                                       sorted(by_span.items(), key=lambda kv: -kv[1])},
            "idle_in_no_program_span_s": outside_program,
            "idle_in_no_program_span_share": outside_program / idle if idle else None,
            "idle_in_no_span_s": outside_all,
            "idle_in_no_span_share": outside_all / idle if idle else None}


def run(cell, seed: int, seconds: float, modes, device: str = "cuda"):
    """Yields one dict a window of ``cell`` (``manifest.find_cell``)."""
    from genpose2_tpu_torch.utils import profiling

    from bench_port.harness.manifest import load_driver
    from bench_port.harness.runner import Context, _power_limit
    from bench_port.harness.trace import Spans

    traced = "profiler" in modes
    if traced and set(modes) != {"profiler"}:
        raise ValueError("the profiler mode is not mixed with the others")
    if not hasattr(profiling, "recording") and "recorder" in modes:
        raise ValueError("this program has no recorder (profiling.recording)")
    driver = load_driver(cell.traffic["driver"])
    ctx = Context(cell, seed, seconds, traced, device, Spans(traced))
    session = driver.Session(ctx)
    session.warmup()
    ctx.sync()
    reset = getattr(profiling, "reset_counters", None)
    read = getattr(profiling, "counters", None)
    for mode in modes:
        ctx.units = []
        session.outputs.clear()  # each window starts as a run's does
        if reset is not None:
            reset()
        t0, timer, events = _window(session, ctx, mode)
        n = len(ctx.units)
        window_s = ctx.units[-1].end - t0
        line = {"workload": cell.name, "seed": seed, "mode": mode, "units": n,
                "candidates_per_s": ctx.work("candidates") / window_s,
                "device": _power_limit() if device != "cpu" else "cpu"}
        if timer is not None:
            self_s = timer.self_s()
            line["span_ms_a_unit"] = {k: {"total": 1e3 * v / n, "self": 1e3 * self_s[k] / n}
                                      for k, v in timer.totals.items()}
        if events is not None:
            line.update(_idle(events, ctx.spans.times, n))
        if read is not None:
            line["counters"] = {k: v for k, v in read().items()
                                if not k.startswith("launches.")}
        yield line
    session.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--modes", nargs="+", choices=MODES, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_port.run import set_environment

    set_environment()
    from bench_port.harness.manifest import find_cell

    cell = find_cell(ROOT, args.workload)
    for line in run(cell, args.seed, args.seconds, args.modes):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
