"""The program's own counters (``genpose2_tpu_torch.utils.profiling``), for
the readers of per-layer metrics.

The readers run after the window, the reference's judgement and the release
of the program's state, so they read what the program's unit spans counted
inside the window's units (``units``, ``unit.<counter>``): a traced window
is the only place the benchmark runs them while a profiler is on. A program
without these counters (an older commit) and an untraced run give None."""

from __future__ import annotations

from typing import Dict, Optional


def program_counters(ctx) -> Optional[Dict[str, float]]:
    """``profiling.counters()`` of a traced run; None without a trace or
    without the counters."""
    if ctx.device_trace is None:
        return None
    from genpose2_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return None if read is None else read()


def per_unit(ctx, counter: str) -> Optional[float]:
    """What ``counter`` moved inside the program's unit spans of the traced
    window, a unit (a batch or a request)."""
    c = program_counters(ctx)
    if not c or not c.get("units"):
        return None
    return c[f"unit.{counter}"] / c["units"]


def process_counter(ctx, name: str) -> Optional[float]:
    """A counter that covers the whole process (set-up included)."""
    c = program_counters(ctx)
    return None if c is None or name not in c else float(c[name])
