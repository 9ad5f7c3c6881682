"""What the metric readers share. Each returns None where it finds nothing
to read (an untraced run, a kernel the trace does not name), never 0 for a
share of a roofline or a peak."""

from __future__ import annotations

import re
from typing import Optional

from bench_port.harness.costs import PEAK
from bench_port.harness.stats import percentile, rate


def work_rate(ctx, key: str) -> Optional[float]:
    return rate(ctx.work(key), ctx.window_s) if ctx.units else None


def unit_ms_percentile(ctx, q: float) -> Optional[float]:
    return percentile([1e3 * u.seconds for u in ctx.units], q) if ctx.units else None


def device_idle_pct(ctx) -> Optional[float]:
    dt = ctx.device_trace
    if dt is None or dt.window_s <= 0 or dt.launches == 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)


def launches_per_unit(ctx) -> Optional[float]:
    dt = ctx.device_trace
    if dt is None or dt.launches == 0 or not ctx.units:
        return None
    return dt.launches / len(ctx.units)


def kernel_roofline_pct(ctx, pattern: str, cost: str) -> Optional[float]:
    """100 x the least time of one launch (``ctx.costs``: '<cost>.bound_s'
    over '<cost>.launches', from the reference's shapes) / the mean device
    time of a launch of the kernels whose names match ``pattern`` (the
    profiler's)."""
    dt = ctx.device_trace
    bound, count = ctx.costs.get(f"{cost}.bound_s"), ctx.costs.get(f"{cost}.launches")
    if dt is None or not bound or not count:
        return None
    rx = re.compile(pattern)
    secs = sum(v for k, v in dt.kernel_s.items() if rx.search(k))
    n = sum(v for k, v in dt.kernel_count.items() if rx.search(k))
    if n == 0 or secs <= 0:
        return None
    return 100.0 * (bound / count) / (secs / n)


def mfu_pct(ctx) -> Optional[float]:
    """100 x the least time the published peaks need for a unit's product
    FLOPs (counted over the reference) / the traced window's time a unit."""
    flops = {k.split(".", 1)[1]: v for k, v in ctx.costs.items() if k.startswith("flops.")}
    if not flops or not ctx.units or ctx.device_trace is None or not ctx.device_trace.launches:
        return None
    least = sum(n / PEAK[kind] for kind, n in flops.items())
    return 100.0 * least / (ctx.window_s / len(ctx.units))


def span_ms(ctx, name: str) -> Optional[float]:
    return ctx.spans.mean_ms(name)

