"""Device idle time inside named host ranges of a traced window.

``trace.reduce_events`` labels each idle gap by the ranges running through
its middle and keeps the ten largest labels. ``span_idle_s`` is exact: for
each name, the intersection of the window's idle intervals (the window less
the union of the device's operations) with the union of that name's ranges.
``tools/program_spans.py`` reads the program's spans with it."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from bench_port.harness.trace import _union

Interval = Tuple[int, int]


def idle_intervals(device_events, window: Interval) -> List[Interval]:
    """The window less the union of the device operations (name, start_ns,
    end_ns) clipped to it, in order."""
    w0, w1 = window
    busy = _union([(max(s, w0), min(e, w1)) for _, s, e in device_events if e > w0 and s < w1])
    out, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The length of the intersection of two ordered lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_idle_s(device_events, host_events, window: Interval,
                names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """{name: device idle seconds inside that name's ranges} over the
    host_events (name, start_ns, end_ns, is_span) that are spans, of
    ``names`` only when given."""
    keep = None if names is None else set(names)
    ranges: Dict[str, List[Interval]] = defaultdict(list)
    for name, s, e, is_span in host_events:
        if is_span and (keep is None or name in keep):
            ranges[name].append((s, e))
    idle = idle_intervals(device_events, window)
    return {name: overlap_ns(idle, _union(r)) * 1e-9 for name, r in ranges.items()}


def idle_outside_s(device_events, host_events, window: Interval,
                   names: Iterable[str]) -> float:
    """Device idle seconds inside no span of ``names``."""
    keep = set(names)
    inside = _union([(s, e) for name, s, e, is_span in host_events if is_span and name in keep])
    idle = idle_intervals(device_events, window)
    return (sum(e - s for s, e in idle) - overlap_ns(idle, inside)) * 1e-9


def profiler_events(prof, window_name: str):
    """(device events, host events, window) of a finished
    ``torch.profiler.profile`` whose window is a ``record_function``
    range named ``window_name``, in the forms above (as ``trace.from_profiler``
    reads them)."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, s, e))
        elif name == window_name:
            window = (s, e)
        else:
            host.append((name, s, e, bool(ev.is_user_annotation())))
    if window is None:
        raise RuntimeError(f"the trace holds no {window_name!r} range")
    return device, host, window
