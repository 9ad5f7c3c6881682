"""Spans, counters and the device trace of a traced run.

Spans are the benchmark's own, put around calls into the program's layers
by the drivers: ``Spans.span(name)`` records the host time of each call and,
while the profiler runs, a ``record_function`` range of the same name, so
that the trace can say what the host was doing while the device idled.
With tracing off a span costs one attribute test.

``reduce_trace`` turns the profiler's events into what the readers take:
the union of kernel intervals (busy), the traced window, kernel time and
launches by name, the longest idle gaps labelled by the innermost span or
host operation running through them, and the device operations that took
the most time."""

from __future__ import annotations

import contextlib
import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


class Spans:
    """Host times of named calls, in seconds; on only in traced runs."""

    def __init__(self, on: bool):
        self.on = on
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; ``sync`` (a callable, e.g. torch.cuda.synchronize)
        runs at both ends so the span holds the device work it queued."""
        if not self.on:
            yield
            return
        from torch.profiler import record_function

        if sync is not None:
            sync()
        t0 = time.perf_counter()
        with record_function(name):
            yield
            if sync is not None:
                sync()
        self.times[name].append(time.perf_counter() - t0)

    def wrap(self, obj, attr: str, name: str, sync=None) -> None:
        """Put a span around ``obj.attr`` (a bound method or function) on
        this instance only."""
        if not self.on:
            return
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)

        setattr(obj, attr, spanned)

    def mean_ms(self, name: str) -> Optional[float]:
        xs = self.times.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)      # device seconds by name
    kernel_count: Dict[str, int] = field(default_factory=dict)    # launches by name
    launches: int = 0
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)


_NOT_KERNELS = ("Memcpy", "Memset", "cudaMemcpy", "cudaMemset")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _labels(host_events, points: List[int]) -> List[str]:
    """For each time point, "<innermost span> > <innermost host operation>"
    running through it (a sweep: points in order, ranges in a max-heap by
    start, those that ended dropped lazily)."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    hosts = sorted(host_events, key=lambda h: h[1])
    heaps = ([], [])  # spans, host operations: (-start, end, name)
    out = [""] * len(points)
    j = 0
    for i in order:
        p = points[i]
        while j < len(hosts) and hosts[j][1] <= p:
            name, s, e, is_span = hosts[j]
            heapq.heappush(heaps[0 if is_span else 1], (-s, e, name))
            j += 1
        names = []
        for heap in heaps:
            while heap and heap[0][1] < p:
                heapq.heappop(heap)
            names.append(heap[0][2] if heap else None)
        out[i] = " > ".join(n for n in names if n) or "no host range"
    return out


def reduce_events(device_events, host_events, window: Tuple[int, int], top: int = 10,
                  ) -> DeviceTrace:
    """device_events: (name, start_ns, end_ns) of every device operation;
    host_events: (name, start_ns, end_ns, is_span) of host ranges; window:
    (start_ns, end_ns). Device operations are clipped to the window."""
    w0, w1 = window
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_count: Dict[str, int] = defaultdict(int)
    intervals = []
    for name, s, e in device_events:
        if e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        intervals.append((s, e))
        kernel_s[name] += (e - s) * 1e-9
        if not name.startswith(_NOT_KERNELS):
            kernel_count[name] += 1
    busy = _union(intervals)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled: Dict[str, float] = defaultdict(float)
    for (g0, g1), label in zip(gaps, _labels(host_events, [(g0 + g1) // 2 for g0, g1 in gaps])):
        labelled[label] += (g1 - g0) * 1e-9
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:top]
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return DeviceTrace(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, kernel_s=dict(kernel_s),
                       kernel_count=dict(kernel_count),
                       launches=sum(kernel_count.values()), idle_gaps=idle, device_ops=ops)


def from_profiler(prof) -> DeviceTrace:
    """Reduce a finished ``torch.profiler.profile`` whose window was recorded
    as a ``record_function(WINDOW)`` range."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            device.append((name, s, e))
        elif name == WINDOW:
            window = (s, e)
        else:
            host.append((name, s, e, bool(ev.is_user_annotation())))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    return reduce_events(device, host, window)
