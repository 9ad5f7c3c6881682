"""Spans, counters, tracing and stage timing (port of
genpose2_tpu/utils/profiling.py, whose ``trace_context`` and ``StageTimer``
keep their form here).

Spans. ``span(name)``, a context manager or a decorator, marks a stage where
the program does its work. While a ``torch.profiler`` runs, a span is a
``record_function`` range in the trace, on the clock of the device's
events, so that each stretch of device idle time can be put down to the
host's work beside it. While ``recording()`` is on, a ``StageTimer`` keeps
each span in memory: its name, start and end (``time.perf_counter_ns``),
the span that encloses it and its unit. With neither on, a span costs two
tests (``record_function`` alone costs about 14 us a call even with the
profiler off, so it is never entered unguarded). A unit span
(``unit=True``: one request, one evaluation batch; units do not nest) opens
a unit whose id the recorded spans inside it carry; in the trace a unit's
spans are the ranges inside its unit span's range.

Counters, read by ``counters()``, process-wide like the caching allocator
whose counts they include, and reset by ``reset_counters()``:

- ``host_reads``: reads of device tensors by the host (``to_host``);
- ``cuda_mallocs`` and ``alloc_retries``: the caching allocator's segment
  allocations (its ``cudaMalloc`` calls) and allocation retries on the
  current device, read at the call, less their values at the reset;
- ``launches.<kernel>``: ``ops/_cuda.py:launch_counts``;
- ``units`` and ``unit.<counter>`` (``host_reads``, ``cuda_mallocs``,
  ``alloc_retries``): the unit spans that closed while a profiler or a
  recorder was on, and what each counter moved inside them, so that a
  traced window's counts do not take in what ran before or after it;
- ``kernel_builds`` (``kernel_builds.<library>``): ``nvcc`` runs, and
  ``kernel_load_s``: seconds in ``_cuda.library`` building or loading a
  kernel library. These two cover the whole process; the reset leaves them.

``trace_context`` wraps a block in a ``torch.profiler`` trace (the CPU and,
on a card, the CUDA activity) and writes it where the JAX package's trace
goes: ``<log_dir>/plugins/profile/<time>/<host>.pt.trace.json``, a Chrome
trace that TensorBoard, Perfetto and ``chrome://tracing`` open.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import threading
import time
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

_profiler_on = torch._C._autograd._profiler_enabled
_recorder: Optional["StageTimer"] = None
_thread = threading.local()  # .stack: the open recorded spans; .unit: the open unit's id
_unit_ids = itertools.count(1)

_lock = threading.Lock()
_counts: Counter = Counter()   # host_reads, units, unit.*
_process: Counter = Counter()  # kernel_builds.<library>, kernel_load_s
_alloc_base: Tuple[int, int] = (0, 0)


# ------------------------------------------------------------------ spans
class span:
    """A named stage: ``with span("aggregate"):`` or ``@span("aggregate")``.
    ``unit=True`` opens a unit (see the module's docstring)."""

    __slots__ = ("name", "unit", "_range", "_timer", "_index", "_outer", "_at")

    def __init__(self, name: str, unit: bool = False):
        self.name = name
        self.unit = unit
        self._range = self._timer = None

    def __call__(self, fn):
        name, unit = self.name, self.unit

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, unit):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        timer = _recorder
        traced = _profiler_on()
        if timer is not None or traced:
            self._open(timer, traced)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None or self._timer is not None:
            self._close()
        return False

    def _open(self, timer: Optional["StageTimer"], traced: bool) -> None:
        st = _thread
        if self.unit:
            self._outer = getattr(st, "unit", None)
            st.unit = next(_unit_ids)
            self._at = _unit_counts()
        if traced:
            self._range = record_function(self.name)
            self._range.__enter__()
        if timer is not None:
            stack = st.__dict__.setdefault("stack", [])
            self._index = timer._open(self.name, stack[-1] if stack else None,
                                      getattr(st, "unit", None))
            stack.append(self._index)
            self._timer = timer

    def _close(self) -> None:
        # the recorded span starts after its range does and ends after it
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._timer is not None:
            _thread.stack.pop()
            self._timer._close(self._index, time.perf_counter_ns())
            self._timer = None
        if self.unit:
            host_reads, mallocs, retries = (b - a for a, b in zip(self._at, _unit_counts()))
            with _lock:
                _counts["units"] += 1
                _counts["unit.host_reads"] += host_reads
                _counts["unit.cuda_mallocs"] += mallocs
                _counts["unit.alloc_retries"] += retries
            _thread.unit = self._outer


@contextlib.contextmanager
def recording():
    """Keep every span opened inside the block in memory; yields the
    ``StageTimer`` that holds them (``summary()``, ``self_s()``,
    ``spans``)."""
    global _recorder
    timer = StageTimer()
    outer, _recorder = _recorder, timer
    try:
        yield timer
    finally:
        _recorder = outer


# --------------------------------------------------------------- counters
def _allocator() -> Tuple[int, int]:
    """(segment allocations, allocation retries) of the caching allocator
    on the current device since the process started; none before CUDA is
    initialised."""
    if not torch.cuda.is_initialized():
        return 0, 0
    stats = torch.cuda.memory_stats_as_nested_dict()
    return stats["segment"]["all"]["allocated"], stats["num_alloc_retries"]


def _unit_counts() -> Tuple[int, int, int]:
    return (_counts["host_reads"], *_allocator())


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x.detach().cpu()``. A tensor on a device makes the host wait for
    it: such a read is counted in ``host_reads`` and spanned as
    ``host_read``."""
    x = x.detach()
    if x.is_cpu:
        return x
    with span("host_read"):
        with _lock:
            _counts["host_reads"] += 1
        return x.cpu()


def note_kernel_load(library: str, seconds: float, built: bool) -> None:
    """``_cuda.library`` loaded ``library`` in ``seconds``, after an
    ``nvcc`` run when ``built``."""
    with _lock:
        _process["kernel_load_s"] += seconds
        if built:
            _process[f"kernel_builds.{library}"] += 1


def counters() -> Dict[str, float]:
    """The counters named in the module's docstring, read now."""
    from genpose2_tpu_torch.ops import _cuda

    mallocs, retries = _allocator()
    with _lock:
        builds = {k: v for k, v in _process.items() if k.startswith("kernel_builds.")}
        out = {"host_reads": _counts["host_reads"],
               "cuda_mallocs": mallocs - _alloc_base[0],
               "alloc_retries": retries - _alloc_base[1],
               "units": _counts["units"],
               **{k: v for k, v in _counts.items() if k.startswith("unit.")},
               "kernel_builds": sum(builds.values()), **builds,
               "kernel_load_s": _process["kernel_load_s"]}
    out.update((f"launches.{k}", v) for k, v in _cuda.launch_counts.items())
    return out


def reset_counters() -> None:
    """Start every counter but ``kernel_builds`` and ``kernel_load_s`` again
    from 0."""
    global _alloc_base
    from genpose2_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    with _lock:
        _counts.clear()
        _alloc_base = _allocator()


# ---------------------------------------------------------------- tracing
@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None):
    """torch.profiler trace around a block; no-op when log_dir is None.
    Yields the path the trace is written to (None for the no-op). The
    program's spans are ranges of the trace."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    run = os.path.join(log_dir, "plugins", "profile", time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(run, exist_ok=True)
    path = os.path.join(run, f"{socket.gethostname()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def _sync(tree) -> None:
    """Wait for the device work behind the first tensor of a tree (a CPU
    tensor is ready once it is returned)."""
    stack = [tree]
    while stack:
        x = stack.pop(0)
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack[:0] = list(x.values())
        elif isinstance(x, (list, tuple)):
            stack[:0] = list(x)


@dataclass
class Span:
    """One recorded span; ``parent`` is the index of the enclosing span in
    ``StageTimer.spans``, ``end_ns`` None while it is open."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    unit: Optional[int]


class StageTimer:
    """Accumulates wall-clock per named stage. ``sync_on`` (a tensor or a
    tree of them) makes the stage wait for the device work behind its first
    tensor: ``torch.cuda.synchronize`` on a CUDA tensor's device.

    As the recorder that ``recording()`` installs, it also keeps each span
    in ``spans`` and counts it in ``summary()``; ``self_s()`` gives each
    name's self time."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            dt = time.perf_counter() - start
            self.totals[name] += dt
            self.counts[name] += 1

    def _open(self, name: str, parent: Optional[int], unit: Optional[int]) -> int:
        self.spans.append(Span(name, time.perf_counter_ns(), None, parent, unit))
        return len(self.spans) - 1

    def _close(self, index: int, end_ns: int) -> None:
        s = self.spans[index]
        s.end_ns = end_ns
        self.totals[s.name] += (end_ns - s.start_ns) * 1e-9
        self.counts[s.name] += 1

    def self_s(self) -> Dict[str, float]:
        """{name: seconds}: the closed spans' durations less the part their
        children cover (the children of a span run one after another)."""
        covered: Dict[int, int] = defaultdict(int)
        for s in self.spans:
            if s.parent is not None and s.end_ns is not None:
                covered[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, float] = defaultdict(float)
        for i, s in enumerate(self.spans):
            if s.end_ns is not None:
                out[s.name] += (s.end_ns - s.start_ns - covered[i]) * 1e-9
        return dict(out)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
