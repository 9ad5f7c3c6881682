"""Tracing and stage timing (port of genpose2_tpu/utils/profiling.py).

- ``trace_context`` wraps a block in a ``torch.profiler`` trace (the CPU
  and, on a card, the CUDA activity) and writes it where the JAX package's
  trace goes: ``<log_dir>/plugins/profile/<time>/<host>.pt.trace.json``, a
  Chrome trace that TensorBoard, Perfetto and ``chrome://tracing`` open;
- ``StageTimer`` collects per-stage wall-clock, the block's device work
  waited for.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from typing import Optional

import torch


@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None):
    """torch.profiler trace around a block; no-op when log_dir is None.
    Yields the path the trace is written to (None for the no-op)."""
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


class StageTimer:
    """Accumulates wall-clock per named stage. ``sync_on`` (a tensor or a
    tree of them) makes the stage wait for the device work behind its first
    tensor: ``torch.cuda.synchronize`` on a CUDA tensor's device."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

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
