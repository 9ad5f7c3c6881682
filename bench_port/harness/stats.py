"""Statistics over every sample of a window: no medians of chunks, so a
stall inside the window shows in the metric."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the two
    nearest ranks (numpy's default 'linear' method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work completed in the window over the window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds

