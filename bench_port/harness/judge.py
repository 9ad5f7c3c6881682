"""The comparison that decides ``correct``: each number that the cell file's
``limits`` names, against its limit. A number is within its limit when it is
finite and no larger; a limit whose number the driver did not report fails.
A number the cell names no limit for is not compared (a cell chooses its
numbers by its limits)."""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple


def decide(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    checks = []
    ok = True
    for name in sorted(limits):
        value, limit = numbers.get(name), limits[name]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks.append({"name": name, "value": value, "limit": limit})
    return ok, checks


def print_checks(checks: List[dict]) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr,
              flush=True)
