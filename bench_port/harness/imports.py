"""Which loaded modules the benchmark forbids, compared by whole top-level
names (the part before the first dot): ``genpose2_tpu_torch`` is the port,
``genpose2_tpu`` is the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "genpose2_tpu")
PORT = "genpose2_tpu_torch"


def forbidden_loaded(names: Iterable[str] = None, also: Iterable[str] = ()) -> List[str]:
    """The top-level names among ``names`` (default: ``sys.modules``) that are
    forbidden, plus those in ``also``."""
    bad = set(FORBIDDEN) | set(also)
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & bad)
