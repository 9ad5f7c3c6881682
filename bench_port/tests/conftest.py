"""Tests of the benchmark's own files, on the CPU (the ``gpu`` ones decide
inside the test whether there is a card). Run them from the repository's
root: ``python -m pytest bench_port/tests -p no:cacheprovider -n 0``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
