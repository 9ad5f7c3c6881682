"""The control of each cell's comparison comes out as not correct at the
cell's own limits: the frozen reference in the program's place at the
nearest precision below the configuration's (TF32 for float32 products, fp8
operands for the backbone's bf16 products), and TF32 alone, on the cell's
own inputs and sizes, one seed. Needs a CUDA card; skips without one."""

import pytest

from bench_port.harness.judge import decide
from bench_port.harness.manifest import find_cell
from bench_port.tests.conftest import ROOT
from bench_port.tests.helpers import manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("tf32_only", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_incorrect(name, tf32_only):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_port.tools.control import readings

    limits = find_cell(ROOT, name).traffic["limits"]
    got = readings(name, 2 ** 31 + 1234, tf32_only=tf32_only)
    ok, checks = decide({k: got.get(k, 0.0) for k in limits}, limits)
    assert not ok, checks
