"""Each cell end to end at a tiny size on the CPU: the port's plain
versions against the frozen reference agree exactly (same code, same
weights from the seed, same inputs); the result line has the contract's
keys."""

import pytest
import torch

from bench_port.harness.runner import run_cell
from bench_port.tests.helpers import manifest, tiny_cell

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_matches_the_reference(name, trace):
    cell = tiny_cell(name, exact=True)
    r = run_cell(cell, 2 ** 31 + 977, 0.5, trace, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(cell.traffic["limits"])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:  # no device on the CPU: the device readers find nothing, spans read
        device = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
        assert not device & set(r["metrics"])
        assert set(r["metrics"]) == {m["name"] for m in cell.per_layer} - device
        assert {"busy_s", "window_s"} <= set(r["device"])


@pytest.mark.parametrize("name", CELLS)
def test_the_same_seed_gives_the_same_inputs(name):
    from bench_port.harness.manifest import load_driver
    from bench_port.harness.runner import Context
    from bench_port.harness.trace import Spans

    cell = tiny_cell(name)
    driver = load_driver(cell.traffic["driver"])
    outs = [driver.reference(Context(cell, seed, 0.0, False, "cpu", Spans(False)), [0, 3])
            for seed in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4)]
    for k in [k for k, v in outs[0][0].items() if torch.is_tensor(v)]:
        for u in range(2):
            assert (outs[0][u][k] == outs[1][u][k]).all()
    assert not (outs[0][0]["candidates"] == outs[2][0]["candidates"]).all()
