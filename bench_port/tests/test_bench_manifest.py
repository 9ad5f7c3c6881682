"""The manifest and the files it names, found by name; a cell added from
files alone."""

import json
import shutil
import textwrap

import pytest

from bench_port.harness import configs
from bench_port.harness.manifest import BENCH_DIR, find_cell, load_driver, load_reader
from bench_port.tests.helpers import manifest

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["bench_port"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = find_cell(BENCH_DIR.parent, cell)
    assert hasattr(load_driver(c.traffic["driver"]), "Session")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(load_reader(m["name"]).read)
        assert m["moves"] in {x["name"] for x in c.end_to_end} if "moves" in m else True


@pytest.mark.parametrize("config", [c["name"] for c in manifest()["configs"]])
def test_config_files_hold_the_configuration_as_run(config):
    import genpose2_tpu_torch.config as port_config

    import bench_port.reference.config as ref_config

    entry = next(c for c in manifest()["configs"] if c["name"] == config)
    spec = json.loads((BENCH_DIR.parent / entry["file"]).read_text())
    assert spec["reduced"] == entry["reduced"] == []
    assert configs.as_json(configs.build(port_config, spec)) == spec["config"]
    assert configs.as_json(configs.build(ref_config, spec)) == spec["config"]


def test_a_config_that_differs_from_its_file_is_refused():
    import bench_port.reference.config as ref_config

    spec = json.loads((BENCH_DIR / "configs" / "pts_only.json").read_text())
    spec["changes"] = {}
    with pytest.raises(ValueError, match="model"):
        configs.build(ref_config, spec)


DUMMY_DRIVER = textwrap.dedent('''
    """A dummy entry: a small product on the CPU per unit."""
    import torch

    from bench_port.harness.runner import closed_loop


    def reference(ctx, units, control=False):
        return [float(u) for u in units]


    class Session:
        def __init__(self, ctx):
            self.ctx = ctx
            self.x = torch.ones(8, 8)
            self.out = {}

        def warmup(self):
            self.x @ self.x

        def window(self, t0, seconds, record):
            def step(i):
                self.out[i] = float(i) + float((self.x @ self.x)[0, 0]) * 0
                return {"items": 2}
            closed_loop(step, t0, seconds, record)

        def release(self):
            self.x = None

        def judge(self, units):
            return {"item_gap": max(abs(self.out[u] - r)
                                    for u, r in zip(units, reference(self.ctx, units)))}
''')


def test_a_cell_config_and_metric_added_from_files_alone(tmp_path):
    from bench_port.harness.runner import run_cell

    bench = tmp_path / "bench_port"
    for sub in ("configs", "cells", "drivers", "metrics"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    m = manifest()
    spec = json.loads((BENCH_DIR / "configs" / "pts_only.json").read_text())
    (bench / "configs" / "dummy.json").write_text(json.dumps(spec))
    m["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                         "file": "bench_port/configs/dummy.json", "reduced": [],
                         "why": "a dummy configuration"})
    m["workloads"].append({"name": "dummy.items", "config": "dummy", "traffic": "items",
                           "chips": 1, "why": "a dummy cell"})
    m["end_to_end"].append({"name": "items_per_s", "unit": "items/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["dummy.items"]})
    m["per_layer"].append({"name": "unit_ms_p50.dummy", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "Dummy", "moves": "items_per_s",
                           "workloads": ["dummy.items"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (bench / "cells" / "dummy.items.json").write_text(json.dumps(
        {"driver": "dummy", "judge_units": 2, "limits": {"item_gap": 0.0}}))
    (bench / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (bench / "metrics" / "items_per_s.py").write_text(
        "from bench_port.harness.readers import work_rate\n\n\n"
        "def read(ctx):\n    return work_rate(ctx, 'items')\n")
    (bench / "metrics" / "unit_ms_p50.dummy.py").write_text(
        "from bench_port.harness.readers import unit_ms_percentile\n\n\n"
        "def read(ctx):\n    return unit_ms_percentile(ctx, 50)\n")
    cell = find_cell(tmp_path, "dummy.items", bench)
    assert [x["name"] for x in cell.end_to_end] == ["setup_s", "items_per_s"]
    r = run_cell(cell, 2 ** 31 + 5, 0.2, False, "cpu", bench_dir=bench)
    assert r["correct"] and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "items_per_s"}
    assert r["metrics"]["items_per_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    r = run_cell(cell, 7, 0.2, True, "cpu", bench_dir=bench)
    assert set(r["metrics"]) == {"unit_ms_p50.dummy"}
