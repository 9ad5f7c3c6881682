"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``configs/<config>.json`` (the path is the entry's ``file``);
- a cell's traffic: ``cells/<cell>.json``, which names its entry driver;
- an entry driver: ``drivers/<entry>.py``;
- a metric's reader: ``metrics/<metric>.py``, end-to-end and per-layer alike.

A later cell, configuration or metric is added by adding such files and
entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict       # the configuration file's content
    traffic: dict      # the cell file's content
    chips: int
    end_to_end: List[dict]   # the manifest's end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics this cell reports


def load_manifest(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_of_cell: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is not None:  # a per-layer metric without a list: every cell of its metric
        return metric["moves"] in e2e_of_cell
    return True


def find_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the manifest at ``root`` with its files read."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    with open(Path(root) / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "cells" / f"{name}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["config"], config, traffic, int(w["chips"]), e2e, per_layer)


def _load_file(path: Path, module_name: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(entry: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _load_file(bench_dir / "drivers" / f"{entry}.py", f"bench_port_driver_{entry}")


_readers: Dict[str, ModuleType] = {}


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader module of ``metric``: it defines ``read(ctx)``, which
    returns the metric's value or None when it finds nothing to read."""
    key = str(bench_dir / metric)
    if key not in _readers:
        safe = metric.replace(".", "_").replace("-", "_")
        _readers[key] = _load_file(bench_dir / "metrics" / f"{metric}.py",
                                   f"bench_port_metric_{safe}")
    return _readers[key]
