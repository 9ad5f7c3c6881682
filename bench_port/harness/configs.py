"""A configuration file -> the ``Config`` that a package's
``default_config()`` gives with the file's ``changes`` applied.

The file holds ``source``, ``base`` (the name of a function of the
package's ``config`` module, as a rule ``default_config``), ``changes``
(dotted keys, e.g. ``"model.dino": "none"``), ``assumed``, ``reduced``, and
``config``: the whole configuration as it is run, which ``build`` checks
against what it built. The same file builds the port's configuration and the
reference's, each from its own package."""

from __future__ import annotations

import dataclasses
import json
from types import ModuleType


def _replace(obj, dotted: str, value):
    head, _, rest = dotted.partition(".")
    cur = getattr(obj, head)
    if rest:
        value = _replace(cur, rest, value)
    elif isinstance(cur, tuple):
        value = _tuple(value)
    return dataclasses.replace(obj, **{head: value})


def _tuple(v):
    return tuple(_tuple(x) for x in v) if isinstance(v, list) else v


def as_json(cfg) -> dict:
    """The configuration as JSON would hold it (tuples as lists)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def build(config_module: ModuleType, spec: dict):
    """The configuration of ``spec`` from ``config_module``'s base function;
    raises when it differs from the file's ``config``."""
    cfg = getattr(config_module, spec.get("base", "default_config"))()
    for key, value in spec.get("changes", {}).items():
        cfg = _replace(cfg, key, value)
    if "config" in spec and as_json(cfg) != spec["config"]:
        got, want = as_json(cfg), spec["config"]
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise ValueError(f"the configuration built differs from the file's in {diff}")
    return cfg
