"""Freeze the port's plain code paths into ``bench_port/reference/``.

    python3 bench_port/tools/freeze_reference.py [--commit SHA]

Copies the modules of ``genpose2_tpu_torch`` that the benchmark imports
(``ROOTS`` and every module of the port they import, found by reading their
imports) into ``bench_port/reference/``, and the traffic generator
(``GENERATORS``) into ``bench_port/gen/``, with these rewrites:

- imports of ``genpose2_tpu_torch`` become imports of ``bench_port.reference``;
- each op wrapper's dispatch (``if x.device.type == "cpu": return ...``)
  becomes its plain branch alone: the kernel route after it goes, and so do
  the private functions, the op wrappers' functions and the imports that
  only the kernel routes used;
- ``parallel/`` is a stand-in with the no-mesh bodies of the helpers the
  models call (``active_mesh``, ``batch_rand``, ``batch_randn``).

The copy launches no kernel and loads no native library. ``SOURCES.json``
records each copy's source file, the commit it was copied from, the sha256
of the source and the kernel routes removed. The copy is made once and
committed; a run of the benchmark never calls this script, and the copy
never imports the port. Reads files only: it imports nothing of the port
either.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PORT = ROOT / "genpose2_tpu_torch"
DEST = ROOT / "bench_port" / "reference"
GEN = ROOT / "bench_port" / "gen"
# what the harness and the generator import of the reference
ROOTS = ("config", "training/agent", "eval/aggregate", "eval/metrics", "so3/rotations",
         "data/loader", "diffusion/sde", "models/vit", "models/fast_encoder", "ops/ball_query")
# the traffic generator, copied to bench_port/gen/ (its imports go to the reference)
GENERATORS = ("data/synthetic",)
STAND_INS = ("parallel/__init__", "parallel/mesh")

HEADER = ('# Frozen copy of genpose2_tpu_torch/{src} at commit {commit}, made by\n'
          '# bench_port/tools/freeze_reference.py: imports rewritten{extra}. Do not edit.\n')

PARALLEL_STANDIN = '''"""Stand-in for the port's parallel/: the reference runs in one process."""
'''

MESH_STANDIN = '''"""Stand-in for the port's parallel/mesh.py: the no-mesh bodies of the
helpers the models call; the reference runs in one process."""

import torch


def active_mesh():
    return None


def batch_rand(shape, generator=None, device=None, batch_axis: int = 0, **kw) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device, **kw)


def batch_randn(shape, generator=None, device=None, batch_axis: int = 0, **kw) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, **kw)
'''

_IMPORT = re.compile(r'^(\s*)(from|import) genpose2_tpu_torch\b', re.M)
_PORT_IMPORT, _COPY_IMPORT = (
    re.compile(rf'^\s*from {pkg}((?:\.\w+)*) import (?:\(([^)]*)\)|([\w ,]+))'
               rf'|^\s*import {pkg}((?:\.\w+)+)', re.M)
    for pkg in (r"genpose2_tpu_torch", r"bench_port\.reference"))


def _is_dispatch(node: ast.stmt) -> bool:
    """``if <x>.device.type == "cpu": ... return ...`` without an else."""
    if not (isinstance(node, ast.If) and not node.orelse
            and isinstance(node.body[-1], ast.Return)):
        return False
    t = node.test
    return (isinstance(t, ast.Compare) and len(t.ops) == 1 and isinstance(t.ops[0], ast.Eq)
            and isinstance(t.left, ast.Attribute) and t.left.attr == "type"
            and isinstance(t.left.value, ast.Attribute) and t.left.value.attr == "device"
            and isinstance(t.comparators[0], ast.Constant) and t.comparators[0].value == "cpu")


def plain_dispatches(src: str) -> tuple[str, int]:
    """Each dispatch replaced by its plain branch, dedented, and the kernel
    route after it (the rest of its function) dropped."""
    lines = src.splitlines(keepends=True)
    edits = []
    for fn in ast.walk(ast.parse(src)):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for k, stmt in enumerate(fn.body):
                if _is_dispatch(stmt):
                    body = lines[stmt.body[0].lineno - 1:stmt.body[-1].end_lineno]
                    edits.append((stmt.lineno - 1, fn.body[-1].end_lineno,
                                  [ln[4:] if ln.startswith(" " * 4) else ln for ln in body]))
                    break
    for start, end, body in sorted(edits, reverse=True):
        lines[start:end] = body
    return "".join(lines), len(edits)


def _span(node: ast.stmt) -> tuple[int, int]:
    first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
    return first - 1, node.end_lineno


def _drop(src: str, spans) -> str:
    lines = src.splitlines(keepends=True)
    for start, end in sorted(spans, reverse=True):
        while end < len(lines) and not lines[end].strip() and (
                start == 0 or not lines[start - 1].strip()):
            end += 1  # the blank lines after it too, where blank lines precede it
        del lines[start:end]
    return "".join(lines)


def drop_dead_functions(texts: dict, users: str) -> None:
    """Top-level functions that nothing names any more, until none is left:
    private ones that their module no longer names, and public ones of the
    op wrappers (``ops/``) that neither the copy nor ``users`` (the
    harness's text) names."""
    while True:
        changed = False
        for mod, src in texts.items():
            everything = "\n".join(texts.values()) + users
            dead = [_span(node) for node in ast.parse(src).body
                    if isinstance(node, ast.FunctionDef) and not node.name.startswith("__")
                    and (node.name.startswith("_") or mod.startswith("ops/"))
                    and len(re.findall(rf"\b{node.name}\b",
                                       src if node.name.startswith("_") else everything)) == 1]
            if dead:
                texts[mod] = _drop(src, dead)
                changed = True
        if not changed:
            return


def drop_unused_imports(src: str) -> str:
    """Top-level one-line imports whose names the module no longer uses."""
    tree = ast.parse(src)
    dead = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)) and node.lineno == node.end_lineno:
            if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                continue
            names = [(a.asname or a.name).split(".")[0] for a in node.names]
            rest = src.splitlines()
            del rest[node.lineno - 1]
            body = "\n".join(rest)
            if all(not re.search(rf"\b{n}\b", body) for n in names):
                dead.append(_span(node))
    return _drop(src, dead)


def port_imports(src: str, pattern=_PORT_IMPORT) -> set:
    """The port's modules that ``src`` imports (packages as their __init__)."""
    out = set()
    for m in pattern.finditer(src):
        path = (m.group(1) or m.group(4) or "").strip(".").replace(".", "/")
        if (PORT / path).is_dir():
            out.add(f"{path}/__init__" if path else "__init__")
            for name in (m.group(2) or m.group(3) or "").replace("\n", " ").split(","):
                name = name.strip()
                if name and (PORT / path / f"{name}.py").exists():
                    out.add(f"{path}/{name}" if path else name)
        else:
            out.add(path)
    return out


def closure(roots, source, pattern) -> list:
    """``roots``, the packages above them and every module they import
    (``source(mod)`` its text, ``pattern`` its imports), but the
    stand-ins."""
    seen, todo = set(), list(roots)
    while todo:
        mod = todo.pop()
        if mod in seen or mod in STAND_INS:
            continue
        seen.add(mod)
        parts = mod.split("/")
        todo += ["/".join(parts[:i] + ["__init__"]) for i in range(len(parts))]
        todo += port_imports(source(mod), pattern)
    return sorted(seen - set(STAND_INS))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--commit", default=None, help="the commit copied (default: git HEAD)")
    args = ap.parse_args()
    commit = args.commit or subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                           capture_output=True, text=True,
                                           check=True).stdout.strip()
    modules = closure(ROOTS, lambda m: (PORT / f"{m}.py").read_text(), _PORT_IMPORT)
    texts, routes = {}, {}
    for mod in modules + [f"../gen/{g}" for g in GENERATORS]:
        src = (PORT / f"{mod.replace('../gen/', '')}.py").read_text()
        texts[mod], routes[mod] = plain_dispatches(_IMPORT.sub(
            lambda m: f"{m.group(1)}{m.group(2)} bench_port.reference", src))
    users = "\n".join(f.read_text() for sub in ("harness", "drivers", "gen", "metrics", "tools")
                       for f in (ROOT / "bench_port" / sub).glob("*.py"))
    drop_dead_functions(texts, users)
    texts = {m: t if m.endswith("__init__") else drop_unused_imports(t)
             for m, t in texts.items()}
    gens = [m for m in texts if m.startswith("../gen/")]
    kept = closure(list(ROOTS) + list(GENERATORS),
                   lambda m: texts[m] if m in texts else texts[f"../gen/{m}"], _COPY_IMPORT)
    texts = {m: t for m, t in texts.items() if m in kept or m in gens}
    if "ops/_cuda" in texts:
        raise RuntimeError("a plain path of the copy still imports ops/_cuda")
    shutil.rmtree(DEST, ignore_errors=True)
    sources = {}
    for mod, body in texts.items():
        src_mod = mod.replace("../gen/", "")
        src = (PORT / f"{src_mod}.py").read_text()
        n = routes[mod]
        extra = f", {n} kernel route(s) removed" if n else ""
        target = GEN / f"{src_mod.split('/')[-1]}.py" if mod.startswith("../gen/") \
            else DEST / f"{mod}.py"
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(HEADER.format(src=f"{src_mod}.py", commit=commit, extra=extra)
                          + body)
        key = f"../gen/{target.name}" if mod.startswith("../gen/") else f"{mod}.py"
        sources[key] = {"source": f"genpose2_tpu_torch/{src_mod}.py", "commit": commit,
                        "sha256": hashlib.sha256(src.encode()).hexdigest(),
                        "kernel_routes_removed": n}
    for mod, text in zip(STAND_INS, (PARALLEL_STANDIN, MESH_STANDIN)):
        (DEST / f"{mod}.py").parent.mkdir(parents=True, exist_ok=True)
        (DEST / f"{mod}.py").write_text(text)
        sources[f"{mod}.py"] = {"source": f"genpose2_tpu_torch/{mod}.py", "commit": commit,
                                "stand_in": "no-mesh bodies: one process"}
    (DEST / "SOURCES.json").write_text(json.dumps(sources, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
