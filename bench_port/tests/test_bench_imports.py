"""What a run may load: no module whose whole top-level name is jax, jaxlib,
flax or genpose2_tpu (the JAX package; genpose2_tpu_torch, the port, is
allowed), and the frozen reference loads nothing of the port either."""

import json
import subprocess
import sys

import pytest

from bench_port.harness.imports import forbidden_loaded
from bench_port.tests.conftest import ROOT


def test_names_compare_whole_top_level_names():
    names = ["genpose2_tpu_torch", "genpose2_tpu_torch.ops._cuda", "jaxtyping", "flaxen.x",
             "genpose2_tpu.models", "jax.numpy", "jaxlib"]
    assert forbidden_loaded(names) == ["genpose2_tpu", "jax", "jaxlib"]
    assert forbidden_loaded(["genpose2_tpu_torch.x"], also=["genpose2_tpu_torch"]) == \
        ["genpose2_tpu_torch"]


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_port_or_jax():
    got = _python(
        "import json, sys, pkgutil, importlib\n"
        "import bench_port.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'bench_port.reference.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bench_port.gen.synthetic, bench_port.gen.batches\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    assert not {"genpose2_tpu_torch", "genpose2_tpu", "jax", "jaxlib", "flax"} & set(got)


def test_a_run_loads_no_forbidden_module():
    got = _python(
        "import json, sys\n"
        "from bench_port.tests.helpers import tiny_cell\n"
        "from bench_port.harness.runner import run_cell\n"
        "r = run_cell(tiny_cell('pts_only.serve128', exact=True), 3, 0.3, False, 'cpu')\n"
        "print(json.dumps([r['correct'], sorted({k.split('.')[0] for k in sys.modules})]))\n")
    assert got[0] is True
    assert "genpose2_tpu_torch" in got[1]
    assert not {"genpose2_tpu", "jax", "jaxlib", "flax"} & set(got[1])


def test_a_run_with_a_forbidden_module_loaded_gives_no_result():
    got = _python(
        "import json, sys, types\n"
        "from bench_port.tests.helpers import tiny_cell\n"
        "from bench_port.harness.runner import Refusal, run_cell\n"
        "sys.modules['genpose2_tpu'] = types.ModuleType('genpose2_tpu')\n"
        "try:\n"
        "    run_cell(tiny_cell('pts_only.serve128', exact=True), 3, 0.3, False, 'cpu')\n"
        "    print(json.dumps('no refusal'))\n"
        "except Refusal as e:\n"
        "    print(json.dumps(str(e)))\n")
    assert "genpose2_tpu" in got and "no refusal" not in got


@pytest.mark.parametrize("argv", [["--workload", "pts_only.serve128", "--seed", "3",
                                   "--seconds", "1", "--trace", "0"]])
def test_the_command_refuses_without_a_card(argv):
    out = subprocess.run([sys.executable, "bench_port/run.py", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_without_the_program_beside_it_a_run_gives_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and bench_port/ has no program
    to run: the run refuses before set-up."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "from bench_port.harness.runner import Refusal, _check_program\n"
            "try:\n"
            "    _check_program(Path('.').resolve())\n"
            "except Refusal as e:\n"
            "    print('refused:', e); sys.exit(2)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 2 and "refused" in out.stdout, out.stdout + out.stderr
