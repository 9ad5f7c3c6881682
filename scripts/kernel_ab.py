"""What the kernel A/B scripts share (time_fps_ball_query.py,
time_ball_count_layernorm.py): build a parent checkout's sources and this
checkout's variant translation units with the port's nvcc flags, swap a
parent library into the port's wrappers, and write one JSON line per
measurement.

A script names its sources by the variant entries it adds: {name: text of a
translation unit that ``#include``s ``name.cu`` and adds an entry taking the
choice a plan makes}. The parent's ``name.cu`` is built as it is.
"""

import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """chip_smoke.py as a module, for its timing helpers and inputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all(parent, out_dir, variant_entries):
    """{("parent" | "variant", name): loaded library} for each name of
    variant_entries, one nvcc each, all started together; and {name: the
    variant's ptxas lines (registers, spills)}."""
    from genpose2_tpu_torch.ops import _cuda

    os.makedirs(out_dir, exist_ok=True)
    parent_csrc = os.path.join(parent, "genpose2_tpu_torch", "ops", "csrc")
    procs = {}
    for name, text in variant_entries.items():
        src = os.path.join(out_dir, f"{name}_variant.cu")
        with open(src, "w") as f:
            f.write(text)
        for key, csrc, src_, extra in ((("variant", name), str(_cuda.CSRC), src, ["-Xptxas", "-v"]),
                                       (("parent", name), parent_csrc,
                                        os.path.join(parent_csrc, f"{name}.cu"), [])):
            out = os.path.join(out_dir, f"lib{key[0]}_{name}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *extra, "-I", csrc, "-o", out, src_]
            procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True), out)
    libs, ptxas = {}, {}
    for key, (proc, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}: {err}")
        libs[key] = ctypes.CDLL(out)
        if key[0] == "variant":
            ptxas[key[1]] = [ln.strip() for ln in err.splitlines()
                             if "entry function" in ln or "registers" in ln or "spill" in ln]
    for name in variant_entries:
        _cuda.library(name)  # this checkout's, built before any swap
    return libs, ptxas


@contextlib.contextmanager
def library_of(libs, turn, name):
    """The wrappers run the parent's library of ``name`` on a "parent" turn,
    this checkout's on any other."""
    from genpose2_tpu_torch.ops import _cuda

    own = _cuda._libs[name]
    if turn == "parent":
        _cuda._libs[name] = libs["parent", name]
    try:
        yield
    finally:
        _cuda._libs[name] = own


def checked(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


class Log:
    """One JSON line per measurement, printed and written to ``path``; the
    first names the card (nvidia-smi's name and power limit) and torch."""

    def __init__(self, path):
        import torch

        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._sink = open(path, "w")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        self.emit({"device": smi.stdout.strip(), "torch": torch.__version__})

    def emit(self, obj):
        line = json.dumps(obj)
        print(line, flush=True)
        self._sink.write(line + "\n")

    def close(self):
        self._sink.close()
