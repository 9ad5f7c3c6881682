"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, and loaded with ``ctypes``. The
build happens at first use, into ``_build/`` beside this file (git ignores
it), one ``nvcc`` process per source, all started together. A library's file
name carries a hash of its source, the shared header and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.

Which version of an op runs is decided here alone: each op wrapper asks
``launches(t)`` and runs its plain PyTorch version where that is false (a CPU
tensor, or any tensor inside ``plain_versions()``, the card tests' scope);
otherwise it launches its kernel or raises, and never falls back.

``launch_counts`` is one of the port's counters (``utils/profiling.py`` holds
the others, and ``profiling.reset_counters()`` resets them all): each op
wrapper adds one to its kernel's entry where it launches the kernel, and
nowhere else, so a run can show that the main path went through the kernels.
``library`` adds the seconds it spends building or loading a library to
``profiling``'s ``kernel_load_s``, and each ``nvcc`` run to its
``kernel_builds``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator

import torch

from genpose2_tpu_torch.utils import profiling

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("fps", "ball_count", "fused_sa", "ode_rk4", "layernorm", "relpe_attention",
           "vit_attention", "ball_query")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# the launch_counts entry of each kernel wrapper
KERNELS = ("fps", "ball_count", "fused_sa_stage", "fused_rk4", "residual_layernorm",
           "add_layernorm", "relpe_attention", "vit_attention", "ball_query", "fused_sa_scale",
           "fused_group_mlp_pool", "layernorm", "vit_attention_unpadded", "vit_attention_rope")

launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_plain = False  # inside plain_versions()


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Inside the block every op runs its plain PyTorch version, on any
    device; nested blocks and exceptions restore what was before."""
    global _plain
    saved, _plain = _plain, True
    try:
        yield
    finally:
        _plain = saved


def launches(t: torch.Tensor) -> bool:
    """Whether an op on ``t`` launches its kernel: ``t`` is off the CPU and
    the call is outside ``plain_versions()``."""
    return t.device.type != "cpu" and not _plain


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile the named sources that are not built yet, all at once.

    Returns {name: {"seconds": wall time of its nvcc (0 if cached),
    "log": nvcc's stderr}}. Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(out)}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        report[name] = {"seconds": seconds, "log": stdout + stderr, "path": str(out)}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with profiling.span("setup.kernel_library"):
                t0 = time.perf_counter()
                report = build([name])[name]
                lib = ctypes.CDLL(report["path"])
                lib.gp2_strerror.argtypes = [ctypes.c_int]
                lib.gp2_strerror.restype = ctypes.c_char_p
                _libs[name] = lib
                profiling.note_kernel_load(name, time.perf_counter() - t0,
                                           built=report["seconds"] > 0)
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: {lib.gp2_strerror(code).decode()}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Check one kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
