"""ctypes binding of the repo's native host core (``native/gp2_host.cc``,
outside both packages): ``extract_cloud``, the fused backprojection and
sampling of a crop's valid pixels, and ``exr_chunk``, the fused inflate and
reorder of one EXR chunk.

The front end takes the native branch exactly when the JAX package does
(genpose2_tpu/data/native.py): the library is there or ``make -C native``
builds it, and ``GP2_DISABLE_NATIVE`` is unset. The native branch samples with
its own generator, seeded from the caller's numpy generator, so the two
branches pick different points from the same frame. ``data/exr.py`` takes
``exr_chunk`` exactly when the JAX package's reader takes it: the library is
there, it has the entry, and ``GP2_DISABLE_NATIVE`` is unset; both decoders
give the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
SO_PATH = os.path.join(NATIVE_DIR, "libgp2_host.so")

_lib: Optional[ctypes.CDLL] = None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built with ``make`` on first use; None when it
    cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(SO_PATH):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        if not os.path.exists(SO_PATH):
            return None
    lib = ctypes.CDLL(SO_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.gp2_extract_cloud.argtypes = [
        f32p, u8p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_uint64, ctypes.c_int, f32p, i32p, i32p,
    ]
    lib.gp2_extract_cloud.restype = ctypes.c_int
    if hasattr(lib, "gp2_exr_chunk"):  # an older built library lacks it
        lib.gp2_exr_chunk.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int]
        lib.gp2_exr_chunk.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    if os.environ.get("GP2_DISABLE_NATIVE"):
        return False
    return get_lib() is not None


def exr_chunk(zdata: bytes, expect: int) -> Optional[np.ndarray]:
    """Inflate one EXR ZIP chunk and undo its predictor and interleave
    natively: the decoded (expect,) uint8 block, or None when the native
    branch is off (the caller decodes in numpy)."""
    if os.environ.get("GP2_DISABLE_NATIVE"):
        return None
    lib = get_lib()
    if lib is None or not hasattr(lib, "gp2_exr_chunk"):
        return None
    out = np.empty(expect, np.uint8)
    n = lib.gp2_exr_chunk(zdata, len(zdata), out, expect)
    if n != expect:
        raise ValueError(f"native EXR chunk decode failed (rc={n})")
    return out


def extract_cloud(roi_depth: np.ndarray, roi_mask: np.ndarray, coord_x: np.ndarray,
                  coord_y: np.ndarray, fx: float, fy: float, cx: float, cy: float, n_pts: int,
                  seed: int = 0):
    """Backproject the pixels with depth > 0 and mask > 0 and sample n_pts of
    them in one native call. Returns (n_valid, pts (n_pts, 3), rows (n_pts,),
    cols (n_pts,)), or (0, None, None, None) when no pixel is valid."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native library {SO_PATH} is not available")
    h, w = roi_depth.shape
    pts = np.zeros((n_pts, 3), np.float32)
    rows = np.zeros(n_pts, np.int32)
    cols = np.zeros(n_pts, np.int32)
    n_valid = lib.gp2_extract_cloud(
        np.ascontiguousarray(roi_depth, np.float32), np.ascontiguousarray(roi_mask, np.uint8),
        np.ascontiguousarray(coord_x, np.float32), np.ascontiguousarray(coord_y, np.float32),
        h, w, fx, fy, cx, cy, seed, n_pts, pts, rows, cols)
    if n_valid == 0:
        return 0, None, None, None
    return int(n_valid), pts, rows, cols
