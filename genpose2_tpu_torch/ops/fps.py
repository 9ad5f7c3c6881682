"""Furthest point sampling (port of genpose2_tpu/ops/fps.py).

The first pick is index 0; each next pick is the argmax of the running min
squared distance to the picks so far, ties to the lowest index.

``furthest_point_sample`` launches the CUDA kernel (``csrc/fps.cu``) on a
CUDA tensor, for any N (past ``MAX_REGISTER_POINTS`` with a float32 scratch
of B x N for the running distances), and runs ``fps_plain`` otherwise
(``_cuda.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genpose2_tpu_torch.ops import _cuda

_BIG = 1e10
# plan.cuh:kFpsMaxSlots: larger clouds take the kernel's wide route, whose
# running distances live in a scratch the wrapper allocates
MAX_REGISTER_POINTS = 8192


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int32; the loop of ``fps.py:fps_ref``."""
    B, N, _ = xyz.shape
    xyz = xyz.detach().float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    temp = torch.full((B, N), _BIG, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    old = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x[rows, old][:, None]
        dy = y - y[rows, old][:, None]
        dz = z - z[rows, old][:, None]
        d = (dx * dx + dy * dy) + dz * dz  # the reference's summation order
        temp = torch.minimum(temp, d)
        old = torch.argmax(temp, dim=1)  # first maximal index
        out[:, j] = old.to(torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def _entry(lib: ctypes.CDLL):
    """``gp2_fps`` with its argument types set, once per loaded library."""
    fn = lib.gp2_fps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    if not 0 < npoint <= N:
        raise ValueError(f"npoint {npoint} out of range for N={N}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    scratch = None
    if N > MAX_REGISTER_POINTS:
        scratch = torch.empty((B, N), dtype=torch.float32, device=xyz.device)
    lib = _cuda.library("fps")
    code = _entry(lib)(xyz.data_ptr(), B, N, npoint, out.data_ptr(), _cuda.stream_ptr(xyz),
                       None if scratch is None else scratch.data_ptr())
    _cuda.check(lib, code, "fps")
    _cuda.launch_counts["fps"] += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) float32 -> (B, npoint) int32 sample indices."""
    if not _cuda.launches(xyz):
        return fps_plain(xyz, npoint)
    return _fps_cuda(xyz.detach().contiguous(), npoint)
