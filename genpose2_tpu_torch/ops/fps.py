"""Furthest point sampling (port of genpose2_tpu/ops/fps.py).

The first pick is index 0; each next pick is the argmax of the running min
squared distance to the picks so far, ties to the lowest index.

``furthest_point_sample`` launches the CUDA kernel (``csrc/fps.cu``) on a
CUDA tensor and runs ``fps_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from genpose2_tpu_torch.ops import _cuda

_BIG = 1e10


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


def _fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    if not 0 < npoint <= N:
        raise ValueError(f"npoint {npoint} out of range for N={N}")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    lib = _cuda.library("fps")
    lib.gp2_fps.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
    lib.gp2_fps.restype = ctypes.c_int
    code = lib.gp2_fps(xyz.data_ptr(), B, N, npoint, out.data_ptr(), _cuda.stream_ptr(xyz))
    _cuda.check(lib, code, "fps")
    _cuda.launch_counts["fps"] += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) float32 -> (B, npoint) int32 sample indices."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    return _fps_cuda(xyz.detach().contiguous(), npoint)
