"""Ball query and in-radius counts (port of genpose2_tpu/ops/ball_query.py and
the count kernel of genpose2_tpu/ops/ball_query_pallas.py).

Hits are ``d2 < r^2`` with d2 summed as ((dx*dx + dy*dy) + dz*dz) and r^2 the
Python double ``radius * radius`` rounded to float32, which is what the JAX
code compares against. Hits are kept in ascending point order; slots past the
hit count repeat the first hit; a centroid with no hit gets index 0 in every
slot.

``ball_query`` and ``ball_count`` launch their CUDA kernels
(``csrc/ball_query.cu``, ``csrc/ball_count.cu``) on a CUDA tensor and run
``ball_query_plain`` / ``ball_count_plain`` on a CPU tensor. The training
path's module forward calls ``ball_query``; the serving path's fused SA
kernel finds its own hits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from genpose2_tpu_torch.ops import _cuda


def radius_sq(radius: float) -> float:
    """float32(radius * radius), the threshold the JAX kernels compare with."""
    return float(np.float32(radius * radius))


def _sq_dist(xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, M, N) squared distances, reference order."""
    d = xyz[:, None, :, :] - new_xyz[:, :, None, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def ball_query_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M, nsample) int32 indices."""
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    mask = _sq_dist(xyz, new_xyz) < radius_sq(radius)
    cnt = mask.sum(-1)
    # a stable sort of (0 for a hit, 1 for a miss) lists the hits first, in order
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[..., :nsample]
    first = torch.where(cnt[..., None] > 0, order[..., :1], torch.zeros_like(order[..., :1]))
    if order.shape[-1] < nsample:  # fewer points than slots: the pad slots repeat the first
        order = F.pad(order, (0, nsample - order.shape[-1]))
    slots = torch.arange(nsample, device=xyz.device)
    return torch.where(cnt[..., None] > slots, order, first).to(torch.int32)


def _ball_query_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    _cuda.require(new_xyz, "new_xyz", torch.float32, (B, M, 3), xyz.device)
    if nsample < 1:
        raise ValueError(f"nsample {nsample} must be positive")
    out = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    lib = _cuda.library("ball_query")
    lib.gp2_ball_query.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.gp2_ball_query.restype = ctypes.c_int
    code = lib.gp2_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, radius_sq(radius),
                              nsample, out.data_ptr(), _cuda.stream_ptr(xyz))
    _cuda.check(lib, code, "ball_query")
    _cuda.launch_counts["ball_query"] += 1
    return out


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` in-radius point indices of each centroid:
    (B, N, 3), (B, M, 3) -> (B, M, nsample) int32."""
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    return _ball_query_cuda(xyz.detach().float().contiguous(),
                            new_xyz.detach().float().contiguous(), radius, nsample)


def ball_count_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M) int32 in-radius counts."""
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    return (_sq_dist(xyz, new_xyz) < radius_sq(radius)).sum(-1).to(torch.int32)


def _ball_count_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), xyz.device)
    _cuda.require(new_xyz, "new_xyz", torch.float32, (B, M, 3), xyz.device)
    out = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    lib = _cuda.library("ball_count")
    lib.gp2_ball_count.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    lib.gp2_ball_count.restype = ctypes.c_int
    code = lib.gp2_ball_count(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, radius_sq(radius),
                              out.data_ptr(), _cuda.stream_ptr(xyz))
    _cuda.check(lib, code, "ball_count")
    _cuda.launch_counts["ball_count"] += 1
    return out


def ball_count(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """Number of in-radius points per centroid: (B, N, 3), (B, M, 3) -> (B, M) int32."""
    if xyz.device.type == "cpu":
        return ball_count_plain(xyz, new_xyz, radius)
    return _ball_count_cuda(xyz.detach().contiguous(), new_xyz.detach().contiguous(), radius)
