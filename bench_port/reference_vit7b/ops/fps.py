# Frozen copy of genpose2_tpu_torch/ops/fps.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten, 1 kernel route(s) removed. Do not edit.
"""Furthest point sampling (port of genpose2_tpu/ops/fps.py).

The first pick is index 0; each next pick is the argmax of the running min
squared distance to the picks so far, ties to the lowest index.

``furthest_point_sample`` launches the CUDA kernel (``csrc/fps.cu``) on a
CUDA tensor, for any N (past ``MAX_REGISTER_POINTS`` with a float32 scratch
of B x N for the running distances), and runs ``fps_plain`` on a CPU tensor.
"""

from __future__ import annotations

import torch

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


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) float32 -> (B, npoint) int32 sample indices."""
    return fps_plain(xyz, npoint)
