# Frozen copy of genpose2_tpu_torch/ops/ball_query.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten, 2 kernel route(s) removed. Do not edit.
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

import numpy as np
import torch
import torch.nn.functional as F

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


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The first ``nsample`` in-radius point indices of each centroid:
    (B, N, 3), (B, M, 3) -> (B, M, nsample) int32."""
    return ball_query_plain(xyz, new_xyz, radius, nsample)


def ball_count_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M) int32 in-radius counts."""
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    return (_sq_dist(xyz, new_xyz) < radius_sq(radius)).sum(-1).to(torch.int32)


def ball_count(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """Number of in-radius points per centroid: (B, N, 3), (B, M, 3) -> (B, M) int32."""
    return ball_count_plain(xyz, new_xyz, radius)
