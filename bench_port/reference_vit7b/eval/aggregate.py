# Frozen copy of genpose2_tpu_torch/eval/aggregate.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Candidate aggregation: energy ranking -> retain -> cluster -> average (port
of genpose2_tpu/eval/aggregate.py).

DBSCAN runs over the ROWS of the quaternion distance matrix taken as
Euclidean feature vectors (the reference hands the matrix to sklearn
without ``metric='precomputed'``); neighbourhoods are ``<= eps`` and include
the point itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from bench_port.reference_vit7b.so3.rotations import (
    average_quaternion_batch_fast as average_quaternion_batch,
    get_rot_matrix,
    matrix_to_quaternion,
    quaternion_to_matrix,
)
from bench_port.reference_vit7b.training.ranking import sort_poses_by_energy
from bench_port.reference_vit7b.utils.profiling import span


def _dbscan_largest_cluster(row_dist: torch.Tensor, eps: float, min_samples: int):
    """row_dist (B, K, K) -> (mask of each object's largest cluster (B, K),
    found (B,)). Clusters are connected components of core points (>=
    min_samples neighbours) plus their border points; labels are the
    smallest core index of the component."""
    B, K, _ = row_dist.shape
    adj = row_dist <= eps
    core = adj.sum(-1) >= min_samples  # (B, K)
    core_adj = adj & core[:, :, None] & core[:, None, :]
    ids = torch.arange(K, device=row_dist.device).expand(B, K)
    none = torch.full_like(ids, K)
    labels = torch.where(core, ids, none)
    for _ in range(K):
        neigh = torch.where(core_adj, labels[:, None, :], K)
        labels = torch.where(core, torch.minimum(labels, neigh.min(-1).values), none)
    border = torch.where(adj & core[:, None, :], labels[:, None, :], K).min(-1).values
    final = torch.where(core, labels, border)  # K = noise
    counts = ((final[:, :, None] == torch.arange(K, device=row_dist.device))
              & (final[:, :, None] < K)).sum(1)  # (B, K) members per label
    best = torch.argmax(counts, dim=1)
    found = counts.gather(1, best[:, None])[:, 0] > 0
    return (final == best[:, None]) & found[:, None], found


@torch.no_grad()
@span("aggregate")
def aggregate_candidates(poses: torch.Tensor, energies: Optional[torch.Tensor] = None,
                         retain_ratio: float = 0.4, clustering: bool = True,
                         eps: float = 0.05, minpts_ratio: float = 0.1667,
                         pose_mode: str = "rot_matrix") -> dict:
    """poses (B, K, D) camera-frame candidates, energies (B, K, 2) (all equal
    when None: score-only aggregation) -> dict(rotation (B, 3, 3),
    translation (B, 3), quat (B, 4), retained (B, K', D))."""
    B, K, D = poses.shape
    if energies is None:
        energies = torch.ones((B, K, 2), dtype=poses.dtype, device=poses.device)
    sorted_poses, _ = sort_poses_by_energy(poses, energies)
    retain = max(int(K * retain_ratio), 1)
    good = sorted_poses[:, :retain]

    R = get_rot_matrix(good[..., :-3].reshape(B * retain, -1), pose_mode)
    quat = matrix_to_quaternion(R).reshape(B, retain, 4)
    agg_quat = average_quaternion_batch(quat)

    if clustering:
        min_samples = max(int(minpts_ratio * retain), 1)
        qd = 1.0 - torch.einsum("bki,bji->bkj", quat, quat) ** 2
        row_dist = torch.linalg.norm(qd[:, :, None, :] - qd[:, None, :, :], dim=-1)
        mask, found = _dbscan_largest_cluster(row_dist, eps, min_samples)
        w = mask.to(quat.dtype)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        clustered = average_quaternion_batch(quat, w)
        agg_quat = torch.where(found[:, None], clustered, agg_quat)

    return {
        "rotation": quaternion_to_matrix(agg_quat),
        "translation": good[..., -3:].mean(dim=1),
        "quat": agg_quat,
        "retained": good,
    }


def analytic_bbox_lengths(pcl: torch.Tensor, rotation: torch.Tensor,
                          translation: torch.Tensor) -> torch.Tensor:
    """Box sizes without a ScaleNet: 2 max|xyz| of the cloud in the predicted
    object frame. pcl (B, N, 3), rotation (B, 3, 3), translation (B, 3) -> (B, 3)."""
    obj = torch.einsum("bji,bnj->bni", rotation, pcl - translation[:, None, :])
    return 2.0 * obj.abs().amax(dim=1)
