# Frozen copy of genpose2_tpu_torch/eval/metrics.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Symmetry-aware pose metrics (port of genpose2_tpu/eval/metrics.py, the
replacement of the reference's cutoop toolkit).

- Symmetry labels are (any, x, y, z) with per-axis tags none (0), any (1),
  half (2) and quarter (3).
- Rotation calibration snaps the prediction along its symmetry orbit to the
  pose closest to the ground truth: continuous axes by a closed-form angle,
  discrete axes by enumerating the product of the per-axis cyclic groups,
  global 'any' objects to the ground truth.
- 3D IoU is the NOCS approximation: each oriented box is replaced by its
  axis-aligned box in the camera frame.
- Rotation error is the geodesic angle (degrees), translation error the L2
  distance times 100 (cm).
- The metric family: per-class means, acc at thresholds, IoU AUC over
  threshold sweeps and pose VUS over (deg, cm) grids, in numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bench_port.reference.so3.rotations import axis_angle_to_matrix, rotation_angle_deg

_TAGS = {"none": 0, "any": 1, "half": 2, "quarter": 3}

SYM_NONE = torch.zeros((4,), dtype=torch.int32)


def sym_label(any_sym: bool = False, x: str = "none", y: str = "none",
              z: str = "none") -> torch.Tensor:
    """A (4,) int32 symmetry label [any, x, y, z]."""
    return torch.tensor([int(any_sym), _TAGS[x], _TAGS[y], _TAGS[z]], dtype=torch.int32)


# ------------------------------------------------------------ calibration
def _continuous_calibrate(R_pred: torch.Tensor, R_gt: torch.Tensor,
                          axis: torch.Tensor) -> torch.Tensor:
    """R_pred @ Rot(axis, theta) with the theta that maximises
    trace(M Rot(axis, theta)), M = R_gt^T R_pred: theta = atan2 of the
    coefficients of sin and cos."""
    M = R_gt.transpose(-1, -2) @ R_pred
    aMa = ((axis[:, None] * M).sum(-2) * axis).sum(-1)
    trM = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    v = torch.stack([M[..., 1, 2] - M[..., 2, 1], M[..., 2, 0] - M[..., 0, 2],
                     M[..., 0, 1] - M[..., 1, 0]], dim=-1)
    theta = torch.arctan2((v * axis).sum(-1), trM - aMa)
    return R_pred @ axis_angle_to_matrix(axis.expand(R_pred.shape[:-2] + (3,)), theta)


def _discrete_group_angles(tag: torch.Tensor) -> torch.Tensor:
    """tags (...) -> (..., 4) angles of each cyclic subgroup: half 2 and
    quarter 4 distinct angles, repeated (k % n) up to 4; none and any 0."""
    n = torch.where(tag == 2, 2, torch.where(tag == 3, 4, 1)).to(torch.float32)
    k = torch.arange(4, dtype=torch.float32, device=tag.device)
    return 2.0 * math.pi * torch.remainder(k, n[..., None]) / n[..., None]


@torch.no_grad()
def calibrate_rotation(R_pred: torch.Tensor, R_gt: torch.Tensor,
                       sym: torch.Tensor) -> torch.Tensor:
    """Snap each predicted rotation along its symmetry orbit to the rotation
    closest to the ground truth. R_pred, R_gt (B, 3, 3); sym (B, 4).

    Continuous axes first, in priority x, y, z; then the 64 products
    Rx Ry Rz of the per-axis cyclic groups, in meshgrid 'ij' order, the
    first of the smallest geodesic errors winning; global 'any' objects take
    the ground truth."""
    sym = sym.to(R_pred.device).long()
    R_gt = R_gt.to(R_pred)
    axes = torch.eye(3, dtype=R_pred.dtype, device=R_pred.device)
    R = R_pred
    for i in range(3):
        R = torch.where((sym[:, 1 + i] == 1)[:, None, None],
                        _continuous_calibrate(R, R_gt, axes[i]), R)
    B = R.shape[0]
    ang = _discrete_group_angles(sym[:, 1:]).to(R.dtype)  # (B, 3, 4)
    grid = torch.stack([ang[:, 0, :, None, None].expand(B, 4, 4, 4),
                        ang[:, 1, None, :, None].expand(B, 4, 4, 4),
                        ang[:, 2, None, None, :].expand(B, 4, 4, 4)], dim=-1).reshape(B, 64, 3)
    g = [axis_angle_to_matrix(axes[i].expand(B, 64, 3), grid[..., i]) for i in range(3)]
    cands = R[:, None] @ (g[0] @ g[1] @ g[2])  # (B, 64, 3, 3)
    best = torch.argmin(rotation_angle_deg(cands, R_gt[:, None]), dim=1)
    R = cands[torch.arange(B, device=R.device), best]
    return torch.where((sym[:, 0] == 1)[:, None, None], R_gt, R)


# -------------------------------------------------------------------- IoU
_CORNERS = torch.tensor(
    [[+1, +1, +1], [+1, +1, -1], [-1, +1, +1], [-1, +1, -1],
     [+1, -1, +1], [+1, -1, -1], [-1, -1, +1], [-1, -1, -1]], dtype=torch.float32)


def _world_aabb(R, t, size):
    corners = 0.5 * size[..., None, :] * _CORNERS.to(size)  # (..., 8, 3)
    world = (R[..., None, :, :] * corners[..., None, :]).sum(-1) + t[..., None, :]
    return world.amin(-2), world.amax(-2)


def iou_3d(R1, t1, size1, R2, t2, size2) -> torch.Tensor:
    """NOCS-style 3D IoU: the IoU of the two boxes' camera-frame AABBs,
    batched over leading dims."""
    lo1, hi1 = _world_aabb(R1, t1, size1)
    lo2, hi2 = _world_aabb(R2, t2, size2)
    edge = torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)
    inter = torch.where(edge.amin(-1) < 0, 0.0, edge.prod(-1))
    v1 = (hi1 - lo1).prod(-1)
    v2 = (hi2 - lo2).prod(-1)
    return inter / torch.clamp(v1 + v2 - inter, min=1e-12)


# ----------------------------------------------------- criterion + metrics
@torch.no_grad()
def batch_criterion(pred_R, pred_t, pred_size, gt_R, gt_t, gt_size,
                    sym) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-instance (iou, rotation error deg, translation error cm) after
    symmetry calibration, on pred_R's device."""
    dev = pred_R.device
    gt_R, gt_t, gt_size = (x.to(dev, torch.float32) for x in (gt_R, gt_t, gt_size))
    pred_t, pred_size = pred_t.to(dev), pred_size.to(dev)
    sym = sym.to(dev)
    R_cal = calibrate_rotation(pred_R, gt_R, sym)
    deg = torch.where(sym[:, 0] == 1, 0.0, rotation_angle_deg(R_cal, gt_R))
    sht = torch.linalg.norm(pred_t - gt_t, dim=-1) * 100.0
    iou = iou_3d(R_cal, pred_t, pred_size, gt_R, gt_t, gt_size)
    return iou, deg, sht


@torch.no_grad()
def rot_error_deg(pred_R, gt_R, sym) -> torch.Tensor:
    """Symmetry-aware rotation error (deg) alone, as the ranking candidates'
    supervision takes it."""
    sym = sym.to(pred_R.device)
    gt_R = gt_R.to(pred_R)
    deg = rotation_angle_deg(calibrate_rotation(pred_R, gt_R, sym), gt_R)
    return torch.where(sym[:, 0] == 1, 0.0, deg)


@dataclasses.dataclass
class PoseMetrics:
    iou_mean: float
    deg_mean: float
    sht_mean: float
    iou_acc: Dict[float, float]  # threshold -> accuracy
    pose_acc: Dict[Tuple[float, float], float]  # (deg, cm) -> accuracy
    iou_auc: Dict[float, float]  # range start -> normalized AUC
    pose_auc: Dict[Tuple[float, float], float]  # (deg, cm) -> VUS
    per_class: Dict[int, "PoseMetrics"]

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["iou_acc"] = {str(k): v for k, v in self.iou_acc.items()}
        d["pose_acc"] = {str(k): v for k, v in self.pose_acc.items()}
        d["iou_auc"] = {str(k): v for k, v in self.iou_auc.items()}
        d["pose_auc"] = {str(k): v for k, v in self.pose_auc.items()}
        d["per_class"] = {str(k): v.to_dict() for k, v in self.per_class.items()}
        return d


_IOU_AUC_RANGES = [(0.25, 1.0, 0.075), (0.5, 1.0, 0.005), (0.75, 1.0, 0.0025)]
_POSE_AUC_RANGES = [
    ((0.0, 5.0, 0.05), (0.0, 2.0, 0.02)),
    ((0.0, 5.0, 0.05), (0.0, 5.0, 0.05)),
    ((0.0, 10.0, 0.1), (0.0, 2.0, 0.02)),
    ((0.0, 10.0, 0.1), (0.0, 5.0, 0.05)),
]


def _metrics_for(iou, deg, sht) -> dict:
    iou_acc = {thr: float(np.mean(iou > thr)) for thr in (0.25, 0.5, 0.75)}
    pose_acc = {(d, s): float(np.mean((deg < d) & (sht < s)))
                for d, s in ((5, 2), (5, 5), (10, 2), (10, 5))}
    iou_auc = {}
    for lo, hi, step in _IOU_AUC_RANGES:
        ts = np.arange(lo, hi, step)
        iou_auc[lo] = float(np.mean([np.mean(iou > t) for t in ts]))
    pose_auc = {}
    for (dlo, dhi, dstep), (slo, shi, sstep) in _POSE_AUC_RANGES:
        ds = np.arange(dlo, dhi, dstep) + dstep
        ss = np.arange(slo, shi, sstep) + sstep
        grid = (deg[None, None, :] < ds[:, None, None]) & (sht[None, None, :] < ss[None, :, None])
        pose_auc[(dhi, shi)] = float(np.mean(grid))
    return dict(iou_mean=float(np.mean(iou)), deg_mean=float(np.mean(deg)),
                sht_mean=float(np.mean(sht)), iou_acc=iou_acc, pose_acc=pose_acc,
                iou_auc=iou_auc, pose_auc=pose_auc)


def compute_metrics(iou, deg, sht, class_labels: Optional[np.ndarray] = None) -> PoseMetrics:
    """Per-instance criteria (numpy or host tensors) -> the metric family.
    With ``class_labels`` the top-level numbers are means over classes."""
    iou, deg, sht = (np.asarray(x) for x in (iou, deg, sht))
    per_class = {}
    if class_labels is not None:
        class_labels = np.asarray(class_labels)
        for c in np.unique(class_labels):
            m = class_labels == c
            per_class[int(c)] = PoseMetrics(**_metrics_for(iou[m], deg[m], sht[m]), per_class={})
    if not per_class:
        return PoseMetrics(**_metrics_for(iou, deg, sht), per_class={})

    def mean_over(key):
        vals = [getattr(pm, key) for pm in per_class.values()]
        if isinstance(vals[0], dict):
            return {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
        return float(np.mean(vals))

    return PoseMetrics(**{k: mean_over(k) for k in ("iou_mean", "deg_mean", "sht_mean", "iou_acc",
                                                    "pose_acc", "iou_auc", "pose_auc")},
                       per_class=per_class)
