"""Batching of per-object samples (port of genpose2_tpu/data/loader.py:collate
and process_batch without augmentation)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from genpose2_tpu_torch.so3.rotations import get_pose_representation

_PASS_THROUGH = ("sym_info", "roi_rgb", "roi_xs", "roi_ys", "roi_center_dir", "bbox_side_len",
                 "class_label", "intrinsics", "axes_training", "length_training",
                 "handle_visibility")


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of per-object sample dicts into arrays (strings -> list)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[k] = list(vals)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


def process_batch(batch: dict, pose_mode: str = "rot_matrix", device=None) -> dict:
    """A collated numpy batch -> tensors on ``device``: the camera-frame cloud
    ``pts``, its float32 mean ``pts_center``, the zero-mean cloud and
    ground-truth pose, and the pass-through keys the agents read (``roi_rgb``,
    ``roi_xs``, ``roi_ys``, ...)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    pts = t(batch["pcl_in"]).float()
    R = t(batch["rotation"]).float()
    trans = t(batch["translation"]).float()
    gt_pose = torch.cat([get_pose_representation(R, pose_mode), trans], dim=-1)
    center = pts[..., :3].mean(dim=1)
    zero_pts = pts.clone()
    zero_pts[..., :3] -= center[:, None, :]
    zero_gt = gt_pose.clone()
    zero_gt[..., -3:] -= center
    out = {
        "pts": pts,  # the encoder reads the camera-frame cloud
        "zero_mean_pts": zero_pts,
        "gt_pose": gt_pose,
        "zero_mean_gt_pose": zero_gt,
        "pts_center": center,
        "gt_rotation": R,
        "gt_translation": trans,
    }
    for k in _PASS_THROUGH:
        if k in batch:
            out[k] = t(batch[k])
    return out
