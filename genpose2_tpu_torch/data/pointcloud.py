"""Host-side point clouds from depth crops (port of genpose2_tpu/data/pointcloud.py):
backprojection through the original intrinsics with the crop's pixel
coordinate map, sampling of a fixed number of points, and the view direction
of a pixel."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def depth_to_pcl(roi_depth: np.ndarray, K: np.ndarray, roi_coord_2d: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """roi_depth (H, W) or (1, H, W); K (3, 3); roi_coord_2d (2, H, W) pixel
    coordinates of the crop in the original image; valid (H*W,) bool
    -> (n_valid, 3) float32 camera-frame points."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    depth = roi_depth.reshape(-1).astype(np.float32)[valid]
    x_map = roi_coord_2d[0].reshape(-1)[valid]
    y_map = roi_coord_2d[1].reshape(-1)[valid]
    real_x = (x_map - cx) * depth / fx
    real_y = (y_map - cy) * depth / fy
    return np.stack((real_x, real_y, depth), axis=-1).astype(np.float32)


def sample_points(rng: np.random.Generator, pcl: np.ndarray,
                  n_pts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exactly n_pts rows: a random permutation's head when there are enough
    points, else the rows tiled and then the first ones again. Returns
    (ids, sampled)."""
    total = pcl.shape[0]
    if total < n_pts:
        reps = n_pts // total
        ids = np.concatenate([np.tile(np.arange(total), reps), np.arange(n_pts % total)], axis=0)
        return ids, pcl[ids]
    ids = rng.permutation(total)[:n_pts]
    return ids, pcl[ids]


def pixel2xyz(im_h: int, im_w: int, pixel_xy: np.ndarray, intrinsics: dict) -> np.ndarray:
    """Unit view direction of a pixel; intrinsics {fx, fy, cx, cy, width, height}."""
    scale = im_h / intrinsics["height"]
    fx, fy = intrinsics["fx"] * scale, intrinsics["fy"] * scale
    cx, cy = intrinsics["cx"] * scale, intrinsics["cy"] * scale
    x = (pixel_xy[0] - cx) / fx
    y = (pixel_xy[1] - cy) / fy
    v = np.array([x, y, 1.0], np.float32)
    return v / np.linalg.norm(v)
