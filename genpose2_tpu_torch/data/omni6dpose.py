"""Per-object crops and clouds from an RGB-D frame (port of the eval branch of
genpose2_tpu/data/omni6dpose.py:extract_object_sample).

Square 40-px-quantized window around the object's mask, the eval zoom-in
window, affine crops of the pixel-coordinate map, RGB, mask and depth, then
backprojection and sampling of ``num_points`` points: through the native
host core when the JAX package would use it (``data/native.py``), else in
numpy. The draws from ``rng`` come in the JAX package's order, so both
packages crop and sample the same frame alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data import native
from genpose2_tpu_torch.data.pointcloud import depth_to_pcl, pixel2xyz, sample_points
from genpose2_tpu_torch.data.roi import (INTER_LINEAR, INTER_NEAREST, aug_bbox_dzi,
                                         crop_resize_by_warp_affine, get_2d_coord_np, get_bbox,
                                         normalize_rgb)


def extract_object_sample(rgb: np.ndarray, depth: np.ndarray, mask: np.ndarray, meta: dict,
                          obj: dict, sym_info: np.ndarray, cfg: DataConfig,
                          rng: np.random.Generator, train: bool = False) -> Optional[dict]:
    """One object's sample dict, or None when it has too few usable depth
    pixels. Only the eval branch (``train=False``) is ported: the training
    branch's zoom-in jitter and mask deformation are not."""
    if train:
        raise NotImplementedError("the training branch of the front end is not ported "
                                  "(see ROADMAP.md)")
    intr = meta["camera"]["intrinsics"]
    im_h, im_w = rgb.shape[:2]
    img_resize_scale = im_h / intr["height"]
    K = np.array([[intr["fx"], 0, intr["cx"]],
                  [0, intr["fy"], intr["cy"]],
                  [0, 0, 1.0 / img_resize_scale]], np.float32) * img_resize_scale

    object_mask = mask == obj["mask_id"]
    if not np.any(object_mask):
        return None
    ys, xs = np.nonzero(object_mask)
    rmin, rmax, cmin, cmax = get_bbox([ys.min(), xs.min(), ys.max(), xs.max()], im_h, im_w)
    bbox_xyxy = np.array([cmin, rmin, cmax, rmax])
    center, scale = aug_bbox_dzi(rng, bbox_xyxy, im_h, im_w, pad_scale=cfg.dzi_pad_scale,
                                 dzi_type="none", scale_ratio=cfg.dzi_scale_ratio,
                                 shift_ratio=cfg.dzi_shift_ratio)

    coord_2d = get_2d_coord_np(im_w, im_h).transpose(1, 2, 0)
    S = cfg.img_size
    roi_coord_2d = crop_resize_by_warp_affine(coord_2d, center, scale, S,
                                              interpolation=INTER_NEAREST).transpose(2, 0, 1)
    roi_rgb = normalize_rgb(crop_resize_by_warp_affine(rgb, center, scale, S,
                                                       interpolation=INTER_LINEAR))
    roi_mask = crop_resize_by_warp_affine(object_mask.astype(np.float32), center, scale, S,
                                          interpolation=INTER_NEAREST)
    roi_depth = crop_resize_by_warp_affine(depth, center, scale, S, interpolation=INTER_NEAREST)
    if (roi_depth > 0).sum() <= 1:
        return None

    if native.available():
        n_valid, pcl, rows, cols = native.extract_cloud(
            roi_depth, (roi_mask > 0).astype(np.uint8), roi_coord_2d[0], roi_coord_2d[1],
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), cfg.num_points,
            seed=int(rng.integers(1 << 62)))
        if n_valid < 50:
            return None
        pix_rows, pix_cols, ids = rows, cols, np.arange(cfg.num_points)
    else:
        valid2d = (roi_depth > 0) * (roi_mask > 0)
        if valid2d.sum() <= 1:
            return None
        pix_rows, pix_cols = np.nonzero(valid2d)
        pcl = depth_to_pcl(roi_depth, K, roi_coord_2d, valid2d.reshape(-1) > 0)
        if len(pcl) < 50:
            return None
        ids, pcl = sample_points(rng, pcl, cfg.num_points)

    q = np.asarray(obj["quaternion_wxyz"], np.float32)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
                 np.float32)
    t = np.asarray(obj["translation"], np.float32)
    affine = np.eye(4, dtype=np.float32)
    affine[:3, :3] = R
    affine[:3, 3] = t
    return {
        "pcl_in": pcl.astype(np.float32),
        "rotation": R,
        "translation": t,
        "affine": affine,
        "sym_info": sym_info.astype(np.int32),
        "roi_rgb": roi_rgb.astype(np.float32),  # (S, S, 3) normalized, HWC
        "roi_xs": pix_rows[ids].astype(np.int32),  # crop rows of the sampled points
        "roi_ys": pix_cols[ids].astype(np.int32),
        "roi_center_dir": pixel2xyz(im_h, im_w, center, intr),
        "intrinsics": np.array([intr["fx"], intr["fy"], intr["cx"], intr["cy"], intr["width"],
                                intr["height"]], np.float32),
        "bbox_side_len": np.asarray(obj["meta"]["bbox_side_len"], np.float32),
        "class_label": np.int32(obj["meta"]["class_label"]),
        "handle_visibility": np.int32(1),
    }
