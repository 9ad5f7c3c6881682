"""The Omni6DPose (SOPE/ROPE) front end: frames on disk, per-object crops and
clouds (port of genpose2_tpu/data/omni6dpose.py).

A frame is a path prefix with ``color.png`` (uint8 RGB), ``depth.exr``
(float32 meters; or ``depth.png``, uint16 millimeters), ``mask.exr`` or
``mask.png`` (instance ids) and ``meta.json`` (camera intrinsics and the
objects' poses, mask ids, oids, class labels and box sizes); the dataset's
``obj_meta.json`` gives each oid's symmetry tags. The readers are the port's
own (``data/png.py``, ``data/exr.py``): no OpenCV.

``extract_object_sample``: square 40-px-quantized window around the object's
mask, the zoom-in window (jittered when training), affine crops of the
pixel-coordinate map, RGB, mask and depth, the mask deformation when
training, then backprojection and sampling of ``num_points`` points: through
the native host core when the JAX package would use it (``data/native.py``),
else in numpy. ``Omni6DPoseDataset``: REPCNT oversampling of the training
frames, the eval (frame, object) pairs, ``percentage_data``, a thread-safe
LRU of decoded frames, the bad-sample retry and the scale agent's noised
axes. Every draw comes from a generator seeded by (seed, epoch, index) in the
JAX package's order, so both packages give the same samples from the same
files.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from typing import Optional

import numpy as np

from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data import native
from genpose2_tpu_torch.data.exr import read_exr
from genpose2_tpu_torch.data.png import IMREAD_COLOR, IMREAD_UNCHANGED, read_png
from genpose2_tpu_torch.data.pointcloud import depth_to_pcl, pixel2xyz, sample_points
from genpose2_tpu_torch.data.roi import (INTER_LINEAR, INTER_NEAREST, aug_bbox_dzi,
                                         crop_resize_by_warp_affine, defor_2D,
                                         get_2d_coord_np, get_bbox, normalize_rgb)

_SYM_IDX = {"none": 0, "any": 1, "half": 2, "quarter": 3}


def load_color(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    return read_png(path, IMREAD_COLOR)


def _read_exr_f32(path: str) -> np.ndarray:
    d = read_exr(path)
    return d.astype(np.float32) if d.dtype == np.float16 else d


def load_depth(prefix: str) -> np.ndarray:
    """Depth in meters; EXR first, else the uint16-mm PNG; values above 1e3
    set to 0."""
    if os.path.exists(prefix + "depth.exr"):
        d = _read_exr_f32(prefix + "depth.exr")
        if d.ndim == 3:
            d = d[..., 0]
    else:
        d = read_png(prefix + "depth.png", IMREAD_UNCHANGED).astype(np.float32) / 1000.0
    d = d.astype(np.float32)
    d[d > 1e3] = 0
    return d


def load_mask(prefix: str) -> np.ndarray:
    for name in ("mask.exr", "mask.png"):
        p = prefix + name
        if os.path.exists(p):
            m = _read_exr_f32(p) if name.endswith(".exr") else read_png(p, IMREAD_UNCHANGED)
            if m.ndim == 3:
                m = m[..., 0]
            return m.astype(np.int32)
    raise FileNotFoundError(f"no mask at {prefix}")


def load_meta(prefix: str) -> dict:
    with open(prefix + "meta.json") as f:
        return json.load(f)


def extract_object_sample(rgb: np.ndarray, depth: np.ndarray, mask: np.ndarray, meta: dict,
                          obj: dict, sym_info: np.ndarray, cfg: DataConfig,
                          rng: np.random.Generator, train: bool = True) -> Optional[dict]:
    """One object's sample dict, or None when it has too few usable depth
    pixels (the caller retries another index). ``train`` jitters the zoom-in
    window (cfg.dzi_type) and deforms the mask (``defor_2D``)."""
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
                                 dzi_type=cfg.dzi_type if train else "none",
                                 scale_ratio=cfg.dzi_scale_ratio,
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
    if train:
        roi_mask = defor_2D(rng, roi_mask, cfg.roi_mask_r, cfg.roi_mask_pro)

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


def symmetry_label(obj_meta: dict, oid: str) -> np.ndarray:
    """(4,) int32 [any, x, y, z] symmetry tags of ``oid`` in an
    ``obj_meta.json`` instance dict; zeros when it has no entry."""
    info = obj_meta.get(oid)
    if info is None:
        return np.zeros(4, np.int32)
    s = info["tag"]["symmetry"]
    return np.array([int(bool(s["any"])), _SYM_IDX[s["x"]], _SYM_IDX[s["y"]], _SYM_IDX[s["z"]]],
                    np.int32)


class Omni6DPoseDataset:
    """Per-object samples of the frames under a directory. Training: REPCNT
    samples per frame, cycling over its valid objects (a random one for the
    remainder); eval: every valid object of every frame once.
    ``agent_type='scale'`` adds ``scale_batch_size`` noised ground-truth axes
    (10-degree jitter, clipped at 20) and box sizes to each sample."""

    REPCNT = 8

    def __init__(self, cfg: DataConfig, mode: str = "train", data_dir: Optional[str] = None,
                 per_obj: str = "", agent_type: str = "score", scale_batch_size: int = 64):
        self.cfg = cfg
        self.mode = mode
        self.train = mode == "train"
        self.per_obj = per_obj or cfg.per_obj
        self.agent_type = agent_type
        self.scale_batch_size = scale_batch_size
        # set by the DataLoader before each pass; part of each sample's seed
        self.epoch = 0
        data_dir = data_dir or cfg.data_path
        self.img_list = sorted(
            p[:-len("meta.json")]
            for p in glob.glob(os.path.join(data_dir, "**", "*meta.json"), recursive=True)
            if not p.endswith("obj_meta.json"))
        if not self.img_list:
            raise FileNotFoundError(f"no frames under {data_dir}")
        obj_meta_path = os.path.join(data_dir, "obj_meta.json")
        self.obj_meta = {}
        if os.path.exists(obj_meta_path):
            with open(obj_meta_path) as f:
                self.obj_meta = json.load(f).get("instance_dict", {})
        if self.train:
            self.eval_pairs = None
            self.length = len(self.img_list) * self.REPCNT
        else:
            self.eval_pairs = []
            for fi, prefix in enumerate(self.img_list):
                for oi, o in enumerate(load_meta(prefix)["objects"]):
                    if not o.get("is_valid", True):
                        continue
                    if self.per_obj and o["meta"]["class_name"] != self.per_obj:
                        continue
                    self.eval_pairs.append((fi, oi))
            self.length = len(self.eval_pairs)
        # percentage_data: a seeded random subset of the sample indices
        self.index_map = None
        if cfg.percentage_data < 1.0:
            n = max(1, int(self.length * cfg.percentage_data))
            perm = np.random.default_rng(cfg.seed).permutation(self.length)[:n]
            self.index_map = np.sort(perm)
            self.length = n
        # decoded frames, most recent last; the DataLoader's threads share it
        self._cache_frames = max(0, int(cfg.frame_cache))
        self._cache: "dict[str, tuple]" = {}
        self._cache_lock = threading.Lock()

    def _load_frame(self, prefix: str):
        if self._cache_frames:
            with self._cache_lock:
                hit = self._cache.pop(prefix, None)
                if hit is not None:
                    self._cache[prefix] = hit
                    return hit
        frame = (load_color(prefix + "color.png"), load_depth(prefix), load_mask(prefix))
        if self._cache_frames:
            with self._cache_lock:
                self._cache[prefix] = frame
                while len(self._cache) > self._cache_frames:
                    self._cache.pop(next(iter(self._cache)))
        return frame

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> dict:
        # a generator per call: numpy generators are not thread-safe
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(self.cfg.seed, self.epoch, index)))
        for _ in range(len(self)):  # bad-sample retry
            i = int(self.index_map[index]) if self.index_map is not None else index
            if self.train:
                prefix = self.img_list[i // self.REPCNT % len(self.img_list)]
                meta = load_meta(prefix)
                valid = [o for o in meta["objects"] if o.get("is_valid", True)]
                if self.per_obj:
                    valid = [o for o in valid if o["meta"]["class_name"] == self.per_obj]
                if not valid:
                    index = (index + 1) % len(self)
                    continue
                sel = i % self.REPCNT
                if sel < self.REPCNT - self.REPCNT % len(valid):
                    obj = valid[sel % len(valid)]
                else:
                    obj = valid[int(rng.integers(len(valid)))]
            else:
                fi, oi = self.eval_pairs[i]
                prefix = self.img_list[fi]
                meta = load_meta(prefix)
                obj = meta["objects"][oi]
            rgb, depth, mask = self._load_frame(prefix)
            sample = extract_object_sample(rgb, depth, mask, meta, obj,
                                           symmetry_label(self.obj_meta, obj["meta"]["oid"]),
                                           self.cfg, rng, self.train)
            if sample is None:
                index = (index + 1) % len(self)
                continue
            sample["path"] = prefix
            if self.agent_type == "scale":
                from scipy.spatial.transform import Rotation

                S = self.scale_batch_size
                angles = np.clip(rng.normal(0, 10, S), -20, 20)
                axes = rng.normal(size=(S, 3))
                axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
                noise = Rotation.from_rotvec(axes * np.radians(angles)[:, None]).as_matrix()
                sample["axes_training"] = (noise @ sample["rotation"][None]).astype(np.float32)
                sample["length_training"] = np.tile(sample["bbox_side_len"][None], (S, 1))
            return sample
        raise RuntimeError("no valid samples in dataset")
