"""BOP-format dataset loader (XYZ-IBD industrial dataset and any BOP split;
port of genpose2_tpu/data/xyzibd.py, reading PNGs with data/png.py).

reference: datasets_my/xyzibd_dataset.py:35-848. Scene layout (BOP standard):

    <root>/<split>/<scene_id>/
        rgb/<im_id>.png          depth/<im_id>.png (uint16 * depth_scale mm)
        mask_visib/<im_id>_<gt_idx>.png
        scene_gt.json            {im_id: [{obj_id, cam_R_m2c(9), cam_t_m2c(3, mm)}]}
        scene_gt_info.json       {im_id: [{visib_fract, px_count_valid, ...}]}
        scene_camera.json        {im_id: {cam_K(9), depth_scale}}
    <root>/models/models_info.json  {obj_id: {size_x/y/z (mm),
        symmetries_continuous: [{axis, offset}], symmetries_discrete: [4x4]}}

Sample filters match the reference: visib_fract >= 0.1 and
px_count_valid >= 1000 (reference: xyzibd_dataset.py:521-527).

Multi-camera val/test: pass ``cameras=['xyz','realsense','photoneo']`` to
enumerate the per-camera suffixed layout (``scene_gt_<cam>.json``,
``rgb_<cam>``/``gray_<cam>``, ...) the fork uses for validation
(reference: xyzibd_dataset.py:583-608). Translation normalization stats:
``compute_translation_stats`` / ``save_translation_stats`` /
``load_translation_stats`` mirror the fork's
``configs/xyzibd_trans_{mean,std}.npy`` flow (reference: :16-32, 796-804).

Symmetry inference: continuous axes map to per-axis 'any' tags; discrete
symmetry groups are classified by the minimal rotation angle about their
common axis (order >= 4 -> 'quarter', order 2 -> 'half') — a cleaner rule
than the reference's hard-coded trig pattern matching
(xyzibd_dataset.py:175-245). Deliberate divergence: the reference sets the
GLOBAL 'any' flag for every object with any symmetry (:158-162), which the
metric layer reads as full spherical symmetry and zeroes the rotation error;
here the global flag stays False unless the model is actually a sphere.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data.omni6dpose import extract_object_sample
from genpose2_tpu_torch.data.png import IMREAD_COLOR, IMREAD_UNCHANGED, read_png


def bop_symmetry_label(model_info: dict) -> np.ndarray:
    """models_info entry -> (4,) int32 [any, x, y, z]."""
    tags = {"none": 0, "any": 1, "half": 2, "quarter": 3}
    ax_tag = ["none", "none", "none"]
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym.get("axis", [0, 0, 0]), float)
        if np.linalg.norm(axis) > 1e-6:
            ax_tag[int(np.argmax(np.abs(axis)))] = "any"

    discrete = model_info.get("symmetries_discrete", [])
    if discrete:
        angles = {0: [], 1: [], 2: []}
        for mat in discrete:
            M = np.asarray(mat, float).reshape(4, 4)
            R = M[:3, :3]
            cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
            ang = np.arccos(cos)
            if ang < 1e-6:
                continue
            # rotation axis from the antisymmetric part (or eigenvector for pi)
            if abs(np.pi - ang) > 1e-3:
                v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
            else:
                w, vecs = np.linalg.eigh(R)
                v = vecs[:, np.argmax(w)]
            axis_idx = int(np.argmax(np.abs(v)))
            angles[axis_idx].append(ang)
        for i in range(3):
            if angles[i] and ax_tag[i] == "none":
                order = int(round(2 * np.pi / min(angles[i])))
                ax_tag[i] = "quarter" if order >= 4 else "half"
    return np.asarray(
        [0, tags[ax_tag[0]], tags[ax_tag[1]], tags[ax_tag[2]]], np.int32
    )


def compute_translation_stats(dataset: "XyzibdDataset"):
    """Dataset-level translation mean/std over the loaded split
    (reference: xyzibd_dataset.py:16-32 compute_translation_stats). The
    reference iterates ``dataset[i]`` and reads the raw translation; the
    translations come verbatim from scene_gt, so this reads them from the
    already-parsed metadata — same values, no image decoding. std floors at
    1e-8 -> 1.0 exactly as the reference does."""
    all_t = []
    for scene_key, im_id, gi, _ in dataset.samples:
        scene_gt, _, _ = dataset.scene_meta[scene_key]
        t = np.asarray(scene_gt[im_id][gi]["cam_t_m2c"], np.float64) / 1000.0
        all_t.append(t)
    all_t = np.stack(all_t)
    mean = all_t.mean(axis=0).astype(np.float32)
    std = all_t.std(axis=0).astype(np.float32)
    std[std < 1e-8] = 1.0
    return mean, std


def save_translation_stats(stats_dir: str, mean, std, name: str = "xyzibd"):
    """Persist ``{name}_trans_{mean,std}.npy`` (reference:
    dataset_port.py:54-78 save_trans_stats / configs/xyzibd_trans_*.npy)."""
    os.makedirs(stats_dir, exist_ok=True)
    np.save(os.path.join(stats_dir, f"{name}_trans_mean.npy"), np.asarray(mean))
    np.save(os.path.join(stats_dir, f"{name}_trans_std.npy"), np.asarray(std))


def load_translation_stats(stats_dir: str, name: str = "xyzibd"):
    """Load ``{name}_trans_{mean,std}.npy`` (reference:
    xyzibd_dataset.py:796-804 get_mean_std)."""
    mean = np.load(os.path.join(stats_dir, f"{name}_trans_mean.npy"))
    std = np.load(os.path.join(stats_dir, f"{name}_trans_std.npy"))
    return mean.astype(np.float32), std.astype(np.float32)


class XyzibdDataset:
    """Per-object BOP samples through the shared crop/backprojection pipeline.

    ``cameras``: multi-camera validation/test enumeration (reference:
    xyzibd_dataset.py:583-608 get_val_samples over cam_ids
    ['xyz','realsense','photoneo']). When given, every scene is scanned once
    per camera through the per-camera suffixed layout
    (``scene_gt_<cam>.json``, ``rgb_<cam>``/``gray_<cam>``, ``depth_<cam>``,
    ``mask_visib_<cam>``); scenes missing a camera's files are skipped with a
    warning, as the reference does. ``cameras=None`` reads the unsuffixed
    single-camera layout.

    ``trans_mean``/``trans_std``: dataset-level translation normalization
    (reference: xyzibd_dataset.py:16-32, 152, 796-804). Samples carry the
    stats plus ``normalized_translation = (t - mean) / std``; the raw
    camera-frame ``translation`` stays the pipeline's pose target (the
    reference's main GenPose2 path likewise trains on the raw translation —
    its normalized field feeds only the fork's se3-mode experiments, where
    label_dict['translation'] is normalized and 'raw_translation' keeps the
    camera frame, xyzibd_dataset.py:320-332)."""

    def __init__(
        self,
        cfg: DataConfig,
        split_dir: str,
        models_info_path: Optional[str] = None,
        mode: str = "train",
        min_visib_fract: float = 0.1,
        min_px_count: int = 1000,
        cameras: Optional[list] = None,
        trans_mean=None,
        trans_std=None,
    ):
        self.cfg = cfg
        self.train = mode == "train"
        self.trans_mean = (
            np.zeros(3, np.float32) if trans_mean is None
            else np.asarray(trans_mean, np.float32)
        )
        self.trans_std = (
            np.ones(3, np.float32) if trans_std is None
            else np.asarray(trans_std, np.float32)
        )
        # epoch set by the DataLoader; per-sample RNG derives from it (numpy
        # Generators are not thread-safe under the threaded loader)
        self.epoch = 0

        models_info_path = models_info_path or os.path.join(
            os.path.dirname(split_dir.rstrip("/")), "models", "models_info.json"
        )
        with open(models_info_path) as f:
            self.models_info = {int(k): v for k, v in json.load(f).items()}
        self.sym_labels = {
            oid: bop_symmetry_label(mi) for oid, mi in self.models_info.items()
        }
        self.sizes_m = {
            oid: np.asarray(
                [mi.get("size_x", 0), mi.get("size_y", 0), mi.get("size_z", 0)], np.float32
            )
            / 1000.0
            for oid, mi in self.models_info.items()
        }

        # cam=None -> unsuffixed layout; else per-camera suffixed files.
        # scene_key = (scene_dir, cam); samples = (scene_key, im_id, gi, obj_id)
        self.samples = []
        self.scene_meta = {}
        cams = cameras if cameras else [None]
        for scene_dir in sorted(glob.glob(os.path.join(split_dir, "*"))):
            for cam in cams:
                sfx = "" if cam is None else f"_{cam}"
                gt_p = os.path.join(scene_dir, f"scene_gt{sfx}.json")
                cam_p = os.path.join(scene_dir, f"scene_camera{sfx}.json")
                if not (os.path.exists(gt_p) and os.path.exists(cam_p)):
                    if cam is not None and os.path.isdir(scene_dir):
                        import warnings

                        warnings.warn(
                            f"skipping scene {scene_dir} camera {cam}: missing "
                            f"{[p for p in (gt_p, cam_p) if not os.path.exists(p)]}",
                            stacklevel=2,
                        )
                    continue
                with open(gt_p) as f:
                    scene_gt = json.load(f)
                info_p = os.path.join(scene_dir, f"scene_gt_info{sfx}.json")
                scene_info = {}
                if os.path.exists(info_p):
                    with open(info_p) as f:
                        scene_info = json.load(f)
                with open(cam_p) as f:
                    scene_cam = json.load(f)
                scene_key = (scene_dir, cam)
                self.scene_meta[scene_key] = (scene_gt, scene_info, scene_cam)
                for im_id, gts in scene_gt.items():
                    infos = scene_info.get(im_id, [{}] * len(gts))
                    for gi, (gt, inf) in enumerate(zip(gts, infos)):
                        if inf.get("visib_fract", 1.0) < min_visib_fract:
                            continue
                        if inf.get("px_count_valid", min_px_count) < min_px_count:
                            continue
                        self.samples.append((scene_key, im_id, gi, int(gt["obj_id"])))
        if not self.samples:
            raise FileNotFoundError(f"no BOP samples under {split_dir}")
        if cfg.percentage_data < 1.0:
            # seeded random subset (reference: datasets_omni6dpose.py:588-589,
            # dataset_port.py sample_ratio)
            n = max(1, int(len(self.samples) * cfg.percentage_data))
            perm = np.random.default_rng(cfg.seed).permutation(len(self.samples))
            self.samples = [self.samples[i] for i in np.sort(perm[:n])]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(self.cfg.seed, self.epoch, index))
        )
        for _ in range(len(self)):
            scene_key, im_id, gi, obj_id = self.samples[index % len(self)]
            scene_dir, cam_id = scene_key
            sfx = "" if cam_id is None else f"_{cam_id}"
            scene_gt, scene_info, scene_cam = self.scene_meta[scene_key]
            gt = scene_gt[im_id][gi]
            cam = scene_cam[im_id]
            K = np.asarray(cam["cam_K"], np.float32).reshape(3, 3)
            depth_scale = float(cam.get("depth_scale", 1.0))

            imi = int(im_id)
            # realsense publishes color under rgb_<cam>; the structured-light
            # cameras publish gray_<cam> (reference: xyzibd_dataset.py:588-592).
            # Try rgb then gray (jpg falls back to png, ref :626-639).
            rgb_p = None
            for d in (f"rgb{sfx}", f"gray{sfx}"):
                for ext in ("png", "jpg"):
                    p = os.path.join(scene_dir, d, f"{imi:06d}.{ext}")
                    if os.path.exists(p):
                        rgb_p = p
                        break
                if rgb_p:
                    break
            if rgb_p is None or not rgb_p.endswith(".png"):
                raise NotImplementedError(
                    f"{rgb_p or scene_dir}: the port reads PNG images only (no JPEG decoder)")
            rgb = read_png(rgb_p, IMREAD_COLOR)
            depth = (read_png(os.path.join(scene_dir, f"depth{sfx}", f"{imi:06d}.png"),
                              IMREAD_UNCHANGED).astype(np.float32)
                     * depth_scale / 1000.0)  # -> meters
            mask = read_png(os.path.join(scene_dir, f"mask_visib{sfx}",
                                         f"{imi:06d}_{gi:06d}.png"), IMREAD_UNCHANGED)
            mask = (mask > 0).astype(np.int32)

            R = np.asarray(gt["cam_R_m2c"], np.float32).reshape(3, 3)
            t = np.asarray(gt["cam_t_m2c"], np.float32) / 1000.0  # mm -> m
            from scipy.spatial.transform import Rotation as ScipyRot

            quat_xyzw = ScipyRot.from_matrix(R).as_quat()
            meta = {
                "camera": {
                    "intrinsics": {
                        "fx": float(K[0, 0]), "fy": float(K[1, 1]),
                        "cx": float(K[0, 2]), "cy": float(K[1, 2]),
                        "width": rgb.shape[1], "height": rgb.shape[0],
                    }
                }
            }
            obj = {
                "mask_id": 1,
                "quaternion_wxyz": quat_xyzw[[3, 0, 1, 2]].tolist(),
                "translation": t.tolist(),
                "meta": {
                    "oid": str(obj_id),
                    "class_label": obj_id,
                    "class_name": str(obj_id),
                    "bbox_side_len": self.sizes_m[obj_id].tolist(),
                },
            }
            sample = extract_object_sample(
                rgb, depth, mask, meta, obj, self.sym_labels[obj_id],
                self.cfg, rng, self.train,
            )
            if sample is None:
                index += 1
                continue
            cam_tag = cam_id or "main"
            sample["path"] = os.path.join(scene_dir, f"{cam_tag}_{imi:06d}_{gi}")
            # translation normalization fields (reference:
            # xyzibd_dataset.py:152, 320-344): stats ride the sample so a
            # consumer can train/denormalize in normalized space; the raw
            # 'translation' stays the standard pipeline's target
            sample["trans_mean"] = self.trans_mean
            sample["trans_std"] = self.trans_std
            sample["normalized_translation"] = (
                (sample["translation"] - self.trans_mean) / self.trans_std
            ).astype(np.float32)
            return sample
        raise RuntimeError("no valid BOP samples")
