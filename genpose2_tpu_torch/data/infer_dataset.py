"""Raw colour + depth + mask (+ intrinsics) -> a collated per-object batch
(port of genpose2_tpu/data/infer_dataset.py:frame_to_object_batch)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data.loader import collate
from genpose2_tpu_torch.data.omni6dpose import extract_object_sample

BACKGROUND_ID = 255


def frame_to_object_batch(color: np.ndarray, depth: np.ndarray, mask: np.ndarray,
                          intrinsics: dict, cfg: DataConfig,
                          mask_ids: Optional[Sequence[int]] = None,
                          sym_infos: Optional[dict] = None, seed: int = 0) -> Optional[dict]:
    """color (H, W, 3) uint8, depth (H, W) meters, mask (H, W) int;
    intrinsics {fx, fy, cx, cy, width, height}. Returns a collated numpy batch
    over every object with usable depth (mask ids other than 0 and 255, or
    ``mask_ids``), with their ``mask_ids``; None when there is none."""
    rng = np.random.default_rng(seed)
    if mask_ids is None:
        mask_ids = [int(i) for i in np.unique(mask) if i != BACKGROUND_ID and i != 0]
    meta = {"camera": {"intrinsics": intrinsics}}
    samples, kept_ids = [], []
    for mid in mask_ids:
        obj = {
            "mask_id": mid,
            "quaternion_wxyz": [1.0, 0, 0, 0],  # no ground truth at inference
            "translation": [0.0, 0, 0],
            "meta": {"oid": str(mid), "class_label": -1, "class_name": "",
                     "bbox_side_len": [0.0, 0, 0]},
        }
        sym = np.zeros(4, np.int32)
        if sym_infos and mid in sym_infos:
            sym = np.asarray(sym_infos[mid], np.int32)
        s = extract_object_sample(color, depth, mask, meta, obj, sym, cfg, rng, train=False)
        if s is not None:
            samples.append(s)
            kept_ids.append(mid)
    if not samples:
        return None
    batch = collate(samples)
    batch["mask_ids"] = np.asarray(kept_ids, np.int32)
    return batch
