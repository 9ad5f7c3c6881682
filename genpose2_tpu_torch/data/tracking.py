"""Per-video tracking dataset (port of genpose2_tpu/data/tracking.py): one
folder = one video; every frame yields the SAME object set in the SAME order,
so index i of consecutive frame batches is one physical object across time.

reference: datasets/datasets_tracking.py:64-449 (asserts identical object sets
across frames :117-131, sorted object order :139-144; failures append to a
per-video fail log, evaluation_tracking.py:282-286).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data.loader import collate
from genpose2_tpu_torch.data.omni6dpose import (extract_object_sample, load_color, load_depth,
                                                load_mask, load_meta, symmetry_label)


class TrackingVideoDataset:
    """Frames of one video, each item = the collated batch of ALL tracked
    objects in that frame (fixed order)."""

    def __init__(
        self,
        cfg: DataConfig,
        video_dir: str,
        obj_meta: Optional[dict] = None,
        fail_log: Optional[str] = None,
    ):
        self.cfg = cfg
        self.fail_log = fail_log
        self.prefixes = sorted(
            p[: -len("meta.json")]
            for p in glob.glob(os.path.join(video_dir, "*meta.json"))
        )
        if not self.prefixes:
            raise FileNotFoundError(f"no frames in {video_dir}")
        self.obj_meta = obj_meta or {}

        # the tracked object set = valid objects of the first frame, sorted by
        # oid (reference: datasets_tracking.py:139-144)
        meta0 = load_meta(self.prefixes[0])
        self.oids = sorted(
            o["meta"]["oid"] for o in meta0["objects"] if o.get("is_valid", True)
        )
        if not self.oids:
            raise ValueError(f"no valid objects in first frame of {video_dir}")

    def __len__(self):
        return len(self.prefixes)

    def _fail(self, msg):
        if self.fail_log:
            with open(self.fail_log, "a") as f:
                f.write(msg + "\n")
        raise ValueError(msg)

    def __getitem__(self, frame_idx: int) -> dict:
        # per-call generator: thread-safe + deterministic point sampling
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(self.cfg.seed, frame_idx))
        )
        prefix = self.prefixes[frame_idx]
        meta = load_meta(prefix)
        by_oid = {
            o["meta"]["oid"]: o for o in meta["objects"] if o.get("is_valid", True)
        }
        if sorted(by_oid) != self.oids:
            self._fail(f"object set changed at {prefix}")
        rgb = load_color(prefix + "color.png")
        depth = load_depth(prefix)
        mask = load_mask(prefix)
        samples = []
        for oid in self.oids:
            obj = by_oid[oid]
            sym = symmetry_label(self.obj_meta, oid)
            sample = extract_object_sample(
                rgb, depth, mask, meta, obj, sym, self.cfg, rng, train=False
            )
            if sample is None:
                self._fail(f"object {oid} unusable at {prefix}")
            samples.append(sample)
        batch = collate(samples)
        batch["path"] = prefix
        return batch


def open_video_datasets(
    cfg: DataConfig, root: str, obj_meta: Optional[dict] = None, fail_log: Optional[str] = None
) -> List[TrackingVideoDataset]:
    """One TrackingVideoDataset per subdirectory of ``root``. Videos that fail
    validation are skipped with a log entry rather than aborting the run
    (reference: evaluation_tracking.py:282-286 tracking_fail.txt)."""
    out = []
    for d in sorted(glob.glob(os.path.join(root, "*"))):
        if not os.path.isdir(d):
            continue
        try:
            out.append(TrackingVideoDataset(cfg, d, obj_meta, fail_log))
        except (FileNotFoundError, ValueError) as e:
            if fail_log:
                with open(fail_log, "a") as f:
                    f.write(f"{d}: {e}\n")
    return out
