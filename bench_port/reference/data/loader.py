# Frozen copy of genpose2_tpu_torch/data/loader.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Batching and prefetching of per-object samples (port of
genpose2_tpu/data/loader.py: collate, process_batch with its augmentation
branch, DataLoader).

``DataLoader`` is a threaded prefetcher over a map-style dataset: the host
work of a sample (PNG and EXR decoding, crops, clouds) releases the GIL in
zlib, numpy and the native core, and threads need no pickling. Its order is
the JAX package's: one permutation of ``default_rng(seed + epoch)`` per
pass, the same contiguous shard on every host, the epoch handed to the
dataset before the pass.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from bench_port.reference.so3.rotations import get_pose_representation

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


def process_batch(batch: dict, pose_mode: str = "rot_matrix", device=None,
                  aug_params: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None,
                  aug_draws: Optional[dict] = None) -> dict:
    """A collated numpy batch -> tensors on ``device``: the camera-frame cloud
    ``pts``, its float32 mean ``pts_center``, the zero-mean cloud and
    ground-truth pose, and the pass-through keys the agents read (``roi_rgb``,
    ``roi_xs``, ``roi_ys``, ...).

    ``aug_params`` (cfg.data.pts_aug_params()): the NOCS-style augmentation
    (``data/augmentation.py:data_augment``), applied exactly when it is set
    and the batch is NOCS-style (carries ``old_sym_info``), with full sizes
    ``fsnet_scale + mean_shape``; its draws come from ``generator`` (on
    ``device``) unless ``aug_draws`` gives them. The deformed sizes are
    dropped, as in the JAX package."""
    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    pts = t(batch["pcl_in"]).float()
    R = t(batch["rotation"]).float()
    trans = t(batch["translation"]).float()
    if aug_params is not None and "old_sym_info" in batch:
        from bench_port.reference.data.augmentation import data_augment

        if generator is None and aug_draws is None:
            raise ValueError("aug_params set but neither a generator nor aug_draws")
        opt = {k: t(batch[k]) for k in ("model_point", "nocs_scale", "mug_bowl_mask")
               if k in batch}
        xyz, R, trans, _ = data_augment(
            aug_params, pts[..., :3], R, trans,
            t(batch["fsnet_scale"]).float() + t(batch["mean_shape"]).float(),
            t(batch["old_sym_info"]), opt.get("model_point"), opt.get("nocs_scale"),
            opt.get("mug_bowl_mask"), generator=generator, draws=aug_draws)
        pts = torch.cat([xyz, pts[..., 3:]], dim=-1) if pts.shape[-1] > 3 else xyz
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


class DataLoader:
    """Threaded prefetching loader over a map-style dataset.

    ``shard_index`` / ``num_shards``: every host builds the same seeded
    permutation, cut to a multiple of ``num_shards``, and keeps its own
    contiguous slice; ``batch_size`` is the host's. A sample that raises in a
    worker raises in the consumer."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4, drop_last: bool = False,
                 shard_index: int = 0, num_shards: int = 1):
        assert 0 <= shard_index < num_shards, (shard_index, num_shards)
        assert num_shards <= len(dataset), (
            f"num_shards={num_shards} exceeds dataset size {len(dataset)}: every shard "
            "would be empty")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._epoch = 0

    def _shard_len(self):
        return len(self.dataset) // self.num_shards

    def __len__(self):
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list:
        """This pass's batches of dataset indices; advances the epoch and
        hands it to the dataset."""
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self._epoch
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.num_shards > 1:
            n = self._shard_len()
            order = order[self.shard_index * n:(self.shard_index + 1) * n]
        self._epoch += 1
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(self.dataset.__getitem__, idxs))))
                q.put(done)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # let a producer blocked on a full queue finish
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
