"""The in-training sampling evaluation (port of
genpose2_tpu/training/eval_hooks.py:make_sampling_eval_fn): its scalars and
its grid of rendered poses.

The grid draws with matplotlib (``utils/visualize.py``); where it is
missing, or drawing fails for any other reason, the scalars carry
``eval_image_error`` and training goes on, as in the JAX hook.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
from genpose2_tpu_torch.eval.metrics import batch_criterion
from genpose2_tpu_torch.so3.rotations import matrix_to_rot6d_cols


def make_sampling_eval_fn(agent, cfg: Config, eval_batch_fn: Callable[[int], dict],
                          log_dir: Optional[str] = None, repeat_num: int = 10,
                          num_steps: int = 50, save_images: bool = True):
    """eval_fn(state, epoch) -> {eval_deg_mean, eval_deg_median,
    eval_sht_mean_cm, eval_iou_mean} for ``Trainer.fit``: ``repeat_num``
    candidates per object of ``eval_batch_fn(epoch)`` (a prepared batch) from
    the state's EMA weights (the fixed grid, ``num_steps`` steps from T0 1,
    the prior from a generator seeded by the epoch), score-only aggregation,
    symmetry-aware errors against the ground truth. With ``save_images`` and
    a ``log_dir``, the clouds under the aggregated and the ground-truth
    poses go to ``<log_dir>/eval_img/epoch_<epoch>.png``."""

    def eval_fn(state, epoch: int) -> dict:
        batch = eval_batch_fn(epoch)
        g = torch.Generator(agent.device).manual_seed(epoch)
        poses = agent.sample_candidates(batch, repeat_num=repeat_num, T0=1.0, method="fixed",
                                        num_steps=num_steps, generator=g, state=state)
        agg = aggregate_candidates(poses, None, retain_ratio=cfg.eval.retain_ratio,
                                   pose_mode=cfg.model.pose_mode)
        n = poses.shape[0]
        sizes = batch.get("bbox_side_len",
                          torch.full((n, 3), 0.1, dtype=poses.dtype, device=poses.device))
        sym = batch.get("sym_info", torch.zeros((n, 4), dtype=torch.int32))
        iou, deg, sht = batch_criterion(agg["rotation"], agg["translation"], sizes,
                                        batch["gt_rotation"], batch["gt_translation"], sizes,
                                        sym)
        scalars = {"eval_deg_mean": float(deg.mean()),
                   "eval_deg_median": float(torch.quantile(deg.float(), 0.5)),
                   "eval_sht_mean_cm": float(sht.mean()),
                   "eval_iou_mean": float(iou.mean())}
        if save_images and log_dir:
            try:
                save_eval_grid(batch, agg, os.path.join(log_dir, "eval_img",
                                                        f"epoch_{epoch}.png"))
            except Exception:  # visualization must never kill training
                scalars["eval_image_error"] = 0.0
        return scalars

    return eval_fn


def save_eval_grid(batch: dict, agg: dict, path: str) -> None:
    """The eval batch's clouds (``pts`` plus ``pts_center``, as the JAX hook
    draws them) under the aggregated and the ground-truth poses, 9-D, as
    ``create_grid_image`` renders them, to ``path``."""
    from genpose2_tpu_torch.utils.visualize import create_grid_image

    def nine(R, t):
        return np.concatenate([matrix_to_rot6d_cols(torch.as_tensor(R)).cpu().numpy(),
                               torch.as_tensor(t).cpu().numpy()], axis=-1)

    os.makedirs(os.path.dirname(path), exist_ok=True)
    pts = torch.as_tensor(batch["pts"]).cpu().numpy()
    center = torch.as_tensor(batch["pts_center"]).cpu().numpy()
    create_grid_image(pts + center[:, None, :],
                      pred_pose=nine(agg["rotation"], agg["translation"]),
                      gt_pose=nine(batch["gt_rotation"], batch["gt_translation"]), path=path)
