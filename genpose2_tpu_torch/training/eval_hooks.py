"""The in-training sampling evaluation (port of
genpose2_tpu/training/eval_hooks.py:make_sampling_eval_fn, its scalars).

The JAX hook also saves a grid of rendered candidates through
``utils/visualize.py``, which needs matplotlib; the card's machine has none,
and the grid waits for that module's port (ROADMAP.md queue 1, parallel and
utilities).
"""

from __future__ import annotations

from typing import Callable

import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
from genpose2_tpu_torch.eval.metrics import batch_criterion


def make_sampling_eval_fn(agent, cfg: Config, eval_batch_fn: Callable[[int], dict],
                          repeat_num: int = 10, num_steps: int = 50):
    """eval_fn(state, epoch) -> {eval_deg_mean, eval_deg_median,
    eval_sht_mean_cm, eval_iou_mean} for ``Trainer.fit``: ``repeat_num``
    candidates per object of ``eval_batch_fn(epoch)`` (a prepared batch) from
    the state's EMA weights (the fixed grid, ``num_steps`` steps from T0 1,
    the prior from a generator seeded by the epoch), score-only aggregation,
    symmetry-aware errors against the ground truth."""

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
        return {"eval_deg_mean": float(deg.mean()),
                "eval_deg_median": float(torch.quantile(deg.float(), 0.5)),
                "eval_sht_mean_cm": float(sht.mean()),
                "eval_iou_mean": float(iou.mean())}

    return eval_fn
