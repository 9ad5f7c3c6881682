"""The training loop (port of genpose2_tpu/training/trainer.py): the epoch
loop with logging, periodic evaluation and checkpoints.

A batch is either raw (a collated dataset batch: ``process_batch`` runs here,
with the NOCS-style augmentation where the batch is NOCS-style) or prepared
(it carries ``zero_mean_gt_pose``). An energy-with-ranking batch that carries
no ``candidate_poses`` gets them, with their ``candidate_metrics``, from the
frozen score agent, as the JAX trainer draws them. The scale agent's batches
are turned into frozen score-encoder features here; unlike the JAX trainer,
a raw scale batch goes through ``process_batch`` first (the JAX trainer reads
``pts`` from it, which only a synthetic batch has).

``fit`` resumes as the JAX package does: from epoch step // steps_per_epoch
+ 1, a checkpoint every ``eval_freq`` epochs and at the last, then
``final``. Each epoch's draws come from a generator seeded by (seed,
epoch), so a resumed run repeats the uninterrupted one bit for bit on the
CPU. The port runs one step at a time (the JAX package scans chunks of
steps in one dispatch) and logs every 8th step, the scale agent every 50th,
and one record an epoch.

Still raising, with their ROADMAP.md items (queue 1, the rest of training):
distillation, the EDM decoder's training, ``dino='global'`` training;
multi-device training (queue 1, parallel and utilities).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.eval.metrics import rot_error_deg
from genpose2_tpu_torch.so3.rotations import get_rot_matrix
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent, TrainState
from genpose2_tpu_torch.training.checkpoint import (load_checkpoint, load_params_only,
                                                    save_checkpoint)
from genpose2_tpu_torch.utils.logging import MetricsLogger


@torch.no_grad()
def zero_init_energy_heads(agent: PoseAgent, state: TrainState) -> TrainState:
    """Zero the output layer of every regression head of the pose net (after
    loading score weights into an energy net) and restart the EMA from the
    result, as genpose2_tpu/training/trainer.py:37-60 does."""
    net = agent.model.pose_score_net
    for name in net.head_names():
        out = getattr(net, name)[-1]
        out.weight.zero_()
        out.bias.zero_()
    for k, p in state.params.items():
        state.ema_params[k].copy_(p)
    return state


@torch.no_grad()
def candidate_metrics_for_ranking(score_agent: PoseAgent, batch: dict, num: int,
                                  generator: Optional[torch.Generator] = None,
                                  prior: Optional[torch.Tensor] = None,
                                  state: Optional[TrainState] = None):
    """``num`` candidates per object from the frozen score agent (T0 1.0, the
    fixed grid, 50 steps; ``prior`` (B * num, D) or drawn with
    ``generator``; ``state``'s EMA weights when given) and their errors
    against the ground truth, the ranking loss's supervision: returns
    (candidate poses zero-centred (B, num, D), metrics (B, num, 2) =
    symmetry-aware rotation error in degrees, translation error in m)."""
    dev = score_agent.device
    poses = score_agent.sample_candidates(batch, repeat_num=num, T0=1.0, method="fixed",
                                          num_steps=50, generator=generator, prior=prior,
                                          state=state)  # camera frame
    B, K, D = poses.shape
    flat = poses.reshape(B * K, D)
    R_pred = get_rot_matrix(flat[:, :-3], score_agent.cfg.model.pose_mode)
    R_gt = batch["gt_rotation"].to(dev, torch.float32).repeat_interleave(K, 0)
    sym = batch["sym_info"].to(dev).repeat_interleave(K, 0)
    deg = rot_error_deg(R_pred, R_gt, sym).reshape(B, K)
    t_gt = batch["gt_translation"].to(dev, torch.float32).repeat_interleave(K, 0)
    sht = torch.linalg.norm(flat[:, -3:] - t_gt, dim=-1).reshape(B, K)
    zero_centred = poses.clone()
    zero_centred[..., -3:] -= batch["pts_center"].to(dev)[:, None, :]
    return zero_centred, torch.stack([deg, sht], dim=-1)


def epoch_generator(seed: int, epoch: int, device=None) -> torch.Generator:
    """The generator of one epoch's draws, seeded by (seed, epoch)."""
    state = np.random.SeedSequence((seed, epoch)).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state >> np.uint64(1)))


class Trainer:
    """Epoch loop of one agent, with logging, periodic evaluation and
    checkpoints under ``log_dir`` (``<log_dir>/<agent_type>_metrics.jsonl``,
    ``<log_dir>/ckpt/``). ``frozen_score`` is the (score agent, its train
    state) pair whose features the scale agent trains on and whose candidates
    the energy-with-ranking agent ranks, read through the state's EMA weights
    as the JAX trainer reads them. ``score_ckpt`` warm-starts an energy agent
    from a score checkpoint with zeroed heads; ``resume_from`` restores a
    whole train state."""

    def __init__(self, cfg: Config, agent_type: Optional[str] = None,
                 steps_per_epoch: int = 1000,
                 frozen_score: Optional[Tuple[PoseAgent, TrainState]] = None, device=None,
                 log_dir: Optional[str] = None, score_ckpt: Optional[str] = None,
                 resume_from: Optional[str] = None):
        self.cfg = cfg
        self.agent_type = agent_type or cfg.train.agent_type
        self.steps_per_epoch = steps_per_epoch
        self.device = device
        self.frozen_score = frozen_score
        self.score_ckpt = score_ckpt
        self.resume_from = resume_from
        self.log_dir = log_dir or cfg.log_dir
        self.logger = MetricsLogger(self.log_dir, self.agent_type)
        self.is_scale = self.agent_type == "scale"
        if cfg.train.distillation and self.agent_type == "score" and frozen_score is not None:
            raise NotImplementedError("distillation (train_step_distilled) is not ported yet "
                                      "(ROADMAP.md queue 1, the rest of training)")
        # the scale agent is built by init(), sized from the frozen feature
        self.agent = None
        if not self.is_scale:
            base_type = "energy" if self.agent_type.startswith("energy") else self.agent_type
            self.agent = PoseAgent(cfg, base_type, device, steps_per_epoch)
        self.state: Optional[TrainState] = None

    def init(self, sample_batch: Optional[dict] = None) -> TrainState:
        """The train state over the agent's current weights. The scale agent
        is built here: its input width is that of the frozen score encoder's
        feature of ``sample_batch`` (raw or prepared) when both are given,
        else 1024. Then the energy agent's warm start and the resume."""
        if self.is_scale:
            pts_dim = 1024
            if self.frozen_score is not None and sample_batch is not None:
                agent, state = self.frozen_score
                batch = self._processed(sample_batch, None)
                pts_dim = int(agent.extract_features(batch, state=state)[0].shape[-1])
            self.agent = ScaleAgent(self.cfg, pts_dim, self.device, self.steps_per_epoch)
        self.state = self.agent.init_state()
        if self.agent_type.startswith("energy") and self.score_ckpt:
            load_params_only(self.score_ckpt, self.state, agent=self.agent)
            zero_init_energy_heads(self.agent, self.state)
        if self.resume_from:
            load_checkpoint(self.resume_from, self.state, self.agent)
        return self.state

    def _processed(self, batch: dict, generator: Optional[torch.Generator]) -> dict:
        """A raw batch through process_batch (and the NOCS-style augmentation
        where it applies, not for the scale agent); a prepared one as it is."""
        if "zero_mean_gt_pose" in batch:
            return batch
        dev = self.agent.device if self.agent is not None else self.frozen_score[0].device
        aug = None if self.is_scale else self.cfg.data.pts_aug_params()
        return process_batch(batch, self.cfg.model.pose_mode, dev, aug_params=aug,
                             generator=generator)

    def _prepare(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        """A batch as the agent's step takes it: the scale agent's frozen
        features; an energy-with-ranking batch's candidates, drawn with
        ``generator`` from the frozen score agent unless it carries them."""
        batch = self._processed(batch, generator)
        if self.is_scale:
            agent, state = self.frozen_score
            feat, _ = agent.extract_features(batch, state=state)
            return {"pts_feat": feat, "axes_training": batch["axes_training"],
                    "gt_length": batch["bbox_side_len"]}
        if self.agent_type == "energy_with_ranking" and "candidate_poses" not in batch:
            if self.frozen_score is None:
                raise ValueError("energy_with_ranking draws its candidates from a frozen "
                                 "score agent: pass frozen_score=(agent, state)")
            agent, state = self.frozen_score
            cand, cmet = candidate_metrics_for_ranking(agent, batch, self.cfg.train.ranking_num,
                                                       generator, state=state)
            batch = dict(batch, candidate_poses=cand, candidate_metrics=cmet)
        return batch

    def train_epoch(self, batches: Iterable[dict],
                    generator: Optional[torch.Generator] = None, epoch: int = 0) -> dict:
        """One step per batch; logs every 8th step (the scale agent every
        50th) and one record for the epoch (its last step's metrics as
        ``epoch_<name>`` and ``epoch_time_s``). Returns the last step's
        metrics."""
        t0 = time.time()
        last: dict = {}
        every = 50 if self.is_scale else 8
        for i, batch in enumerate(batches):
            batch = self._prepare(batch, generator)
            if self.is_scale:
                self.state, last = self.agent.train_step(self.state, batch)
            else:
                self.state, last = self.agent.train_step(self.state, batch, generator)
            if i % every == 0:
                self.logger.log(self.state.step, last)
        self.logger.log(self.state.step, {**{f"epoch_{k}": v for k, v in last.items()},
                                          "epoch": epoch, "epoch_time_s": time.time() - t0})
        return last

    def save(self, name: Optional[str] = None) -> str:
        """The train state (and the backbone) to ``<log_dir>/ckpt/<name>``."""
        return save_checkpoint(os.path.join(self.log_dir, "ckpt"), self.state, name, self.agent)

    def fit(self, loader_fn: Callable[[int], Iterable[dict]], epochs: Optional[int] = None,
            eval_fn: Optional[Callable[[TrainState, int], dict]] = None) -> TrainState:
        """``loader_fn(epoch)`` -> the epoch's batches. From the epoch after
        the state's step (a resume skips the epochs done) to ``epochs``
        (cfg.train.n_epochs); every cfg.train.eval_freq epochs and at the
        last: ``eval_fn(state, epoch)``'s scalars logged, a checkpoint
        ``epoch_<n>``; at the end, ``final``."""
        epochs = epochs or self.cfg.train.n_epochs
        start = self.state.step // max(self.steps_per_epoch, 1) + 1
        for epoch in range(start, epochs + 1):
            g = epoch_generator(self.cfg.train.seed, epoch, self.agent.device)
            self.train_epoch(loader_fn(epoch), g, epoch)
            if epoch % self.cfg.train.eval_freq == 0 or epoch == epochs:
                if eval_fn is not None:
                    self.logger.log(self.state.step, eval_fn(self.state, epoch))
                self.save(f"epoch_{epoch}")
        self.save("final")
        return self.state
