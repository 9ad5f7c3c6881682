"""The training loop over prepared batches (port of
genpose2_tpu/training/trainer.py: zero_init_energy_heads,
candidate_metrics_for_ranking, Trainer.__init__ / init / train_epoch).

A prepared batch is ``data.loader.process_batch``'s output (it carries
``zero_mean_gt_pose``). An energy-with-ranking batch that carries no
``candidate_poses`` gets them, with their ``candidate_metrics``, from the
frozen score agent, as the JAX trainer draws them. The scale agent's batches
are turned into frozen score-encoder features here, as the JAX trainer does.
Still to port (ROADMAP.md): ``fit`` and checkpoints, ``process_batch``'s
augmentation branch, distillation, the energy agent's warm start from a
score checkpoint, multi-device training.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.eval.metrics import rot_error_deg
from genpose2_tpu_torch.so3.rotations import get_rot_matrix
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent, TrainState


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


class Trainer:
    """Epoch loop of one agent over prepared batches. ``frozen_score`` is the
    (score agent, its train state) pair whose features the scale agent trains
    on and whose candidates the energy-with-ranking agent ranks, read through
    the state's EMA weights as the JAX trainer reads them."""

    def __init__(self, cfg: Config, agent_type: Optional[str] = None,
                 steps_per_epoch: int = 1000,
                 frozen_score: Optional[Tuple[PoseAgent, TrainState]] = None, device=None):
        self.cfg = cfg
        self.agent_type = agent_type or cfg.train.agent_type
        self.steps_per_epoch = steps_per_epoch
        self.device = device
        self.frozen_score = frozen_score
        self.is_scale = self.agent_type == "scale"
        # the scale agent is built by init(), sized from the frozen feature
        self.agent = None
        if not self.is_scale:
            base_type = "energy" if self.agent_type.startswith("energy") else self.agent_type
            self.agent = PoseAgent(cfg, base_type, device, steps_per_epoch)
        self.state: Optional[TrainState] = None

    def init(self, sample_batch: Optional[dict] = None) -> TrainState:
        """The train state over the agent's current weights. The scale agent
        is built here: its input width is that of the frozen score encoder's
        feature of ``sample_batch`` when both are given, else 1024."""
        if self.is_scale:
            pts_dim = 1024
            if self.frozen_score is not None and sample_batch is not None:
                agent, state = self.frozen_score
                pts_dim = int(agent.extract_features(sample_batch, state=state)[0].shape[-1])
            self.agent = ScaleAgent(self.cfg, pts_dim, self.device, self.steps_per_epoch)
        self.state = self.agent.init_state()
        return self.state

    def _prepare(self, batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        """A batch as the agent's step takes it: the scale agent's frozen
        features; an energy-with-ranking batch's candidates, drawn with
        ``generator`` from the frozen score agent unless it carries them."""
        if self.is_scale:
            agent, state = self.frozen_score
            feat, _ = agent.extract_features(batch, state=state)
            return {"pts_feat": feat, "axes_training": batch["axes_training"],
                    "gt_length": batch["bbox_side_len"]}
        if "zero_mean_gt_pose" not in batch:
            raise NotImplementedError("raw batches need process_batch's augmentation branch, "
                                      "which is not ported yet (see ROADMAP.md); pass "
                                      "process_batch outputs")
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
                    generator: Optional[torch.Generator] = None) -> dict:
        """One step per batch; returns the last step's metrics."""
        last: dict = {}
        for batch in batches:
            batch = self._prepare(batch, generator)
            if self.is_scale:
                self.state, last = self.agent.train_step(self.state, batch)
            else:
                self.state, last = self.agent.train_step(self.state, batch, generator)
        return last
