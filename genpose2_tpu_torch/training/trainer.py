"""The training loop over prepared batches (port of
genpose2_tpu/training/trainer.py: zero_init_energy_heads, Trainer.__init__ /
init / train_epoch).

A prepared batch carries ``zero_mean_gt_pose`` (the JAX package's
``process_batch`` output); an energy-with-ranking batch also carries
``candidate_poses`` and ``candidate_metrics``. The scale agent's batches are
turned into frozen score-encoder features here, as the JAX trainer does.
Still to port (ROADMAP.md): ``fit`` and checkpoints, ``process_batch`` and
its augmentation, ``candidate_metrics_for_ranking``, distillation, the
energy agent's warm start from a score checkpoint, multi-device training.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from genpose2_tpu_torch.config import Config
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


class Trainer:
    """Epoch loop of one agent over prepared batches. ``frozen_score`` is the
    (score agent, its train state) pair whose features the scale agent trains
    on, read through the state's EMA weights as the JAX trainer reads them."""

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

    def _prepare(self, batch: dict) -> dict:
        if self.is_scale:
            agent, state = self.frozen_score
            feat, _ = agent.extract_features(batch, state=state)
            return {"pts_feat": feat, "axes_training": batch["axes_training"],
                    "gt_length": batch["bbox_side_len"]}
        if "zero_mean_gt_pose" not in batch:
            raise NotImplementedError("raw batches need process_batch, which is not ported "
                                      "yet (see ROADMAP.md); pass prepared batches")
        if self.agent_type == "energy_with_ranking" and "candidate_poses" not in batch:
            raise NotImplementedError("ranking candidates need candidate_metrics_for_ranking, "
                                      "which is not ported yet (see ROADMAP.md)")
        return batch

    def train_epoch(self, batches: Iterable[dict],
                    generator: Optional[torch.Generator] = None) -> dict:
        """One step per batch; returns the last step's metrics."""
        last: dict = {}
        for batch in batches:
            batch = self._prepare(batch)
            if self.is_scale:
                self.state, last = self.agent.train_step(self.state, batch)
            else:
                self.state, last = self.agent.train_step(self.state, batch, generator)
        return last
