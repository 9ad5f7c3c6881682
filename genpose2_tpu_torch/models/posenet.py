"""Composition root: point encoder + score or energy net (port of
genpose2_tpu/models/posenet.py:GFObjectPose, for ``dino='none'`` and
``pts_encoder='pointnet2'`` only).

State dict layout (reference): ``pts_encoder.*`` and ``pose_score_net.*``
(for both agent types).
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from genpose2_tpu_torch.config import ModelConfig
from genpose2_tpu_torch.models.energynet import PoseEnergyNet
from genpose2_tpu_torch.models.fast_encoder import fast_cls_forward
from genpose2_tpu_torch.models.pointnet2 import PointNet2ClsMSG
from genpose2_tpu_torch.models.scorenet import PoseScoreNet


class GFObjectPose(nn.Module):
    def __init__(self, cfg: ModelConfig, marginal_std_fn: Callable, agent_type: str = "score"):
        super().__init__()
        if cfg.dino != "none" or cfg.pts_encoder != "pointnet2":
            raise NotImplementedError(
                f"dino={cfg.dino!r}, pts_encoder={cfg.pts_encoder!r}: the port serves only "
                "dino='none' with pts_encoder='pointnet2' so far (see ROADMAP.md)")
        self.cfg = cfg
        self.agent_type = agent_type
        self.pts_encoder = PointNet2ClsMSG(cfg.pointnet2)
        args = (marginal_std_fn, cfg.pose_dim, cfg.regression_head, self.pts_encoder.out_channels)
        if agent_type == "score":
            self.pose_score_net = PoseScoreNet(*args)
        elif agent_type == "energy":
            self.pose_score_net = PoseEnergyNet(*args, cfg.energy_mode, cfg.s_theta_mode,
                                                cfg.norm_energy)
        else:
            raise NotImplementedError(agent_type)

    def extract_pts_feature(self, pts, plain: bool = False):
        """pts (B, N, 3) -> (B, 1024) through the fast encoder."""
        return fast_cls_forward(self.pts_encoder, pts, self.cfg.pointnet2, plain=plain)

    def score(self, pts_feat, sampled_pose, t):
        assert self.agent_type == "score"
        return self.pose_score_net(pts_feat, sampled_pose, t)

    def energy(self, pts_feat, sampled_pose, t, decoupled_rt: bool = True):
        assert self.agent_type == "energy"
        return self.pose_score_net(pts_feat, sampled_pose, t, decoupled_rt)
