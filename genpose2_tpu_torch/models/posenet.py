"""Composition root: point encoder (+ DINO fusion) + score or energy net (port
of genpose2_tpu/models/posenet.py:GFObjectPose, for ``pts_encoder='pointnet2'``
with ``dino='none'`` or ``dino='pointwise'``).

State dict layout (reference): ``pts_encoder.*`` and ``pose_score_net.*``
(for both agent types), plus ``img_encoder.*`` with ``dino='pointwise'``. The
frozen backbone is not part of it: the agent owns it
(models/provider.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from genpose2_tpu_torch.config import ModelConfig
from genpose2_tpu_torch.models.energynet import PoseEnergyNet
from genpose2_tpu_torch.models.fast_encoder import fast_cls_forward, fast_fus_forward
from genpose2_tpu_torch.models.img_encoder import ImgEncoder
from genpose2_tpu_torch.models.pointnet2 import PointNet2ClsMSG, PointNet2ClsMSGFus
from genpose2_tpu_torch.models.scorenet import PoseScoreNet


class GFObjectPose(nn.Module):
    def __init__(self, cfg: ModelConfig, marginal_std_fn: Callable, agent_type: str = "score"):
        super().__init__()
        if cfg.dino not in ("none", "pointwise") or cfg.pts_encoder != "pointnet2":
            raise NotImplementedError(
                f"dino={cfg.dino!r}, pts_encoder={cfg.pts_encoder!r}: the port serves only "
                "dino='none' or 'pointwise' with pts_encoder='pointnet2' so far (see ROADMAP.md)")
        self.cfg = cfg
        self.agent_type = agent_type
        if cfg.dino == "pointwise":
            grid = cfg.img_size // cfg.patch_size
            dt = torch.bfloat16 if cfg.pointnet2.compute_dtype == "bfloat16" else None
            self.img_encoder = ImgEncoder(cfg.dino_dim, grid * grid, dtype=dt)
            self.pts_encoder = PointNet2ClsMSGFus(cfg.pointnet2, cfg.dino_dim)
        else:
            self.pts_encoder = PointNet2ClsMSG(cfg.pointnet2)
        args = (marginal_std_fn, cfg.pose_dim, cfg.regression_head, self.pts_encoder.out_channels)
        if agent_type == "score":
            self.pose_score_net = PoseScoreNet(*args)
        elif agent_type == "energy":
            self.pose_score_net = PoseEnergyNet(*args, cfg.energy_mode, cfg.s_theta_mode,
                                                cfg.norm_energy)
        else:
            raise NotImplementedError(agent_type)

    def fuse_dino_layers(self, dino_layers: Sequence[torch.Tensor]) -> torch.Tensor:
        """Tapped ViT layers -> fused patch features (B, P, D)."""
        return self.img_encoder(dino_layers)

    def pointwise_rgb_feat(self, fused_patches, roi_xs, roi_ys) -> torch.Tensor:
        """Each point's fused patch feature, from its pixel (xs, ys): patch
        index (xs // p) * grid + ys // p, clipped into the grid -> (B, N, D)."""
        m = self.cfg
        grid = m.img_size // m.patch_size
        xs = roi_xs.to(torch.int64) // m.patch_size
        ys = roi_ys.to(torch.int64) // m.patch_size
        pos = (xs * grid + ys).clamp(0, fused_patches.shape[1] - 1)
        return torch.gather(fused_patches, 1,
                            pos[..., None].expand(-1, -1, fused_patches.shape[-1]))

    @torch.no_grad()
    def extract_pts_feature(self, pts, plain: bool = False,
                            dino_layers: Optional[Sequence[torch.Tensor]] = None,
                            roi_xs=None, roi_ys=None):
        """pts (B, N, 3) (+ the tapped ViT layers and each point's pixel with
        dino='pointwise') -> (B, C_final) through the fast encoder."""
        if self.cfg.dino == "none":
            return fast_cls_forward(self.pts_encoder, pts, self.cfg.pointnet2, plain=plain)
        rgb = self.pointwise_rgb_feat(self.fuse_dino_layers(dino_layers), roi_xs, roi_ys)
        inp = torch.cat([pts.float(), rgb], dim=-1)
        return fast_fus_forward(self.pts_encoder, inp, self.cfg.pointnet2, plain=plain)

    def score(self, pts_feat, sampled_pose, t):
        assert self.agent_type == "score"
        return self.pose_score_net(pts_feat, sampled_pose, t)

    def energy(self, pts_feat, sampled_pose, t, decoupled_rt: bool = True):
        assert self.agent_type == "energy"
        return self.pose_score_net(pts_feat, sampled_pose, t, decoupled_rt)
