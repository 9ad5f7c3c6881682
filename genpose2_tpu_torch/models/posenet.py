"""Composition root: point encoder (+ DINO fusion) + score or energy net (port
of genpose2_tpu/models/posenet.py:GFObjectPose).

The point encoders, as the JAX package accepts them:
- ``pts_encoder='pointnet2'`` with ``dino`` 'none', 'pointwise' or
  'global';
- ``'pointnet'`` (PointNetFeat on the cloud) and ``'pointnet_and_pointnet2'``
  (PointNetFeat and PointNet2ClsMSG on the cloud, their features joined by a
  1024-wide Linear + ReLU) with ``dino`` 'none' or 'global'. With
  dino='pointwise' the JAX package fails on both (it feeds 3 + dino_dim
  channels to the 3-channel T-Net, or has no ``pts_encoder``), and the port
  raises.

With dino='global' the heads also take the global rgb feature: the
backbone's class token concatenated with ``encode_axes(roi_center_dir)``,
``dino_dim + global_embedding_dim`` wide. Eval runs the fast encoders of
models/fast_encoder.py for pointnet2 with dino 'none' or 'pointwise', and
the encoders' module forms otherwise, as the JAX package routes them.

State dict layout (reference): ``pts_encoder.*`` (or, for
'pointnet_and_pointnet2', ``pts_pointnet_encoder.*``,
``pts_pointnet2_encoder.*`` and ``fusion_layer``) and ``pose_score_net.*``
(for both agent types and the score agent's EDM decoder), plus
``img_encoder.*`` with ``dino='pointwise'`` (a global model holds none: the
JAX package creates its parameters only where the module runs). The frozen
backbone is not part of it: the agent owns it (models/provider.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from genpose2_tpu_torch.config import ModelConfig
from genpose2_tpu_torch.models.energynet import PoseEnergyNet
from genpose2_tpu_torch.models.fast_encoder import fast_cls_forward, fast_fus_forward
from genpose2_tpu_torch.models.img_encoder import ImgEncoder
from genpose2_tpu_torch.models.pointnet import PointNetFeat
from genpose2_tpu_torch.models.pointnet2 import PointNet2ClsMSG, PointNet2ClsMSGFus
from genpose2_tpu_torch.models.scorenet import PoseDecoderNet, PoseScoreNet
from genpose2_tpu_torch.so3.rotations import encode_axes
from genpose2_tpu_torch.utils.profiling import span


class GFObjectPose(nn.Module):
    """``use_decoder`` (a score agent whose sde mode is 'edm'): the pose net is
    the EDM denoiser ``PoseDecoderNet`` in place of the score net."""

    def __init__(self, cfg: ModelConfig, marginal_std_fn: Callable, agent_type: str = "score",
                 use_decoder: bool = False):
        super().__init__()
        if cfg.dino not in ("none", "pointwise", "global"):
            raise NotImplementedError(f"dino={cfg.dino!r}")
        if cfg.pts_encoder not in ("pointnet", "pointnet2", "pointnet_and_pointnet2"):
            raise NotImplementedError(f"pts_encoder={cfg.pts_encoder!r}")
        if cfg.dino == "pointwise" and cfg.pts_encoder != "pointnet2":
            raise ValueError(f"pts_encoder={cfg.pts_encoder!r} does not take dino='pointwise' "
                             "(the per-point DINO feature feeds only the pointnet2 Fus "
                             "encoder); use dino 'none' or 'global'")
        self.cfg = cfg
        self.agent_type = agent_type
        self.use_decoder = use_decoder
        if cfg.dino == "pointwise":
            grid = cfg.img_size // cfg.patch_size
            dt = torch.bfloat16 if cfg.pointnet2.compute_dtype == "bfloat16" else None
            self.img_encoder = ImgEncoder(cfg.dino_dim, grid * grid, dtype=dt)
            self.pts_encoder = PointNet2ClsMSGFus(cfg.pointnet2, cfg.dino_dim)
        elif cfg.pts_encoder == "pointnet2":
            self.pts_encoder = PointNet2ClsMSG(cfg.pointnet2)
        elif cfg.pts_encoder == "pointnet":
            self.pts_encoder = PointNetFeat(out_dim=1024, in_dim=3)
        else:
            self.pts_pointnet_encoder = PointNetFeat(out_dim=1024, in_dim=3)
            self.pts_pointnet2_encoder = PointNet2ClsMSG(cfg.pointnet2)
            self.fusion_layer = nn.Linear(1024 + self.pts_pointnet2_encoder.out_channels, 1024)
        feat_dim = 1024 if cfg.pts_encoder != "pointnet2" else self.pts_encoder.out_channels
        rgb_dim = cfg.dino_dim + cfg.global_embedding_dim if cfg.dino == "global" else 0
        args = (marginal_std_fn, cfg.pose_dim, cfg.regression_head, feat_dim)
        if agent_type == "score" and use_decoder:
            self.pose_score_net = PoseDecoderNet(*args)
        elif agent_type == "score":
            self.pose_score_net = PoseScoreNet(*args, rgb_dim=rgb_dim)
        elif agent_type == "energy":
            self.pose_score_net = PoseEnergyNet(*args, cfg.energy_mode, cfg.s_theta_mode,
                                                cfg.norm_energy, rgb_dim=rgb_dim)
        else:
            raise NotImplementedError(agent_type)

    def fuse_dino_layers(self, dino_layers: Sequence[torch.Tensor]) -> torch.Tensor:
        """Tapped ViT layers -> fused patch features (B, P, D)."""
        with span("img_encoder"):
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

    def extract_pts_feature(self, pts, dino_layers: Optional[Sequence[torch.Tensor]] = None,
                            roi_xs=None, roi_ys=None, train: bool = False,
                            generator: Optional[torch.Generator] = None):
        """pts (B, N, 3) (+ the tapped ViT layers and each point's pixel with
        dino='pointwise') -> (B, C_final).

        Eval: the fast encoder, without gradients (dino='global' and the
        PointNet encoders: the encoders' module forwards in eval form).
        ``train``: the encoders' module forwards with autograd, noise and
        dropout drawn from ``generator``; the per-point DINO feature is
        computed without gradients (the JAX package's stop_gradient), so the
        ImgEncoder gets none."""
        if self.cfg.dino == "pointwise":
            with torch.no_grad():
                rgb = self.pointwise_rgb_feat(self.fuse_dino_layers(dino_layers), roi_xs, roi_ys)
            inp = torch.cat([pts.float(), rgb], dim=-1)
        else:
            inp = pts.float()
        if train:
            return self._module_forward(inp, True, generator)
        if self.cfg.dino == "global" or self.cfg.pts_encoder != "pointnet2":
            with torch.no_grad():
                return self._module_forward(inp, False)
        fast = fast_fus_forward if self.cfg.dino == "pointwise" else fast_cls_forward
        with torch.no_grad():
            return fast(self.pts_encoder, inp, self.cfg.pointnet2)

    def _module_forward(self, inp, train: bool, generator=None):
        if self.cfg.pts_encoder == "pointnet":
            return self.pts_encoder(inp)
        if self.cfg.pts_encoder == "pointnet_and_pointnet2":
            f1 = self.pts_pointnet_encoder(inp)
            f2 = self.pts_pointnet2_encoder(inp, train, generator)
            return torch.relu(self.fusion_layer(torch.cat([f1, f2], dim=-1)))
        return self.pts_encoder(inp, train, generator)

    def extract_global_rgb_feature(self, dino_global: torch.Tensor,
                                   roi_center_dir: torch.Tensor) -> torch.Tensor:
        """dino='global': the class token (B, dino_dim) and the crop centre's
        view direction (B, 3), encoded -> (B, dino_dim + global_embedding_dim)."""
        emb = encode_axes(roi_center_dir.float(), self.cfg.global_embedding_dim // 6)
        return torch.cat([dino_global.float(), emb], dim=-1)

    def score(self, pts_feat, sampled_pose, t, rgb_feat=None):
        assert self.agent_type == "score" and not self.use_decoder
        return self.pose_score_net(pts_feat, sampled_pose, t, rgb_feat)

    def denoise(self, pts_feat, sampled_pose, sigma, rgb_feat=None):
        """The EDM denoiser D(x; sigma) (sde mode 'edm', where t and sigma are
        one)."""
        assert self.agent_type == "score" and self.use_decoder
        return self.pose_score_net(pts_feat, sampled_pose, sigma, rgb_feat)

    def energy(self, pts_feat, sampled_pose, t, decoupled_rt: bool = True, rgb_feat=None):
        assert self.agent_type == "energy"
        return self.pose_score_net(pts_feat, sampled_pose, t, decoupled_rt, rgb_feat)

    def energy_score(self, pts_feat, sampled_pose, t, rgb_feat=None):
        """The energy net's score, d sum(E(p, decoupled_rt=False)) / dp, kept
        differentiable (create_graph) for the DSM loss that trains it
        (genpose2_tpu/training/agent.py:464-475)."""
        with torch.enable_grad():
            p = sampled_pose.detach().requires_grad_(True)
            e = self.energy(pts_feat, p, t, decoupled_rt=False, rgb_feat=rgb_feat).sum()
            return torch.autograd.grad(e, p, create_graph=True)[0]
