"""Inference surface of the agents (port of genpose2_tpu/training/agent.py:
PoseAgent.extract_features / sample_candidates / get_energy and
ScaleAgent.predict). Training is not ported yet (see ROADMAP.md).

Each agent owns its network (``.model``) on its device; weights come in
through ``agent.model.load_state_dict`` in the reference layout
(genpose2_tpu_torch/weights.py turns the JAX package's variables into it). The device is ``cuda`` unless the
caller passes one; without a card and without a device the agents raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.device import resolve_device
from genpose2_tpu_torch.diffusion import init_sde, ode_sampler
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.models.scalenet import ScaleNet
from genpose2_tpu_torch.models.scorenet import fast_score_weights
from genpose2_tpu_torch.ops.ode_rk4 import fast_score


class PoseAgent:
    """A score or energy GFObjectPose, in eval mode, on one device."""

    def __init__(self, cfg: Config, agent_type: Optional[str] = None, device=None):
        self.cfg = cfg
        self.agent_type = agent_type or cfg.train.agent_type
        self.device = resolve_device(device)
        self.sde = init_sde(cfg.sde)
        self.model = GFObjectPose(cfg.model, self.sde.marginal_std, self.agent_type)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def extract_features(self, batch: dict, plain: bool = False):
        """batch['pts'] (B, N, 3) -> (pts_feat (B, 1024), rgb_feat None).
        ``plain`` runs the plain versions of the encoder's kernels."""
        pts = batch["pts"].to(self.device, torch.float32)
        return self.model.extract_pts_feature(pts, plain=plain), None

    @torch.no_grad()
    def sample_candidates(self, batch: dict, repeat_num: int = 50, T0: float = 1.0,
                          init_x: Optional[torch.Tensor] = None, method: str = "fixed",
                          num_steps: int = 500, features=None,
                          generator: Optional[torch.Generator] = None,
                          prior: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``repeat_num`` pose candidates per object, (B, K, D), camera frame.

        ``features`` (pts_feat, None) from ``extract_features`` skips the
        encoder. ``prior`` (B * K, D) is the start noise; when None it is
        drawn with ``generator``. With cfg.sampler.fused_fixed the integration
        is one fused RK4 launch, otherwise the per-step loop."""
        assert self.agent_type == "score"
        pts_feat, _ = features if features is not None else self.extract_features(batch)
        B, K, D = pts_feat.shape[0], repeat_num, self.cfg.model.pose_dim
        feat_rep = pts_feat.repeat_interleave(K, dim=0)
        net = self.model.pose_score_net
        dtype = self.cfg.model.score_dtype
        center = batch.get("pts_center")
        center_rep = None if center is None else center.to(self.device).repeat_interleave(K, 0)
        if init_x is not None:
            init_x = init_x.to(self.device)
            init_x = init_x.repeat_interleave(K, 0) if init_x.ndim == 2 else init_x.reshape(B * K, D)
        w = fast_score_weights(net, feat_rep)

        def score(x, t):
            return fast_score(w, x, t, net.marginal_std_fn, dtype)

        fused = w if method == "fixed" and self.cfg.sampler.fused_fixed else None
        poses, _ = ode_sampler(
            score, self.sde, B * K, D,
            T0=T0, init_x=init_x, num_steps=num_steps, pose_mode=self.cfg.model.pose_mode,
            pts_center=center_rep, method=method, fused_weights=fused, compute_dtype=dtype,
            prior=None if prior is None else prior.to(self.device), generator=generator,
            device=self.device,
        )
        return poses.reshape(B, K, D)

    @torch.no_grad()
    def get_energy(self, batch: dict, poses: torch.Tensor, fixed_t: float = 1e-5,
                   features=None) -> torch.Tensor:
        """Energy of camera-frame candidates (B, K, D) -> (B, K, 2), at
        diffusion time ``fixed_t``; the cloud center is subtracted first."""
        assert self.agent_type == "energy"
        pts_feat, _ = features if features is not None else self.extract_features(batch)
        B, K, D = poses.shape
        poses = poses.to(self.device).clone()
        center = batch.get("pts_center")
        if center is not None:
            poses[..., -3:] -= center.to(self.device)[:, None, :]
        flat = poses.reshape(B * K, D)
        t = torch.full((B * K, 1), fixed_t, dtype=flat.dtype, device=self.device)
        energy = self.model.energy(pts_feat.repeat_interleave(K, 0), flat, t, True)
        return energy.reshape(B, K, 2)


class ScaleAgent:
    """ScaleNet on the frozen score-encoder feature, on one device."""

    def __init__(self, cfg: Config, pts_dim: int = 1024, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = ScaleNet(cfg.model.scale_embedding, pts_dim).to(self.device).eval()

    @torch.no_grad()
    def predict(self, pts_feat: torch.Tensor, axes: torch.Tensor) -> torch.Tensor:
        """pts_feat (B, F), axes (B, 3, 3) -> box side lengths (B, 3)."""
        return self.model(pts_feat.to(self.device), axes.to(self.device))
