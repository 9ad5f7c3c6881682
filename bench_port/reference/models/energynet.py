# Frozen copy of genpose2_tpu_torch/models/energynet.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Pose energy network (port of genpose2_tpu/models/energynet.py): the score
net's trunk with the head output turned into an energy. Its gradient with
respect to the pose is the energy agent's score, for training
(``GFObjectPose.energy_score``) and for sampling (``PoseAgent.score_fn``)."""

from __future__ import annotations

import torch

from bench_port.reference.models.scorenet import _PoseTrunk


class PoseEnergyNet(_PoseTrunk):
    def __init__(self, marginal_std_fn, pose_dim: int = 9, regression_head: str = "Rx_Ry_and_T",
                 pts_dim: int = 1024, energy_mode: str = "IP", s_theta_mode: str = "score",
                 norm_energy: str = "identical", rgb_dim: int = 0):
        super().__init__(marginal_std_fn, pose_dim, regression_head, pts_dim, rgb_dim)
        self.energy_mode, self.s_theta_mode, self.norm_energy = energy_mode, s_theta_mode, norm_energy

    def forward(self, pts_feat, sampled_pose, t, decoupled_rt: bool = True, rgb_feat=None):
        """Energy (B, 2) [rot, trans] when decoupled, else (B,); rgb_feat
        (B, rgb_dim) with dino='global'."""
        f_theta = self.raw_heads(pts_feat, sampled_pose, t, rgb_feat)
        std = self.marginal_std_fn(t)
        if self.s_theta_mode == "score":
            s_theta = f_theta / std
        elif self.s_theta_mode == "decoder":
            s_theta = sampled_pose - std * f_theta
        elif self.s_theta_mode == "identical":
            s_theta = f_theta
        else:
            raise NotImplementedError(self.s_theta_mode)

        if self.energy_mode == "DAE":
            energy = -0.5 * torch.sum((sampled_pose - s_theta) ** 2, dim=-1)
        elif self.energy_mode == "L2":
            energy = -0.5 * torch.sum(s_theta ** 2, dim=-1)
        elif self.energy_mode == "IP":
            if decoupled_rt:
                e_rot = torch.sum(sampled_pose[:, :-3] * s_theta[:, :-3], dim=-1)
                e_trans = torch.sum(sampled_pose[:, -3:] * s_theta[:, -3:], dim=-1)
                energy = torch.stack([e_rot, e_trans], dim=-1)
            else:
                energy = torch.sum(sampled_pose * s_theta, dim=-1)
        else:
            raise NotImplementedError(self.energy_mode)

        if self.norm_energy == "std":
            energy = energy / ((std[:, 0] if energy.ndim == 1 else std) + 1e-7)
        elif self.norm_energy == "minus":
            energy = -energy
        elif self.norm_energy != "identical":
            raise NotImplementedError(self.norm_energy)
        return energy
