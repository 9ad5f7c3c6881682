"""Conditional pose score network (port of genpose2_tpu/models/scorenet.py).

State dict layout (reference): ``t_encoder.0.W`` (Fourier weights),
``t_encoder.1`` (Linear), ``pose_encoder.{0,2}``, and the heads
``fusion_tail_rot_x`` / ``fusion_tail_rot_y`` / ``fusion_tail_trans``
(``Rx_Ry_and_T``), ``fusion_tail_rot`` / ``fusion_tail_trans`` (``R_and_T``)
or ``fusion_tail`` (``RT``), each ``.{0,2}``. All output layers start at zero.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from genpose2_tpu_torch.models.layers import MLP, GaussianFourierProjection

HEADS = {
    "RT": (("fusion_tail", None),),
    "R_and_T": (("fusion_tail_rot", -3), ("fusion_tail_trans", 3)),
    "Rx_Ry_and_T": (("fusion_tail_rot_x", 3), ("fusion_tail_rot_y", 3), ("fusion_tail_trans", 3)),
}


class _PoseTrunk(nn.Module):
    """t encoder + pose encoder + regression heads, shared by the score and
    the energy nets."""

    def __init__(self, marginal_std_fn: Callable, pose_dim: int = 9,
                 regression_head: str = "Rx_Ry_and_T", pts_dim: int = 1024):
        super().__init__()
        if regression_head not in HEADS:
            raise NotImplementedError(regression_head)
        self.marginal_std_fn = marginal_std_fn
        self.pose_dim, self.regression_head = pose_dim, regression_head
        self.t_encoder = nn.Sequential(GaussianFourierProjection(128), nn.Linear(128, 128),
                                       nn.ReLU())
        self.pose_encoder = MLP(pose_dim, (256, 256), final_act=True)
        total = pts_dim + 128 + 256
        hidden = 512 if regression_head == "RT" else 256
        for name, out in HEADS[regression_head]:
            out = pose_dim if out is None else (pose_dim + out if out < 0 else out)
            self.add_module(name, MLP(total, (hidden, out), zero_final=True))

    def head_names(self):
        return [name for name, _ in HEADS[self.regression_head]]

    def raw_heads(self, pts_feat, sampled_pose, t):
        total_feat = torch.cat([pts_feat, self.t_encoder(t[:, 0]),
                                self.pose_encoder(sampled_pose)], dim=-1)
        return torch.cat([getattr(self, n)(total_feat) for n in self.head_names()], dim=-1)


class PoseScoreNet(_PoseTrunk):
    def forward(self, pts_feat, sampled_pose, t):
        """pts_feat (B, F), sampled_pose (B, D), t (B, 1) -> score (B, D)."""
        out = self.raw_heads(pts_feat, sampled_pose, t)
        return out / (self.marginal_std_fn(t) + 1e-7)


def fast_score_weights(net: _PoseTrunk, pts_feat: torch.Tensor) -> dict:
    """Fold a score net into the layout of the fast score function
    (ops/ode_rk4.py:fast_score) and the fused RK4 kernel: heads' first
    layers side by side, second layers block diagonal, and the loop-invariant
    pts part of the first layer precomputed into ``static`` (R, H1). Weights
    are (in, out), as the JAX package keeps them."""
    heads = [getattr(net, n) for n in net.head_names()]
    W1 = torch.cat([h[0].weight.t() for h in heads], dim=1)
    b1 = torch.cat([h[0].bias for h in heads])
    W2bd = torch.block_diag(*[h[2].weight.t() for h in heads])
    b2cat = torch.cat([h[2].bias for h in heads])
    F = pts_feat.shape[-1]
    dyn_dim = 128 + 256
    static = pts_feat @ W1[:F] + b1
    W1_dyn = W1[F:F + dyn_dim]
    lin = net.t_encoder[1]
    pe = net.pose_encoder
    return {
        "fourier_W": net.t_encoder[0].W,
        "t_dense": {"kernel": lin.weight.t(), "bias": lin.bias},
        "pose_mlp": {
            "Dense_0": {"kernel": pe[0].weight.t(), "bias": pe[0].bias},
            "Dense_1": {"kernel": pe[2].weight.t(), "bias": pe[2].bias},
        },
        "static": static,
        "W1_dyn": W1_dyn,
        "W1_t": W1_dyn[:128],
        "W1_pose": W1_dyn[128:],
        "W2bd": W2bd,
        "b2cat": b2cat,
    }
