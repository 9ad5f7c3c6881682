# Frozen copy of genpose2_tpu_torch/models/scorenet.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Conditional pose score network (port of genpose2_tpu/models/scorenet.py).

State dict layout (reference): ``t_encoder.0.W`` (Fourier weights),
``t_encoder.1`` (Linear), ``pose_encoder.{0,2}``, and the heads
``fusion_tail_rot_x`` / ``fusion_tail_rot_y`` / ``fusion_tail_trans``
(``Rx_Ry_and_T``), ``fusion_tail_rot`` / ``fusion_tail_trans`` (``R_and_T``)
or ``fusion_tail`` (``RT``), each ``.{0,2}``. All output layers start at zero.
With dino='global' the heads' first layers take ``rgb_dim`` more inputs, the
global rgb feature, after [pts, t, pose] (the JAX package's concat order).

``PoseDecoderNet`` (the score agent's net with sde mode 'edm') keeps the
score net's entry names: its noise embedding's Linear is ``t_encoder.1``,
the pose encoder and the heads as above.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from bench_port.reference.models.layers import MLP, GaussianFourierProjection

HEADS = {
    "RT": (("fusion_tail", None),),
    "R_and_T": (("fusion_tail_rot", -3), ("fusion_tail_trans", 3)),
    "Rx_Ry_and_T": (("fusion_tail_rot_x", 3), ("fusion_tail_rot_y", 3), ("fusion_tail_trans", 3)),
}


class _PoseTrunk(nn.Module):
    """t encoder + pose encoder + regression heads, shared by the score and
    the energy nets."""

    def __init__(self, marginal_std_fn: Callable, pose_dim: int = 9,
                 regression_head: str = "Rx_Ry_and_T", pts_dim: int = 1024, rgb_dim: int = 0):
        super().__init__()
        if regression_head not in HEADS:
            raise NotImplementedError(regression_head)
        self.marginal_std_fn = marginal_std_fn
        self.pose_dim, self.regression_head, self.rgb_dim = pose_dim, regression_head, rgb_dim
        self.t_encoder = nn.Sequential(GaussianFourierProjection(128), nn.Linear(128, 128),
                                       nn.ReLU())
        self.pose_encoder = MLP(pose_dim, (256, 256), final_act=True)
        total = pts_dim + 128 + 256 + rgb_dim
        hidden = 512 if regression_head == "RT" else 256
        for name, out in HEADS[regression_head]:
            out = pose_dim if out is None else (pose_dim + out if out < 0 else out)
            self.add_module(name, MLP(total, (hidden, out), zero_final=True))

    def head_names(self):
        return [name for name, _ in HEADS[self.regression_head]]

    def raw_heads(self, pts_feat, sampled_pose, t, rgb_feat=None):
        parts = [pts_feat, self.t_encoder(t[:, 0]), self.pose_encoder(sampled_pose)]
        if self.rgb_dim:
            parts.append(rgb_feat)
        total_feat = torch.cat(parts, dim=-1)
        return torch.cat([getattr(self, n)(total_feat) for n in self.head_names()], dim=-1)


class PoseScoreNet(_PoseTrunk):
    def forward(self, pts_feat, sampled_pose, t, rgb_feat=None):
        """pts_feat (B, F), sampled_pose (B, D), t (B, 1) (rgb_feat (B,
        rgb_dim) with dino='global') -> score (B, D)."""
        out = self.raw_heads(pts_feat, sampled_pose, t, rgb_feat)
        return out / (self.marginal_std_fn(t) + 1e-7)


class NoiseEmbedding(nn.Module):
    """Fixed embedding [cos(c f), sin(c f)] of a noise level c (B,), with
    frequencies f_i = (1 / 10000) ** (i / half), i < half."""

    def __init__(self, num_channels: int = 128):
        super().__init__()
        half = num_channels // 2
        freqs = (1.0 / 10000.0) ** (torch.arange(half, dtype=torch.float32) / half)
        self.register_buffer("freqs", freqs, persistent=False)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        emb = c.reshape(-1, 1) * self.freqs[None, :]
        return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class PoseDecoderNet(_PoseTrunk):
    """The EDM-preconditioned denoiser (port of
    genpose2_tpu/models/scorenet.py:PoseDecoderNet), VE preconditioning:
    c_skip 1, c_out sigma, c_in 1, c_noise log(sigma / 2). The noise level's
    128-channel cos/sin embedding goes through a Linear and a ReLU in place
    of the score net's t encoder; the heads take [pts, noise, pose]. Heads
    'RT' and 'Rx_Ry_and_T' only, as in the JAX package."""

    def __init__(self, marginal_std_fn: Callable, pose_dim: int = 9,
                 regression_head: str = "Rx_Ry_and_T", pts_dim: int = 1024):
        if regression_head not in ("RT", "Rx_Ry_and_T"):
            raise NotImplementedError(regression_head)
        super().__init__(marginal_std_fn, pose_dim, regression_head, pts_dim)
        self.t_encoder = nn.Sequential(NoiseEmbedding(128), nn.Linear(128, 128), nn.ReLU())

    def forward(self, pts_feat, sampled_pose, sigma, rgb_feat=None):
        """pts_feat (B, F), sampled_pose (B, D), sigma (B, 1) -> the denoised
        pose D(x; sigma) (B, D). ``rgb_feat`` is taken and not used, as in
        the JAX package."""
        sigma_t = self.marginal_std_fn(sigma)
        out = self.raw_heads(pts_feat, sampled_pose, torch.log(sigma_t / 2.0))
        return sampled_pose + sigma_t * out


def fast_score_weights(net: _PoseTrunk, pts_feat: torch.Tensor,
                       rgb_feat: Optional[torch.Tensor] = None) -> dict:
    """Fold a score net into the layout of the fast score function
    (ops/ode_rk4.py:fast_score) and the fused RK4 kernel: heads' first
    layers side by side, second layers block diagonal, and the loop-invariant
    pts (and, with dino='global', rgb) part of the first layer precomputed
    into ``static`` (R, H1). Weights are (in, out), as the JAX package keeps
    them."""
    heads = [getattr(net, n) for n in net.head_names()]
    W1 = torch.cat([h[0].weight.t() for h in heads], dim=1)
    b1 = torch.cat([h[0].bias for h in heads])
    W2bd = torch.block_diag(*[h[2].weight.t() for h in heads])
    b2cat = torch.cat([h[2].bias for h in heads])
    F = pts_feat.shape[-1]
    dyn_dim = 128 + 256
    static = pts_feat @ W1[:F]
    if rgb_feat is not None:
        static = static + rgb_feat @ W1[F + dyn_dim:]
    static = static + b1
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
