# Frozen copy of genpose2_tpu_torch/models/scalenet.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Bounding-box side lengths from the score encoder's feature and the rotation
axes (port of genpose2_tpu/models/scalenet.py). State dict layout
(reference): ``axes_encoder.{0,2}``, ``fusion_tail_length.{0,2}``."""

from __future__ import annotations

import torch
from torch import nn

from bench_port.reference_vit7b.models.layers import MLP
from bench_port.reference_vit7b.so3.rotations import encode_axes


class ScaleNet(nn.Module):
    def __init__(self, embedding_dim: int = 180, pts_dim: int = 1024):
        super().__init__()
        if embedding_dim % 18:
            raise ValueError("embedding_dim must be divisible by 18")
        self.embedding_dim = embedding_dim
        self.axes_encoder = MLP(embedding_dim, (256, 256), final_act=True)
        self.fusion_tail_length = MLP(pts_dim + 256, (256, 3), zero_final=True)

    def forward(self, pts_feat, axes):
        """pts_feat (B, F), axes (B, 3, 3) -> lengths (B, 3)."""
        axes_feat = self.axes_encoder(encode_axes(axes, self.embedding_dim // 18))
        return self.fusion_tail_length(torch.cat([pts_feat, axes_feat], dim=-1))


def scale_loss(pred_len: torch.Tensor, gt_len: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the side lengths, times 1e4 (port of
    genpose2_tpu/models/scalenet.py:scale_loss)."""
    return torch.mean((pred_len - gt_len) ** 2) * 10000.0
