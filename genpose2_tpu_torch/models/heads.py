"""Per-point-feature regression heads (port of genpose2_tpu/models/heads.py;
the reference's ``per_point_feat`` path, off by default).

Reference layout: 1x1 ``Conv1d`` layers ``conv1``, ``conv2`` over the points,
a max over the points, then ``conv3``, ``conv4`` on the pooled feature.
Channels last here: (B, N, C) -> (B, out_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from genpose2_tpu_torch.models.layers import Conv1x1


class RotHead(nn.Module):
    """The rotation head (reference: rot_head.py:7-35): conv1, conv2 (ReLU
    each) per point, max over the points, conv3 (ReLU), conv4 -> out_dim."""

    def __init__(self, in_dim: int, out_dim: int = 3):
        super().__init__()
        self.conv1, self.conv2 = Conv1x1(in_dim, 256), Conv1x1(256, 256)
        self.conv3, self.conv4 = Conv1x1(256, 256), Conv1x1(256, out_dim)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(feat.float()))
        x = torch.relu(self.conv2(x)).amax(dim=1)
        return self.conv4(torch.relu(self.conv3(x)))


class TransHead(RotHead):
    """The translation head (reference: trans_head.py:9-40): RotHead's
    layers, weights of its own."""
