# Frozen copy of genpose2_tpu_torch/models/pointnet.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""The vanilla PointNet encoder with a learned input transform (port of
genpose2_tpu/models/pointnet.py; no BatchNorm, as there).

Reference layout (genpose2_tpu/training/torch_ingest.py reads it): ``stn.``
the input T-Net (``conv1``-``conv3`` 1x1 ``Conv1d``, ``fc1``-``fc3``
``Linear``), ``conv1``-``conv4`` 1x1 ``Conv1d``, and ``fstn.`` the feature
T-Net with ``feature_transform``. Channels last: (B, N, C_in) -> (B, out_dim).
"""

from __future__ import annotations

import torch
from torch import nn

from bench_port.reference_vit7b.models.layers import Conv1x1


class STNkd(nn.Module):
    """The T-Net: a (k, k) transform, the identity added to its output."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.conv1, self.conv2, self.conv3 = Conv1x1(k, 64), Conv1x1(64, 128), Conv1x1(128, 1024)
        self.fc1, self.fc2, self.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), \
            nn.Linear(256, k * k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, N, k) -> (B, k, k)
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        h = torch.relu(self.conv3(h)).amax(dim=1)
        h = torch.relu(self.fc1(h))
        h = torch.relu(self.fc2(h))
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, self.k * self.k)
        return (self.fc3(h) + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """The input T-Net's transform, then the 64-128-512-out_dim point MLP
    (with ``feature_transform`` the feature T-Net after the first layer) and a
    max over the points. ``global_feat=False`` returns each point's 64-wide
    feature after the pooled one, (B, N, out_dim + 64)."""

    def __init__(self, out_dim: int = 1024, in_dim: int = 3, feature_transform: bool = False,
                 global_feat: bool = True):
        super().__init__()
        self.global_feat = global_feat
        self.stn = STNkd(in_dim)
        self.conv1, self.conv2 = Conv1x1(in_dim, 64), Conv1x1(64, 128)
        self.conv3, self.conv4 = Conv1x1(128, 512), Conv1x1(512, out_dim)
        self.fstn = STNkd(64) if feature_transform else None
        self.out_channels = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = torch.einsum("bnk,bkj->bnj", x, self.stn(x))
        x = torch.relu(self.conv1(x))
        if self.fstn is not None:
            x = torch.einsum("bnk,bkj->bnj", x, self.fstn(x))
        point_feat = x
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x))
        g = self.conv4(x).amax(dim=1)
        if self.global_feat:
            return g
        return torch.cat([g[:, None].expand(-1, x.shape[1], -1), point_feat], dim=-1)
