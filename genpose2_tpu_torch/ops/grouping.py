"""Index gathers, channels-last (port of genpose2_tpu/ops/grouping.py)."""

from __future__ import annotations

import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) integer -> (B, M, C)."""
    idx = idx.long()[..., None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, idx)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) integer -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather_points(features, idx.reshape(B, M * S)).reshape(B, M, S, features.shape[-1])
