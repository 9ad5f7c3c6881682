# Frozen copy of genpose2_tpu_torch/ops/interpolate.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Three-nearest-neighbour feature interpolation, the feature-propagation
path (port of genpose2_tpu/ops/interpolate.py).

The JAX package computes both in plain array ops, outside any kernel, and so
does the port.
"""

from __future__ import annotations

import torch

from bench_port.reference.ops.grouping import group_points


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, N, 3), known (B, M >= 3, 3) -> (dist (B, N, 3) euclidean,
    idx (B, N, 3) int32), nearest first.

    The squared distances are the JAX package's (squared differences summed
    x, y, z in that order), and a stable sort keeps the lower index first
    among equal distances, as ``lax.top_k`` does."""
    d = unknown.float()[:, :, None, :] - known.float()[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    d2_sorted, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(d2_sorted[..., :3], min=0.0)), idx[..., :3].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C): the
    weighted sum of each point's three gathered rows. Differentiable in
    ``features`` and ``weight``; the gather's backward is ``group_points``'s
    deterministic scatter-add."""
    gathered = group_points(features, idx)  # (B, N, 3, C)
    return torch.sum(gathered * weight[..., None], dim=2)
