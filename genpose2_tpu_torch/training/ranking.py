"""Energy ranking of candidates (port of genpose2_tpu/training/ranking.py:
sort_poses_by_energy)."""

from __future__ import annotations

import torch


def sort_poses_by_energy(poses: torch.Tensor, energy: torch.Tensor):
    """Candidates from highest to lowest energy, decoupled: the rotation part
    follows the rotation energy, the translation part the translation energy.
    The sort is stable, as ``jnp.argsort``: equal energies keep their order.

    poses (B, K, D), energy (B, K, 2) -> (sorted_poses, sorted_energy)."""
    order = torch.argsort(-energy, dim=1, stable=True)
    sorted_energy = torch.gather(energy, 1, order)
    D = poses.shape[-1]
    rot = torch.gather(poses, 1, order[..., 0:1].expand(-1, -1, D))
    trans = torch.gather(poses[..., -3:], 1, order[..., 1:2].expand(-1, -1, 3))
    return torch.cat([rot[..., :-3], trans], dim=-1), sorted_energy
