# Frozen copy of genpose2_tpu_torch/training/ranking.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Energy ranking of candidates (port of genpose2_tpu/training/ranking.py):
the serving path's ``sort_poses_by_energy`` and the energy net's ranking
loss over candidates sorted by their ground-truth error."""

from __future__ import annotations

import torch


def sort_results(energy: torch.Tensor, metrics: torch.Tensor) -> torch.Tensor:
    """Energies reordered so that index 0 is the candidate with the lowest
    error: rotation energies by rotation error, translation energies by
    translation error (stable, as ``jnp.argsort``).

    energy, metrics (B, K, 2) -> (B, K, 2)."""
    order = torch.argsort(metrics, dim=1, stable=True)
    return torch.gather(energy, 1, order)


def ranking_loss(energy: torch.Tensor) -> torch.Tensor:
    """Pairwise normalised-margin loss over candidates sorted best first: for
    each pair i < j, 1 + (E_j - E_i) / (|E_i - E_j| + 1e-5), averaged over
    objects, pairs and the two energies. energy (B, K, 2) -> scalar."""
    K = energy.shape[1]
    Ei = energy[:, :, None, :]
    Ej = energy[:, None, :, :]
    diff = 1.0 + (Ej - Ei) / (torch.abs(Ei - Ej) + 1e-5)
    iu, ju = torch.triu_indices(K, K, offset=1, device=energy.device)
    return torch.mean(diff[:, iu, ju, :])


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
