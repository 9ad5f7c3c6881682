"""Denoising score-matching loss (port of genpose2_tpu/diffusion/losses.py:
dsm_loss, without the distillation teacher).

The JAX package vmaps ``repeat`` independent (t, z) draws; here the draws are
stacked along the batch axis and the score net runs once over all of them
(the score net has no BatchNorm, so the rows do not interact).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from genpose2_tpu_torch.diffusion.sde import SDE


def dsm_draws(batch: int, dim: int, sde: SDE, repeat: int,
              generator: Optional[torch.Generator], device=None):
    """``repeat`` draws of t ~ U(eps, 1) (repeat, B, 1) and z ~ N(0, 1)
    (repeat, B, D) from ``generator``."""
    t = torch.rand((repeat, batch, 1), generator=generator, device=device)
    t = t * (1.0 - sde.eps) + sde.eps
    z = torch.randn((repeat, batch, dim), generator=generator, device=device)
    return t, z


def dsm_loss(score_fn: Callable, gt_pose: torch.Tensor, sde: SDE, t: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """Weighted DSM loss over stacked draws.

    score_fn(x (R*B, D), t (R*B, 1)) -> score (R*B, D); gt_pose (B, D) the
    zero-centred ground-truth pose; t (R, B, 1) and z (R, B, D) the draws
    (``dsm_draws``, or the JAX package's, for parity). With std the marginal
    std at t: target = -z / std, weight = std^2, and the loss is the mean over
    draws and rows of sum_d weight * (score - target)^2."""
    R, B, D = z.shape
    std = sde.marginal_std(t)
    perturbed = sde.marginal_mean(gt_pose, t) + z * std
    est = score_fn(perturbed.reshape(R * B, D), t.reshape(R * B, 1)).reshape(R, B, D)
    return torch.mean(torch.sum(std ** 2 * (est + z / std) ** 2, dim=-1))
