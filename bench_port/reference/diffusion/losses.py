# Frozen copy of genpose2_tpu_torch/diffusion/losses.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""The training losses (port of genpose2_tpu/diffusion/losses.py): the
denoising score-matching loss, with a distillation teacher's score as its
target when given, and the EDM denoiser loss.

The JAX package vmaps ``repeat`` independent draws; here the draws are
stacked along the batch axis and the pose net runs once over all of them
(the score net and the denoiser have no BatchNorm, so the rows do not
interact).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from bench_port.reference.diffusion.sde import SDE
from bench_port.reference.parallel.mesh import batch_rand, batch_randn


def dsm_draws(batch: int, dim: int, sde: SDE, repeat: int,
              generator: Optional[torch.Generator], device=None):
    """``repeat`` draws of t ~ U(eps, 1) (repeat, B, 1) and z ~ N(0, 1)
    (repeat, B, D) from ``generator`` (under a mesh, this rank's rows of the
    global batch's draws: the batch axis is axis 1)."""
    t = batch_rand((repeat, batch, 1), generator, device, batch_axis=1)
    t = t * (1.0 - sde.eps) + sde.eps
    z = batch_randn((repeat, batch, dim), generator, device, batch_axis=1)
    return t, z


def dsm_loss(score_fn: Callable, gt_pose: torch.Tensor, sde: SDE, t: torch.Tensor,
             z: torch.Tensor, teacher_score_fn: Optional[Callable] = None) -> torch.Tensor:
    """Weighted DSM loss over stacked draws.

    score_fn(x (R*B, D), t (R*B, 1)) -> score (R*B, D); gt_pose (B, D) the
    zero-centred ground-truth pose; t (R, B, 1) and z (R, B, D) the draws
    (``dsm_draws``, or the JAX package's, for parity). With std the marginal
    std at t: target = -z / std, or with ``teacher_score_fn`` (same
    signature) the teacher's score at the same perturbed poses and times
    (distillation); weight = std^2, and the loss is the mean over draws and
    rows of sum_d weight * (score - target)^2."""
    R, B, D = z.shape
    std = sde.marginal_std(t)
    perturbed = (sde.marginal_mean(gt_pose, t) + z * std).reshape(R * B, D)
    t_flat = t.reshape(R * B, 1)
    est = score_fn(perturbed, t_flat).reshape(R, B, D)
    if teacher_score_fn is None:
        target = -z / std
    else:
        target = teacher_score_fn(perturbed, t_flat).reshape(R, B, D)
    return torch.mean(torch.sum(std ** 2 * (est - target) ** 2, dim=-1))


def edm_draws(batch: int, dim: int, repeat: int, generator: Optional[torch.Generator],
              device=None):
    """``repeat`` draws of z ~ N(0, 1) (repeat, B, D) and u ~ U(0, 1)
    (repeat, B, 1) from ``generator``, in that order (under a mesh as
    ``dsm_draws``)."""
    z = batch_randn((repeat, batch, dim), generator, device, batch_axis=1)
    u = batch_rand((repeat, batch, 1), generator, device, batch_axis=1)
    return z, u


def edm_loss(denoiser_fn: Callable, gt_pose: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
             sigma_min: float = 0.002, sigma_max: float = 80.0) -> torch.Tensor:
    """The EDM denoiser loss over stacked draws, sigma log-uniform in
    [sigma_min, sigma_max] as the reference samples it.

    denoiser_fn(x (R*B, D), sigma (R*B, 1)) -> the denoised x; gt_pose (B, D)
    zero-centred; z (R, B, D) and u (R, B, 1) the draws (``edm_draws``, or
    the JAX package's). sigma = exp(log sigma_min + u (log sigma_max - log
    sigma_min)), and the loss is the mean over draws and rows of
    sum_d ((D(y + sigma z, sigma) - y) / sigma)^2."""
    R, B, D = z.shape
    lo = math.log(sigma_min)
    sigma = torch.exp(lo + u * (math.log(sigma_max) - lo))
    perturbed = gt_pose + z * sigma
    denoised = denoiser_fn(perturbed.reshape(R * B, D), sigma.reshape(R * B, 1))
    return torch.mean(torch.sum(((denoised.reshape(R, B, D) - gt_pose) / sigma) ** 2, dim=-1))
