"""Probability-flow ODE sampler, method 'fixed' (port of
genpose2_tpu/diffusion/samplers.py:ode_sampler).

With ``fused_weights`` the whole integration is one kernel launch
(ops/ode_rk4.py:fused_rk4_integrate); without, it is the per-step RK4 loop
over ``score_fn``. Then the optional denoise step at eps, the Gram-Schmidt
renormalisation of the rotation and the re-added point-cloud center.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from genpose2_tpu_torch.diffusion.sde import SDE
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate, pf_ode_rhs, rk4_fixed_grid
from genpose2_tpu_torch.so3.rotations import normalize_rotation


def ode_sampler(
    score_fn: Callable,
    sde: SDE,
    batch_size: int,
    pose_dim: int,
    *,
    T0: Optional[float] = None,
    init_x: Optional[torch.Tensor] = None,
    num_steps: int = 500,
    denoise: bool = True,
    pose_mode: str = "rot_matrix",
    pts_center: Optional[torch.Tensor] = None,
    method: str = "fixed",
    fused_weights: Optional[dict] = None,
    compute_dtype: str = "float32",
    prior: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Integrate the reverse probability-flow ODE from T0 to sde.eps.

    ``prior`` (batch_size, pose_dim) is the start noise; when None it is drawn
    from ``sde.prior_sample`` with ``generator``. A given ``init_x`` (tracking
    warm start) has the prior noise added to it. Returns (poses, num_steps)."""
    if method != "fixed":
        raise NotImplementedError(f"sampler method {method!r} is not ported yet (see ROADMAP.md)")
    T0 = sde.T if T0 is None else T0
    if prior is None:
        prior = sde.prior_sample((batch_size, pose_dim), T=T0, generator=generator, device=device)
    x0 = prior if init_x is None else init_x + prior

    if fused_weights is not None:
        x = fused_rk4_integrate(x0, fused_weights, sde, T0, num_steps, compute_dtype)
    else:
        x = rk4_fixed_grid(lambda t, y: pf_ode_rhs(score_fn, sde, t, y), x0, T0, sde.eps,
                           num_steps)

    if denoise:
        eps = torch.tensor(sde.eps, dtype=torch.float32, device=x.device)
        t_vec = eps.reshape(1, 1).expand(batch_size, 1)
        g = sde.diffusion_coeff(eps)
        drift = sde.drift(x, eps) - (g * g) * score_fn(x, t_vec)
        x = x + drift * ((1.0 - sde.eps) / num_steps)

    rot = normalize_rotation(x[..., :-3], pose_mode)
    trans = x[..., -3:]
    if pts_center is not None:
        trans = trans + pts_center
    return torch.cat([rot, trans], dim=-1), num_steps
