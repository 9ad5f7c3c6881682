"""Pose jitter for the tracker's first frame (port of genpose2_tpu/so3/noise.py):
a rotation about a random axis by a truncated-normal angle, and an
elementwise truncated-normal translation offset. Both truncate at 2 sigma.

Draws come from a ``torch.Generator``, or are passed in (``axis``,
``angle_z``, ``t_z``: the standard normal axis and the unit truncated-normal
draws before scaling), which is how tests hand over the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from genpose2_tpu_torch.so3.rotations import axis_angle_to_matrix

TRUNCATE = 2.0  # sigmas


def truncated_normal(shape, generator: Optional[torch.Generator] = None, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], by the inverse CDF of a
    uniform draw between the bounds' CDF values."""
    lo = 0.5 * (1 + math.erf(-TRUNCATE / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(TRUNCATE / math.sqrt(2)))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    z = math.sqrt(2) * torch.special.erfinv(2 * (lo + u * (hi - lo)) - 1)
    return z.clamp(-TRUNCATE, TRUNCATE).to(dtype)


def add_noise_to_R(R: torch.Tensor, r_deg: float = 5.0,
                   generator: Optional[torch.Generator] = None,
                   axis: Optional[torch.Tensor] = None,
                   angle_z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotations (..., 3, 3) turned about a random axis by r_deg * z degrees,
    z truncated-normal; the turn is applied on the left."""
    batch = R.shape[:-2]
    if axis is None:
        axis = torch.randn(batch + (3,), generator=generator, device=R.device, dtype=R.dtype)
    if angle_z is None:
        angle_z = truncated_normal(batch, generator, R.device, R.dtype)
    angle = torch.deg2rad(r_deg * angle_z.to(R))
    return axis_angle_to_matrix(axis.to(R), angle) @ R


def add_noise_to_RT(R: torch.Tensor, t: torch.Tensor, r_deg: float = 5.0, t_std: float = 0.03,
                    generator: Optional[torch.Generator] = None,
                    axis: Optional[torch.Tensor] = None,
                    angle_z: Optional[torch.Tensor] = None,
                    t_z: Optional[torch.Tensor] = None):
    """(R, t) with the rotation jitter of ``add_noise_to_R`` and t + t_std * z,
    z truncated-normal per element."""
    R_noisy = add_noise_to_R(R, r_deg, generator, axis, angle_z)
    if t_z is None:
        t_z = truncated_normal(t.shape, generator, t.device, t.dtype)
    return R_noisy, t + t_std * t_z.to(t)
