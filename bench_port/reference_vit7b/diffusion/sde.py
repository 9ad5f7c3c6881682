# Frozen copy of genpose2_tpu_torch/diffusion/sde.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Forward SDEs VE / VP / sub-VP / EDM (port of genpose2_tpu/diffusion/sde.py).

The drift is a vector field f(x, t): 0 for VE and EDM, -0.5 beta(t) x for VP
and sub-VP. Time arguments are float32 tensors. For EDM, t is the noise level
sigma itself: std(t) = t, g(t) = sqrt(2 t).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from bench_port.reference_vit7b.config import SDEConfig
from bench_port.reference_vit7b.parallel.mesh import batch_randn


def _unknown(mode):
    return NotImplementedError(f"sde mode {mode!r}")


@dataclass(frozen=True)
class SDE:
    mode: str
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    beta_0: float = 0.1
    beta_1: float = 20.0
    eps: float = 1e-5
    T: float = 1.0

    def _log_mean_coeff(self, t):
        return -0.25 * t * t * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_prob(self, x: Optional[torch.Tensor], t: torch.Tensor):
        """Mean (None when x is None) and std of p_t(x_t | x_0 = x)."""
        return (None if x is None else self.marginal_mean(x, t)), self.marginal_std(t)

    def marginal_std(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "ve":
            return self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        if self.mode == "vp":
            return torch.sqrt(1.0 - torch.exp(2.0 * self._log_mean_coeff(t)))
        if self.mode == "subvp":
            return 1.0 - torch.exp(2.0 * self._log_mean_coeff(t))
        if self.mode == "edm":
            return t
        raise _unknown(self.mode)

    def marginal_mean(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Mean of p_t(x_t | x_0 = x)."""
        if self.mode in ("ve", "edm"):
            return x
        if self.mode in ("vp", "subvp"):
            return torch.exp(self._log_mean_coeff(t)) * x
        raise _unknown(self.mode)

    def diffusion_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """g(t)."""
        if self.mode == "ve":
            sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
            return sigma * math.sqrt(2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        if self.mode == "edm":
            return torch.sqrt(2.0 * t)
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        if self.mode == "vp":
            return torch.sqrt(beta_t)
        if self.mode == "subvp":
            discount = 1.0 - torch.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t * t)
            return torch.sqrt(beta_t * discount)
        raise _unknown(self.mode)

    def drift(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.mode in ("ve", "edm"):
            return torch.zeros_like(x)
        if self.mode in ("vp", "subvp"):
            return -0.5 * (self.beta_0 + t * (self.beta_1 - self.beta_0)) * x
        raise _unknown(self.mode)

    def prior_sample(self, shape, T: Optional[float] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
        """A draw from p_T; for VE, T may be lowered to start the reverse
        process early. EDM scales N(0, 1) by sigma_max whatever T is. Under a
        mesh (a data-parallel step's ranking candidates) the leading axis is
        the batch's: this rank's rows of the global draw."""
        T = self.T if T is None else T
        z = batch_randn(shape, generator, device, dtype=torch.float32)
        if self.mode == "ve":
            return z * self.marginal_std(torch.tensor(T, dtype=torch.float32, device=device))
        if self.mode in ("vp", "subvp"):
            return z
        if self.mode == "edm":
            return z * self.sigma_max
        raise _unknown(self.mode)

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """log N(z; 0, sigma^2 I) summed over the last axis, sigma =
        sigma_max for VE (not the std at T) and ``edm_like_sigma()`` for
        EDM; standard normal for VP and sub-VP."""
        n = z.shape[-1]
        if self.mode in ("ve", "edm"):
            sigma = self.sigma_max if self.mode == "ve" else self.edm_like_sigma()
            return (-n / 2.0 * math.log(2 * math.pi * sigma ** 2)
                    - torch.sum(z * z, dim=-1) / (2 * sigma ** 2))
        return -n / 2.0 * math.log(2 * math.pi) - torch.sum(z * z, dim=-1) / 2.0

    def edm_like_sigma(self) -> float:
        return self.sigma_max


def init_sde(mode_or_cfg) -> SDE:
    """An SDE with the reference's hyperparameters."""
    cfg = mode_or_cfg if isinstance(mode_or_cfg, SDEConfig) else SDEConfig(mode=mode_or_cfg)
    if cfg.mode == "ve":
        return SDE("ve", sigma_min=cfg.sigma_min, sigma_max=cfg.sigma_max, eps=1e-5, T=1.0)
    if cfg.mode in ("vp", "subvp"):
        return SDE(cfg.mode, beta_0=cfg.beta_0, beta_1=cfg.beta_1, eps=1e-3, T=1.0)
    if cfg.mode == "edm":
        return SDE("edm", sigma_min=cfg.edm_sigma_min, sigma_max=cfg.edm_sigma_max,
                   eps=cfg.edm_sigma_min, T=cfg.edm_sigma_max)
    raise _unknown(cfg.mode)
