"""Forward SDEs VE / VP / sub-VP (port of genpose2_tpu/diffusion/sde.py).

The drift is a vector field f(x, t): 0 for VE, -0.5 beta(t) x for VP and
sub-VP. Time arguments are float32 tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from genpose2_tpu_torch.config import SDEConfig


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

    def marginal_std(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "ve":
            return self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        if self.mode == "vp":
            return torch.sqrt(1.0 - torch.exp(2.0 * self._log_mean_coeff(t)))
        if self.mode == "subvp":
            return 1.0 - torch.exp(2.0 * self._log_mean_coeff(t))
        raise NotImplementedError(f"sde mode {self.mode!r} is not ported yet (see ROADMAP.md)")

    def marginal_mean(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Mean of p_t(x_t | x_0 = x)."""
        if self.mode == "ve":
            return x
        if self.mode in ("vp", "subvp"):
            return torch.exp(self._log_mean_coeff(t)) * x
        raise NotImplementedError(f"sde mode {self.mode!r} is not ported yet (see ROADMAP.md)")

    def diffusion_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """g(t)."""
        if self.mode == "ve":
            sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
            return sigma * math.sqrt(2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        if self.mode == "vp":
            return torch.sqrt(beta_t)
        if self.mode == "subvp":
            discount = 1.0 - torch.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t * t)
            return torch.sqrt(beta_t * discount)
        raise NotImplementedError(f"sde mode {self.mode!r} is not ported yet (see ROADMAP.md)")

    def drift(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "ve":
            return torch.zeros_like(x)
        return -0.5 * (self.beta_0 + t * (self.beta_1 - self.beta_0)) * x

    def prior_sample(self, shape, T: Optional[float] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
        """A draw from p_T; for VE, T may be lowered to start the reverse
        process early."""
        T = self.T if T is None else T
        z = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        if self.mode == "ve":
            return z * self.marginal_std(torch.tensor(T, dtype=torch.float32, device=device))
        return z


def init_sde(mode_or_cfg) -> SDE:
    """An SDE with the reference's hyperparameters."""
    cfg = mode_or_cfg if isinstance(mode_or_cfg, SDEConfig) else SDEConfig(mode=mode_or_cfg)
    if cfg.mode == "ve":
        return SDE("ve", sigma_min=cfg.sigma_min, sigma_max=cfg.sigma_max, eps=1e-5, T=1.0)
    if cfg.mode in ("vp", "subvp"):
        return SDE(cfg.mode, beta_0=cfg.beta_0, beta_1=cfg.beta_1, eps=1e-3, T=1.0)
    raise NotImplementedError(f"sde mode {cfg.mode!r} is not ported yet (see ROADMAP.md)")
