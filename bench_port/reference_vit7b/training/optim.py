# Frozen copy of genpose2_tpu_torch/training/optim.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""The learning-rate schedule and the optimizer of the JAX package's agents
(genpose2_tpu/training/agent.py:59-70,100-105), reproduced on torch tensors.

The optimizer is ``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` or
``... sgd(lr, momentum=0.9)``:

- clip: when the global norm of the gradients is at least ``max_norm``,
  each gradient becomes g / norm * max_norm (optax's form; no epsilon);
- adam: mu = 0.9 mu + 0.1 g, nu = 0.999 nu + 0.001 g^2, then
  (mu / (1 - 0.9^n)) / (sqrt(nu / (1 - 0.999^n)) + 1e-8) after n updates;
- sgd: trace = g + 0.9 trace;
- the step is -lr(count) times that, with ``count`` the optimizer's own
  update count (as optax's scale_by_schedule keeps it).

Scalars (the schedule, the bias corrections) are float32 on the host, as the
JAX package computes them; the tensors are updated in place with the
multi-tensor ``torch._foreach_*`` ops.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port.reference_vit7b.config import Config

_F = np.float32


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup over cfg.train.warmup steps, then per-epoch exponential
    decay with a floor: step -> learning rate."""
    t = cfg.train

    def schedule(step: int) -> float:
        warm = np.minimum(_F(1.0), (_F(step) + _F(1.0)) / _F(max(t.warmup, 1)))
        epoch = step // max(steps_per_epoch, 1)
        decayed = np.maximum(_F(t.lr) * _F(t.lr_decay) ** _F(epoch), _F(t.lr_floor))
        return float(_F(warm * decayed))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, as a 0-d float32 tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class ClippedOptimizer:
    """clip_by_global_norm(max_norm) then adam or sgd(momentum=0.9)."""

    def __init__(self, kind: str, schedule: Callable[[int], float], max_norm: float):
        if kind not in ("adam", "sgd"):
            raise NotImplementedError(f"optimizer {kind!r}")
        self.kind, self.schedule, self.max_norm = kind, schedule, max_norm

    def init(self, params: List[torch.Tensor]) -> Dict:
        zeros = [torch.zeros_like(p) for p in params]
        if self.kind == "adam":
            return {"count": 0, "mu": zeros, "nu": [torch.zeros_like(p) for p in params]}
        return {"count": 0, "trace": zeros}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
             norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` and ``state`` in place. ``norm`` is the
        gradients' global norm when the caller has it already."""
        norm = global_norm(grads) if norm is None else norm
        clip = norm >= self.max_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        g = torch._foreach_div(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(g, torch.where(clip, one * self.max_norm, one))
        lr = self.schedule(state["count"])
        state["count"] += 1
        n = state["count"]
        if self.kind == "adam":
            b1, b2 = _F(0.9), _F(0.999)
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, float(b1))
            torch._foreach_add_(mu, torch._foreach_mul(g, float(_F(1.0) - b1)))
            torch._foreach_mul_(nu, float(b2))
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                       float(_F(1.0) - b2)))
            mu_hat = torch._foreach_div(mu, float(_F(1.0) - b1 ** _F(n)))
            nu_hat = torch._foreach_div(nu, float(_F(1.0) - b2 ** _F(n)))
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, 1e-8)
            update = torch._foreach_div(mu_hat, nu_hat)
        else:
            trace = state["trace"]
            torch._foreach_mul_(trace, 0.9)
            torch._foreach_add_(trace, g)
            update = trace
        torch._foreach_add_(params, torch._foreach_mul(update, -lr))
