# Frozen copy of genpose2_tpu_torch/training/ema.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Exponential moving average of the trainable parameters (port of
genpose2_tpu/training/ema.py): decay min(rate, (1 + n) / (10 + n)) after n
updates, in float32 as the JAX package computes it."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               num_updates: float, decay: float = 0.999) -> float:
    """One EMA step in place, e <- e - (1 - d) (e - p); returns num_updates + 1."""
    n = np.float32(num_updates)
    d = np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
    es = list(ema.values())
    diff = torch._foreach_sub(es, [params[k].detach() for k in ema])
    torch._foreach_mul_(diff, float(np.float32(1.0) - d))
    torch._foreach_sub_(es, diff)
    return float(n + np.float32(1.0))
