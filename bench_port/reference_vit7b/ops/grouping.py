# Frozen copy of genpose2_tpu_torch/ops/grouping.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Index gathers, channels-last (port of genpose2_tpu/ops/grouping.py).

``group_points`` has a deterministic backward. The gradient of a gather is a
scatter-add into the gathered rows; ``torch.gather``'s backward on CUDA adds
with atomics, in an order that changes from run to run. Here the backward is,
on CUDA, ``index_put_(accumulate=True)``, which sorts the flat indices and
sums each row's slots in that fixed order, and on the CPU ``index_add_``,
which adds the slots one after another (the CPU's ``index_put_`` accumulates
in parallel). So a training step repeats bit for bit, as the JAX package's
scatter-add does.
"""

from __future__ import annotations

import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) integer -> (B, M, C)."""
    idx = idx.long()[..., None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, idx)


class _GroupPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, idx):
        B, N, C = features.shape
        rows = torch.arange(B, device=idx.device)[:, None] * N
        flat = (idx.reshape(B, -1).long() + rows).reshape(-1)
        ctx.save_for_backward(flat)
        ctx.shape = (B, N, C)
        return features.reshape(B * N, C).index_select(0, flat).reshape(*idx.shape, C)

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        B, N, C = ctx.shape
        out = grad.new_zeros(B * N, C)
        g = grad.reshape(-1, C)
        if out.is_cuda:
            out.index_put_((flat,), g, accumulate=True)
        else:
            out.index_add_(0, flat, g)
        return out.reshape(B, N, C), None


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) integer -> (B, M, S, C)."""
    return _GroupPoints.apply(features, idx)
