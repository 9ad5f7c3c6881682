# Frozen copy of genpose2_tpu_torch/models/layers.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Shared building blocks (port of genpose2_tpu/models/layers.py).

The modules keep the reference torch ``state_dict`` layout (the one
genpose2_tpu/training/torch_ingest.py reads), so published checkpoints load
with no conversion: ``nn.Linear`` weights are (out, in), an MLP is an
``nn.Sequential`` of Linear and ReLU, and a SharedMLP layer is
``layer{i}.conv`` (a bias-free 1x1 conv, weight (out, in, 1, 1)) plus
``layer{i}.bn.bn`` (BatchNorm2d).

The module (training) forwards follow flax semantics, not torch's:
``batch_norm`` normalises with the biased batch variance E[x^2] - E[x]^2 and
moves the running statistics as 0.9 * old + 0.1 * batch with that biased
variance (``nn.BatchNorm2d`` uses the unbiased one for its running update),
and ``dropout`` draws its mask from an explicit ``torch.Generator``, so a
step can be replayed from a seed. Under a data-parallel mesh
(``parallel/mesh.py:use_mesh``) ``batch_norm`` takes the global batch's
statistics and ``dropout`` draws at the global batch's shape, so that the
ranks together reproduce one process on the whole batch.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference_vit7b.parallel.mesh import active_mesh, batch_rand


def MLP(in_dim: int, features: Sequence[int], final_act: bool = False,
        zero_final: bool = False) -> nn.Sequential:
    """Linear layers with ReLU between them (and after the last with
    ``final_act``); ``zero_final`` zero-initialises the last layer, as the
    reference does for every score head."""
    mods = []
    for i, f in enumerate(features):
        last = i == len(features) - 1
        lin = nn.Linear(in_dim, f)
        if last and zero_final:
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)
        mods.append(lin)
        if not last or final_act:
            mods.append(nn.ReLU())
        in_dim = f
    return nn.Sequential(*mods)


class _BN(nn.Module):
    """The reference's BatchNorm wrapper: its BatchNorm2d sits at ``.bn``."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(c, eps=1e-5)


class _ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size=1, bias=False)
        self.bn = _BN(c_out)


BN_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9), the JAX package's setting
_COLLECTING: List[dict] = []  # the open batch_stats() collections, innermost last


@contextmanager
def batch_stats():
    """Collect the batch statistics of every train-mode ``batch_norm`` run
    inside the block: yields {BatchNorm module: (mean, biased variance)},
    which ``update_running_stats`` moves into the running statistics (the
    counterpart of flax's mutable ``batch_stats``)."""
    stats: dict = {}
    _COLLECTING.append(stats)
    try:
        yield stats
    finally:
        _COLLECTING.pop()


def batch_norm(x: torch.Tensor, bn: nn.Module, train: bool) -> torch.Tensor:
    """flax ``BatchNorm`` over the last axis, in float32, with a torch
    BatchNorm module's parameters and running statistics.

    In train mode it normalises with the statistics of this batch (over every
    other axis; variance E[x^2] - E[x]^2, biased, clipped at 0; under an
    active mesh E[x] and E[x^2] of the global batch, all-reduced over the
    data ranks) and hands them to the innermost open ``batch_stats()``
    collection, if any; the module itself is not changed. In eval mode it
    uses the running statistics."""
    x = x.float()
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dims)
        msq = (x * x).mean(dims)
        mesh = active_mesh()
        if mesh is not None:
            mean, msq = mesh.batch_moments(mean, msq)
        var = torch.clamp(msq - mean * mean, min=0.0)
        if _COLLECTING:
            _COLLECTING[-1][bn] = (mean.detach(), var.detach())
    else:
        mean, var = bn.running_mean, bn.running_var
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


@torch.no_grad()
def update_running_stats(stats: dict) -> None:
    """Move each BatchNorm of a ``batch_stats()`` collection to
    0.9 * running + 0.1 * batch."""
    for bn, batch in stats.items():
        for buf, b in zip((bn.running_mean, bn.running_var), batch):
            buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * b)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """flax ``Dropout``: in train mode keep each entry with probability
    1 - rate (a uniform draw from ``generator`` below 1 - rate) and scale it
    by 1 / (1 - rate); identity in eval mode or at rate 0."""
    if not train or rate == 0.0:
        return x
    keep = batch_rand(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class SharedMLP(nn.Module):
    """1x1 conv + BatchNorm + ReLU layers over channels-last rows. Serving
    runs them in eval form, through ``folded()``; training through
    ``forward``."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"layer{i}", _ConvBN(a, b))
        self.num_layers = len(widths) - 1

    def folded(self, i: int):
        """Layer i as (W (in, out), a, c) with eval BN(x W) = (x W) * a + c."""
        lay = getattr(self, f"layer{i}")
        W = lay.conv.weight.reshape(lay.conv.out_channels, lay.conv.in_channels).t()
        return (W,) + fold_bn(lay.bn.bn)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype = torch.float32,
                start: int = 0) -> torch.Tensor:
        """flax ``SharedMLP(dtype)`` over layers ``start``..: each a bias-free
        Dense in ``dtype`` (the result in ``dtype``), then float32 BatchNorm
        and ReLU. x (..., C_in) -> (..., C_out) float32."""
        for i in range(start, self.num_layers):
            lay = getattr(self, f"layer{i}")
            W = lay.conv.weight[:, :, 0, 0].t()
            x = torch.relu(batch_norm(x.to(dtype) @ W.to(dtype), lay.bn.bn, train))
        return x


class Conv1x1(nn.Conv1d):
    """A 1x1 ``Conv1d`` (the reference layout: weight (out, in, 1), bias)
    applied to channels-last rows, (..., in) -> (..., out), float32."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(c_in, c_out, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight[:, :, 0].t() + self.bias


def mm(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """a @ w with both operands rounded to ``dt``, as float32. A bf16 product
    is a bf16 matmul (float32 sums, the result rounded to bf16 as torch
    returns it): the JAX package keeps that result in float32, which these
    projections outside the kernels give up for the tensor cores."""
    return (a.to(dt) @ w.to(dt)).float()


def dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)``: operands and bias in dt, the result in dt."""
    return x.to(dt) @ lin.weight.t().to(dt) + lin.bias.to(dt)


def linear_resize_points(x: torch.Tensor, new_n: int) -> torch.Tensor:
    """Linear resize along the point axis of (B, N, C), as
    F.interpolate(mode='linear', align_corners=False); an exact 2x
    downsample averages neighbouring pairs."""
    N = x.shape[1]
    if N == new_n:
        return x
    if N == 2 * new_n:
        return 0.5 * (x[:, 0::2] + x[:, 1::2])
    return F.interpolate(x.transpose(1, 2), size=new_n, mode="linear",
                         align_corners=False).transpose(1, 2)


def fold_bn(bn: nn.Module):
    """Eval-mode BatchNorm -> (a, c) with y = a * x + c."""
    a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    c = bn.bias - bn.running_mean * a
    return a, c


class GaussianFourierProjection(nn.Module):
    """Fixed random time embedding [sin(2 pi W t), cos(2 pi W t)]."""

    def __init__(self, embed_dim: int = 128, scale: float = 30.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embed_dim // 2) * scale, requires_grad=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        proj = t.reshape(-1, 1) * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
