"""Shared building blocks (port of genpose2_tpu/models/layers.py).

The modules keep the reference torch ``state_dict`` layout (the one
genpose2_tpu/training/torch_ingest.py reads), so published checkpoints load
with no conversion: ``nn.Linear`` weights are (out, in), an MLP is an
``nn.Sequential`` of Linear and ReLU, and a SharedMLP layer is
``layer{i}.conv`` (a bias-free 1x1 conv, weight (out, in, 1, 1)) plus
``layer{i}.bn.bn`` (BatchNorm2d).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


class SharedMLP(nn.Module):
    """1x1 conv + BatchNorm + ReLU layers over channels-last rows. The port
    runs them only in eval form, through ``folded()``."""

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
