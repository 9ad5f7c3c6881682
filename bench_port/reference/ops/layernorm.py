# Frozen copy of genpose2_tpu_torch/ops/layernorm.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten, 3 kernel route(s) removed. Do not edit.
"""LayerNorm with or without a residual add (port of
genpose2_tpu/ops/layernorm.py: fast_residual_layernorm, fast_add_layernorm and
fast_layernorm).

All three treat (B, N, D) as B*N independent rows. The sum is float32, the
statistics are float32 over that unrounded sum, eps is 1e-6 (flax's
LayerNorm default, which every LayerNorm of the port uses):

- ``fast_residual_layernorm(x, h, scale, bias)`` = LN(x + h), the post-norm
  rel-PE transformer blocks of the Fus encoder;
- ``fast_add_layernorm(x, h, gamma, scale, bias)`` = (x + gamma*h,
  LN(x + gamma*h)), the ViT block's layer-scale residual plus norm2 on the
  bf16 stream; only the written sum is rounded to the output dtype;
- ``fast_layernorm(x, scale, bias)`` = LN(x) in x's dtype, block 0's norm1
  on the ViT's bf16 stream when the block tails are deferred.

Each launches ``csrc/layernorm.cu`` on CUDA tensors and runs its ``_plain``
version on CPU tensors.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics -> float32."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fast_residual_layernorm_plain(x, h, scale, bias, eps: float = LN_EPS):
    return layer_norm(x.float() + h.float(), scale, bias, eps).to(x.dtype)


def fast_layernorm_plain(x, scale, bias, eps: float = LN_EPS):
    return layer_norm(x, scale, bias, eps).to(x.dtype)


def fast_add_layernorm_plain(x, h, gamma, scale, bias, eps: float = LN_EPS):
    x2 = x.float() + h.float() * gamma.float()
    return x2.to(x.dtype), layer_norm(x2, scale, bias, eps).to(x.dtype)


def fast_residual_layernorm(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float = LN_EPS):
    """LN(x + h) over the last axis: x, h (..., D) -> (..., D) in x's dtype."""
    return fast_residual_layernorm_plain(x, h, scale, bias, eps)


def fast_add_layernorm(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS):
    """(x + gamma*h, LN(x + gamma*h)), both in x's dtype (h must match it)."""
    return fast_add_layernorm_plain(x, h, gamma, scale, bias, eps)


def fast_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = LN_EPS):
    """LN(x) over the last axis with float32 statistics, in x's dtype."""
    return fast_layernorm_plain(x, scale, bias, eps)
