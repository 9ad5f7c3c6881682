# Frozen copy of genpose2_tpu_torch/ops/vit_attention.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten, 2 kernel route(s) removed. Do not edit.
"""Token-major multi-head self-attention of the ViT backbone (port of
genpose2_tpu/ops/vit_attention.py: ``vit_attention_tm``, with and without
RoPE inside the kernel, and ``vit_attention``, the route for a token axis that
is not padded to the sublane tile).

q, k, v (B, N, C) stay in the layout the qkv projection gives them; head h is
columns h*D .. h*D+D-1. Scores are float32 with the scale 1/sqrt(D) applied
after the product, keys at or past ``n_valid`` get -1e9, the softmax is
float32, the probabilities are rounded to v's dtype before the PV product,
and the output is float32. Query rows at or past ``n_valid`` hold finite
values the caller slices off.

- ``vit_attention_tm(q, k, v, H, n_valid)``: N padded by the caller
  (``DinoV3ViT`` pads once for all blocks);
- ``vit_attention_tm(..., sin=, cos=)``: the (N, D) float32 tables, the same
  for every head, rotate q and k first: x * cos + rotate_half(x) * sin in
  float32, rounded back to the input dtype;
- ``vit_attention(q, k, v, H, n_valid)``: any N. The TPU kernel transposes to
  head-major and pads N for Mosaic; the result is the same function.

Each launches its entry of ``csrc/vit_attention.cu`` on CUDA tensors and runs
its ``_plain`` version on CPU tensors, for any N and head dims to 128 (a wider
head raises a ValueError).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

def _roped(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, num_heads: int):
    """x (B, N, C) with every head rotated by the (N, D) tables, in float32,
    rounded back to x's dtype."""
    B, N, C = x.shape
    D = C // num_heads
    xf = x.float().reshape(B, N, num_heads, D)
    rot = torch.cat([-xf[..., D // 2:], xf[..., :D // 2]], dim=-1)
    out = xf * cos.float()[None, :, None] + rot * sin.float()[None, :, None]
    return out.reshape(B, N, C).to(x.dtype)


def vit_attention_tm_plain(q, k, v, num_heads: int, n_valid: Optional[int] = None,
                           sin: Optional[torch.Tensor] = None, cos: Optional[torch.Tensor] = None):
    B, N, C = q.shape
    D = C // num_heads
    n_valid = N if n_valid is None else n_valid
    if sin is not None:
        q, k = _roped(q, sin, cos, num_heads), _roped(k, sin, cos, num_heads)

    def heads(t):
        return t.float().reshape(B, N, num_heads, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(D))
    mask = torch.where(torch.arange(N, device=q.device) < n_valid, 0.0, -1e9)
    p = torch.softmax(scores + mask, dim=-1).to(v.dtype).float()
    return (p @ heads(v)).transpose(1, 2).reshape(B, N, C)


def vit_attention_plain(q, k, v, num_heads: int, n_valid: Optional[int] = None):
    return vit_attention_tm_plain(q, k, v, num_heads, n_valid)


def vit_attention_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     n_valid: Optional[int] = None, sin: Optional[torch.Tensor] = None,
                     cos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, N, C) -> (B, N, C) float32; keys >= n_valid masked; with
    ``sin``/``cos`` (N, C // num_heads) RoPE on q and k inside the kernel."""
    n_valid = q.shape[1] if n_valid is None else n_valid
    return vit_attention_tm_plain(q, k, v, num_heads, n_valid, sin, cos)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """q, k, v (B, N, C), any N -> (B, N, C) float32; keys >= n_valid masked."""
    n_valid = q.shape[1] if n_valid is None else n_valid
    return vit_attention_plain(q, k, v, num_heads, n_valid)
