"""The frozen DINOv3 ViT backbone (port of genpose2_tpu/models/vit.py:DinoV3ViT
with its defaults, RoPE outside the attention kernel and every block's tail
residual in place).

Parameters carry the DINOv3 torch names (``cls_token``, ``storage_tokens``,
``rope_embed.periods``, ``patch_embed.proj``, ``blocks.{i}.norm1``,
``.attn.qkv``, ``.attn.proj``, ``.ls1.gamma``, ``.norm2``, ``.mlp.w1/w2/w3``,
``.ls2.gamma``, ``norm``), so ``weights.dinov3_state_dict`` and a DINOv3
checkpoint load as they are.

The forward, with ``dtype`` None (float32) or bfloat16:

- patch embedding as one product over flattened (p, p, 3) patches, float32
  out; cls + storage tokens in front; from there on the residual stream is
  in the compute dtype;
- 2D axial RoPE tables (rotate-half pairs), identity rows for the prefix,
  tiled to (N, C) and rounded to the compute dtype, applied elementwise to q
  and k;
- the token axis padded once to 16 rows (bf16) or 8 (float32); keys at or
  past the real count are masked in the attention and the pad rows are
  sliced off at the taps;
- per block: LN1 (float32) -> qkv -> RoPE -> ``vit_attention_tm`` -> proj;
  in bf16 the layer-scale residual and LN2 are one ``fast_add_layernorm``
  launch, in float32 they are plain ops; SwiGLU w3(silu(w1 h) * w2 h) with
  w1 and w2 as one product; the tail residual x + ls2 * h;
- the final ``norm`` (float32 statistics, float32 out) at each tapped block.

Dense layers whose JAX counterpart is a flax ``Dense(dtype=bf16)`` return bf16
here too; those with a float32 ``preferred_element_type`` round the product to
bf16 (``layers.mm``). ``plain=True`` runs the plain versions of the two kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genpose2_tpu_torch.models.layers import dense, mm
from genpose2_tpu_torch.ops.layernorm import (LN_EPS, fast_add_layernorm,
                                              fast_add_layernorm_plain, layer_norm)
from genpose2_tpu_torch.ops.vit_attention import vit_attention_tm, vit_attention_tm_plain


def rope_tables(periods: torch.Tensor, gh: int, gw: int):
    """sin, cos (gh*gw, head_dim) for a gh x gw patch grid: coordinates in
    [-1, 1] per axis, angles 2*pi*coord/period laid out [y | x] and tiled x2
    (the rotate-half pairs (i, i + head_dim/2))."""
    dev = periods.device
    ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / gh * 2.0 - 1.0
    xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / gw * 2.0 - 1.0
    coords = torch.stack([ys.repeat_interleave(gw), xs.repeat(gh)], dim=-1)  # (P, 2)
    angles = 2.0 * math.pi * coords[:, :, None] / periods[None, None, :].float()
    angles = angles.reshape(gh * gw, -1)
    angles = torch.cat([angles, angles], dim=-1)
    return torch.sin(angles), torch.cos(angles)


def _rotate_half(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per head: concat(-x2, x1) of the head's halves."""
    B, N, C = t.shape
    th = t.reshape(B, N, num_heads, C // num_heads)
    h2 = th.shape[-1] // 2
    return torch.cat([-th[..., h2:], th[..., :h2]], dim=-1).reshape(B, N, C)


class _RopeEmbed(nn.Module):
    def __init__(self, head_dim: int, base: float):
        super().__init__()
        dq = head_dim // 4
        self.register_buffer("periods", base ** (torch.arange(dq, dtype=torch.float32) / dq))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1, self.w2 = nn.Linear(dim, hidden), nn.Linear(dim, hidden)
        self.w3 = nn.Linear(hidden, dim)


class DinoV3Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_hidden: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _SwiGLU(dim, ffn_hidden)
        self.ls2 = _LayerScale(dim)

    def forward(self, x, sin, cos, n_valid: int, dtype: Optional[torch.dtype], plain: bool):
        dt = dtype or torch.float32
        C = x.shape[-1]
        h = layer_norm(x, self.norm1.weight, self.norm1.bias)
        qkv = (mm(h, self.attn.qkv.weight.t(), dt) + self.attn.qkv.bias).to(dt)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        q = q * cos + _rotate_half(q, self.num_heads) * sin
        k = k * cos + _rotate_half(k, self.num_heads) * sin
        attend = vit_attention_tm_plain if plain else vit_attention_tm
        h = dense(attend(q, k, v.contiguous(), self.num_heads, n_valid=n_valid),
                  self.attn.proj, dt)
        if dtype is not None:
            add_ln = fast_add_layernorm_plain if plain else fast_add_layernorm
            x, h = add_ln(x.to(dt), h.to(dt), self.ls1.gamma, self.norm2.weight,
                          self.norm2.bias)
        else:
            x = x + (h * self.ls1.gamma).to(dt)
            h = layer_norm(x, self.norm2.weight, self.norm2.bias)
        hidden = self.mlp.w1.out_features
        w12 = torch.cat([self.mlp.w1.weight, self.mlp.w2.weight]).t()
        b12 = torch.cat([self.mlp.w1.bias, self.mlp.w2.bias])
        ab = (mm(h, w12, dt) + b12).to(dt)
        h = dense((F.silu(ab[..., :hidden]) * ab[..., hidden:]).to(dt), self.mlp.w3, dt)
        return x + (h * self.ls2.gamma).to(dt)


class DinoV3ViT(nn.Module):
    """DINOv3-style ViT; ``forward(rgb, layer_ids)`` returns the patch tokens of
    the tapped blocks (cls and storage tokens stripped), float32."""

    def __init__(self, patch_size: int = 16, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_storage_tokens: int = 4, ffn_hidden: int = 1536,
                 rope_base: float = 100.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size, self.num_heads, self.dtype = patch_size, num_heads, dtype
        self.patch_embed = _PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.storage_tokens = nn.Parameter(torch.zeros(1, num_storage_tokens, dim))
        self.rope_embed = _RopeEmbed(dim // num_heads, rope_base)
        self.blocks = nn.ModuleList(DinoV3Block(dim, num_heads, ffn_hidden) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, layer_ids: Sequence[int] = (),
                plain: bool = False):
        """x (B, S, S, 3) -> [(B, (S/p)^2, dim) float32 for each tapped block,
        in block order]; a block listed twice is tapped once, as in the JAX
        package."""
        B, Hpx, Wpx, _ = x.shape
        p, dt = self.patch_size, self.dtype or torch.float32
        gh, gw = Hpx // p, Wpx // p
        D = self.cls_token.shape[-1]
        W = self.patch_embed.proj.weight.permute(2, 3, 1, 0).reshape(p * p * 3, D)
        patches = x.float().reshape(B, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
        tokens = mm(patches.reshape(B, gh * gw, p * p * 3), W, dt) + self.patch_embed.proj.bias
        prefix = torch.cat([self.cls_token.expand(B, -1, -1),
                            self.storage_tokens.expand(B, -1, -1)], dim=1)
        tokens = torch.cat([prefix, tokens], dim=1).to(dt)
        num_prefix = prefix.shape[1]

        sin, cos = rope_tables(self.rope_embed.periods, gh, gw)
        N = tokens.shape[1]
        Np = -(-N // (8 if dt == torch.float32 else 16)) * (8 if dt == torch.float32 else 16)
        hd = sin.shape[1]
        sin = torch.cat([sin.new_zeros(num_prefix, hd), sin, sin.new_zeros(Np - N, hd)])
        cos = torch.cat([cos.new_ones(num_prefix, hd), cos, cos.new_ones(Np - N, hd)])
        sin = sin.repeat(1, self.num_heads).to(dt)
        cos = cos.repeat(1, self.num_heads).to(dt)
        tokens = F.pad(tokens, (0, 0, 0, Np - N))

        outputs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, sin, cos, N, self.dtype, plain)
            if i in layer_ids:
                outputs.append(layer_norm(tokens, self.norm.weight, self.norm.bias)[:, num_prefix:N])
        return outputs
