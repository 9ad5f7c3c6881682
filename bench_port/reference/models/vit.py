# Frozen copy of genpose2_tpu_torch/models/vit.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""The frozen ViT backbones (port of genpose2_tpu/models/vit.py: DinoV3ViT, and
the DINOv2-style ViT).

DINOv3 parameters carry the DINOv3 torch names (``cls_token``,
``storage_tokens``, ``rope_embed.periods``, ``patch_embed.proj``,
``blocks.{i}.norm1``, ``.attn.qkv``, ``.attn.proj``, ``.ls1.gamma``, ``.norm2``,
``.mlp.w1/w2/w3``, ``.ls2.gamma``, ``norm``), so ``weights.dinov3_state_dict``
and a DINOv3 checkpoint load as they are.

The DINOv3 forward, with ``dtype`` None (float32) or bfloat16:

- patch embedding as one product over flattened (p, p, 3) patches, float32
  out; cls + storage tokens in front; from there on the residual stream is
  in the compute dtype;
- 2D axial RoPE tables (rotate-half pairs), identity rows for the prefix and
  the pad rows, tiled to (N, C) float32 once for all blocks;
- the token axis padded once to 16 rows (bf16) or 8 (float32); keys at or
  past the real count are masked in the attention and the pad rows are
  sliced off at the taps;
- per block: LN1 (float32) -> qkv -> attention -> proj; in bf16 the
  layer-scale residual and LN2 are one ``fast_add_layernorm`` launch, in
  float32 they are plain ops; SwiGLU w3(silu(w1 h) * w2 h) with w1 and w2 as
  one product; the tail residual x + ls2 * h;
- the final ``norm`` (float32 statistics, float32 out) at each tapped block,
  or on the class token (``return_class_token``).

The attention takes one of three routes, as ``DinoV3Attention`` does:
RoPE elementwise with the tables rounded to the compute dtype, then
``vit_attention_tm`` on a padded token axis or ``vit_attention`` on an
unpadded one; or, with ``_INKERNEL_ROPE`` on and a padded axis,
``vit_attention_tm`` with the float32 tables, rotating q and k inside the
kernel. With ``_DEFER_TAIL`` on and a bf16 stream each block hands its tail
residual (h, ls2) to the next block, whose norm1 becomes one
``fast_add_layernorm`` (block 0's a ``fast_layernorm``); the sum is
materialised at the taps and at the end. Both switches are read at call
time and are off by default, as in the JAX package.

Dense layers whose JAX counterpart is a flax ``Dense(dtype=bf16)`` return bf16
here too; those with a float32 ``preferred_element_type`` round the product to
bf16 (``layers.mm``). ``plain=True`` runs the plain versions of the kernels.

``ViT`` is the DINOv2-style backbone (``backbone='dinov2_vits16'``), plain
PyTorch as the JAX package leaves it to XLA: learned ``pos_embed``, optional
register tokens, pre-norm blocks with flax ``MultiHeadDotProductAttention``
semantics, GELU MLP and layer scale, a float32 residual stream. Its
parameters carry the DINOv2 torch names (``weights.dinov2_state_dict``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.models.layers import dense, mm
from bench_port.reference.ops.layernorm import (LN_EPS, fast_add_layernorm,
                                              fast_add_layernorm_plain, fast_layernorm,
                                              fast_layernorm_plain, layer_norm)
from bench_port.reference.ops.vit_attention import (vit_attention, vit_attention_plain,
                                                  vit_attention_tm, vit_attention_tm_plain)

# The JAX package's two ViT switches (genpose2_tpu/models/vit.py:218, 227),
# off there and here; read at call time.
_INKERNEL_ROPE = False  # RoPE inside the attention kernel, float32 tables
_DEFER_TAIL = False  # each block's tail residual folded into the next norm1 (bf16)


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

    def attention(self, h, sin, cos, n_valid: int, dt: torch.dtype, plain: bool):
        """qkv, RoPE and attention on h (B, N, C) -> proj output in dt; sin,
        cos (N, C) float32, per-head tiled."""
        N, C = h.shape[1], h.shape[2]
        H = self.num_heads
        qkv = (mm(h, self.attn.qkv.weight.t(), dt) + self.attn.qkv.bias).to(dt)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:].contiguous()
        padded = N % (8 if dt == torch.float32 else 16) == 0
        if _INKERNEL_ROPE and padded:
            hd = C // H
            attend = vit_attention_tm_plain if plain else vit_attention_tm
            att = attend(q, k, v, H, n_valid, sin=sin[:, :hd], cos=cos[:, :hd])
        else:
            sin_d, cos_d = sin.to(dt), cos.to(dt)
            q = q * cos_d + _rotate_half(q, H) * sin_d
            k = k * cos_d + _rotate_half(k, H) * sin_d
            if padded:
                attend = vit_attention_tm_plain if plain else vit_attention_tm
            else:
                attend = vit_attention_plain if plain else vit_attention
            att = attend(q, k, v, H, n_valid)
        return dense(att, self.attn.proj, dt)

    def forward(self, x, sin, cos, n_valid: int, dtype: Optional[torch.dtype], plain: bool,
                pending=None):
        """-> (x, pending): with the tail deferred (``_DEFER_TAIL`` on a bf16
        stream) the residual stream without this block's tail and its
        (h, ls2.gamma); otherwise the full residual stream and None."""
        dt = dtype or torch.float32
        defer = dtype is not None and _DEFER_TAIL
        if defer and pending is None:
            ln = fast_layernorm_plain if plain else fast_layernorm
            h = ln(x.to(dt), self.norm1.weight, self.norm1.bias)
        elif defer:
            add_ln = fast_add_layernorm_plain if plain else fast_add_layernorm
            x, h = add_ln(x.to(dt), pending[0].to(dt), pending[1], self.norm1.weight,
                          self.norm1.bias)
        else:
            assert pending is None
            h = layer_norm(x, self.norm1.weight, self.norm1.bias)
        h = self.attention(h, sin, cos, n_valid, dt, plain)
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
        if defer:
            return x, (h, self.ls2.gamma)
        return _materialize(x, (h, self.ls2.gamma)), None


def _materialize(tokens, pending):
    """tokens + ls2 * h of a deferred tail, the product rounded to the
    stream's dtype before the add (as the JAX package's ``materialize``)."""
    if pending is None:
        return tokens
    h, gamma = pending
    return tokens + (h * gamma).to(tokens.dtype)


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
    def forward(self, x: torch.Tensor, layer_ids: Sequence[int] = (), plain: bool = False,
                return_class_token: bool = False):
        """x (B, S, S, 3) -> [(B, (S/p)^2, dim) float32 for each tapped block,
        in block order] (a block listed twice is tapped once, as in the JAX
        package); with no ``layer_ids`` the final normed patch tokens, or with
        ``return_class_token`` the final normed class token (B, dim)."""
        B = x.shape[0]
        dt = self.dtype or torch.float32
        tokens, gh, gw = _patch_tokens(self.patch_embed, x, self.patch_size, dt)
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
        sin, cos = sin.repeat(1, self.num_heads), cos.repeat(1, self.num_heads)
        tokens = F.pad(tokens, (0, 0, 0, Np - N))

        outputs, pending = [], None
        for i, blk in enumerate(self.blocks):
            tokens, pending = blk(tokens, sin, cos, N, self.dtype, plain, pending)
            if i in layer_ids:
                full = _materialize(tokens, pending)
                outputs.append(layer_norm(full, self.norm.weight, self.norm.bias)[:, num_prefix:N])
        if layer_ids:
            return outputs
        final = layer_norm(_materialize(tokens, pending), self.norm.weight, self.norm.bias)
        return final[:, 0] if return_class_token else final[:, num_prefix:N]


def _patch_tokens(patch_embed: nn.Module, x: torch.Tensor, p: int, dt: torch.dtype):
    """Patchify x (B, S, S, 3) as one product over flattened (p, p, 3) patches
    with the conv's weights -> ((B, gh*gw, dim) float32, gh, gw)."""
    B, Hpx, Wpx, _ = x.shape
    gh, gw = Hpx // p, Wpx // p
    proj = patch_embed.proj
    W = proj.weight.permute(2, 3, 1, 0).reshape(p * p * 3, proj.out_channels)
    patches = x.float().reshape(B, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
    return mm(patches.reshape(B, gh * gw, p * p * 3), W, dt) + proj.bias, gh, gw


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm block of the DINOv2-style ViT (flax ``ViTBlock``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _Attention(dim)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = _LayerScale(dim)

    def attention(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """flax ``MultiHeadDotProductAttention(dtype=dt)``: q, k, v and the
        output projection as ``Dense(dt)``, q divided by sqrt(head_dim) (that
        square root rounded to dt), scores, softmax and the PV product in
        dt."""
        B, N, C = h.shape
        H = self.num_heads
        hd = C // H
        q, k, v = dense(h, self.attn.qkv, dt).reshape(B, N, 3, H, hd).unbind(2)
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dt)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        return dense(torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, C), self.attn.proj, dt)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """x (B, N, C) float32 -> float32: LayerNorms with float32
        statistics, attention and MLP (tanh GELU) in the compute dtype, the
        layer-scaled residuals in float32."""
        dt = dtype or torch.float32
        h = self.attention(layer_norm(x, self.norm1.weight, self.norm1.bias), dt)
        x = x + h * self.ls1.gamma
        h = dense(layer_norm(x, self.norm2.weight, self.norm2.bias), self.mlp.fc1, dt)
        h = dense(F.gelu(h, approximate="tanh"), self.mlp.fc2, dt)
        return x + h * self.ls2.gamma


class ViT(nn.Module):
    """DINOv2-style ViT (``backbone='dinov2_vits16'``); the interface of
    ``DinoV3ViT``. ``num_patches`` fixes ``pos_embed`` (1, 1 + num_patches,
    dim), as the JAX package's parameter is shaped at init."""

    def __init__(self, num_patches: int, patch_size: int = 16, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, num_register_tokens: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.patch_embed = _PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        self.register_tokens = (nn.Parameter(torch.zeros(1, num_register_tokens, dim))
                                if num_register_tokens else None)
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, layer_ids: Sequence[int] = (), plain: bool = False,
                return_class_token: bool = False):
        """As ``DinoV3ViT.forward``; ``plain`` changes nothing (no kernel
        runs here)."""
        B = x.shape[0]
        tokens, _, _ = _patch_tokens(self.patch_embed, x, self.patch_size,
                                     self.dtype or torch.float32)
        tokens = torch.cat([self.cls_token.expand(B, -1, -1), tokens], dim=1) + self.pos_embed
        skip = 1
        if self.register_tokens is not None:
            skip += self.register_tokens.shape[1]
            tokens = torch.cat([tokens[:, :1], self.register_tokens.expand(B, -1, -1),
                                tokens[:, 1:]], dim=1)
        outputs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, self.dtype)
            if i in layer_ids:
                outputs.append(layer_norm(tokens, self.norm.weight, self.norm.bias)[:, skip:])
        if layer_ids:
            return outputs
        final = layer_norm(tokens, self.norm.weight, self.norm.bias)
        return final[:, 0] if return_class_token else final[:, skip:]
