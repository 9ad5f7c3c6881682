"""DINOv3 ViT backbones in plain PyTorch, written from the published
description (facebookresearch/dinov3: ``dinov3/models/vision_transformer.py``,
``dinov3/layers/``; arXiv:2508.10104), for holding the port's ``DinoV3ViT``
to it: on the CPU in the tests, on the card as the backbone of the
DINOv3 ViT-7B/16 cell's judge (``drivers/eval_streaming_ref.py``). It
imports neither the port nor JAX, launches no kernel of its own,
and reads a state dict under the DINOv3 names (``cls_token``,
``storage_tokens``, ``rope_embed.periods``, ``patch_embed.proj``,
``blocks.{i}.norm1``, ``.attn.qkv`` (with or without a bias), ``.attn.proj``,
``.ls1.gamma``, ``.norm2``, ``.mlp.w1/w2/w3``, ``.ls2.gamma``, ``norm``);
other keys of a checkpoint (``mask_token``, the untied class-token norms)
are not read.

The forward of an image batch x (B, S, S, 3), normalised:

- patch embedding: a 16-px stride-16 convolution, the class token and the
  storage tokens in front;
- 2D axial RoPE on the patch tokens' q and k (the prefix tokens are not
  rotated): coordinates (i + 0.5) / h * 2 - 1 per axis, periods base **
  (i / (head_dim / 4)), angles 2 pi coord / period laid out [y | x] and
  tiled twice, q * cos + rotate_half(q) * sin;
- per block: x += ls1 * attn(norm1 x); x += ls2 * w3(silu(w1 h) * w2 h),
  h = norm2 x; attention softmax(q k^T / sqrt(head_dim)) v over all tokens;
- a tapped block's output through the final ``norm``, patch tokens only.

``dtype`` float32 runs everything in float32. ``dtype`` bfloat16 runs as the
configuration states its backbone: the patch embedding in float32, then
the products take bf16 operands and give bf16 results (float32 sums);
biases are added in float32 and the sum rounded to bf16; the residual stream is bf16; each LayerNorm takes float32
statistics of its float32 input; the attention's scores and softmax are
float32, the probabilities rounded to bf16 before the PV product.

Departures from the published model, each kept on purpose:

- LayerNorm eps is 1e-6, the port's and the JAX package's (flax's default);
  the hub's ``layernormbf16`` uses 1e-5;
- the class token's final norm is the patch tokens' (the 7B unties them);
  only patch tokens are returned, which that norm does not touch;
- where the layer-scaled residual is rounded (bf16): the product ls * h in
  float32, then the sum rounded once, as the port's fused add;
- no RoPE jitter, rescaling or shift (the published model applies them only
  in training)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-6


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), EPS)


def _linear(x: torch.Tensor, w: torch.Tensor, b, dt: torch.dtype) -> torch.Tensor:
    y = x.to(dt) @ w.to(dt).t()
    return y if b is None else (y.float() + b.float()).to(dt)


def _rope(h: int, w: int, periods: torch.Tensor):
    dev = periods.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    coords = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(-1, 2)
    angles = 2.0 * math.pi * coords[:, :, None] / periods.float()[None, None, :]
    angles = angles.reshape(h * w, -1).repeat(1, 2)
    return torch.sin(angles), torch.cos(angles)


def _rotate(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """t (B, H, P, hd) rotated by the (P, hd) tables, in float32, back to t's dtype."""
    tf = t.float()
    half = tf.shape[-1] // 2
    rot = torch.cat([-tf[..., half:], tf[..., :half]], dim=-1)
    return (tf * cos + rot * sin).to(t.dtype)


def _block(sd: Dict[str, torch.Tensor], p: str, x: torch.Tensor, num_heads: int, prefix: int,
           sin, cos, dt: torch.dtype) -> torch.Tensor:
    B, N, C = x.shape
    hd = C // num_heads
    h = _ln(x, sd[p + "norm1.weight"], sd[p + "norm1.bias"])
    qkv = _linear(h, sd[p + "attn.qkv.weight"], sd.get(p + "attn.qkv.bias"), dt)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = torch.cat([q[:, :, :prefix], _rotate(q[:, :, prefix:], sin, cos)], dim=2)
    k = torch.cat([k[:, :, :prefix], _rotate(k[:, :, prefix:], sin, cos)], dim=2)
    s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(hd)
    att = torch.softmax(s, dim=-1).to(dt).float() @ v.float()
    att = att.transpose(1, 2).reshape(B, N, C)
    h = _linear(att, sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"], dt)
    x = (x.float() + h.float() * sd[p + "ls1.gamma"].float()).to(dt)
    h = _ln(x, sd[p + "norm2.weight"], sd[p + "norm2.bias"])
    a = _linear(h, sd[p + "mlp.w1.weight"], sd[p + "mlp.w1.bias"], dt)
    g = _linear(h, sd[p + "mlp.w2.weight"], sd[p + "mlp.w2.bias"], dt)
    h = _linear((F.silu(a.float()) * g.float()).to(dt), sd[p + "mlp.w3.weight"],
                sd[p + "mlp.w3.bias"], dt)
    return (x.float() + h.float() * sd[p + "ls2.gamma"].float()).to(dt)


@torch.no_grad()
def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, layer_ids: Sequence[int],
            num_heads: int, dtype: torch.dtype = torch.float32,
            patch: int = 16) -> List[torch.Tensor]:
    """The patch tokens (B, P, C) float32 of each tapped block (ids counted
    from 0, in block order, a block listed twice tapped once) of the DINOv3
    ViT whose state dict is ``sd``, on x (B, S, S, 3), on their device."""
    sd = {k: v.detach() for k, v in sd.items()}
    B, S = x.shape[0], x.shape[1]
    gh = S // patch
    w = sd["patch_embed.proj.weight"].float()
    tokens = F.conv2d(x.float().permute(0, 3, 1, 2), w, sd["patch_embed.proj.bias"].float(),
                      stride=patch)
    tokens = tokens.flatten(2).transpose(1, 2)
    prefix = torch.cat([sd["cls_token"].float().expand(B, -1, -1),
                        sd["storage_tokens"].float().expand(B, -1, -1)], dim=1)
    x = torch.cat([prefix, tokens], dim=1).to(dtype)
    sin, cos = _rope(gh, gh, sd["rope_embed.periods"])
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    out = []
    for i in range(depth):
        x = _block(sd, f"blocks.{i}.", x, num_heads, prefix.shape[1], sin, cos, dtype)
        if i in layer_ids:
            out.append(_ln(x, sd["norm.weight"], sd["norm.bias"])[:, prefix.shape[1]:])
    return out
