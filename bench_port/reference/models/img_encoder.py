# Frozen copy of genpose2_tpu_torch/models/img_encoder.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Multi-layer DINO feature fusion (port of genpose2_tpu/models/img_encoder.py:
ImgEncoder).

Softmax attention over the tapped ViT layers, a spatial attention over the
patch grid modulated by a learned relative-position embedding, and an
edge-enhancement conv branch, combined with learned scalar weights.
features: list of L (B, P, D) float32, P a square grid -> (B, P, D) float32.

State dict layout (reference): ``layer_attn.{0,2}``, ``rel_pos_emb``,
``edge_guide.0`` (Conv2d (D/4, D, 3, 3)), ``geo_weight``, ``edge_weight``.
With ``dtype`` bf16 (``pointnet2.compute_dtype`` bf16 in the JAX package) the
dense layers, the two einsums and the conv take bf16 operands.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.models.layers import dense


class ImgEncoder(nn.Module):
    def __init__(self, dim: int = 384, num_patches: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        h = math.isqrt(num_patches)
        max_rel = 2 * (h - 1)
        self.layer_attn = nn.Sequential(nn.Linear(dim, dim // 2), nn.ReLU(),
                                        nn.Linear(dim // 2, 1))
        self.rel_pos_emb = nn.Embedding(max_rel * max_rel, dim // 4)
        self.edge_guide = nn.Sequential(nn.Conv2d(dim, dim // 4, 3, padding=1), nn.ReLU())
        self.geo_weight = nn.Parameter(torch.tensor(0.2))
        self.edge_weight = nn.Parameter(torch.tensor(0.1))
        # relative (dy, dx) of every patch pair, shifted to >= 0, flattened and
        # clipped into the (2(h-1))^2-row table as the reference does
        coords = np.stack(np.meshgrid(np.arange(h), np.arange(h), indexing="ij"), -1).reshape(-1, 2)
        rel = coords[None, :, :] - coords[:, None, :] + (h - 1)
        idx = np.clip(rel[..., 0] * (2 * (h - 1) + 1) + rel[..., 1], 0, max_rel * max_rel - 1)
        self.register_buffer("rel_idx", torch.from_numpy(idx.astype(np.int64)), persistent=False)

    @torch.no_grad()
    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        B, P, D = features[0].shape
        h = math.isqrt(P)
        dt = self.dtype or torch.float32
        d0, d1 = self.layer_attn[0], self.layer_attn[2]
        logits = torch.cat([dense(torch.relu(dense(f, d0, dt)), d1, dt).float()
                            for f in features], dim=-1)  # (B, P, L)
        lw = torch.softmax(logits, dim=-1)
        fused = sum(f.float() * lw[..., i:i + 1] for i, f in enumerate(features))

        feat_geo = fused[:, :, D // 4:].to(dt)
        attn = (feat_geo @ feat_geo.transpose(1, 2)).float()
        # each (p, q) pair's embedding row, summed over its D/4 channels
        attn = attn * self.rel_pos_emb.weight.float().sum(-1)[self.rel_idx][None]
        attn = torch.softmax(attn, dim=-1)
        geo = (attn.to(dt) @ fused.to(dt)).float()

        conv = self.edge_guide[0]
        spatial = fused.reshape(B, h, h, D).permute(0, 3, 1, 2).to(dt)
        edge = F.conv2d(spatial, conv.weight.to(dt), conv.bias.to(dt), padding=1).float()
        edge = torch.relu(edge).mean(dim=(2, 3))  # (B, D/4)
        edge_w = edge[:, None, :].repeat(1, 1, 4)  # the whole vector four times
        return (fused + torch.relu(self.geo_weight) * geo
                + torch.relu(self.edge_weight) * (fused * edge_w))
