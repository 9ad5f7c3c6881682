"""Attention blocks of the Fus point encoder (port of
genpose2_tpu/models/attention.py).

The modules keep the reference torch names that
genpose2_tpu/training/torch_ingest.py reads:

- ``EfficientRelativePositionalEncoding``: ``distance_encoder.{0,2}``,
  ``direction_encoder.{0,2}``, ``fusion``;
- ``TransformerBlockWithRelativePE``: ``self_attn.w{q,k,v,o}``,
  ``linear1/2``, ``norm1/2``;
- ``GatedAttentionFusion``: ``original_transform.{0,1}``,
  ``channel_attention.{1,3}``, ``spatial_attention.0``, ``gate.{0,1}``,
  ``output_conv.{0,1}`` (1x1 Conv1d weights (out, in, 1), BatchNorm1d).

The forwards here are the plain module math. The serving path
(models/fast_encoder.py) runs the rel-PE blocks of the grouped stages through
the fused attention and LayerNorm kernels and the gated fusion as
``_fast_gaf``; the GroupAll stage's block (one token) runs
``TransformerBlockWithRelativePE.forward`` in float32, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genpose2_tpu_torch.ops.layernorm import LN_EPS

PE_HIDDEN = 16  # distance/direction encoder hidden width


class EfficientRelativePositionalEncoding(nn.Module):
    """Distance MLP + direction MLP -> fused per-head attention bias."""

    def __init__(self, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.distance_encoder = nn.Sequential(nn.Linear(1, PE_HIDDEN), nn.ReLU(),
                                              nn.Linear(PE_HIDDEN, num_heads))
        self.direction_encoder = nn.Sequential(nn.Linear(3, PE_HIDDEN), nn.ReLU(),
                                               nn.Linear(PE_HIDDEN, num_heads))
        self.fusion = nn.Linear(2 * num_heads, num_heads)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3) -> bias (B, H, N, N), rel[b, i, j] = xyz_j - xyz_i."""
        rel = xyz[:, None, :, :] - xyz[:, :, None, :]
        dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
        direction = rel / (dist + 1e-7)
        fused = self.fusion(torch.cat([self.distance_encoder(dist),
                                       self.direction_encoder(direction)], dim=-1))
        return fused.permute(0, 3, 1, 2)


def softmax_attention(q, k, v, num_heads: int, bias: Optional[torch.Tensor] = None):
    """Multi-head softmax(q k^T / sqrt(D) + bias) v, token-major (B, N, C) in
    and out, float32."""
    B, N, C = q.shape
    D = C // num_heads

    def heads(t):
        return t.float().reshape(B, N, num_heads, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(D)
    if bias is not None:
        scores = scores + bias
    out = torch.softmax(scores, dim=-1) @ heads(v)
    return out.transpose(1, 2).reshape(B, N, C)


class MultiheadAttentionWithRelativePE(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.wq, self.wk = nn.Linear(d_model, d_model), nn.Linear(d_model, d_model)
        self.wv, self.wo = nn.Linear(d_model, d_model), nn.Linear(d_model, d_model)

    def forward(self, x, relative_bias=None):
        out = softmax_attention(self.wq(x), self.wk(x), self.wv(x), self.num_heads,
                                relative_bias)
        return self.wo(out)


class TransformerBlockWithRelativePE(nn.Module):
    """Post-norm block: attention -> add & norm -> ReLU FFN (4x) -> add & norm."""

    def __init__(self, d_model: int, num_heads: int = 8):
        super().__init__()
        self.self_attn = MultiheadAttentionWithRelativePE(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, 4 * d_model)
        self.linear2 = nn.Linear(4 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, relative_bias=None):
        x = self.norm1(x + self.self_attn(x, relative_bias))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


def _conv_bn(c_in: int, c_out: int, act: nn.Module) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(c_in, c_out, 1), nn.BatchNorm1d(c_out, eps=1e-5), act)


class GatedAttentionFusion(nn.Module):
    """Channel attention + spatial attention + gated fusion of the current
    point features (C channels) with the transformed DINO features (C_orig).
    A parameter holder: its eval forward is models/fast_encoder.py:_fast_gaf."""

    def __init__(self, current_channels: int, original_channels: int):
        super().__init__()
        C = current_channels
        self.original_transform = _conv_bn(original_channels, C, nn.ReLU())
        self.channel_attention = nn.Sequential(
            nn.AdaptiveAvgPool1d(1), nn.Conv1d(2 * C, (2 * C) // 4, 1), nn.ReLU(),
            nn.Conv1d((2 * C) // 4, C, 1), nn.Sigmoid())
        self.spatial_attention = nn.Sequential(nn.Conv1d(2, 1, 7, padding=3, bias=False),
                                               nn.Sigmoid())
        self.gate = _conv_bn(2 * C, C, nn.Sigmoid())
        self.output_conv = _conv_bn(C, C, nn.ReLU())
