# Frozen copy of genpose2_tpu_torch/models/attention.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
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

The forwards here are the plain module math, with the dropouts and
train-mode BatchNorms of the JAX modules: the training path runs them. The
serving path (models/fast_encoder.py) runs the rel-PE blocks of the grouped
stages through the fused attention and LayerNorm kernels and the gated fusion
as ``_fast_gaf``; the GroupAll stage's block (one token) runs
``TransformerBlockWithRelativePE.forward`` in float32, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.models.layers import batch_norm, dropout, linear_resize_points
from bench_port.reference.ops.layernorm import LN_EPS

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


class MultiheadAttentionWithRelativePE(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.wq, self.wk = nn.Linear(d_model, d_model), nn.Linear(d_model, d_model)
        self.wv, self.wo = nn.Linear(d_model, d_model), nn.Linear(d_model, d_model)

    def forward(self, x, relative_bias=None, train: bool = False, rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """x (B, N, C) -> (B, N, C); in train mode the attention weights get
        dropout at ``rate``."""
        B, N, C = x.shape
        H = self.num_heads
        D = C // H

        def heads(t):
            return t.reshape(B, N, H, D).transpose(1, 2)

        scores = heads(self.wq(x)) @ heads(self.wk(x)).transpose(-1, -2) / math.sqrt(D)
        if relative_bias is not None:
            scores = scores + relative_bias
        weights = dropout(torch.softmax(scores, dim=-1), rate, generator, train)
        out = (weights @ heads(self.wv(x))).transpose(1, 2).reshape(B, N, C)
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

    def forward(self, x, relative_bias=None, train: bool = False, rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """In train mode: dropout at ``rate`` on the attention weights, the
        attention output, the FFN hidden layer and the FFN output."""
        attn = self.self_attn(x, relative_bias, train, rate, generator)
        x = self.norm1(x + dropout(attn, rate, generator, train))
        ff = dropout(F.relu(self.linear1(x)), rate, generator, train)
        return self.norm2(x + dropout(self.linear2(ff), rate, generator, train))


def _conv_bn(c_in: int, c_out: int, act: nn.Module) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(c_in, c_out, 1), nn.BatchNorm1d(c_out, eps=1e-5), act)


class GatedAttentionFusion(nn.Module):
    """Channel attention + spatial attention + gated fusion of the current
    point features (C channels) with the transformed DINO features (C_orig).
    ``forward`` is the module form (training); the eval fast path is
    models/fast_encoder.py:_fast_gaf."""

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

    def forward(self, current: torch.Tensor, original: torch.Tensor, train: bool,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The JAX module's form (genpose2_tpu/models/attention.py:184-221):
        Dense layers in ``dtype``, BatchNorms in float32 (batch statistics in
        train mode), the k=7 SAME spatial conv as seven shifted products.
        current (B, M, C) float32, original (B, M', C_orig) -> (B, M, C) float32."""
        M = current.shape[1]
        if original.shape[1] != M:
            original = linear_resize_points(original, M)
        orig_t = torch.relu(batch_norm(self._dense(original, self.original_transform[0], dtype),
                                       self.original_transform[1], train))
        pooled = torch.cat([current, orig_t], dim=-1).mean(1, keepdim=True)
        ca = torch.relu(self._dense(pooled, self.channel_attention[1], dtype))
        ca = torch.sigmoid(self._dense(ca, self.channel_attention[3], dtype).float())  # (B, 1, C)

        x = torch.cat([current.amax(-1, keepdim=True), current.mean(-1, keepdim=True)], dim=-1)
        kernel = self.spatial_attention[0].weight  # (1, 2, 7): out, [max, mean], taps
        K = kernel.shape[-1]
        xp = F.pad(x, (0, 0, (K - 1) // 2, K // 2))
        sa = xp[:, 0:M] @ kernel[:, :, 0].t()
        for i in range(1, K):
            sa = sa + xp[:, i:i + M] @ kernel[:, :, i].t()
        attended = orig_t * ca * torch.sigmoid(sa)

        gate = self._dense(torch.cat([current, attended], dim=-1), self.gate[0], dtype)
        gate = torch.sigmoid(batch_norm(gate, self.gate[1], train))
        fused = gate * current + (1.0 - gate) * attended
        out = self._dense(fused, self.output_conv[0], dtype)
        return torch.relu(batch_norm(out, self.output_conv[1], train))

    @staticmethod
    def _dense(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
        """A 1x1 Conv1d as flax ``Dense(dtype)``: the result in ``dtype``."""
        return x.to(dtype) @ conv.weight[:, :, 0].t().to(dtype) + conv.bias.to(dtype)
