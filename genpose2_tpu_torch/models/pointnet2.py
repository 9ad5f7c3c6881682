"""PointNet++ MSG classification encoder, as parameter holders (port of
genpose2_tpu/models/pointnet2.py:SetAbstractionMSG / PointNet2ClsMSG).

Their eval forward is the fast path, models/fast_encoder.py:fast_cls_forward.
The module (training) forward is not ported yet (see ROADMAP.md).

State dict layout (reference): ``SA_modules.{k}.mlps.{s}.layer{i}.conv`` and
``.bn.bn``. A grouped stage's layer 0 takes 3 + C_in channels (xyz first) and
is applied to all points before the gather (the projection); a GroupAll
stage's SharedMLP runs over [xyz, features] of every point.
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn

from genpose2_tpu_torch.config import PointNet2Config
from genpose2_tpu_torch.models.attention import (EfficientRelativePositionalEncoding,
                                                 GatedAttentionFusion,
                                                 TransformerBlockWithRelativePE)
from genpose2_tpu_torch.models.layers import SharedMLP


class SetAbstractionMSG(nn.Module):
    def __init__(self, in_channels: int, npoint: Optional[int], radii: Sequence,
                 nsamples: Sequence, mlps: Sequence[Sequence[int]], use_xyz: bool = True):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        c_in = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlps = nn.ModuleList(SharedMLP((c_in,) + tuple(w)) for w in mlps)
        self.out_channels = sum(w[-1] for w in mlps)


class PointNet2ClsMSG(nn.Module):
    """SA stack -> (B, C_final) global feature (1024 for ClsMSG_CFG_Light)."""

    def __init__(self, cfg: PointNet2Config, in_channels: int = 0):
        super().__init__()
        self.cfg = cfg
        mods = []
        for k in range(len(cfg.npoints)):
            sa = SetAbstractionMSG(in_channels, cfg.npoints[k], cfg.radii[k], cfg.nsamples[k],
                                   cfg.mlps[k], cfg.use_xyz)
            mods.append(sa)
            in_channels = sa.out_channels
        self.SA_modules = nn.ModuleList(mods)
        self.out_channels = in_channels


class PointNet2ClsMSGFus(PointNet2ClsMSG):
    """The flagship encoder: the SA stack over [xyz, per-point DINO feature],
    a rel-PE transformer block after every stage, and a gated fusion of the
    (resized) DINO features before every stage but the first.

    State dict layout (reference): ``SA_modules.*`` as above,
    ``relative_pos_encoders.{k}`` for the grouped stages only (the GroupAll
    stage's is dead in the reference and not kept), ``transformer_blocks.{k}``,
    ``feature_fusions.{k-1}``. Its eval forward is
    models/fast_encoder.py:fast_fus_forward."""

    def __init__(self, cfg: PointNet2Config, dino_dim: int):
        super().__init__(cfg, in_channels=dino_dim)
        widths = [sa.out_channels for sa in self.SA_modules]
        self.relative_pos_encoders = nn.ModuleDict({
            str(k): EfficientRelativePositionalEncoding(cfg.num_heads)
            for k, sa in enumerate(self.SA_modules) if sa.npoint is not None})
        self.transformer_blocks = nn.ModuleList(
            TransformerBlockWithRelativePE(w, cfg.num_heads) for w in widths)
        self.feature_fusions = nn.ModuleList(
            GatedAttentionFusion(w, dino_dim) for w in widths[:-1])
