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
