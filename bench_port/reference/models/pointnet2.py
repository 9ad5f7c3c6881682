# Frozen copy of genpose2_tpu_torch/models/pointnet2.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""PointNet++ MSG encoders (port of genpose2_tpu/models/pointnet2.py:
SetAbstractionMSG, the classification encoders PointNet2ClsMSG and
PointNet2ClsMSGFus, and the segmentation encoder PointNet2SegMSG with its
FeaturePropagation).

``forward`` is the module form that training runs: FPS and ball query per
stage (the FPS and ball-query kernels on the card), train-mode BatchNorms,
and for the Fus encoder input jitter and dropout drawn from the step's
generator. The eval forward is the fast path, models/fast_encoder.py.

State dict layout (reference): ``SA_modules.{k}.mlps.{s}.layer{i}.conv`` and
``.bn.bn``. A grouped stage's layer 0 takes 3 + C_in channels (xyz first) and
is applied to all points before the gather (the projection); a GroupAll
stage's SharedMLP runs over [xyz, features] of every point.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bench_port.reference.config import PointNet2Config
from bench_port.reference.models.attention import (EfficientRelativePositionalEncoding,
                                                 GatedAttentionFusion,
                                                 TransformerBlockWithRelativePE)
from bench_port.reference.models.layers import (SharedMLP, batch_norm, dropout,
                                              linear_resize_points)
from bench_port.reference.ops.ball_query import ball_query, ball_query_plain
from bench_port.reference.ops.fps import fps_plain, furthest_point_sample
from bench_port.reference.ops.grouping import gather_points, group_points
from bench_port.reference.ops.interpolate import three_interpolate, three_nn
from bench_port.reference.ops.ode_rk4 import compute_dtype_of
from bench_port.reference.parallel.mesh import batch_randn


def _inputs(xyz, features, use_xyz: bool):
    if features is not None and use_xyz:
        return torch.cat([xyz, features], dim=-1)
    return features if features is not None else xyz


class SetAbstractionMSG(nn.Module):
    def __init__(self, in_channels: int, npoint: Optional[int], radii: Sequence,
                 nsamples: Sequence, mlps: Sequence[Sequence[int]], use_xyz: bool = True):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.use_xyz = use_xyz
        c_in = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlps = nn.ModuleList(SharedMLP((c_in,) + tuple(w)) for w in mlps)
        self.out_channels = sum(w[-1] for w in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], train: bool,
                dtype: torch.dtype = torch.float32, plain: bool = False):
        """(xyz (B, N, 3), features (B, N, C) | None) -> (new_xyz (B, npoint, 3)
        | None, (B, npoint | 1, sum C_out) float32).

        A grouped stage runs FPS on this stage's points, projects every point
        once at the first hidden width (float32, as the JAX module does in
        every setting), gathers the projections of each centroid's ball and
        subtracts the centroid's own (``center @ W[:3]``), then float32 BN +
        ReLU, the rest of the SharedMLP in ``dtype`` and a max over slots
        (``amax``: ties share the gradient, as JAX's max does). ``plain``
        runs the plain versions of the FPS and ball-query kernels."""
        if self.npoint is None:  # GroupAll: one centroid over every point, float32
            grouped = _inputs(xyz, features, self.use_xyz)
            return None, torch.cat([mlp(grouped, train).amax(dim=1, keepdim=True)
                                    for mlp in self.mlps], dim=-1)
        xyz = xyz.float().contiguous()
        idx = (fps_plain if plain else furthest_point_sample)(xyz, self.npoint)
        new_xyz = gather_points(xyz, idx)
        inp = _inputs(xyz, features, self.use_xyz)
        outs = []
        for mlp, radius, nsample in zip(self.mlps, self.radii, self.nsamples):
            lay0 = mlp.layer0
            kernel = lay0.conv.weight[:, :, 0, 0].t()  # (3 + C, h1)
            g_idx = (ball_query_plain if plain else ball_query)(xyz, new_xyz, radius, nsample)
            grouped = group_points(inp.float() @ kernel, g_idx)  # (B, npoint, S, h1)
            if self.use_xyz:
                grouped = grouped - (new_xyz @ kernel[:3])[:, :, None, :]
            pre = torch.relu(batch_norm(grouped, lay0.bn.bn, train))
            outs.append(mlp(pre, train, dtype, start=1).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


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

    def forward(self, pointcloud: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None, plain: bool = False):
        """pointcloud (B, N, 3 + C) -> (B, C_final) float32."""
        dt = compute_dtype_of(self.cfg.compute_dtype)
        xyz = pointcloud[..., :3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        for sa in self.SA_modules:
            xyz, features = sa(xyz, features, train, dt, plain)
        return features.squeeze(1)


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

    def forward(self, pointcloud: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None, plain: bool = False):
        """pointcloud (B, N, 3 + dino_dim) -> (B, C_final) float32. In train
        mode the whole input (DINO channels too) gets N(0, 1) * input_jitter
        noise and each gated fusion's output dropout, both from
        ``generator``; the gated fusions run in the compute dtype, the rel-PE
        blocks in float32."""
        cfg = self.cfg
        dt = compute_dtype_of(cfg.compute_dtype)
        if train and cfg.input_jitter:
            noise = batch_randn(pointcloud.shape, generator, pointcloud.device)
            pointcloud = pointcloud + noise * cfg.input_jitter
        xyz = pointcloud[..., :3]
        features = pointcloud[..., 3:]
        downsampled = features
        for k, sa in enumerate(self.SA_modules):
            if k > 0:
                if downsampled.shape[1] != features.shape[1]:
                    downsampled = linear_resize_points(downsampled, features.shape[1])
                features = self.feature_fusions[k - 1](features, downsampled, train, dt)
                features = dropout(features, cfg.dropout, generator, train)
            new_xyz, features = sa(xyz, features, train, dt, plain)
            bias = None if new_xyz is None else self.relative_pos_encoders[str(k)](new_xyz)
            features = self.transformer_blocks[k](features, bias, train, cfg.dropout, generator)
            xyz = new_xyz
        return features.squeeze(1)


class FeaturePropagation(nn.Module):
    """Feature propagation (upsampling) of the segmentation encoder: the
    coarse features interpolated to the fine points by inverse distance over
    their three nearest coarse points, the fine points' own features
    appended, then a float32 SharedMLP. State dict: ``mlp.layer{i}``."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP((in_channels,) + tuple(mlp))
        self.out_channels = mlp[-1]

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor,
                train: bool) -> torch.Tensor:
        """unknown (B, n, 3), known (B, m, 3) or None (``known_feats`` (B, 1,
        C2) then goes to every point), unknown_feats (B, n, C1) or None,
        known_feats (B, m, C2) -> (B, n, mlp[-1])."""
        if known is not None:
            dist, idx = three_nn(unknown, known)
            recip = 1.0 / (dist + 1e-8)
            weight = recip / torch.sum(recip, dim=2, keepdim=True)
            interp = three_interpolate(known_feats, idx, weight)
        else:
            interp = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                        known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp, train)


class PointNet2SegMSG(nn.Module):
    """The segmentation-style encoder: ``len(fp_mlps)`` SA stages of ``cfg``
    down, as many feature propagations up, then the per-point classification
    tail (a SharedMLP layer and dropout per ``cls_fc`` width, then a Linear
    to one logit). Its FPS and ball queries are the kernels' on the card.

    State dict: ``SA_modules.{k}`` (as PointNet2ClsMSG), ``FP_modules.{i}``
    (FeaturePropagation; module i lifts level i + 1 to level i),
    ``cls_fc.{j}`` (SharedMLP) and ``cls_out`` (Linear). No reference
    checkpoint of this encoder exists; the names follow the reference's
    module names where it has them."""

    def __init__(self, cfg: PointNet2Config, in_channels: int = 0,
                 fp_mlps: Sequence[Sequence[int]] = ((64, 64), (128, 128), (256, 256),
                                                     (512, 512)),
                 cls_fc: Sequence[int] = (128,), dropout: float = 0.5):
        super().__init__()
        self.cfg, self.dropout = cfg, dropout
        widths, mods = [in_channels], []
        for k in range(len(fp_mlps)):
            sa = SetAbstractionMSG(widths[-1], cfg.npoints[k], cfg.radii[k], cfg.nsamples[k],
                                   cfg.mlps[k], cfg.use_xyz)
            mods.append(sa)
            widths.append(sa.out_channels)
        self.SA_modules = nn.ModuleList(mods)
        fps = [None] * len(fp_mlps)
        coarse = widths[-1]
        for i in range(len(fp_mlps), 0, -1):
            fps[i - 1] = FeaturePropagation(coarse + widths[i - 1], fp_mlps[i - 1])
            coarse = fps[i - 1].out_channels
        self.FP_modules = nn.ModuleList(fps)
        cls = []
        for f in cls_fc:
            cls.append(SharedMLP((coarse, f)))
            coarse = f
        self.cls_fc = nn.ModuleList(cls)
        self.cls_out = nn.Linear(coarse, 1)

    def forward(self, pointcloud: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None, plain: bool = False):
        """pointcloud (B, N, 3 + C) -> per-point logits (B, N, 1) float32. The
        SA stages run in cfg.compute_dtype, the rest in float32; in train mode
        the tail's dropout draws from ``generator``. ``plain`` runs the plain
        versions of the FPS and ball-query kernels."""
        dt = compute_dtype_of(self.cfg.compute_dtype)
        l_xyz = [pointcloud[..., :3].float()]
        l_feats = [pointcloud[..., 3:].float() if pointcloud.shape[-1] > 3 else None]
        for sa in self.SA_modules:
            new_xyz, feats = sa(l_xyz[-1], l_feats[-1], train, dt, plain)
            l_xyz.append(new_xyz)
            l_feats.append(feats)
        for i in range(len(self.FP_modules), 0, -1):
            l_feats[i - 1] = self.FP_modules[i - 1](l_xyz[i - 1], l_xyz[i], l_feats[i - 1],
                                                    l_feats[i], train)
        h = l_feats[0]
        for mlp in self.cls_fc:
            h = dropout(mlp(h, train), self.dropout, generator, train)
        return self.cls_out(h)
