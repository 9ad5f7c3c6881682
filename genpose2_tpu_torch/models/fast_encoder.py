"""Eval fast paths of the PointNet++ MSG encoders (port of
genpose2_tpu/models/fast_encoder.py:fast_cls_forward and fast_fus_forward).

- One FPS run serves every stage: stage k's centroids are the first
  npoints[k] picks of the stage-0 run (``_fps_prefix_centroids``).
- BatchNorms are folded into per-layer affines.
- Each grouped stage projects all points once to the first hidden width
  (``inp @ proj_kernel``, plain torch), then runs all its scales in one
  fused SA kernel launch, or one launch per scale where the JAX package does
  (``stage_route``: at 2,048 points, stage 0).
- At N >= 1024 (the dense stage) centroids are ordered by their in-radius
  count (``ball_count``, largest radius of the stage) before the kernel and
  the output is put back in FPS order after it. The order changes no value:
  it gives each kernel block centroids of similar count.
- The GroupAll stage is plain torch and stays float32 in bf16 configs, as in
  the JAX package.
- The Fus encoder (dino='pointwise') adds a gated fusion with the resized
  DINO features before stages 1.. (``_fast_gaf``) and a rel-PE transformer
  block after every stage: the grouped stages' through the rel-PE attention
  and residual-LayerNorm kernels (``_relpe_block``), the GroupAll stage's as
  the plain float32 module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from genpose2_tpu_torch.config import PointNet2Config
from genpose2_tpu_torch.models.attention import (GatedAttentionFusion,
                                                 TransformerBlockWithRelativePE)
from genpose2_tpu_torch.models.layers import fold_bn, linear_resize_points, mm
from genpose2_tpu_torch.models.pointnet2 import (PointNet2ClsMSG, PointNet2ClsMSGFus,
                                                 SetAbstractionMSG, _inputs)
from genpose2_tpu_torch.ops.ball_query import ball_count
from genpose2_tpu_torch.ops.fps import furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_scale, fused_sa_stage, stage_route
from genpose2_tpu_torch.ops.grouping import gather_points
from genpose2_tpu_torch.ops.layernorm import fast_residual_layernorm
from genpose2_tpu_torch.ops.ode_rk4 import compute_dtype_of
from genpose2_tpu_torch.ops.relpe_attention import relpe_attention


def stage_arguments(sa: SetAbstractionMSG, inp: torch.Tensor, nxs: torch.Tensor,
                    use_xyz: bool, dt: torch.dtype):
    """The fused SA kernel's per-scale operands for one grouped stage:
    (projs, center_projs, affines_list, weights_list)."""
    projs, centers, affines_list, weights_list = [], [], [], []
    for mlp in sa.mlps:
        kern, a0, c0 = mlp.folded(0)  # (3 + C, h1): the projection
        projs.append((inp @ kern).to(dt))
        if use_xyz:
            centers.append((nxs @ kern[:3]).float())
        else:  # the module only centers when use_xyz
            centers.append(nxs.new_zeros(nxs.shape[:2] + (kern.shape[1],)))
        affines, weights = [(a0, c0)], []
        for li in range(1, mlp.num_layers):
            W, a, c = mlp.folded(li)
            weights.append(W.to(dt))
            affines.append((a, c))
        affines_list.append(affines)
        weights_list.append(weights)
    return projs, centers, affines_list, weights_list


def _fast_sa_stage(sa: SetAbstractionMSG, xyz, features, cfg: PointNet2Config, dt,
                   new_xyz):
    if sa.npoint is None:
        grouped = _inputs(xyz, features, cfg.use_xyz)
        outs = []
        for mlp in sa.mlps:
            h = grouped.float()
            for li in range(mlp.num_layers):
                W, a, c = mlp.folded(li)
                h = torch.relu((h @ W) * a + c)
            outs.append(h.amax(dim=1, keepdim=True))
        return None, torch.cat(outs, dim=-1)

    if new_xyz is None:
        idx = furthest_point_sample(xyz, sa.npoint)
        new_xyz = gather_points(xyz, idx)
    inp = _inputs(xyz, features, cfg.use_xyz)

    use_skip = xyz.shape[1] >= 1024
    if use_skip:
        radius = max(r for r in sa.radii if r is not None)
        cnt = ball_count(xyz, new_xyz, radius)
        order = torch.argsort(-cnt, dim=1, stable=True)
        inv_order = torch.argsort(order, dim=1)
        nxs = gather_points(new_xyz, order)
    else:
        nxs = new_xyz

    args = stage_arguments(sa, inp, nxs, cfg.use_xyz, dt)
    # the JAX package's route: one stage launch, or one launch per scale when
    # its VMEM estimate is over budget (slot_chunk as fast_encoder.py:205)
    projs, centers, affines_list, weights_list = args
    route = stage_route(xyz.shape[1], nxs.shape[1], projs, affines_list, weights_list,
                        sa.nsamples, 4 if use_skip else 8)
    if route == "stage":
        cat = fused_sa_stage(xyz, nxs, *args, sa.radii, sa.nsamples)
    else:  # scale outputs concatenated in scale order
        cat = torch.cat([fused_sa_scale(xyz, nxs, projs[s], centers[s], affines_list[s],
                                        weights_list[s], sa.radii[s], sa.nsamples[s])
                         for s in range(len(sa.radii))], dim=-1)
    if use_skip:
        cat = gather_points(cat, inv_order)
    return new_xyz, cat


def _fps_prefix_centroids(xyz, cfg: PointNet2Config):
    """The pick-ordered centroids of one stage-0 FPS run, whose prefixes are
    every later stage's centroids; None when npoints is not a shrinking chain."""
    ns = [n for n in cfg.npoints if n is not None]
    if not ns or any(b > a for a, b in zip(ns, ns[1:])):
        return None
    idx = furthest_point_sample(xyz, ns[0])
    return gather_points(xyz, idx)


def _dense(conv: torch.nn.Conv1d):
    """A 1x1 Conv1d as (W (in, out), b)."""
    return conv.weight[:, :, 0].t(), conv.bias


def _fast_gaf(gaf: GatedAttentionFusion, current: torch.Tensor, original: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """Eval GatedAttentionFusion (port of fast_encoder.py:_fast_gaf): BatchNorms
    folded, products in the compute dtype, the gate's product over
    concat(current, attended) split into two halves, the k=7 spatial conv as
    shifted multiply-adds with 3 zeros of padding on each side.
    current (B, M, C) float32, original (B, M', C_orig) -> (B, M, C) float32."""
    C, M = current.shape[-1], current.shape[1]
    original = linear_resize_points(original, M)

    W0, b0 = _dense(gaf.original_transform[0])
    a0, c0 = fold_bn(gaf.original_transform[1])
    orig_t = torch.relu((mm(original, W0, dt) + b0) * a0 + c0)

    pooled = torch.cat([current.mean(1, keepdim=True), orig_t.mean(1, keepdim=True)], dim=-1)
    W1, b1 = _dense(gaf.channel_attention[1])
    W2, b2 = _dense(gaf.channel_attention[3])
    ca = torch.sigmoid(mm(torch.relu(mm(pooled, W1, dt) + b1), W2, dt) + b2)  # (B, 1, C)

    kern = gaf.spatial_attention[0].weight[0].float()  # (2, 7): [max, mean] x taps
    mxp = F.pad(current.amax(-1), (3, 3))
    avp = F.pad(current.mean(-1), (3, 3))
    logit = torch.zeros_like(current[..., 0])
    for i in range(7):
        logit = logit + mxp[:, i:i + M] * kern[0, i]
        logit = logit + avp[:, i:i + M] * kern[1, i]
    attended = orig_t * ca * torch.sigmoid(logit)[..., None]

    Wg, bg = _dense(gaf.gate[0])
    ag, cg = fold_bn(gaf.gate[1])
    gate = torch.sigmoid((mm(current, Wg[:C], dt) + mm(attended, Wg[C:], dt) + bg) * ag + cg)
    fused = gate * current + (1.0 - gate) * attended

    W4, b4 = _dense(gaf.output_conv[0])
    a4, c4 = fold_bn(gaf.output_conv[1])
    return torch.relu((mm(fused, W4, dt) + b4) * a4 + c4)


def _linear(x: torch.Tensor, lin: torch.nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return mm(x, lin.weight.t(), dt) + lin.bias


def _relpe_block(tb: TransformerBlockWithRelativePE, pe, xyz, features, cfg: PointNet2Config,
                 dt):
    """One grouped stage's post-norm rel-PE block through the attention and
    residual-LayerNorm kernels; products in the compute dtype, residuals,
    biases and LayerNorm statistics float32."""
    att = tb.self_attn
    q, k, v = (_linear(features, lin, dt) for lin in (att.wq, att.wk, att.wv))
    attn = _linear(relpe_attention(xyz, q, k, v, pe, cfg.num_heads, cfg.compute_dtype),
                   att.wo, dt)
    h = fast_residual_layernorm(features, attn, tb.norm1.weight, tb.norm1.bias)
    ff = _linear(torch.relu(_linear(h, tb.linear1, dt)), tb.linear2, dt)
    return fast_residual_layernorm(h, ff, tb.norm2.weight, tb.norm2.bias)


@torch.no_grad()
def fast_fus_forward(encoder: PointNet2ClsMSGFus, pointcloud: torch.Tensor,
                     cfg: PointNet2Config) -> torch.Tensor:
    """Eval fast path of the Fus encoder (port of fast_encoder.py:fast_fus_forward):
    pointcloud (B, N, 3 + dino_dim) -> (B, C_final) float32. Stage k > 0 first
    fuses the stage input with the DINO features resized to its point count;
    every stage ends in its rel-PE block (GroupAll: the plain float32 module)."""
    dt = compute_dtype_of(cfg.compute_dtype)
    xyz = pointcloud[..., :3].float().contiguous()
    features = pointcloud[..., 3:].float()
    downsampled = features
    S = _fps_prefix_centroids(xyz, cfg)
    for k, sa in enumerate(encoder.SA_modules):
        if k > 0:
            downsampled = linear_resize_points(downsampled, features.shape[1])
            features = _fast_gaf(encoder.feature_fusions[k - 1], features, downsampled, dt)
        new_xyz = None if (S is None or sa.npoint is None) else S[:, : sa.npoint]
        new_xyz, features = _fast_sa_stage(sa, xyz, features, cfg, dt, new_xyz)
        tb = encoder.transformer_blocks[k]
        if new_xyz is not None:
            features = _relpe_block(tb, encoder.relative_pos_encoders[str(k)], new_xyz,
                                    features, cfg, dt)
        else:
            features = tb(features.float())
        xyz = new_xyz
    return features.squeeze(1)


@torch.no_grad()
def fast_cls_forward(encoder: PointNet2ClsMSG, pointcloud: torch.Tensor,
                     cfg: PointNet2Config) -> torch.Tensor:
    """pointcloud (B, N, 3 + C) -> (B, C_final) float32."""
    dt = compute_dtype_of(cfg.compute_dtype)
    xyz = pointcloud[..., :3].float().contiguous()
    features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
    S = _fps_prefix_centroids(xyz, cfg)
    for sa in encoder.SA_modules:
        new_xyz = None if (S is None or sa.npoint is None) else S[:, : sa.npoint]
        xyz, features = _fast_sa_stage(sa, xyz, features, cfg, dt, new_xyz)
    return features.squeeze(1)
