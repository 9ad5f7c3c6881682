"""Eval fast path of the PointNet++ MSG encoder (port of
genpose2_tpu/models/fast_encoder.py:fast_cls_forward).

- One FPS run serves every stage: stage k's centroids are the first
  npoints[k] picks of the stage-0 run (``_fps_prefix_centroids``).
- BatchNorms are folded into per-layer affines.
- Each grouped stage projects all points once to the first hidden width
  (``inp @ proj_kernel``, plain torch), then runs all its scales in one
  fused SA kernel launch.
- At N >= 1024 (the dense stage) centroids are ordered by their in-radius
  count (``ball_count``, largest radius of the stage) before the kernel and
  the output is put back in FPS order after it. The order changes no value:
  it gives each kernel block centroids of similar count.
- The GroupAll stage is plain torch and stays float32 in bf16 configs, as in
  the JAX package.

``plain=True`` runs the plain versions of the three kernels on any device;
it is there to hold the kernels against them on the card.
"""

from __future__ import annotations

import torch

from genpose2_tpu_torch.config import PointNet2Config
from genpose2_tpu_torch.models.pointnet2 import PointNet2ClsMSG, SetAbstractionMSG
from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain
from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
from genpose2_tpu_torch.ops.grouping import gather_points
from genpose2_tpu_torch.ops.ode_rk4 import compute_dtype_of


def _inputs(xyz, features, use_xyz: bool):
    if features is not None and use_xyz:
        return torch.cat([xyz, features], dim=-1)
    return features if features is not None else xyz


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
                   new_xyz, plain: bool):
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
        idx = (fps_plain if plain else furthest_point_sample)(xyz, sa.npoint)
        new_xyz = gather_points(xyz, idx)
    inp = _inputs(xyz, features, cfg.use_xyz)

    use_skip = xyz.shape[1] >= 1024
    if use_skip:
        radius = max(r for r in sa.radii if r is not None)
        cnt = (ball_count_plain if plain else ball_count)(xyz, new_xyz, radius)
        order = torch.argsort(-cnt, dim=1, stable=True)
        inv_order = torch.argsort(order, dim=1)
        nxs = gather_points(new_xyz, order)
    else:
        nxs = new_xyz

    args = stage_arguments(sa, inp, nxs, cfg.use_xyz, dt)
    run = fused_sa_stage_plain if plain else fused_sa_stage
    cat = run(xyz, nxs, *args, sa.radii, sa.nsamples)
    if use_skip:
        cat = gather_points(cat, inv_order)
    return new_xyz, cat


def _fps_prefix_centroids(xyz, cfg: PointNet2Config, plain: bool):
    """The pick-ordered centroids of one stage-0 FPS run, whose prefixes are
    every later stage's centroids; None when npoints is not a shrinking chain."""
    ns = [n for n in cfg.npoints if n is not None]
    if not ns or any(b > a for a, b in zip(ns, ns[1:])):
        return None
    idx = (fps_plain if plain else furthest_point_sample)(xyz, ns[0])
    return gather_points(xyz, idx)


@torch.no_grad()
def fast_cls_forward(encoder: PointNet2ClsMSG, pointcloud: torch.Tensor,
                     cfg: PointNet2Config, plain: bool = False) -> torch.Tensor:
    """pointcloud (B, N, 3 + C) -> (B, C_final) float32."""
    dt = compute_dtype_of(cfg.compute_dtype)
    xyz = pointcloud[..., :3].float().contiguous()
    features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
    S = _fps_prefix_centroids(xyz, cfg, plain)
    for sa in encoder.SA_modules:
        new_xyz = None if (S is None or sa.npoint is None) else S[:, : sa.npoint]
        xyz, features = _fast_sa_stage(sa, xyz, features, cfg, dt, new_xyz, plain)
    return features.squeeze(1)
