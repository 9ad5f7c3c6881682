# Frozen copy of genpose2_tpu_torch/ops/fused_sa.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten, 3 kernel route(s) removed. Do not edit.
"""Fused set abstraction (port of genpose2_tpu/ops/fused_sa.py): per MSG scale
and centroid, the grouping of the projected point features, centering, the
folded-BN affine, the SharedMLP chain and the max over slots.

- ``fused_sa_stage``: every scale of one stage in one launch, hits from the
  in-kernel ball query, the scales' outputs concatenated;
- ``fused_sa_scale``: one scale, hits from the in-kernel ball query;
- ``fused_group_mlp_pool``: one scale, hits from precomputed indices; an index
  outside [0, N) groups a zero row, as the TPU kernel's one-hot product does.

``stage_route`` is the JAX package's choice between the first and one
``fused_sa_scale`` per scale (its VMEM estimate against 12 MB), so that both
packages run the same kernels on every stage.

Each op launches its CUDA kernel (``csrc/fused_sa.cu``) on CUDA tensors and
runs its plain version on CPU tensors. The plain versions are the JAX
package's ``fused_group_mlp_pool_reference`` on the indices of
``ball_query_plain`` (or the given ones), with the kernel's operand rounding:
the input of each product is rounded to the weights' dtype and the product is
taken in float32, as ``jnp.dot(h.astype(W.dtype), W, preferred_element_type=f32)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bench_port.reference_vit7b.ops.ball_query import ball_query_plain, radius_sq
from bench_port.reference_vit7b.ops.grouping import group_points

_MAX_SCALES = 4  # csrc/fused_sa.cu kMaxScales
_MAX_LAYERS = 4  # csrc/fused_sa.cu kMaxLayers
_PTRS_PER_SCALE = 4 + 3 * _MAX_LAYERS
_VMEM_BUDGET = 12 * 1024 * 1024  # genpose2_tpu/ops/fused_sa.py:553


def _mm(h: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return h.to(W.dtype).float() @ W.float()


def group_mlp_pool(proj, idx, center_proj, affines, weights):
    """proj (B, N, h1), idx (B, M, S), center_proj (B, M, h1) -> (B, M, C_out);
    an index outside [0, N) groups a zero row."""
    inside = (idx >= 0) & (idx < proj.shape[1])
    g = group_points(proj.float(), torch.where(inside, idx, torch.zeros_like(idx)))
    g = torch.where(inside[..., None], g, torch.zeros_like(g))
    h = g - center_proj[:, :, None, :].float()
    a0, c0 = affines[0]
    h = torch.relu(h * a0 + c0)
    for W, (a, c) in zip(weights, affines[1:]):
        h = torch.relu(_mm(h, W) * a + c)
    return h.amax(dim=2)


fused_group_mlp_pool_plain = group_mlp_pool


def fused_sa_scale_plain(xyz, new_xyz, proj, center_proj, affines, weights, radius: float,
                         nsample: int) -> torch.Tensor:
    return group_mlp_pool(proj, ball_query_plain(xyz, new_xyz, radius, nsample), center_proj,
                          affines, weights)


def fused_sa_stage_plain(xyz, new_xyz, projs, center_projs, affines_list, weights_list,
                         radii: Sequence[float], nsamples: Sequence[int]) -> torch.Tensor:
    return torch.cat([fused_sa_scale_plain(xyz, new_xyz, projs[s], center_projs[s],
                                           affines_list[s], weights_list[s], radii[s],
                                           nsamples[s])
                      for s in range(len(radii))], dim=-1)


def stage_route(n_points: int, n_centroids: int, projs, affines_list, weights_list,
                nsamples: Sequence[int], slot_chunk: int, row_tile: int = 128) -> str:
    """'stage' (one ``fused_sa_stage`` launch) or 'scale' (one ``fused_sa_scale``
    launch per scale): the JAX package's decision in
    genpose2_tpu/ops/fused_sa.py:fused_sa_stage, byte for byte, from the
    operands' shapes and dtypes (projs[s] (B, N, h1_s), affines_list and
    weights_list as ``fused_sa_stage`` takes them)."""
    TM = min(row_tile, n_centroids)
    Np = ((n_points + 127) // 128) * 128
    c_out = sum(aff[-1][0].shape[0] for aff in affines_list)
    est = (3 * Np + 3 * TM) * 4 + TM * c_out * 8
    est += 6 * TM * Np * 4
    transient = 0
    for proj, affines, weights, ns in zip(projs, affines_list, weights_list, nsamples):
        h1 = proj.shape[-1]
        sc = min(slot_chunk, ns)
        widths = [h1] + [a.shape[0] for a, _ in affines[1:]]
        est += Np * h1 * proj.element_size()
        est += TM * h1 * 4
        est += sum(w.numel() * w.element_size() for w in weights)
        transient = max(transient,
                        sc * TM * (Np * (4 + proj.element_size()) + 4 * max(widths) * 4))
    est += transient
    return "scale" if est > _VMEM_BUDGET else "stage"


def fused_sa_stage(xyz: torch.Tensor, new_xyz: torch.Tensor, projs, center_projs,
                   affines_list, weights_list, radii: Sequence[float],
                   nsamples: Sequence[int]) -> torch.Tensor:
    """Every MSG scale of one SA stage.

    xyz (B, N, 3), new_xyz (B, M, 3); per scale s: projs[s] (B, N, h1_s) in
    the compute dtype, center_projs[s] (B, M, h1_s) float32,
    affines_list[s] = [(a, c) per layer incl. the projection's], each (h,)
    float32, weights_list[s] = [W (h_in, h_out) in the compute dtype]
    -> (B, M, sum_s C_out_s) float32."""
    return fused_sa_stage_plain(xyz, new_xyz, projs, center_projs, affines_list,
                                weights_list, radii, nsamples)


def fused_sa_scale(xyz: torch.Tensor, new_xyz: torch.Tensor, proj: torch.Tensor,
                   center_proj: torch.Tensor, affines, weights, radius: float,
                   nsample: int) -> torch.Tensor:
    """One MSG scale with its ball query: the arguments of one scale of
    ``fused_sa_stage`` -> (B, M, C_out) float32. new_xyz may come in any order
    (the dense stage sorts it by ``ball_count``); each centroid's output
    depends on its own hits only."""
    return fused_sa_scale_plain(xyz, new_xyz, proj, center_proj, affines, weights, radius,
                                nsample)


def fused_group_mlp_pool(proj: torch.Tensor, idx: torch.Tensor, center_proj: torch.Tensor,
                         affines, weights) -> torch.Tensor:
    """Group, center, affine, MLP and max-pool from indices: proj (B, N, h1)
    in the compute dtype, idx (B, M, S) integer, center_proj (B, M, h1)
    float32, affines / weights as one scale of ``fused_sa_stage``
    -> (B, M, C_out) float32. An index outside [0, N) groups a zero row."""
    return fused_group_mlp_pool_plain(proj, idx, center_proj, affines, weights)
