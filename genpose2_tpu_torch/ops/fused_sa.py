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
runs its plain version otherwise (``_cuda.launches``). The plain versions are the JAX
package's ``fused_group_mlp_pool_reference`` on the indices of
``ball_query_plain`` (or the given ones), with the kernel's operand rounding:
the input of each product is rounded to the weights' dtype and the product is
taken in float32, as ``jnp.dot(h.astype(W.dtype), W, preferred_element_type=f32)``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ball_query import ball_query_plain, radius_sq
from genpose2_tpu_torch.ops.grouping import group_points

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


def _pack_scale(proj, center, affines, weights, dt, B, N, M, dev, what: str):
    """Check one scale's operands; returns (tensors in the kernel's pointer
    order, layer widths, number of layers)."""
    h1 = proj.shape[-1]
    L = len(weights)
    if L > _MAX_LAYERS or len(affines) != L + 1:
        raise ValueError(f"{what}: {L} layers, {len(affines)} affines")
    _cuda.require(proj, f"proj{what}", dt, (B, N, h1), dev)
    _cuda.require(center, f"center_proj{what}", torch.float32, (B, M, h1), dev)
    # proj, center, a0, c0, then W, a, c of each layer
    entries = [proj, center, *affines[0]]
    ws = [h1]
    for li, (W, (a, c)) in enumerate(zip(weights, affines[1:])):
        _cuda.require(W, f"weights{what}[{li}]", dt, (ws[-1], W.shape[1]), dev)
        ws.append(W.shape[1])
        entries += [W, a, c]
    for li, (a, c) in enumerate(affines):
        _cuda.require(a, f"affine a{what}[{li}]", torch.float32, (ws[li],), dev)
        _cuda.require(c, f"affine c{what}[{li}]", torch.float32, (ws[li],), dev)
    return entries, ws, L


def _compute_dtype(proj: torch.Tensor) -> torch.dtype:
    if proj.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"proj dtype {proj.dtype}; the kernel takes float32 or bfloat16")
    return proj.dtype


def _layout(scales):
    """ctypes arrays of the packed scales' widths and pointers."""
    widths = [0] * (len(scales) * (_MAX_LAYERS + 1))
    ptrs = [0] * (len(scales) * _PTRS_PER_SCALE)
    for s, (entries, ws, _) in enumerate(scales):
        ptrs[s * _PTRS_PER_SCALE: s * _PTRS_PER_SCALE + len(entries)] = [t.data_ptr()
                                                                          for t in entries]
        widths[s * (_MAX_LAYERS + 1): s * (_MAX_LAYERS + 1) + len(ws)] = ws
    return (ctypes.c_int * len(widths))(*widths), (ctypes.c_void_p * len(ptrs))(*ptrs)


def _sa_stage_cuda(xyz, new_xyz, projs, center_projs, affines_list, weights_list, radii,
                   nsamples) -> torch.Tensor:
    dev = xyz.device
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    S = len(radii)
    if not 1 <= S <= _MAX_SCALES:
        raise ValueError(f"{S} scales; the kernel takes 1 to {_MAX_SCALES}")
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), dev)
    _cuda.require(new_xyz, "new_xyz", torch.float32, (B, M, 3), dev)
    dt = _compute_dtype(projs[0])
    scales = [_pack_scale(projs[s], center_projs[s], affines_list[s], weights_list[s], dt,
                          B, N, M, dev, f"[{s}]") for s in range(S)]
    c_total = sum(ws[-1] for _, ws, _ in scales)
    c_w, c_p = _layout(scales)
    lib = _cuda.library("fused_sa")
    c_r2 = (ctypes.c_float * S)(*[radius_sq(r) for r in radii])
    c_ns = (ctypes.c_int * S)(*[int(n) for n in nsamples])
    c_nl = (ctypes.c_int * S)(*[L for _, _, L in scales])
    out = torch.empty((B, M, c_total), dtype=torch.float32, device=dev)
    lib.gp2_sa_stage.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 \
        + [ctypes.c_int, ctypes.c_void_p]
    lib.gp2_sa_stage.restype = ctypes.c_int
    code = lib.gp2_sa_stage(xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), B, N, M, c_total,
                            S, c_r2, c_ns, c_nl, c_w, c_p, int(dt == torch.bfloat16),
                            _cuda.stream_ptr(xyz))
    _cuda.check(lib, code, "fused_sa_stage")
    _cuda.launch_counts["fused_sa_stage"] += 1
    return out


def _sa_scale_cuda(xyz, new_xyz, proj, center_proj, affines, weights, radius,
                   nsample) -> torch.Tensor:
    dev = xyz.device
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    _cuda.require(xyz, "xyz", torch.float32, (B, N, 3), dev)
    _cuda.require(new_xyz, "new_xyz", torch.float32, (B, M, 3), dev)
    if nsample < 1:
        raise ValueError(f"nsample {nsample} must be positive")
    scale = _pack_scale(proj, center_proj, affines, weights, _compute_dtype(proj), B, N, M, dev,
                        "")
    c_out = scale[1][-1]
    c_w, c_p = _layout([scale])
    out = torch.empty((B, M, c_out), dtype=torch.float32, device=dev)
    lib = _cuda.library("fused_sa")
    lib.gp2_sa_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.gp2_sa_scale.restype = ctypes.c_int
    code = lib.gp2_sa_scale(xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), B, N, M, c_out,
                            radius_sq(radius), int(nsample), scale[2], c_w, c_p,
                            int(proj.dtype == torch.bfloat16), _cuda.stream_ptr(xyz))
    _cuda.check(lib, code, "fused_sa_scale")
    _cuda.launch_counts["fused_sa_scale"] += 1
    return out


def _group_mlp_pool_cuda(proj, idx, center_proj, affines, weights) -> torch.Tensor:
    dev = proj.device
    B, N, _ = proj.shape
    M, S = idx.shape[1:]
    _cuda.require(idx, "idx", torch.int32, (B, M, S), dev)
    if S < 1:
        raise ValueError("idx has no slots")
    scale = _pack_scale(proj, center_proj, affines, weights, _compute_dtype(proj), B, N, M, dev,
                        "")
    c_out = scale[1][-1]
    c_w, c_p = _layout([scale])
    out = torch.empty((B, M, c_out), dtype=torch.float32, device=dev)
    lib = _cuda.library("fused_sa")
    lib.gp2_group_mlp_pool.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.gp2_group_mlp_pool.restype = ctypes.c_int
    code = lib.gp2_group_mlp_pool(idx.data_ptr(), out.data_ptr(), B, N, M, S, c_out, scale[2],
                                  c_w, c_p, int(proj.dtype == torch.bfloat16),
                                  _cuda.stream_ptr(proj))
    _cuda.check(lib, code, "fused_group_mlp_pool")
    _cuda.launch_counts["fused_group_mlp_pool"] += 1
    return out


def _contiguous(affines, weights):
    return [(a.contiguous(), c.contiguous()) for a, c in affines], [w.contiguous() for w in weights]


def fused_sa_stage(xyz: torch.Tensor, new_xyz: torch.Tensor, projs, center_projs,
                   affines_list, weights_list, radii: Sequence[float],
                   nsamples: Sequence[int]) -> torch.Tensor:
    """Every MSG scale of one SA stage.

    xyz (B, N, 3), new_xyz (B, M, 3); per scale s: projs[s] (B, N, h1_s) in
    the compute dtype, center_projs[s] (B, M, h1_s) float32,
    affines_list[s] = [(a, c) per layer incl. the projection's], each (h,)
    float32, weights_list[s] = [W (h_in, h_out) in the compute dtype]
    -> (B, M, sum_s C_out_s) float32."""
    if not _cuda.launches(xyz):
        return fused_sa_stage_plain(xyz, new_xyz, projs, center_projs, affines_list,
                                    weights_list, radii, nsamples)
    packed = [_contiguous(a, w) for a, w in zip(affines_list, weights_list)]
    return _sa_stage_cuda(xyz.detach().contiguous(), new_xyz.detach().contiguous(),
                          [p.contiguous() for p in projs],
                          [c.contiguous() for c in center_projs],
                          [a for a, _ in packed], [w for _, w in packed], radii, nsamples)


def fused_sa_scale(xyz: torch.Tensor, new_xyz: torch.Tensor, proj: torch.Tensor,
                   center_proj: torch.Tensor, affines, weights, radius: float,
                   nsample: int) -> torch.Tensor:
    """One MSG scale with its ball query: the arguments of one scale of
    ``fused_sa_stage`` -> (B, M, C_out) float32. new_xyz may come in any order
    (the dense stage sorts it by ``ball_count``); each centroid's output
    depends on its own hits only."""
    if not _cuda.launches(xyz):
        return fused_sa_scale_plain(xyz, new_xyz, proj, center_proj, affines, weights, radius,
                                    nsample)
    affines, weights = _contiguous(affines, weights)
    return _sa_scale_cuda(xyz.detach().contiguous(), new_xyz.detach().contiguous(),
                          proj.contiguous(), center_proj.contiguous(), affines, weights,
                          radius, nsample)


def fused_group_mlp_pool(proj: torch.Tensor, idx: torch.Tensor, center_proj: torch.Tensor,
                         affines, weights) -> torch.Tensor:
    """Group, center, affine, MLP and max-pool from indices: proj (B, N, h1)
    in the compute dtype, idx (B, M, S) integer, center_proj (B, M, h1)
    float32, affines / weights as one scale of ``fused_sa_stage``
    -> (B, M, C_out) float32. An index outside [0, N) groups a zero row."""
    if not _cuda.launches(proj):
        return fused_group_mlp_pool_plain(proj, idx, center_proj, affines, weights)
    affines, weights = _contiguous(affines, weights)
    return _group_mlp_pool_cuda(proj.contiguous(), idx.to(torch.int32).contiguous(),
                                center_proj.contiguous(), affines, weights)
