"""Fused set-abstraction stage (port of genpose2_tpu/ops/fused_sa.py:fused_sa_stage).

Per MSG scale and centroid: ball query, grouping of the projected point
features, centering, the folded-BN affine, the SharedMLP chain and the max
over slots; the scales' outputs are concatenated.

``fused_sa_stage`` launches the CUDA kernel (``csrc/fused_sa.cu``) on CUDA
tensors and runs ``fused_sa_stage_plain`` on CPU tensors. The plain version is
the JAX package's ``fused_group_mlp_pool_reference`` applied per scale to the
indices of ``ball_query_plain``, with the kernel's operand rounding: the input of
each product is rounded to the weights' dtype and the product is taken in
float32, as ``jnp.dot(h.astype(W.dtype), W, preferred_element_type=f32)``.
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


def _mm(h: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return h.to(W.dtype).float() @ W.float()


def group_mlp_pool(proj, idx, center_proj, affines, weights):
    """proj (B, N, h1), idx (B, M, S), center_proj (B, M, h1) -> (B, M, C_out)."""
    h = group_points(proj.float(), idx) - center_proj[:, :, None, :].float()
    a0, c0 = affines[0]
    h = torch.relu(h * a0 + c0)
    for W, (a, c) in zip(weights, affines[1:]):
        h = torch.relu(_mm(h, W) * a + c)
    return h.amax(dim=2)


def fused_sa_stage_plain(xyz, new_xyz, projs, center_projs, affines_list, weights_list,
                         radii: Sequence[float], nsamples: Sequence[int]) -> torch.Tensor:
    outs = []
    for s in range(len(radii)):
        idx = ball_query_plain(xyz, new_xyz, radii[s], nsamples[s])
        outs.append(group_mlp_pool(projs[s], idx, center_projs[s], affines_list[s],
                                   weights_list[s]))
    return torch.cat(outs, dim=-1)


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
    dt = projs[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"proj dtype {dt}; the kernel takes float32 or bfloat16")
    widths = [0] * (S * (_MAX_LAYERS + 1))
    ptrs = [0] * (S * (4 + 3 * _MAX_LAYERS))
    num_layers = []
    c_total = 0
    for s in range(S):
        h1 = projs[s].shape[-1]
        L = len(weights_list[s])
        if L > _MAX_LAYERS or len(affines_list[s]) != L + 1:
            raise ValueError(f"scale {s}: {L} layers, {len(affines_list[s])} affines")
        _cuda.require(projs[s], f"projs[{s}]", dt, (B, N, h1), dev)
        _cuda.require(center_projs[s], f"center_projs[{s}]", torch.float32, (B, M, h1), dev)
        # per scale: proj, center, a0, c0, then W, a, c of each layer
        entries = [projs[s], center_projs[s], *affines_list[s][0]]
        ws = [h1]
        for li, (W, (a, c)) in enumerate(zip(weights_list[s], affines_list[s][1:])):
            _cuda.require(W, f"weights[{s}][{li}]", dt, (ws[-1], W.shape[1]), dev)
            ws.append(W.shape[1])
            entries += [W, a, c]
        for li, (a, c) in enumerate(affines_list[s]):
            _cuda.require(a, f"affine a[{s}][{li}]", torch.float32, (ws[li],), dev)
            _cuda.require(c, f"affine c[{s}][{li}]", torch.float32, (ws[li],), dev)
        base = s * (4 + 3 * _MAX_LAYERS)
        ptrs[base:base + len(entries)] = [t.data_ptr() for t in entries]
        widths[s * (_MAX_LAYERS + 1): s * (_MAX_LAYERS + 1) + L + 1] = ws
        num_layers.append(L)
        c_total += ws[-1]

    lib = _cuda.library("fused_sa")
    c_r2 = (ctypes.c_float * S)(*[radius_sq(r) for r in radii])
    c_ns = (ctypes.c_int * S)(*[int(n) for n in nsamples])
    c_nl = (ctypes.c_int * S)(*num_layers)
    c_w = (ctypes.c_int * len(widths))(*widths)
    c_p = (ctypes.c_void_p * len(ptrs))(*ptrs)
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


def fused_sa_stage(xyz: torch.Tensor, new_xyz: torch.Tensor, projs, center_projs,
                   affines_list, weights_list, radii: Sequence[float],
                   nsamples: Sequence[int]) -> torch.Tensor:
    """Every MSG scale of one SA stage.

    xyz (B, N, 3), new_xyz (B, M, 3); per scale s: projs[s] (B, N, h1_s) in
    the compute dtype, center_projs[s] (B, M, h1_s) float32,
    affines_list[s] = [(a, c) per layer incl. the projection's], each (h,)
    float32, weights_list[s] = [W (h_in, h_out) in the compute dtype]
    -> (B, M, sum_s C_out_s) float32."""
    if xyz.device.type == "cpu":
        return fused_sa_stage_plain(xyz, new_xyz, projs, center_projs, affines_list,
                                    weights_list, radii, nsamples)
    return _sa_stage_cuda(xyz.detach().contiguous(), new_xyz.detach().contiguous(),
                          [p.contiguous() for p in projs],
                          [c.contiguous() for c in center_projs],
                          [[(a.contiguous(), c.contiguous()) for a, c in aff]
                           for aff in affines_list],
                          [[w.contiguous() for w in ws] for ws in weights_list],
                          radii, nsamples)
