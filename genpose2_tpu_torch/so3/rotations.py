"""Rotation math on the serving path (port of a subset of
genpose2_tpu/so3/rotations.py).

Quaternions are (w, x, y, z). The 9D 'rot_matrix' pose is
``[col0(3), col1(3), trans(3)]``: the first two columns of the rotation
matrix, then the translation.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=_EPS)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = _normalize(q)
    w, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2.0 * (y * y + z * z), 2.0 * (x * y - z * w), 2.0 * (x * z + y * w),
            2.0 * (x * y + z * w), 1 - 2.0 * (x * x + z * z), 2.0 * (y * z - x * w),
            2.0 * (x * z - y * w), 2.0 * (y * z + x * w), 1 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz: the candidate built on the largest of the
    four |q_i|, as in pytorch3d."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = R.reshape(R.shape[:-2] + (9,)).unbind(-1)
    q_abs = torch.sqrt(torch.clamp(torch.stack(
        [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1), min=0.0))
    cands = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    cands = cands / (2.0 * torch.clamp(q_abs[..., None], min=0.1 * _EPS))
    best = torch.argmax(q_abs, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return _normalize(q)


def rot6d_cols_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) = [col0, col1] -> (..., 3, 3) by Gram-Schmidt."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d_cols(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 6) = [col0, col1]."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def get_rot_matrix(batch_rot: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Rotation part of a pose -> (..., 3, 3). Only 'rot_matrix' is ported."""
    if pose_mode == "rot_matrix":
        return rot6d_cols_to_matrix(batch_rot)
    raise NotImplementedError(f"pose_mode {pose_mode!r} is not ported yet (see ROADMAP.md)")


def normalize_rotation(rotation: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Project the rotation part of a pose back onto the manifold."""
    if pose_mode == "rot_matrix":
        return matrix_to_rot6d_cols(rot6d_cols_to_matrix(rotation))
    raise NotImplementedError(f"pose_mode {pose_mode!r} is not ported yet (see ROADMAP.md)")


def average_quaternion_batch_fast(Q: torch.Tensor, weights=None, num_iters: int = 40):
    """Weighted chordal mean of quaternions Q (B, K, 4) -> (B, 4): the top
    eigenvector of the weighted outer-product matrix by ``num_iters``
    normalised power iterations, started at the sign-aligned weighted mean."""
    B, K, _ = Q.shape
    if weights is None:
        weights = torch.full((B, K), 1.0 / K, dtype=Q.dtype, device=Q.device)
    weight_sum = weights.sum(-1)
    oriented = torch.where(Q[..., 0:1] > 0, Q, -Q)
    A = torch.einsum("bki,bkj,bk->bij", oriented, oriented, weights)
    A = A / torch.clamp(weight_sum, min=1e-12)[:, None, None]
    v = torch.einsum("bk,bki->bi", weights, oriented)
    small = torch.linalg.norm(v, dim=-1, keepdim=True) < 1e-6
    e_w = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=Q.dtype, device=Q.device)
    v = torch.where(small, e_w, v)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    for _ in range(num_iters):
        v = torch.einsum("bij,bj->bi", A, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    return torch.where(v[..., 0:1] > 0, v, -v)


def encode_axes(axes: torch.Tensor, dim: int) -> torch.Tensor:
    """sin/cos encoding of a flattened axes tensor: (B, ...) -> (B, 2 * numel * dim)."""
    bs = axes.shape[0]
    flat = axes.reshape(bs, -1, 1)
    exponent = (2.0 ** torch.arange(dim, dtype=flat.dtype, device=flat.device)).reshape(1, 1, -1)
    return torch.cat([torch.sin(exponent * flat).reshape(bs, -1),
                      torch.cos(exponent * flat).reshape(bs, -1)], dim=-1)
