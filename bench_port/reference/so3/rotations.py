# Frozen copy of genpose2_tpu_torch/so3/rotations.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Rotation math of the pose representations (port of
genpose2_tpu/so3/rotations.py).

Quaternions are (w, x, y, z). The 9D 'rot_matrix' pose is
``[col0(3), col1(3), trans(3)]``: the first two columns of the rotation
matrix, then the translation.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def get_pose_dim(pose_mode: str) -> int:
    """Width of a pose of ``pose_mode``: rotation part + translation (3)."""
    return {"quat_wxyz": 7, "quat_xyzw": 7, "euler_xyz": 6, "euler_xyz_sx_cx": 9,
            "rot_matrix": 9}[pose_mode]


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


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis (..., 3) (normalised here), angle (...) radians -> (..., 3, 3)."""
    axis = _normalize(axis)
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1 - c
    m = torch.stack(
        [
            c + x * x * C, x * y * C - z * s, x * z * C + y * s,
            y * x * C + z * s, c + y * y * C, y * z * C - x * s,
            z * x * C - y * s, z * y * C + x * s, c + z * z * C,
        ],
        dim=-1,
    )
    return m.reshape(angle.shape + (3, 3))


def euler_zyx_to_matrix(euler: torch.Tensor) -> torch.Tensor:
    """(..., 3) ZYX intrinsic angles (z, y, x) -> (..., 3, 3) = Rz @ Ry @ Rx."""
    az, ay, ax = euler[..., 0], euler[..., 1], euler[..., 2]

    def rot(a, rows):
        c, s, o, one = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
        pick = {"c": c, "s": s, "-s": -s, "0": o, "1": one}
        return torch.stack([pick[k] for k in rows.split()], -1).reshape(a.shape + (3, 3))

    return (rot(az, "c -s 0 s c 0 0 0 1") @ rot(ay, "c 0 s 0 1 0 -s 0 c")
            @ rot(ax, "1 0 0 0 c -s 0 s c"))


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) angles (z, y, x) with R = Rz @ Ry @ Rx; R[2, 0]
    is clipped to [-1, 1] (gimbal lock)."""
    ay = torch.arcsin(-torch.clamp(R[..., 2, 0], -1.0, 1.0))
    az = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    ax = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([az, ay, ax], dim=-1)


def get_rot_matrix(batch_rot: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Rotation part of a pose -> (..., 3, 3)."""
    if pose_mode == "quat_wxyz":
        return quaternion_to_matrix(batch_rot)
    if pose_mode == "quat_xyzw":
        return quaternion_to_matrix(batch_rot[..., [3, 0, 1, 2]])
    if pose_mode == "rot_matrix":
        return rot6d_cols_to_matrix(batch_rot)
    if pose_mode == "euler_xyz":
        return euler_zyx_to_matrix(batch_rot)
    if pose_mode == "euler_xyz_sx_cx":
        return euler_zyx_to_matrix(torch.atan2(batch_rot[..., :3], batch_rot[..., 3:6]))
    raise NotImplementedError(pose_mode)


def get_pose_representation(R: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """(..., 3, 3) -> the rotation part of the pose representation."""
    if pose_mode == "quat_xyzw":
        return matrix_to_quaternion(R)[..., [1, 2, 3, 0]]
    if pose_mode == "quat_wxyz":
        return matrix_to_quaternion(R)
    if pose_mode == "rot_matrix":
        return matrix_to_rot6d_cols(R)
    if pose_mode == "euler_xyz":
        return matrix_to_euler_zyx(R)
    if pose_mode == "euler_xyz_sx_cx":
        e = matrix_to_euler_zyx(R)
        return torch.cat([torch.sin(e), torch.cos(e)], dim=-1)
    raise NotImplementedError(pose_mode)


def normalize_rotation(rotation: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """Project the rotation part of a pose back onto the manifold."""
    if pose_mode in ("quat_wxyz", "quat_xyzw"):
        return _normalize(rotation)
    if pose_mode == "rot_matrix":
        return matrix_to_rot6d_cols(rot6d_cols_to_matrix(rotation))
    if pose_mode == "euler_xyz_sx_cx":
        theta = torch.atan2(rotation[..., :3], rotation[..., 3:6])
        return torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1)
    if pose_mode == "euler_xyz":
        return rotation
    raise NotImplementedError(pose_mode)


def normalize_pose(pose: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """``normalize_rotation`` of pose[..., :-3]; the translation passes through."""
    return torch.cat([normalize_rotation(pose[..., :-3], pose_mode), pose[..., -3:]], dim=-1)


def inverse_RT(R: torch.Tensor, t: torch.Tensor):
    """Invert (R (..., 3, 3), t (..., 3)) -> (R^T, -R^T t)."""
    Rinv = R.transpose(-1, -2)
    return Rinv, -(Rinv * t[..., None, :]).sum(-1)


def transform_batch_pts(pts: torch.Tensor, pose: torch.Tensor, pose_mode: str = "rot_matrix",
                        inverse_pose: bool = False) -> torch.Tensor:
    """Apply the pose [rotation, translation] (..., get_pose_dim(pose_mode))
    to the xyz channels of points (..., N, C >= 3); the other channels pass
    through."""
    rot_dim = get_pose_dim(pose_mode) - 3
    R = get_rot_matrix(pose[..., :rot_dim], pose_mode)
    t = pose[..., rot_dim:]
    if inverse_pose:
        R, t = inverse_RT(R, t)
    xyz = (R[..., None, :, :] * pts[..., None, :3]).sum(-1) + t[..., None, :]
    return torch.cat([xyz, pts[..., 3:]], dim=-1)


def average_quaternion_batch(Q: torch.Tensor, weights=None) -> torch.Tensor:
    """Weighted chordal mean of quaternions Q (B, K, 4) wxyz -> (B, 4): the
    eigenvector of the largest eigenvalue of the weighted outer-product matrix
    of the sign-aligned (w > 0) quaternions, by ``torch.linalg.eigh``. Its
    sign is arbitrary: it is fixed to w > 0, and a w of exactly 0 flips."""
    B, K, _ = Q.shape
    if weights is None:
        weights = torch.full((B, K), 1.0 / K, dtype=Q.dtype, device=Q.device)
    oriented = torch.where(Q[..., 0:1] > 0, Q, -Q)
    A = torch.einsum("bki,bkj,bk->bij", oriented, oriented, weights)
    A = A / weights.sum(-1)[:, None, None]
    q = torch.linalg.eigh(A).eigenvectors[..., -1]
    return torch.where(q[..., 0:1] > 0, q, -q)


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


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3), in degrees: the
    trace of R1 R2^T as float32 products, clipped, then arccos."""
    d = (R1 * R2).sum(-1)
    tr = d[..., 0] + d[..., 1] + d[..., 2]
    return torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))
