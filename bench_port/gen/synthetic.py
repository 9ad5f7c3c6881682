# Frozen copy of genpose2_tpu_torch/data/synthetic.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Synthetic pose data: primitive shapes with known poses (port of
genpose2_tpu/data/synthetic.py).

A batch holds the keys of the JAX package's ``SyntheticPoseData.batch``:
zero-centred clouds, the zero-mean ground-truth pose in the 9D [col0, col1,
trans] representation, the subtracted center, symmetry labels, box side
lengths, class labels and the camera-frame cloud. Note that ``pts`` is the
ZERO-MEAN cloud here, as in the JAX package, while ``data.loader.
process_batch`` gives the camera-frame cloud as ``pts``; callers that feed
the encoder camera-frame clouds take ``cam_pts``.
"""

from __future__ import annotations

import math

import torch

from bench_port.reference.eval.metrics import sym_label
from bench_port.reference.so3.rotations import matrix_to_rot6d_cols, quaternion_to_matrix


def _random_rotation(generator: torch.Generator, count: int) -> torch.Tensor:
    q = torch.randn(count, 4, generator=generator, device=generator.device)
    return quaternion_to_matrix(q)


def _box_cloud(generator: torch.Generator, count: int, n: int, size: torch.Tensor):
    """(count, n, 3) points on the surfaces of boxes with side lengths size
    (count, 3)."""
    dev = generator.device
    face = torch.randint(0, 6, (count, n), generator=generator, device=dev)
    uv = torch.rand(count, n, 2, generator=generator, device=dev) - 0.5
    axis = face // 2
    sign = torch.where(face % 2 == 0, 0.5, -0.5)
    pts = torch.zeros(count, n, 3, device=dev)
    pts.scatter_(-1, axis[..., None], sign[..., None])
    pts.scatter_(-1, ((axis + 1) % 3)[..., None], uv[..., 0:1])
    pts.scatter_(-1, ((axis + 2) % 3)[..., None], uv[..., 1:2])
    return pts * size[:, None, :]


def _cylinder_cloud(generator: torch.Generator, count: int, n: int, size: torch.Tensor):
    """(count, n, 3) points on the lateral surfaces of y-axis cylinders of
    diameter size[:, 0] and height size[:, 1]."""
    dev = generator.device
    theta = torch.rand(count, n, generator=generator, device=dev) * 2 * math.pi
    y = (torch.rand(count, n, generator=generator, device=dev) - 0.5) * size[:, 1:2]
    r = size[:, 0:1] / 2
    return torch.stack([r * torch.cos(theta), y, r * torch.sin(theta)], dim=-1)


class SyntheticPoseData:
    """Deterministic synthetic objects: boxes (symmetry half/half/half) or
    y-axis cylinders (half about x, any about y), 0.12 x 0.2 x 0.08 m, at
    random rotations and translations within 15 cm of (0, 0, 0.6) m, with
    Gaussian noise of ``noise`` m on the camera-frame cloud."""

    def __init__(self, num_points: int = 1024, shape: str = "box", noise: float = 0.002,
                 seed: int = 0):
        if shape not in ("box", "cylinder"):
            raise NotImplementedError(shape)
        self.num_points = num_points
        self.shape = shape
        self.noise = noise
        self.seed = seed

    def batch(self, generator: torch.Generator, batch_size: int,
              fixed_pose: bool = False) -> dict:
        """One batch of ``batch_size`` objects; every draw comes from
        ``generator`` and the tensors lie on its device. With ``fixed_pose``
        every object takes one pose, drawn from generators seeded with
        ``seed`` (rotation) and ``seed + 1`` (translation)."""
        dev = generator.device
        B, N = batch_size, self.num_points
        pose_gen, trans_gen = generator, generator
        if fixed_pose:
            pose_gen = torch.Generator(device=dev).manual_seed(self.seed)
            trans_gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        size = torch.tensor([0.12, 0.2, 0.08], device=dev).expand(B, 3).contiguous()
        R = _random_rotation(pose_gen, B)
        t = (torch.rand(B, 3, generator=trans_gen, device=dev) * 0.3 - 0.15
             + torch.tensor([0.0, 0.0, 0.6], device=dev))
        if fixed_pose:
            R, t = R[0:1].expand(B, 3, 3).contiguous(), t[0:1].expand(B, 3).contiguous()
        if self.shape == "box":
            # a rectangular box is invariant under 180-degree flips about each axis
            clouds = _box_cloud(generator, B, N, size)
            sym = sym_label(x="half", y="half", z="half")
        else:
            # continuous about y, plus the end-over-end flip
            clouds = _cylinder_cloud(generator, B, N, size)
            sym = sym_label(x="half", y="any")
        cam = (R[:, None] * clouds[..., None, :]).sum(-1) + t[:, None, :]
        cam = cam + torch.randn(cam.shape, generator=generator, device=dev) * self.noise
        center = cam.mean(dim=1)
        return {
            "pts": cam - center[:, None, :],
            "zero_mean_gt_pose": torch.cat([matrix_to_rot6d_cols(R), t - center], dim=-1),
            "pts_center": center,
            "gt_rotation": R,
            "gt_translation": t,
            "bbox_side_len": size,
            "sym_info": sym.to(dev).expand(B, 4).contiguous(),
            "class_label": torch.zeros(B, dtype=torch.int32, device=dev),
            "cam_pts": cam,
        }
