# Frozen copy of genpose2_tpu_torch/data/augmentation.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""NOCS-style point-cloud augmentation on the device (port of
genpose2_tpu/data/augmentation.py). Four augmentations, each applied per
object with its own probability:

- ``defor_3d_bb``: anisotropic rescale in the object frame (a symmetric
  object, sym[:, 0] == 1, gets one shared x/z factor);
- ``defor_3d_rt``: rigid jitter, a translation then a rotation of the cloud,
  the ground-truth pose moved with it;
- ``defor_3d_bc``: box cage, the x/z scale varying linearly along y
  (mug/bowl objects only);
- ``defor_3d_pc``: radial jitter away from the ground-truth center.

The deterministic parts take their parameters explicitly; ``data_augment``
draws them from a ``torch.Generator`` (JAX draws them from PRNG keys, so the
two packages agree given the same draws: pass ``draws``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bench_port.reference_vit7b.parallel.mesh import batch_rand, batch_randn
from bench_port.reference_vit7b.so3.rotations import euler_zyx_to_matrix


def _to_obj(pc, R, t):
    """Camera-frame points -> object frame, R^T (p - t)."""
    return (pc - t[:, None, :]) @ R


def _to_cam(pc_obj, R, t):
    return pc_obj @ R.transpose(1, 2) + t[:, None, :]


def defor_3d_bb(pc, model_point, R, t, s, sym, aug_bb):
    """Object-frame rescale by aug_bb (B, 3); pc (B, N, 3), s (B, 3) full
    sizes, sym (B, 4). Returns (pc, s, model_point) rescaled."""
    sym_aug = (aug_bb + aug_bb[:, [2, 1, 0]]) / 2.0
    factors = torch.where((sym[:, 0] == 1)[:, None], sym_aug, aug_bb)
    pc_obj = _to_obj(pc, R, t) * factors[:, None, :]
    return _to_cam(pc_obj, R, t), s * factors, model_point * factors[:, None, :]


def defor_3d_rt(pc, R, t, aug_rt_t, aug_rt_r):
    """Translate by aug_rt_t (B, 3), then rotate cloud and pose by aug_rt_r
    (B, 3, 3). Returns (pc, R, t)."""
    pc_new = (pc + aug_rt_t[:, None, :]) @ aug_rt_r.transpose(1, 2)
    t_new = (aug_rt_r @ (t + aug_rt_t)[..., None])[..., 0]
    return pc_new, aug_rt_r @ R, t_new


def _cage(y, s_y, ey_up, ey_down):
    return (y + s_y / 2.0) / s_y * (ey_up - ey_down) + ey_down


def defor_3d_bc(pc, R, t, s, model_point, nocs_scale, ey_up, ey_down):
    """Box cage: x and z scaled by a factor linear in y, from ey_down (B, 1)
    at the bottom to ey_up (B, 1) at the top; the sizes recomputed from the
    deformed model points times nocs_scale (B,). Returns (pc, s)."""
    pc_obj = _to_obj(pc, R, t)
    s_y = s[:, 1:2]
    resize = _cage(pc_obj[..., 1], s_y, ey_up, ey_down)[..., None]
    keep_y = torch.tensor([0.0, 1.0, 0.0], dtype=pc.dtype, device=pc.device)
    pc_obj = pc_obj * (resize * (1 - keep_y) + keep_y)
    mp_resize = _cage(model_point[..., 1], s_y, ey_up, ey_down)[..., None]
    mp = model_point * (mp_resize * (1 - keep_y) + keep_y)
    s_new = (mp.amax(dim=1) - mp.amin(dim=1)) * nocs_scale[:, None]
    return _to_cam(pc_obj, R, t), s_new


def defor_3d_pc(pc, gt_t, defor):
    """Radial jitter: pc + defor * (pc - center), defor (B, N, 3) (U[0, r)
    in ``data_augment``)."""
    return pc + defor * (pc - gt_t[:, None, :])


def random_rt_params(batch: int, generator: Optional[torch.Generator] = None, device=None,
                     t_std: float = 0.02, r_deg: float = 15.0):
    """The rigid jitter's translation N(0, t_std) (B, 3) and rotation from ZYX
    angles U(-r_deg, r_deg) degrees (B, 3, 3)."""
    aug_t = batch_randn((batch, 3), generator, device) * t_std
    angles = (batch_rand((batch, 3), generator, device) * 2 - 1)
    return aug_t, euler_zyx_to_matrix(angles * math.radians(r_deg))


def draw_params(batch: int, n: int, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Every draw of ``data_augment`` for a batch of ``batch`` clouds of ``n``
    points, in this order: the four gates U(0, 1) (B, 1), the box factors
    U(0.8, 1.2) (B, 3), the rigid jitter (``random_rt_params``), the cage's
    ey_up and ey_down U(0.8, 1.2) (B, 1) and the radial jitter's U(0, 1)
    (B, N, 3). Under a mesh, this rank's rows of the global batch's draws."""
    def u(*shape):
        return batch_rand(shape, generator, device)

    d = {"gate_bb": u(batch, 1), "aug_bb": u(batch, 3) * 0.4 + 0.8, "gate_rt": u(batch, 1)}
    d["aug_t"], d["aug_R"] = random_rt_params(batch, generator, device)
    d.update(gate_bc=u(batch, 1), ey_up=u(batch, 1) * 0.4 + 0.8,
             ey_down=u(batch, 1) * 0.4 + 0.8, gate_pc=u(batch, 1), pc_u=u(batch, n, 3))
    return d


def data_augment(params: dict, pc, gt_R, gt_t, gt_s, sym, model_point=None, nocs_scale=None,
                 mug_bowl_mask=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None):
    """The four augmentations with per-object gates (params: cfg.data's
    ``pts_aug_params()``). gt_s are full sizes. Draws from ``generator``
    (``draw_params``) unless ``draws`` gives them. Returns (pc, gt_R, gt_t,
    gt_s)."""
    B, N = pc.shape[:2]
    d = draws if draws is not None else draw_params(B, N, generator, pc.device)
    d = {k: v.to(pc.device, pc.dtype) for k, v in d.items()}
    if model_point is None:
        model_point = torch.zeros_like(pc)
    if nocs_scale is None:
        nocs_scale = torch.ones(B, dtype=pc.dtype, device=pc.device)

    flag = d["gate_bb"] < params["aug_bb_pro"]
    pc_new, s_new, model_new = defor_3d_bb(pc, model_point, gt_R, gt_t, gt_s, sym, d["aug_bb"])
    pc = torch.where(flag[..., None], pc_new, pc)
    gt_s = torch.where(flag, s_new, gt_s)
    model_point = torch.where(flag[..., None], model_new, model_point)

    flag = d["gate_rt"] < params["aug_rt_pro"]
    pc_new, R_new, t_new = defor_3d_rt(pc, gt_R, gt_t, d["aug_t"], d["aug_R"])
    pc = torch.where(flag[..., None], pc_new, pc)
    gt_R = torch.where(flag[..., None], R_new, gt_R)
    gt_t = torch.where(flag, t_new, gt_t)

    if mug_bowl_mask is not None:
        flag = (d["gate_bc"] < params["aug_bc_pro"]) & mug_bowl_mask.to(pc.device)[:, None]
        pc_new, s_new = defor_3d_bc(pc, gt_R, gt_t, gt_s, model_point, nocs_scale,
                                    d["ey_up"], d["ey_down"])
        pc = torch.where(flag[..., None], pc_new, pc)
        gt_s = torch.where(flag, s_new, gt_s)

    flag = d["gate_pc"] < params["aug_pc_pro"]
    pc = torch.where(flag[..., None], defor_3d_pc(pc, gt_t, d["pc_u"] * params["aug_pc_r"]), pc)
    return pc, gt_R, gt_t, gt_s
