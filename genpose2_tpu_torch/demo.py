"""Demo: end-to-end inference on a synthetic RGB-D frame (the port's
counterpart of the JAX package's root ``demo.py``).

Renders a box scene with a known pose, runs ``GenPose2`` on it (crop ->
cloud -> score ODE -> aggregate -> box lengths), prints the pose error, and
writes a bbox overlay and an SO(3) plot of the candidates under ``--out``.

    python -m genpose2_tpu_torch.demo [--trained] [--device cpu]

``--trained`` first trains a tiny score net on matching synthetic scenes
(``--train_steps`` steps). The card runs it unless ``--device`` says
otherwise. The overlay needs OpenCV and the plot matplotlib; where one is
missing its image is skipped with a message.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import DataConfig, tiny_test_config
from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
from genpose2_tpu_torch.so3.rotations import rot6d_cols_to_matrix, rotation_angle_deg
from genpose2_tpu_torch.training.agent import PoseAgent


def random_rotation(seed: int) -> np.ndarray:
    """A uniformly random rotation matrix (a unit quaternion from N(0, 1))."""
    q = np.random.default_rng(seed).normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def render_box_scene(K, R, t, size, im_h=240, im_w=320, n=60000, seed=0):
    """Depth and mask (id 7) of a box's surface points, nearest point a pixel."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 6, n)
    uv = rng.random((n, 2)) - 0.5
    pts = np.zeros((n, 3))
    ax = face // 2
    pts[np.arange(n), ax] = np.where(face % 2 == 0, 0.5, -0.5)
    pts[np.arange(n), (ax + 1) % 3] = uv[:, 0]
    pts[np.arange(n), (ax + 2) % 3] = uv[:, 1]
    pts *= size
    cam = pts @ R.T + t
    z = cam[:, 2]
    u = (cam[:, 0] * K[0, 0] / z + K[0, 2]).astype(int)
    v = (cam[:, 1] * K[1, 1] / z + K[1, 2]).astype(int)
    ok = (u >= 0) & (u < im_w) & (v >= 0) & (v < im_h)
    order = np.argsort(-z[ok])
    depth = np.zeros((im_h, im_w), np.float32)
    mask = np.zeros((im_h, im_w), np.int32)
    depth[v[ok][order], u[ok][order]] = z[ok][order]
    mask[v[ok][order], u[ok][order]] = 7
    return depth, mask


def train_tiny_score(cfg, device, steps: int, batch: int = 16) -> PoseAgent:
    """A score agent trained ``steps`` steps on synthetic batches; its model
    holds the EMA weights afterwards."""
    data = SyntheticPoseData(num_points=cfg.model.num_points)
    agent = PoseAgent(cfg, "score", device=device, steps_per_epoch=500)
    state = agent.init_state()
    for i in range(steps):
        g = torch.Generator(agent.device).manual_seed(i)
        state, m = agent.train_step(state, data.batch(g, batch), g)
        if i % 300 == 0:
            print(f"  step {i}: loss {float(m['loss']):.3f}")
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(state.ema_params[k])
    return agent


def main(argv=None):
    ap = argparse.ArgumentParser("genpose2_tpu_torch.demo")
    ap.add_argument("--trained", action="store_true", help="train a tiny score net first")
    ap.add_argument("--train_steps", type=int, default=1500)
    ap.add_argument("--out", default="demo_out")
    # 'cuda' (the default: the card) or 'cpu' (the plain versions of the kernels)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cfg = tiny_test_config()
    cfg = cfg.replace(data=DataConfig(num_points=cfg.model.num_points, img_size=64))

    K = np.array([[280.0, 0, 160], [0, 280.0, 120], [0, 0, 1]], np.float32)
    size = np.array([0.12, 0.2, 0.08])
    R_gt = random_rotation(11)
    t_gt = np.array([0.02, -0.01, 0.62])
    depth, mask = render_box_scene(K, R_gt, t_gt, size)
    frame = {
        "color": np.full((240, 320, 3), 110, np.uint8),
        "depth": depth,
        "mask": mask,
        "intrinsics": {"fx": 280.0, "fy": 280.0, "cx": 160.0, "cy": 120.0,
                       "width": 320, "height": 240},
    }

    engine = GenPose2(cfg, num_steps=50, device=args.device)
    if args.trained:
        print("training a tiny score model on matching synthetic scenes ...")
        engine.score_agent = train_tiny_score(cfg, engine.device, args.train_steps)

    out = engine.inference(frame)
    assert out is not None, "no object found"
    R_pred = out["pose"][0, :3, :3]
    t_pred = out["pose"][0, :3, 3]
    deg = float(rotation_angle_deg(torch.as_tensor(R_pred, dtype=torch.float64),
                                   torch.as_tensor(R_gt, dtype=torch.float64)))
    cm = float(np.linalg.norm(t_pred - t_gt) * 100)
    print(f"pose error: {deg:.1f} deg, {cm:.2f} cm; lengths {out['lengths'][0]}")

    from genpose2_tpu_torch.utils.visualize import draw_3d_bbox, visualize_so3

    try:
        import cv2

        img = draw_3d_bbox(frame["color"], K, R_pred, t_pred, out["lengths"][0])
        img = draw_3d_bbox(img, K, R_gt, t_gt, size, color=(255, 0, 0), thickness=1)
        cv2.imwrite(os.path.join(args.out, "bbox_overlay.png"), img[..., ::-1])
        print(f"wrote {args.out}/bbox_overlay.png (green=pred, red=gt)")
    except ImportError as e:
        print(f"skipped the bbox overlay: {e}")

    # the candidates' SO(3) distribution
    batch = process_batch(engine.front_end(frame), cfg.model.pose_mode, engine.device)
    poses = engine.score_agent.sample_candidates(
        batch, repeat_num=32, T0=1.0, method="fixed", num_steps=50,
        generator=torch.Generator(engine.device).manual_seed(1))
    Rs = rot6d_cols_to_matrix(poses[0, :, :6])
    try:
        visualize_so3(Rs, R_gt, path=os.path.join(args.out, "so3_candidates.png"))
        print(f"wrote {args.out}/so3_candidates.png")
    except ImportError as e:
        print(f"skipped the SO(3) plot: {e}")
    return out


if __name__ == "__main__":
    main()
