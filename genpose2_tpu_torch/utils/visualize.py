"""Visualization (port of genpose2_tpu/utils/visualize.py): point-cloud grid
renders, SO(3) candidate-distribution plots, 3D bbox overlays, denoising
videos and Mitsuba scene files.

Every function takes numpy arrays or tensors (on any device). matplotlib
(headless, Agg) and OpenCV are imported inside the functions that draw with
them: a machine without them imports this module, and a drawing call there
raises an ImportError that names the missing module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from genpose2_tpu_torch.so3.rotations import transform_batch_pts


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("genpose2_tpu_torch.utils.visualize draws with matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("genpose2_tpu_torch.utils.visualize needs OpenCV (cv2), which is "
                          "not installed") from e
    return cv2


def _np(x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _scatter(ax, pts, axes=(0, 1), color="tab:blue", s=1.0, label=None):
    ax.scatter(pts[:, axes[0]], pts[:, axes[1]], s=s, c=color, label=label)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])


def _inverse_posed(cloud: np.ndarray, pose: np.ndarray, pose_mode: str) -> np.ndarray:
    """The cloud under the inverse of one pose, in float32."""
    out = transform_batch_pts(torch.as_tensor(cloud[None], dtype=torch.float32),
                              torch.as_tensor(pose[None], dtype=torch.float32), pose_mode,
                              inverse_pose=True)
    return out[0].numpy()


def create_grid_image(
    pts,
    pred_pose=None,
    gt_pose=None,
    pose_mode: str = "rot_matrix",
    num_rows: int = 4,
    path: Optional[str] = None,
) -> np.ndarray:
    """Front (x-y) and top (x-z) renders of camera-frame clouds (B, N, 3)
    under the inverse of the predicted and the ground-truth poses (B, D).
    Returns an HWC uint8 image; optionally saves it to ``path``."""
    plt = _pyplot()
    pts, pred_pose, gt_pose = _np(pts), _np(pred_pose), _np(gt_pose)
    B = min(pts.shape[0], num_rows)
    fig, axes = plt.subplots(B, 4, figsize=(8, 2 * B), squeeze=False)
    for b in range(B):
        cloud = pts[b]
        views = []
        if pred_pose is not None:
            inv = _inverse_posed(cloud, pred_pose[b], pose_mode)
            views.append(("pred front", inv, (0, 1)))
            views.append(("pred top", inv, (0, 2)))
        if gt_pose is not None:
            invg = _inverse_posed(cloud, gt_pose[b], pose_mode)
            views.append(("gt front", invg, (0, 1)))
            views.append(("gt top", invg, (0, 2)))
        while len(views) < 4:
            views.append(("cloud", cloud - cloud.mean(0), (0, 1)))
        for c, (title, v, ax_pair) in enumerate(views[:4]):
            _scatter(axes[b][c], v, ax_pair)
            if b == 0:
                axes[b][c].set_title(title, fontsize=8)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if path:
        fig.savefig(path, dpi=100)
    plt.close(fig)
    return img


def visualize_so3(rotations, gt_rotation=None, path: Optional[str] = None) -> np.ndarray:
    """Mollweide projection of candidate rotations (K, 3, 3): each drawn as
    its x-axis direction (longitude, latitude) coloured by the roll about it;
    the ground truth as a star. Returns an HWC uint8 image; optionally saves
    it to ``path``."""
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 3.2))
    ax = fig.add_subplot(111, projection="mollweide")

    def to_lonlat_roll(Rs):
        v = Rs[:, :, 0]  # x axis direction
        lon = np.arctan2(v[:, 1], v[:, 0])
        lat = np.arcsin(np.clip(v[:, 2], -1, 1))
        # roll: angle of the y axis around the x axis
        roll = np.arctan2(Rs[:, 2, 1], Rs[:, 1, 1])
        return lon, lat, roll

    lon, lat, roll = to_lonlat_roll(_np(rotations))
    sc = ax.scatter(lon, lat, c=roll, cmap="hsv", s=12, alpha=0.8, vmin=-np.pi, vmax=np.pi)
    if gt_rotation is not None:
        glon, glat, _ = to_lonlat_roll(_np(gt_rotation)[None])
        ax.scatter(glon, glat, marker="*", s=220, c="black")
    ax.grid(True, alpha=0.3)
    fig.colorbar(sc, shrink=0.6, label="roll")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if path:
        fig.savefig(path, dpi=100)
    plt.close(fig)
    return img


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_3d_bbox(image, K, rotation, translation, lengths, color=(0, 255, 0),
                 thickness: int = 2) -> np.ndarray:
    """The edges of an oriented 3D box (side ``lengths``, pose ``rotation``,
    ``translation`` in the camera frame) projected with intrinsics ``K`` and
    drawn on a copy of ``image``."""
    cv2 = _cv2()
    K = _np(K)
    corners = (
        np.array(
            [[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)]
        )
        * _np(lengths)
    )
    cam = corners @ _np(rotation).T + _np(translation)
    z = np.maximum(cam[:, 2], 1e-6)
    u = (cam[:, 0] * K[0, 0] / z + K[0, 2]).astype(int)
    v = (cam[:, 1] * K[1, 1] / z + K[1, 2]).astype(int)
    out = np.ascontiguousarray(_np(image).copy())
    for a, b in _BOX_EDGES:
        cv2.line(out, (int(u[a]), int(v[a])), (int(u[b]), int(v[b])), color, thickness)
    return out


def denoising_frames(trajectory: Sequence, pts, pose_mode: str = "rot_matrix") -> List[np.ndarray]:
    """One ``create_grid_image`` frame per step of a trajectory of (B, D)
    poses."""
    return [create_grid_image(pts, pred_pose=_np(step), pose_mode=pose_mode)
            for step in trajectory]


def save_denoising_video(trajectory: Sequence, pts, path: str, pose_mode: str = "rot_matrix",
                         fps: int = 10):
    """The denoising poses (a list of (B, D)) as an mp4v video at ``path``."""
    cv2 = _cv2()
    frames = denoising_frames(trajectory, pts, pose_mode)
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def export_mitsuba_xml(
    pcl,
    path: str,
    image_size: Sequence[int] = (800, 600),
    sphere_radius: float = 0.015,
    max_points: int = 4096,
    camera_origin: Sequence[float] = (2.2, 2.2, 2.2),
) -> str:
    """A point-cloud render scene: one XML file for ``mitsuba.load_file``
    (mitsuba itself is not a dependency). The cloud is bbox-centred, scaled
    to a unit diagonal, subsampled to ``max_points`` (seed 0) and written as
    diffuse spheres whose colour encodes position. Returns the XML (also
    written to ``path``)."""
    pcl = np.asarray(_np(pcl), np.float64)
    if len(pcl) > max_points:
        sel = np.random.default_rng(0).choice(len(pcl), max_points, replace=False)
        pcl = pcl[sel]
    lo, hi = pcl.min(axis=0), pcl.max(axis=0)
    center = (lo + hi) / 2.0
    scale = float(np.linalg.norm(hi - lo)) or 1.0
    std = (pcl - center) / scale  # fits in [-0.5, 0.5]^3
    colors = np.clip(std + 0.5, 0.001, 0.999)

    w, h = int(image_size[0]), int(image_size[1])
    ox, oy, oz = (float(v) for v in camera_origin)
    parts = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<scene version="3.0.0">',
        '  <integrator type="path"><integer name="max_depth" value="8"/></integrator>',
        '  <sensor type="perspective">',
        '    <float name="fov" value="25"/>',
        f'    <transform name="to_world"><lookat origin="{ox},{oy},{oz}" '
        'target="0,0,0" up="0,0,1"/></transform>',
        '    <sampler type="independent"><integer name="sample_count" value="64"/></sampler>',
        f'    <film type="hdrfilm"><integer name="width" value="{w}"/>'
        f'<integer name="height" value="{h}"/></film>',
        '  </sensor>',
        '  <emitter type="constant"><rgb name="radiance" value="0.8,0.8,0.8"/></emitter>',
        '  <shape type="rectangle">',
        '    <transform name="to_world"><scale value="10"/>'
        '<translate z="-0.55"/></transform>',
        '    <bsdf type="diffuse"><rgb name="reflectance" value="0.9,0.9,0.9"/></bsdf>',
        '  </shape>',
    ]
    for p, c in zip(std, colors):
        parts.append(
            f'  <shape type="sphere"><point name="center" x="{p[0]:.5f}" '
            f'y="{p[1]:.5f}" z="{p[2]:.5f}"/><float name="radius" '
            f'value="{sphere_radius}"/><bsdf type="diffuse">'
            f'<rgb name="reflectance" value="{c[0]:.3f},{c[1]:.3f},{c[2]:.3f}"/>'
            "</bsdf></shape>"
        )
    parts.append("</scene>")
    xml = "\n".join(parts)
    with open(path, "w") as f:
        f.write(xml)
    return xml
