"""Synthetic RGB-D frames of ellipsoids, for smoke runs and tests: depth and
instance mask by closed-form ray-ellipsoid hits through a pinhole camera,
random uint8 colour. ``write_dataset`` writes such frames to disk in the
Omni6DPose layout that ``data/omni6dpose.py`` and ``data/tracking.py`` read
(PNG colour, EXR depth, PNG mask, ``meta.json``, ``obj_meta.json``). Host
code in numpy.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Ellipsoid:
    center: np.ndarray  # (3,) camera frame, meters
    axes: np.ndarray  # (3,) semi-axes, meters
    rotation: np.ndarray  # (3, 3) object to camera


def intrinsics(width: int, height: int, f: float) -> dict:
    return {"fx": f, "fy": f, "cx": width / 2, "cy": height / 2, "width": width,
            "height": height}


def random_scene(rng: np.random.Generator, count: int, width: int, height: int, f: float,
                 axes=(0.04, 0.15), depth=(0.5, 1.2)) -> list:
    """``count`` ellipsoids, one per cell of a near-square grid over the
    image, at a random depth and attitude. Semi-axes are drawn from ``axes``
    but capped so that each ellipsoid's image stays inside its cell: no
    object hides another."""
    cols = int(np.ceil(np.sqrt(count * width / height)))
    rows = int(np.ceil(count / cols))
    cell = min(width / cols, height / rows)
    objs = []
    for i in range(count):
        r, c = divmod(i, cols)
        u = (c + rng.uniform(0.45, 0.55)) * width / cols
        v = (r + rng.uniform(0.45, 0.55)) * height / rows
        z = rng.uniform(*depth)
        center = np.array([(u - width / 2) * z / f, (v - height / 2) * z / f, z])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        hi = max(axes[0], min(axes[1], 0.4 * cell * z / f))
        objs.append(Ellipsoid(center, rng.uniform(axes[0], hi, size=3),
                              q * np.sign(np.linalg.det(q))))
    return objs


def moved(rng: np.random.Generator, objs: list, shift: float = 0.003,
          turn_deg: float = 1.0) -> list:
    """Each ellipsoid moved by ``shift`` meters along a random direction and
    turned by ``turn_deg`` about a random axis."""
    out = []
    for o in objs:
        d = rng.normal(size=3)
        k = rng.normal(size=3)
        k /= np.linalg.norm(k)
        a = np.radians(turn_deg)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        out.append(Ellipsoid(o.center + shift * d / np.linalg.norm(d), o.axes, dR @ o.rotation))
    return out


def render(rng: np.random.Generator, objs: list, width: int, height: int, f: float) -> dict:
    """The frame dict that ``GenPose2.inference`` takes: color (H, W, 3) uint8,
    depth (H, W) float32 meters, mask (H, W) int32 (object i has id i + 1,
    background 0), intrinsics."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    ray = np.stack([(u - width / 2) / f, (v - height / 2) / f, np.ones_like(u)], -1)
    depth = np.full((height, width), np.inf)
    mask = np.zeros((height, width), np.int32)
    for i, o in enumerate(objs):
        q = ray @ o.rotation / o.axes  # the ray in the unit-sphere frame
        w = o.rotation.T @ o.center / o.axes
        A = (q * q).sum(-1)
        B = q @ w
        C = w @ w - 1.0
        disc = B * B - A * C
        hit = disc > 0
        s = np.where(hit, (B - np.sqrt(np.where(hit, disc, 0.0))) / A, np.inf)
        closer = hit & (s > 0) & (s < depth)
        depth[closer] = s[closer]
        mask[closer] = i + 1
    depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
    color = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    return {"color": color, "depth": depth, "mask": mask,
            "intrinsics": intrinsics(width, height, f)}


_SYMMETRIES = ({"any": False, "x": "none", "y": "none", "z": "none"},
               {"any": False, "x": "half", "y": "any", "z": "none"},
               {"any": False, "x": "half", "y": "half", "z": "half"})


def _quaternion_wxyz(R: np.ndarray) -> list:
    from scipy.spatial.transform import Rotation

    x, y, z, w = Rotation.from_matrix(R).as_quat()
    return [float(w), float(x), float(y), float(z)]


def write_frame(prefix: str, frame: dict, objs: list, oids: List[str]) -> None:
    """One frame at ``prefix``: ``color.png``, ``depth.exr``, ``mask.png``
    (object i has mask id i + 1) and ``meta.json`` with each ellipsoid's
    pose, oid, class label (its symmetry kind) and box (twice its semi-axes)."""
    from genpose2_tpu_torch.data.exr import write_exr
    from genpose2_tpu_torch.data.png import write_png

    write_png(prefix + "color.png", frame["color"])
    write_exr(prefix + "depth.exr", frame["depth"])
    write_png(prefix + "mask.png", frame["mask"].astype(np.uint16))
    objects = [{"is_valid": True, "mask_id": i + 1,
                "quaternion_wxyz": _quaternion_wxyz(o.rotation),
                "translation": [float(v) for v in o.center],
                "meta": {"oid": oid, "class_label": int(oid.rsplit("_", 1)[1]) % 3,
                         "class_name": f"kind{int(oid.rsplit('_', 1)[1]) % 3}",
                         "bbox_side_len": [float(2 * a) for a in o.axes]}}
               for i, (o, oid) in enumerate(zip(objs, oids))]
    with open(prefix + "meta.json", "w") as f:
        json.dump({"camera": {"intrinsics": frame["intrinsics"]}, "objects": objects}, f)


def write_obj_meta(root: str, oids: List[str]) -> None:
    """``obj_meta.json``: each oid's symmetry tags, by its kind."""
    inst = {oid: {"tag": {"symmetry": _SYMMETRIES[int(oid.rsplit("_", 1)[1]) % 3]}}
            for oid in oids}
    with open(os.path.join(root, "obj_meta.json"), "w") as f:
        json.dump({"instance_dict": inst}, f)


def write_dataset(root: str, rng: np.random.Generator, frames: int, objects=(6, 8),
                  width: int = 640, height: int = 480, f: float = 600.0, videos: int = 0,
                  video_frames: int = 4, depth=(0.5, 1.2)) -> dict:
    """``frames`` frames of ``objects`` (a count or a (lo, hi) range)
    ellipsoids under ``root/frames`` and ``videos`` videos of
    ``video_frames`` frames (the objects moving 3 mm and 1 degree a frame)
    under ``root/videos/vid<k>``. Returns {"frames": dir, "videos": dir}."""
    lo, hi = (objects, objects) if isinstance(objects, int) else objects
    out = {"frames": os.path.join(root, "frames"), "videos": os.path.join(root, "videos")}
    os.makedirs(out["frames"], exist_ok=True)
    oids = []
    for i in range(frames):
        objs = random_scene(rng, int(rng.integers(lo, hi + 1)), width, height, f, depth=depth)
        ids = [f"f{i}_{k}" for k in range(len(objs))]
        oids += ids
        write_frame(os.path.join(out["frames"], f"{i:04d}_"),
                    render(rng, objs, width, height, f), objs, ids)
    write_obj_meta(out["frames"], oids)
    for v in range(videos):
        vdir = os.path.join(out["videos"], f"vid{v}")
        os.makedirs(vdir, exist_ok=True)
        objs = random_scene(rng, int(rng.integers(lo, hi + 1)), width, height, f, depth=depth)
        ids = [f"v{v}_{k}" for k in range(len(objs))]
        for i in range(video_frames):
            write_frame(os.path.join(vdir, f"{i:04d}_"), render(rng, objs, width, height, f),
                        objs, ids)
            objs = moved(rng, objs)
    return out
