"""Synthetic RGB-D frames of ellipsoids, for smoke runs and tests: depth and
instance mask by closed-form ray-ellipsoid hits through a pinhole camera,
random uint8 colour. Host code in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

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
