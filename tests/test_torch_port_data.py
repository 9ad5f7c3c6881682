"""The port's data layer against the JAX package's, on the same files and seeds.

- PNG: ``data/png.py`` against ``cv2.imread`` (both flags) for every color
  type, bit depth and filter type it supports, on files written by a filter
  encoder of this test and by cv2.
- EXR: files written by either package read by the other, bit for bit.
- ``defor_2D`` and its erosion against cv2 / the JAX package.
- ``Omni6DPoseDataset`` train and test samples, epochs 0 and 1, native and
  numpy branches, PNG and EXR frames; ``DataLoader`` order, shards,
  ``drop_last`` and batches.
- The augmentation, every piece given explicit parameters, and
  ``process_batch``'s augmentation branch with the JAX draws.
- The tracking and BOP datasets on fixtures built as
  tests/test_bop_tracking_data.py builds them.
- No port module imports cv2, PIL or jax.

Tolerances: integer keys, strings and the nearest-neighbour crops exact;
floats within 1e-6; the bilinear RGB crop (``roi_rgb``) within one uint8
level, at under 0.1% of its pixels (the port's crop follows OpenCV's scalar
rounding; its vector code orders the float32 operations otherwise, as
tests/test_torch_port_frame.py holds it).
"""

import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from genpose2_tpu.config import DataConfig as JaxDataConfig
from genpose2_tpu.data import augmentation as jaug
from genpose2_tpu.data import exr as jexr
from genpose2_tpu.data import roi as jroi
from genpose2_tpu.data.loader import DataLoader as JaxDataLoader
from genpose2_tpu.data.loader import process_batch as jax_process_batch
from genpose2_tpu.data.omni6dpose import Omni6DPoseDataset as JaxOmni
from genpose2_tpu.data.tracking import open_video_datasets as jax_open_videos
from genpose2_tpu.data.xyzibd import XyzibdDataset as JaxXyzibd
from genpose2_tpu.data.xyzibd import bop_symmetry_label as jax_bop_symmetry_label
from genpose2_tpu.so3.rotations import euler_zyx_to_matrix as jax_euler
from genpose2_tpu_torch.config import DataConfig
from genpose2_tpu_torch.data import augmentation as aug
from genpose2_tpu_torch.data import exr, png, roi
from genpose2_tpu_torch.data.loader import DataLoader, process_batch
from genpose2_tpu_torch.data.omni6dpose import Omni6DPoseDataset
from genpose2_tpu_torch.data.tracking import open_video_datasets
from genpose2_tpu_torch.data.xyzibd import XyzibdDataset, bop_symmetry_label
from genpose2_tpu_torch.so3.rotations import euler_zyx_to_matrix
from genpose2_tpu_torch.utils.logging import MetricsLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------- fixtures
def render_box_scene(K, R, t, size, im_h=240, im_w=320):
    """Depth-render the visible faces of a box by dense surface sampling
    (mask id 7)."""
    n = 60000
    rng = np.random.default_rng(0)
    face = rng.integers(0, 6, n)
    uv = rng.random((n, 2)) - 0.5
    pts = np.zeros((n, 3))
    ax = face // 2
    pts[np.arange(n), ax] = np.where(face % 2 == 0, 0.5, -0.5)
    pts[np.arange(n), (ax + 1) % 3] = uv[:, 0]
    pts[np.arange(n), (ax + 2) % 3] = uv[:, 1]
    cam = (pts * size) @ R.T + t
    z = cam[:, 2]
    u = (cam[:, 0] * K[0, 0] / z + K[0, 2]).astype(int)
    v = (cam[:, 1] * K[1, 1] / z + K[1, 2]).astype(int)
    ok = (u >= 0) & (u < im_w) & (v >= 0) & (v < im_h)
    depth = np.zeros((im_h, im_w), np.float32)
    mask = np.zeros((im_h, im_w), np.int32)
    order = np.argsort(-z[ok])
    depth[v[ok][order], u[ok][order]] = z[ok][order]
    mask[v[ok][order], u[ok][order]] = 7
    return depth, mask


def _obj(R, t, mid, oid, label, size):
    return {"is_valid": True, "mask_id": mid,
            "quaternion_wxyz": ScipyRot.from_matrix(R).as_quat()[[3, 0, 1, 2]].tolist(),
            "translation": t.tolist(),
            "meta": {"oid": oid, "class_label": label, "class_name": f"c{label}",
                     "bbox_side_len": size.tolist()}}


INTR = {"fx": 280.0, "fy": 280.0, "cx": 160.0, "cy": 120.0, "width": 320, "height": 240}
K_CAM = np.array([[280.0, 0, 160], [0, 280.0, 120], [0, 0, 1]], np.float32)


def _write_frames(root, specs, use_exr):
    """specs: per frame a list of (t, mask id); frames with random-colour
    RGB, depth and mask as PNG (mm) or EXR."""
    size = np.array([0.1, 0.14, 0.08])
    rng = np.random.default_rng(5)
    for fi, objs in enumerate(specs):
        depth = np.zeros((240, 320), np.float32)
        mask = np.zeros((240, 320), np.int32)
        metas = []
        for t, mid in objs:
            R = ScipyRot.random(random_state=fi * 10 + mid).as_matrix()
            d, _ = render_box_scene(K_CAM, R, t, size)
            put = (d > 0) & ((depth == 0) | (d < depth))
            depth[put] = d[put]
            mask[put] = mid
            metas.append(_obj(R, t, mid, f"box_{mid}", mid, size))
        prefix = os.path.join(str(root), f"frame{fi:04d}_")
        cv2.imwrite(prefix + "color.png", rng.integers(0, 256, (240, 320, 3), dtype=np.uint8))
        if use_exr:
            jexr.write_exr(prefix + "depth.exr", depth)
            jexr.write_exr(prefix + "mask.exr", mask.astype(np.float32))
        else:
            cv2.imwrite(prefix + "depth.png", (depth * 1000).astype(np.uint16))
            cv2.imwrite(prefix + "mask.png", mask.astype(np.uint16))
        with open(prefix + "meta.json", "w") as f:
            json.dump({"camera": {"intrinsics": INTR}, "objects": metas}, f)
    sym = {"any": False, "x": "none", "y": "half", "z": "none"}
    with open(os.path.join(str(root), "obj_meta.json"), "w") as f:
        json.dump({"instance_dict": {"box_7": {"tag": {"symmetry": sym}}}}, f)
    return str(root)


SPECS = [[(np.array([-0.12, 0.0, 0.7]), 7), (np.array([0.12, 0.0, 0.7]), 9)],
         [(np.array([0.0, 0.0, 0.65]), 7)],
         [(np.array([0.03, -0.02, 0.6]), 9)]]


@pytest.fixture(scope="module")
def frames_png(tmp_path_factory):
    return _write_frames(tmp_path_factory.mktemp("omni_png"), SPECS, use_exr=False)


@pytest.fixture(scope="module")
def frames_exr(tmp_path_factory):
    return _write_frames(tmp_path_factory.mktemp("omni_exr"), SPECS, use_exr=True)


def assert_samples_equal(got: dict, want: dict, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, (what, k)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        if k == "roi_rgb":
            np.testing.assert_allclose(g, w, rtol=0, atol=1.01 / 255 / 0.224,
                                       err_msg=f"{what} {k}")
            assert (np.abs(g - w) > 1e-6).mean() < 1e-3, what
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{what} {k}")
        else:  # integer keys: exact
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


# -------------------------------------------------------------------- PNG
def _encode_png(path, samples, ctype, depth, palette=None, interlace=0):
    """A PNG whose row y carries filter type y % 5, encoded here from the
    PNG spec's predictors."""
    h = samples.shape[0]
    data = samples.astype(">u2") if depth == 16 else samples.astype(np.uint8)
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = CHANNELS[ctype] * depth // 8
    out = []
    for y in range(h):
        f = y % 5
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = a + up - c
        paeth = np.where((abs(p - a) <= abs(p - up)) & (abs(p - a) <= abs(p - c)), a,
                         np.where(abs(p - up) <= abs(p - c), up, c))
        pred = [0 * x, a, up, (a + up) >> 1, paeth][f]
        out.append(np.concatenate([[f], (x - pred) % 256]).astype(np.uint8).tobytes())

    def chunk(kind, d):
        return struct.pack(">I", len(d)) + kind + d + struct.pack(">I", zlib.crc32(kind + d))

    w = samples.shape[1]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
        if palette is not None:
            fh.write(chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        fh.write(chunk(b"IEND", b""))


def _cv2_read(path, flag):
    img = cv2.imread(path, flag)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if flag == cv2.IMREAD_COLOR else img


@pytest.mark.parametrize("flag", [cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (3, 8), (4, 8), (6, 8), (0, 16),
                                         (2, 16)])
def test_png_matches_cv2_imread(tmp_path, ctype, depth, flag):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 23, 37
    if ctype == 3:
        samples, palette = rng.integers(0, 40, (h, w)), rng.integers(0, 256, (40, 3))
    else:
        # a smooth ramp plus noise, so the predictors see small and large steps
        ramp = (np.arange(w)[None, :, None] * 7 + np.arange(h)[:, None, None] * 3)
        samples = (ramp * (257 if depth == 16 else 1)
                   + rng.integers(0, 2 ** depth // 8, (h, w, CHANNELS[ctype]))) % 2 ** depth
        samples, palette = (samples[..., 0] if CHANNELS[ctype] == 1 else samples), None
    path = str(tmp_path / "t.png")
    _encode_png(path, samples, ctype, depth, palette)
    want = _cv2_read(path, flag)
    got = png.read_png(path, flag)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "gray8", "gray16"])
def test_png_reads_cv2_imwrite_and_write_png(tmp_path, kind):
    """cv2.imwrite picks its own filters (adaptive); write_png writes filter 0
    and cv2 reads it back as written."""
    rng = np.random.default_rng(1)
    dt = np.uint16 if kind.endswith("16") else np.uint8
    shape = (48, 64, 3) if kind.startswith("rgb") else (48, 64)
    img = rng.integers(0, np.iinfo(dt).max, shape, dtype=dt)
    img[:20] = img[:1]  # repeated rows: the Up filter
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        np.testing.assert_array_equal(png.read_png(path, flag), _cv2_read(path, flag))
    rgb = img[..., ::-1] if img.ndim == 3 else img
    png.write_png(path, rgb)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "odd.png")
    _encode_png(path, np.zeros((4, 4), np.uint8), 0, 8, interlace=1)
    with pytest.raises(NotImplementedError, match="odd.png: interlaced"):
        png.read_png(path)
    _encode_png(path, np.zeros((4, 4, 4), np.uint16), 6, 16)
    with pytest.raises(NotImplementedError, match="odd.png: PNG color type 6 at 16 bits"):
        png.read_png(path)
    with open(path, "wb") as f:
        f.write(b"GIF89a" + bytes(64))
    with pytest.raises(ValueError, match="odd.png: not a PNG"):
        png.read_png(path)


# -------------------------------------------------------------------- EXR
@pytest.mark.parametrize("native_off", [False, True])
@pytest.mark.parametrize("compression", ["none", "zip", "zips"])
@pytest.mark.parametrize("dtype,channels", [(np.float32, 1), (np.float16, 3), (np.uint32, 4)])
def test_exr_both_directions(tmp_path, monkeypatch, native_off, compression, dtype, channels):
    if native_off:
        monkeypatch.setenv("GP2_DISABLE_NATIVE", "1")
    rng = np.random.default_rng(channels)
    img = (rng.random((33, 21, channels)) * 1000).astype(dtype)
    img = img[..., 0] if channels == 1 else img
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(a, img, compression)
    jexr.write_exr(b, img, compression)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, want in ((exr.read_exr(b), jexr.read_exr(a)), (exr.read_exr(a), img)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- defor_2D
@pytest.mark.parametrize("k", [1, 2, 3])
def test_erode_matches_cv2(k):
    rng = np.random.default_rng(k)
    for _ in range(5):
        m = ((rng.random((19, 27)) > 0.25) * rng.integers(1, 3)).astype(np.uint8)
        m[0], m[:, -1] = 1, 1  # the mask touches the border
        np.testing.assert_array_equal(roi.erode(m, k), cv2.erode(m, np.ones((k, k), np.uint8)))


@pytest.mark.parametrize("rand_r", [1, 2, 3])
def test_defor_2d_matches_jax(rand_r):
    rng = np.random.default_rng(rand_r)
    for seed in range(12):
        m = (rng.random((32, 32)) > 0.3).astype(np.float32)
        m[:, :3] = 1.0  # touching the border
        got = roi.defor_2D(np.random.default_rng(seed), m, rand_r, 0.8)
        want = jroi.defor_2D(np.random.default_rng(seed), m, rand_r, 0.8)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- Omni6DPose
def _datasets(root, mode, **kw):
    jcfg = JaxDataConfig(num_points=128, img_size=64, **kw)
    cfg = DataConfig(num_points=128, img_size=64, **kw)
    return (Omni6DPoseDataset(cfg, mode=mode, data_dir=root),
            JaxOmni(jcfg, mode=mode, data_dir=root))


@pytest.mark.parametrize("native_off", [False, True])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("files", ["png", "exr"])
def test_omni6dpose_samples_match_jax(request, monkeypatch, files, mode, native_off):
    if native_off:
        monkeypatch.setenv("GP2_DISABLE_NATIVE", "1")
    root = request.getfixturevalue(f"frames_{files}")
    port, jax_ds = _datasets(root, mode, roi_mask_pro=0.9)
    assert len(port) == len(jax_ds) == (3 * 8 if mode == "train" else 4)
    idx = range(len(port)) if mode == "test" else [0, 5, 8, 13, 23]
    for epoch in (0, 1):
        port.epoch = jax_ds.epoch = epoch
        for i in idx:
            assert_samples_equal(port[i], jax_ds[i], f"{files} {mode} epoch {epoch} #{i}")


def test_omni6dpose_options_match_jax(frames_png):
    for kw, mode in (({"percentage_data": 0.5}, "train"), ({"per_obj": "c9"}, "test")):
        port, jax_ds = _datasets(frames_png, mode, **kw)
        assert len(port) == len(jax_ds)
        for i in range(len(port)):
            assert_samples_equal(port[i], jax_ds[i], str(kw))
    # the scale agent's noised axes (scipy, the same draws)
    cfg, jcfg = DataConfig(num_points=128, img_size=64), JaxDataConfig(num_points=128, img_size=64)
    port = Omni6DPoseDataset(cfg, "train", frames_png, agent_type="scale", scale_batch_size=8)
    jax_ds = JaxOmni(jcfg, "train", frames_png, agent_type="scale", scale_batch_size=8)
    assert_samples_equal(port[3], jax_ds[3], "scale")
    assert port[3]["axes_training"].shape == (8, 3, 3)


def test_dataloader_matches_jax(frames_png):
    """The same per-epoch permutations, shards, drop_last and batches."""
    class Idx:
        epoch = 0

        def __len__(self):
            return 103

        def __getitem__(self, i):
            return {"idx": np.asarray(i), "epoch": np.asarray(self.epoch)}

    for kw in ({"shuffle": True, "seed": 7}, {"shuffle": False},
               {"shuffle": True, "seed": 3, "drop_last": True},
               {"shuffle": True, "seed": 7, "num_shards": 4, "shard_index": 2}):
        port, jdl = DataLoader(Idx(), 10, num_workers=3, **kw), JaxDataLoader(Idx(), 10,
                                                                             num_workers=3, **kw)
        assert len(port) == len(jdl)
        for _ in range(2):  # two epochs
            got, want = list(port), list(jdl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["idx"], w["idx"])
                np.testing.assert_array_equal(g["epoch"], w["epoch"])
    port, jax_ds = _datasets(frames_png, "train")
    got = list(DataLoader(port, 5, seed=1, num_workers=4))
    want = list(JaxDataLoader(jax_ds, 5, seed=1, num_workers=4))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_samples_equal(g, w, "batch")


def test_dataloader_raises_a_worker_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("sample 2 is broken")
            return {"x": np.asarray(i)}

    with pytest.raises(RuntimeError, match="sample 2"):
        list(DataLoader(Bad(), 2, shuffle=False, num_workers=2))


# ----------------------------------------------------------- augmentation
def _scene(B=5, N=64, seed=0):
    rng = np.random.default_rng(seed)
    R = np.stack([ScipyRot.random(random_state=seed + i).as_matrix() for i in range(B)])
    t = rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.7]
    s = rng.uniform(0.05, 0.2, (B, 3))
    pc = (rng.uniform(-0.5, 0.5, (B, N, 3)) * s[:, None]) @ R.transpose(0, 2, 1) + t[:, None]
    sym = np.array([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 0, 0], [0, 2, 2, 2], [0, 0, 1, 0]][:B])
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(pc), f32(R), f32(t), f32(s), sym.astype(np.int32), f32(
        rng.uniform(-0.05, 0.05, (B, N, 3)))


def T(a):
    return torch.tensor(np.asarray(a))


def J(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_augmentation_pieces_match_jax():
    pc, R, t, s, sym, mp = _scene()
    rng = np.random.default_rng(3)
    aug_bb = rng.uniform(0.8, 1.2, (5, 3)).astype(np.float32)
    for g, w in zip(aug.defor_3d_bb(T(pc), T(mp), T(R), T(t), T(s), T(sym), T(aug_bb)),
                    jaug.defor_3d_bb(*J(pc, mp, R, t, s, sym, aug_bb))):
        _close(g, w)
    angles = rng.uniform(-0.3, 0.3, (5, 3)).astype(np.float32)
    _close(euler_zyx_to_matrix(T(angles)), jax_euler(jnp.asarray(angles)))
    aug_t = rng.normal(0, 0.02, (5, 3)).astype(np.float32)
    aug_R = np.asarray(jax_euler(jnp.asarray(angles)))
    for g, w in zip(aug.defor_3d_rt(T(pc), T(R), T(t), T(aug_t), T(aug_R)),
                    jaug.defor_3d_rt(*J(pc, R, t, aug_t, aug_R))):
        _close(g, w)
    # box cage: JAX draws ey_up / ey_down from the split key; hand them over
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    up = np.asarray(jax.random.uniform(k1, (5, 1), minval=0.8, maxval=1.2))
    down = np.asarray(jax.random.uniform(k2, (5, 1), minval=0.8, maxval=1.2))
    nocs = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    for g, w in zip(aug.defor_3d_bc(T(pc), T(R), T(t), T(s), T(mp), T(nocs), T(up), T(down)),
                    jaug.defor_3d_bc(key, *J(pc, R, t, s, mp, nocs))):
        _close(g, w)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, pc.shape))
    _close(aug.defor_3d_pc(T(pc), T(t), T(u) * 0.2), jaug.defor_3d_pc(key, *J(pc, t), 0.2))


def jax_draws(key, B, N):
    """The draws of genpose2_tpu/data/augmentation.py:data_augment from its
    key, in the port's ``draw_params`` layout."""
    keys = jax.random.split(key, 8)
    kt, kr = jax.random.split(keys[3])
    k1, k2 = jax.random.split(keys[5])
    u = jax.random.uniform
    angles = u(kr, (B, 3), minval=-1.0, maxval=1.0) * jnp.radians(15.0)
    d = {"gate_bb": u(keys[0], (B, 1)), "aug_bb": u(keys[1], (B, 3), minval=0.8, maxval=1.2),
         "gate_rt": u(keys[2], (B, 1)), "aug_t": jax.random.normal(kt, (B, 3)) * 0.02,
         "aug_R": jax_euler(angles), "gate_bc": u(keys[4], (B, 1)),
         "ey_up": u(k1, (B, 1), minval=0.8, maxval=1.2),
         "ey_down": u(k2, (B, 1), minval=0.8, maxval=1.2), "gate_pc": u(keys[6], (B, 1)),
         "pc_u": u(keys[7], (B, N, 3))}
    return {k: T(v) for k, v in d.items()}


@pytest.mark.parametrize("mug_bowl", [False, True])
def test_data_augment_and_process_batch_match_jax(mug_bowl):
    pc, R, t, s, sym, mp = _scene(seed=7)
    B, N = pc.shape[:2]
    params = {"aug_pc_pro": 0.6, "aug_pc_r": 0.2, "aug_rt_pro": 0.6, "aug_bb_pro": 0.6,
              "aug_bc_pro": 0.6}
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, B, N)
    mb = np.array([True, False, True, True, False]) if mug_bowl else None
    nocs = np.full(B, 1.3, np.float32)
    want = jaug.data_augment(key, params, *J(pc, R, t, s, sym), model_point=jnp.asarray(mp),
                             nocs_scale=jnp.asarray(nocs),
                             mug_bowl_mask=None if mb is None else jnp.asarray(mb))
    got = aug.data_augment(params, T(pc), T(R), T(t), T(s), T(sym), T(mp), T(nocs),
                           None if mb is None else T(mb), draws=draws)
    for g, w in zip(got, want):
        _close(g, w)
    # process_batch: the branch runs exactly for NOCS-style batches
    raw = {"pcl_in": pc, "rotation": R, "translation": t, "old_sym_info": sym,
           "fsnet_scale": s * 0.5, "mean_shape": s * 0.5, "model_point": mp,
           "sym_info": sym, "bbox_side_len": s}
    if mb is not None:
        raw["mug_bowl_mask"] = mb
    want = jax_process_batch(dict(raw), "rot_matrix", aug_params=params, aug_key=key)
    got = process_batch(dict(raw), "rot_matrix", aug_params=params, aug_draws=draws)
    for k in ("pts", "zero_mean_gt_pose", "pts_center", "gt_rotation", "gt_translation"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-6,
                                   err_msg=k)
    plain = process_batch({k: v for k, v in raw.items() if k != "old_sym_info"}, "rot_matrix",
                          aug_params=params)  # not NOCS-style: no draws needed, no change
    np.testing.assert_array_equal(plain["pts"].numpy(), pc)
    with pytest.raises(ValueError):
        process_batch(dict(raw), "rot_matrix", aug_params=params)
    # drawn from a generator: the same draws give the same batch
    g1 = process_batch(dict(raw), "rot_matrix", aug_params=params,
                       generator=torch.Generator().manual_seed(1))
    g2 = process_batch(dict(raw), "rot_matrix", aug_params=params,
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(g1["pts"], g2["pts"]) and not torch.equal(g1["pts"], plain["pts"])


# ---------------------------------------------------- tracking and BOP data
@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    size = np.array([0.12, 0.2, 0.08])
    for v in range(2):
        vdir = root / f"vid{v}"
        os.makedirs(vdir)
        base_R = ScipyRot.random(random_state=9 + v).as_matrix()
        for i in range(3):
            R = base_R @ ScipyRot.from_euler("y", 4 * i, degrees=True).as_matrix()
            t = np.array([0.01 * i, 0.0, 0.65])
            depth, mask = render_box_scene(K_CAM, R, t, size)
            prefix = str(vdir / f"{i:04d}_")
            cv2.imwrite(prefix + "color.png", np.full((240, 320, 3), 90, np.uint8))
            cv2.imwrite(prefix + "depth.png", (depth * 1000).astype(np.uint16))
            cv2.imwrite(prefix + "mask.png", mask.astype(np.uint16))
            with open(prefix + "meta.json", "w") as f:
                json.dump({"camera": {"intrinsics": INTR},
                           "objects": [_obj(R, t, 7, "obj_a", 1, size)]}, f)
    os.makedirs(root / "empty_video")
    return str(root)


def test_tracking_datasets_match_jax(video_root, tmp_path):
    cfg, jcfg = DataConfig(num_points=128, img_size=64), JaxDataConfig(num_points=128, img_size=64)
    logs = [str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")]
    port = open_video_datasets(cfg, video_root, fail_log=logs[0])
    want = jax_open_videos(jcfg, video_root, fail_log=logs[1])
    assert len(port) == len(want) == 2
    assert open(logs[0]).read() == open(logs[1]).read() != ""  # the empty video
    for pv, jv in zip(port, want):
        assert pv.oids == jv.oids and len(pv) == len(jv) == 3
        for i in range(3):
            assert_samples_equal(pv[i], jv[i], f"frame {i}")


def _write_bop_scene(scene, ims, cam=None, img_dir="rgb"):
    size_mm = np.array([120.0, 200.0, 80.0])
    sfx = "" if cam is None else f"_{cam}"
    for sub in (f"{img_dir}{sfx}", f"depth{sfx}", f"mask_visib{sfx}"):
        os.makedirs(scene / sub)
    gt, info, camj = {}, {}, {}
    for im in ims:
        R = ScipyRot.random(random_state=im).as_matrix()
        t = np.array([0.01, -0.02, 0.7 if cam != "realsense" else 0.9])
        depth, mask = render_box_scene(K_CAM, R, t, size_mm / 1000.0)
        colour = np.random.default_rng(im).integers(0, 256, (240, 320, 3), dtype=np.uint8)
        cv2.imwrite(str(scene / f"{img_dir}{sfx}" / f"{im:06d}.png"),
                    colour if img_dir == "rgb" else colour[..., 0])
        cv2.imwrite(str(scene / f"depth{sfx}" / f"{im:06d}.png"), (depth * 1000).astype(np.uint16))
        cv2.imwrite(str(scene / f"mask_visib{sfx}" / f"{im:06d}_{0:06d}.png"),
                    ((mask > 0) * 255).astype(np.uint8))
        gt[str(im)] = [{"obj_id": 5, "cam_R_m2c": R.reshape(-1).tolist(),
                        "cam_t_m2c": (t * 1000).tolist()}]
        info[str(im)] = [{"visib_fract": 0.9, "px_count_valid": int((mask > 0).sum())}]
        camj[str(im)] = {"cam_K": K_CAM.reshape(-1).tolist(), "depth_scale": 1.0}
    for name, blob in (("scene_gt", gt), ("scene_gt_info", info), ("scene_camera", camj)):
        with open(scene / f"{name}{sfx}.json", "w") as f:
            json.dump(blob, f)


@pytest.fixture(scope="module")
def bop_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop")
    models = {"5": {"size_x": 120.0, "size_y": 200.0, "size_z": 80.0,
                    "symmetries_continuous": [{"axis": [0, 1, 0], "offset": [0, 0, 0]}]}}
    os.makedirs(root / "models")
    with open(root / "models" / "models_info.json", "w") as f:
        json.dump(models, f)
    _write_bop_scene(root / "test" / "000001", [0, 1])
    _write_bop_scene(root / "val" / "000001", [0], "xyz", "gray")
    _write_bop_scene(root / "val" / "000001", [0], "realsense", "rgb")
    return str(root)


@pytest.mark.parametrize("split,cameras,mode", [("test", None, "train"), ("test", None, "test"),
                                                ("val", ["xyz", "realsense"], "val")])
def test_xyzibd_matches_jax(bop_root, split, cameras, mode):
    cfg, jcfg = DataConfig(num_points=128, img_size=64), JaxDataConfig(num_points=128, img_size=64)
    kw = dict(mode=mode, cameras=cameras, trans_mean=[0.01, 0.0, 0.5], trans_std=[1.0, 2.0, 0.5])
    port = XyzibdDataset(cfg, os.path.join(bop_root, split), **kw)
    want = JaxXyzibd(jcfg, os.path.join(bop_root, split), **kw)
    assert port.samples == want.samples and len(port) == 2
    for epoch in (0, 1):
        port.epoch = want.epoch = epoch
        for i in range(len(port)):
            assert_samples_equal(port[i], want[i], f"{split} {mode} #{i}")


def test_bop_symmetry_labels_match_jax():
    mats = []
    for deg in (90, 180, 270):
        M = np.eye(4)
        M[:3, :3] = ScipyRot.from_euler("y", deg, degrees=True).as_matrix()
        mats.append(M.reshape(-1).tolist())
    half = np.eye(4)
    half[:3, :3] = ScipyRot.from_euler("z", 180, degrees=True).as_matrix()
    for mi in ({}, {"symmetries_discrete": mats}, {"symmetries_discrete": [half.ravel().tolist()]},
               {"symmetries_continuous": [{"axis": [0, 0, 1]}]}):
        np.testing.assert_array_equal(bop_symmetry_label(mi), jax_bop_symmetry_label(mi))


# ----------------------------------------------------------------- logging
def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), "score")
    log.log(3, {"loss": torch.tensor(1.5), "lr": 0.1, "name": "skipped"})
    log.close()
    rec = json.loads(open(tmp_path / "score_metrics.jsonl").read())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["lr"] == 0.1 and "name" not in rec


# ------------------------------------------------------------------ imports
def test_port_imports_no_cv2_pil_or_jax():
    """Every module of the port imports with cv2, PIL and jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('cv2', 'PIL', 'jax', 'jaxlib', 'flax', 'genpose2_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import genpose2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in ('cv2', 'PIL', 'jax', 'genpose2_tpu') if sys.modules.get(m)]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 50
