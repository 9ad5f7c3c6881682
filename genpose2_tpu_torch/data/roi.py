"""Host-side RoI crops without OpenCV (port of genpose2_tpu/data/roi.py, the
eval branch): square crop windows, the dynamic zoom-in window, the CenterNet
affine, and the affine crop itself.

``get_affine_transform`` solves the 3-point affine as ``cv2.getAffineTransform``
does: a 6x6 system in float64 by Gaussian elimination with partial pivoting,
in OpenCV's order of operations. ``crop_resize_by_warp_affine`` reproduces
``cv2.warpAffine`` with a constant zero border as OpenCV 4.11 and later
compute it. The affine is inverted in float64. For 1, 3 and 4 channels (RGB,
depth, mask) the inverse is rounded to float32 and each output pixel's source
position is ``x * M0 + (y * M1 + M2)`` in float32 with fused multiply-adds;
nearest takes that position rounded half to even, bilinear interpolates the
four neighbours in float32 (pixels outside the image are 0) and rounds half
to even for uint8. Other channel counts (the 2-channel coordinate map) keep
OpenCV's older fixed-point map: the inverse in units of 1/1024 (AB_BITS = 10),
floored. Nearest is equal to OpenCV's; bilinear uint8 may differ by one
level where OpenCV's vector code orders the float32 operations otherwise.

Host code in numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

INTER_NEAREST = 0  # cv2.INTER_NEAREST
INTER_LINEAR = 1  # cv2.INTER_LINEAR


def get_2d_coord_np(width: int, height: int, fmt: str = "CHW") -> np.ndarray:
    x = np.linspace(0, width - 1, width, dtype=np.float32)
    y = np.linspace(0, height - 1, height, dtype=np.float32)
    xy = np.asarray(np.meshgrid(x, y))
    if fmt == "HWC":
        xy = xy.transpose(1, 2, 0)
    return xy


def get_bbox(bbox, img_height: int = 480, img_length: int = 640):
    """(y1, x1, y2, x2) -> square (rmin, rmax, cmin, cmax), side quantized to
    40 px and clamped into the image."""
    y1, x1, y2, x2 = bbox
    window_size = (max(y2 - y1, x2 - x1) // 40 + 1) * 40
    window_size = min(window_size, img_height - 40, img_length - 40)
    center = [(y1 + y2) // 2, (x1 + x2) // 2]
    rmin = center[0] - int(window_size / 2)
    rmax = center[0] + int(window_size / 2)
    cmin = center[1] - int(window_size / 2)
    cmax = center[1] + int(window_size / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_height:
        rmin -= rmax - img_height
        rmax = img_height
    if cmax > img_length:
        cmin -= cmax - img_length
        cmax = img_length
    return rmin, rmax, cmin, cmax


def aug_bbox_dzi(rng: np.random.Generator, bbox_xyxy: np.ndarray, im_h: int, im_w: int,
                 pad_scale: float = 1.5, dzi_type: str = "uniform", scale_ratio: float = 0.25,
                 shift_ratio: float = 0.25):
    """Dynamic zoom-in: returns (center (2,), square side)."""
    x1, y1, x2, y2 = np.asarray(bbox_xyxy, np.float64).copy()
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bh, bw = y2 - y1, x2 - x1
    if dzi_type == "uniform":
        s = 1 + scale_ratio * (2 * rng.random() - 1)
        sh = shift_ratio * (2 * rng.random(2) - 1)
        center = np.array([cx + bw * sh[0], cy + bh * sh[1]])
        scale = max(bh, bw) * s * pad_scale
    elif dzi_type == "roi10d":
        a, b = -0.15, 0.15
        x1 += bw * (rng.random() * (b - a) + a)
        x2 += bw * (rng.random() * (b - a) + a)
        y1 += bh * (rng.random() * (b - a) + a)
        y2 += bh * (rng.random() * (b - a) + a)
        x1, x2 = np.clip(x1, 0, im_w), np.clip(x2, 0, im_w)
        y1, y2 = np.clip(y1, 0, im_h), np.clip(y2, 0, im_h)
        center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
        scale = max(y2 - y1, x2 - x1) * pad_scale
    elif dzi_type == "none":
        center = np.array([cx, cy])
        scale = max(bh, bw)
    else:
        raise NotImplementedError(dzi_type)
    return center, float(min(scale, max(im_h, im_w)))


def aug_bbox_eval(bbox_xyxy, im_h, im_w):
    """Deterministic eval-time window."""
    return aug_bbox_dzi(np.random.default_rng(0), bbox_xyxy, im_h, im_w, dzi_type="none")


def _lu_solve(a: list, b: list) -> list:
    """Solve the n x n system a x = b (row-major lists of Python floats) as
    OpenCV's LUImpl does: partial pivoting on the largest |a[j][i]|, rows
    updated with alpha = a[j][i] * (-1 / a[i][i]), back substitution divided
    by the pivot."""
    n = len(b)
    a = [row[:] for row in a]
    b = b[:]
    for i in range(n):
        k = i
        for j in range(i + 1, n):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < 100 * np.finfo(np.float64).eps:
            raise np.linalg.LinAlgError("degenerate affine points")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, n):
            alpha = a[j][i] * d
            for c in range(i + 1, n):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(n - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, n):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def _affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getAffineTransform: (3, 2) float32 point sets -> (2, 3) float64."""
    a, b = [], []
    for (sx, sy), (dx, dy) in zip(src.astype(np.float64), dst.astype(np.float64)):
        a.append([float(sx), float(sy), 1.0, 0.0, 0.0, 0.0])
        a.append([0.0, 0.0, 0.0, float(sx), float(sy), 1.0])
        b += [float(dx), float(dy)]
    return np.array(_lu_solve(a, b), np.float64).reshape(2, 3)


def _get_3rd_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def get_affine_transform(center, scale, rot_deg, output_size, inv=False) -> np.ndarray:
    """CenterNet affine from a square source window to the output crop, (2, 3) float64."""
    center = np.asarray(center, np.float32)
    if isinstance(scale, (int, float)):
        scale = np.array([scale, scale], np.float32)
    if isinstance(output_size, (int, float)):
        output_size = (output_size, output_size)
    src_w = scale[0]
    dst_w, dst_h = output_size
    rot = np.pi * rot_deg / 180
    sn, cs = np.sin(rot), np.cos(rot)
    # get_dir([0, -w/2], rot): (x cos - y sin, x sin + y cos)
    src_dir = np.array([0 * cs - (src_w * -0.5) * sn, 0 * sn + (src_w * -0.5) * cs], np.float32)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)
    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])
    if inv:
        return _affine_from_points(dst, src)
    return _affine_from_points(src, dst)


def _inverse_map(M: np.ndarray) -> list:
    """cv2.warpAffine's inversion of the forward (2, 3) map, in float64."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)]
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0], m[1], m[3], m[4] = a11, m[1] * -D, m[3] * -D, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (exact in float64 at these magnitudes)."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _source_positions(M: np.ndarray, dh: int, dw: int):
    """(dh, dw) float32 source x and y of every output pixel."""
    m = np.array(_inverse_map(M), np.float32)
    xs = np.arange(dw, dtype=np.float32)[None, :]
    ys = np.arange(dh, dtype=np.float32)[:, None]
    sx = _fma32(m[0], xs, _fma32(m[1], ys, m[2]))
    sy = _fma32(m[3], xs, _fma32(m[4], ys, m[5]))
    return sx, sy


def _fixed_point_nearest(M: np.ndarray, dh: int, dw: int):
    """(rows, cols) of the older fixed-point map that OpenCV keeps for other
    channel counts: the inverse map in units of 1/1024 (AB_BITS = 10),
    rounded half to even per term, plus half a unit, floored."""
    m = _inverse_map(M)
    ab = 1 << 10
    xs = np.arange(dw, dtype=np.float64)
    ys = np.arange(dh, dtype=np.float64)
    adelta = np.rint(m[0] * xs * ab).astype(np.int64)
    bdelta = np.rint(m[3] * xs * ab).astype(np.int64)
    x0 = np.rint((m[1] * ys + m[2]) * ab).astype(np.int64) + ab // 2
    y0 = np.rint((m[4] * ys + m[5]) * ab).astype(np.int64) + ab // 2
    cols = np.clip((x0[:, None] + adelta[None, :]) >> 10, -32768, 32767)
    rows = np.clip((y0[:, None] + bdelta[None, :]) >> 10, -32768, 32767)
    return rows, cols


class _Gather:
    """img[rows, cols] with 0 outside the image, as one gather from the flat
    image with a zero pixel appended, which every outside position reads."""

    def __init__(self, img: np.ndarray):
        self.h, self.w = img.shape[:2]
        self.tail = img.shape[2:]
        flat = img.reshape(self.h * self.w, -1)
        self.pixels = np.concatenate([flat, np.zeros((1, flat.shape[1]), img.dtype)])

    def __call__(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        inside = (rows >= 0) & (rows < self.h) & (cols >= 0) & (cols < self.w)
        index = np.where(inside, rows * self.w + cols, self.h * self.w)
        return np.take(self.pixels, index, axis=0).reshape(rows.shape + self.tail)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Sequence[int],
                interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags=interpolation)`` with a constant 0
    border: img (H, W) or (H, W, C) uint8 or float32, M the forward (2, 3)
    map, dsize (width, height). 1, 3 and 4 channels take OpenCV's float32
    map; other channel counts its fixed-point map (nearest only)."""
    dw, dh = int(dsize[0]), int(dsize[1])
    take = _Gather(img)
    float_map = img.ndim == 2 or img.shape[2] in (1, 3, 4)
    if interpolation == INTER_NEAREST and not float_map:
        return take(*_fixed_point_nearest(M, dh, dw))
    if interpolation not in (INTER_NEAREST, INTER_LINEAR) or not float_map:
        raise NotImplementedError(f"interpolation {interpolation} of {img.shape}")
    sx, sy = _source_positions(M, dh, dw)
    if interpolation == INTER_NEAREST:
        return take(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    x0, y0 = np.floor(sx), np.floor(sy)
    a, b = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = take(y0, x0).astype(np.float32), take(y0, x0 + 1).astype(np.float32)
    p10, p11 = take(y0 + 1, x0).astype(np.float32), take(y0 + 1, x0 + 1).astype(np.float32)
    v = _lerp(b, _lerp(a, p00, p01), _lerp(a, p10, p11))
    if img.dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v.astype(img.dtype)


def _lerp(t: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """float32 lo + t * (hi - lo) with the product and sum fused."""
    return (t.astype(np.float64) * (hi - lo).astype(np.float64) + lo).astype(np.float32)


def crop_resize_by_warp_affine(img, center, scale, output_size, rot=0,
                               interpolation: int = INTER_LINEAR) -> np.ndarray:
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    trans = get_affine_transform(center, scale, rot, output_size)
    return warp_affine(img, trans, (int(output_size[0]), int(output_size[1])), interpolation)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_rgb(rgb_hwc_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC, ImageNet-normalized."""
    x = rgb_hwc_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
