"""Minimal OpenEXR scanline codec (numpy), for float depth/mask images (port
of genpose2_tpu/data/exr.py: read_exr, write_exr).

The Omni6DPose data ships float32 EXR depth maps
(reference: datasets_omni6dpose.py loads '<prefix>depth.exr' via
``cv2.imread(..., IMREAD_UNCHANGED)``), but OpenCV builds without the OpenEXR
contrib codec (like this environment's) cannot read them at all. This module
implements the needed slice of the OpenEXR 2 spec natively:

- single-part scanline images, compression NONE / ZIP / ZIPS (what OpenEXR's
  default writers — including OpenCV's — emit; PIZ/B44/DWA are not supported),
- channel types HALF, FLOAT, UINT; any channel count (sorted by name, per
  spec); no sub-sampling.

ZIP chunks are zlib streams of predictor-delta-encoded, two-way interleaved
bytes (OpenEXR's ``reconstruct``/``interleave`` scheme); inflate runs in
zlib's C code, the reorder is vectorized numpy — decode speed is bounded by
zlib, not Python.

The writer emits the same scanline format (used by tests for round-trips and
by the synthetic-data fabricators).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from genpose2_tpu_torch.data import native as _native

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXELTYPE_INV = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_CHUNK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist attribute -> [(name, pixel_type)] in file order."""
    out = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        ptype, _plinear, _r0, _r1, _r2, xs, ys = struct.unpack_from(
            "<iBBBBii", data, off
        )
        off += 16  # type(4) + pLinear(1) + reserved(3) + xs(4) + ys(4)
        if xs != 1 or ys != 1:
            raise NotImplementedError(
                f"EXR channel sub-sampling ({xs}x{ys}) not supported"
            )
        out.append((name, ptype))
    return out


def _reconstruct_and_deinterleave(raw: bytes) -> np.ndarray:
    """OpenEXR ZIP post-inflate reorder: byte delta-decode then interleave the
    two halves (spec: ImfZip.cpp reconstruct + interleave)."""
    # the predictor is sequential (d[i] = d[i] + d[i-1] - 128 mod 256), but has
    # the closed cumulative form out[i] = (sum_{j<=i} d[j] - 128*i) mod 256.
    # uint8 cumsum wraps mod 256 natively, and 128*i mod 256 alternates 0/128,
    # so the whole decode is one wrapping cumsum + one subtract (this is the
    # loader's hottest few lines: ~half of an EXR depth decode).
    d = np.frombuffer(raw, np.uint8)
    out = np.cumsum(d, dtype=np.uint8)
    out[1::2] -= 128
    # deinterleave: even output positions from the first half, odd from second
    n = out.size
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = out[:half]
    res[1::2] = out[half:]
    return res


def _interleave_and_predict(data: bytes) -> bytes:
    """Inverse of _reconstruct_and_deinterleave (for the ZIP writer)."""
    d = np.frombuffer(data, np.uint8)
    n = d.size
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = d[0::2]
    inter[half:] = d[1::2]
    # e[i] = x[i] - x[i-1] + 128 (mod 256) — a plain first difference
    e = np.empty(n, np.int64)
    e[0] = inter[0]
    e[1:] = inter[1:].astype(np.int64) - inter[:-1].astype(np.int64) + 128
    return (e % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Returns (H, W) for single-channel files or (H, W, C) with channels in
    ALPHABETICAL name order (R,G,B -> B,G,R would be file order; we return
    file order, which the spec requires to be sorted)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x1000 or version & 0x800:
        raise NotImplementedError("tiled / multi-part / deep EXR not supported")

    off = 8
    attrs: Dict[str, bytes] = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        _type, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        attrs[name] = buf[off : off + size]
        off += size
    off += 1  # header terminator

    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in (_NO_COMPRESSION, _ZIPS, _ZIP):
        raise NotImplementedError(f"EXR compression {compression} not supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    num_chunks = -(-H // lines_per_chunk)

    # scanline offset table
    offsets = struct.unpack_from(f"<{num_chunks}q", buf, off)

    dtypes = [np.dtype(_PIXELTYPE[t]) for _, t in channels]
    bytes_per_px = sum(dt.itemsize for dt in dtypes)
    planes = [np.empty((H, W), dt) for dt in dtypes]

    for ci in range(num_chunks):
        o = offsets[ci]
        y, size = struct.unpack_from("<ii", buf, o)
        data = buf[o + 8 : o + 8 + size]
        rows = min(lines_per_chunk, y1 - y + 1)
        expect = rows * W * bytes_per_px
        if compression != _NO_COMPRESSION and size < expect:
            # native C path fuses inflate + predictor + deinterleave into one
            # cache-resident sweep (native/gp2_host.cc:gp2_exr_chunk, bound by data/native.py)
            arr = _native.exr_chunk(data, expect)
            if arr is None:
                arr = _reconstruct_and_deinterleave(zlib.decompress(data))
            arr = arr.reshape(rows, expect // rows)
        else:
            arr = np.frombuffer(data, np.uint8).reshape(rows, expect // rows)
        # per scanline: channels in file order, each a full row
        row0 = y - y0
        col = 0
        for p, dt in zip(planes, dtypes):
            w = W * dt.itemsize
            p[row0 : row0 + rows] = (
                arr[:, col : col + w].copy().view(dt).reshape(rows, W)
            )
            col += w

    if len(planes) == 1:
        return planes[0]
    return np.stack(planes, axis=-1)


def write_exr(path: str, img: np.ndarray, compression: str = "zip") -> None:
    """Write (H, W) or (H, W, C) as scanline EXR. float32/float16/uint32.
    Channel names: single -> 'Y'; 3 -> B,G,R (OpenCV layout); else C0..Cn."""
    comp = {"none": _NO_COMPRESSION, "zip": _ZIP, "zips": _ZIPS}[compression]
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    if img.dtype == np.float64:
        img = img.astype(np.float32)
    # zero-padded generic names keep numeric order == the spec's sorted-name
    # order for any channel count (C10 would otherwise sort before C2)
    names = ["Y"] if C == 1 else (["B", "G", "R"] if C == 3 else [f"C{i:03d}" for i in range(C)])
    order = np.argsort(names)  # spec: channels sorted by name
    ptype = _PIXELTYPE_INV[img.dtype]

    def attr(name, typ, payload):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload

    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\x00" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chlist += b"\x00"
    dw = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp])),
            attr("dataWindow", "box2i", dw),
            attr("displayWindow", "box2i", dw),
            attr("lineOrder", "lineOrder", b"\x00"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    lines_per_chunk = _LINES_PER_CHUNK[comp]
    num_chunks = -(-H // lines_per_chunk)
    chunks = []
    for ci in range(num_chunks):
        r0 = ci * lines_per_chunk
        rows = min(lines_per_chunk, H - r0)
        row_bytes = []
        for r in range(r0, r0 + rows):
            for i in order:
                row_bytes.append(np.ascontiguousarray(img[r, :, i]).tobytes())
        data = b"".join(row_bytes)
        if comp != _NO_COMPRESSION:
            z = zlib.compress(_interleave_and_predict(data))
            if len(z) < len(data):
                data = z
        chunks.append((r0, data))

    base = 8 + len(header) + 8 * num_chunks
    offsets = []
    o = base
    for _, data in chunks:
        offsets.append(o)
        o += 8 + len(data)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{num_chunks}q", *offsets))
        for (y, data) in chunks:
            f.write(struct.pack("<ii", y, len(data)))
            f.write(data)
