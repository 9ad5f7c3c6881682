"""A PNG reader that gives what ``cv2.imread`` gives, without OpenCV (the card's
machine has none), and a minimal writer for fixtures.

``read_png(path, IMREAD_COLOR)`` returns (H, W, 3) uint8 RGB: what the JAX
package's ``cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``
gives. Gray is repeated into three channels, alpha is dropped, and a 16-bit
image keeps each sample's high byte. ``read_png(path, IMREAD_UNCHANGED)``
returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives: (H, W) for
gray, BGR or BGRA channels otherwise (gray with alpha repeats the gray),
uint8 or uint16 as stored; a palette image is expanded to BGR.

Supported: color types 0 (gray), 2 (RGB), 3 (palette), 4 (gray and alpha)
and 6 (RGBA) at 8 bits, 0 and 2 at 16 bits, every filter type, not
interlaced, no ``tRNS`` chunk. Anything else raises, naming the file.

zlib inflates the image data. The scanlines are unfiltered by
``csrc/png_unfilter.cc``, built with ``g++`` at first use into
``ops/_build/`` (git ignores it) and loaded with ctypes: the Average and
Paeth filters read the pixel to the left, so a Python loop would take about
a second a 640x480 frame. When the library cannot be built, reading raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

IMREAD_UNCHANGED = -1  # cv2.IMREAD_UNCHANGED
IMREAD_COLOR = 1  # cv2.IMREAD_COLOR, returned as RGB

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_SOURCE = Path(__file__).with_name("csrc") / "png_unfilter.cc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "_build"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    """The unfilter library, built on first use; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_CXX_FLAGS).encode())
        path = _BUILD_DIR / f"libpng_unfilter_{h.hexdigest()[:16]}.so"
        if not path.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("png: no C++ compiler (g++) to build png_unfilter.cc")
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"png: building {_SOURCE} failed:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gp2_png_unfilter.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.gp2_png_unfilter.restype = ctypes.c_int
        _lib = lib
        return _lib


def _chunks(buf: bytes, path: str):
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off = 8
    while off + 8 <= len(buf):
        (n,) = struct.unpack_from(">I", buf, off)
        kind = buf[off + 4:off + 8]
        yield kind, buf[off + 8:off + 8 + n]
        if kind == b"IEND":
            return
        off += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def read_png(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread`` gives it (see the module
    docstring); ``flags`` is IMREAD_COLOR (RGB) or IMREAD_UNCHANGED."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f"read_png: flags {flags}, expected IMREAD_COLOR or IMREAD_UNCHANGED")
    with open(path, "rb") as f:
        buf = f.read()
    header, palette, idat = None, None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"tRNS":
            raise NotImplementedError(f"{path}: PNG with a tRNS chunk is not supported")
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype not in (0, 2)):
        raise NotImplementedError(f"{path}: PNG color type {ctype} at {depth} bits is not "
                                  "supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    rc = _library().gp2_png_unfilter(np.ascontiguousarray(raw), out, h, stride, bpp)
    if rc != 0:
        raise ValueError(f"{path}: unknown PNG filter type in row {-rc - 1}")
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    if ctype == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the PLTE entries")
        img = palette[img[..., 0]]
    if flags == IMREAD_COLOR:
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.shape[-1] in (1, 2):  # gray, gray + alpha
            img = np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    if ctype == 0:
        return np.ascontiguousarray(img[..., 0])
    if ctype == 4:  # gray + alpha -> BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0, 3][:img.shape[-1]]  # RGB(A) -> BGR(A)
    return np.ascontiguousarray(img[..., order])


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) RGB, uint8 or uint16, with filter 0 on
    every row (for fixtures)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png: (H, W) or (H, W, 3) uint8/uint16, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = rows.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
