"""Token-major multi-head self-attention of the ViT backbone (port of
genpose2_tpu/ops/vit_attention.py: ``vit_attention_tm``, with and without
RoPE inside the kernel, and ``vit_attention``, the route for a token axis that
is not padded to the sublane tile).

q, k, v (B, N, C) stay in the layout the qkv projection gives them; head h is
columns h*D .. h*D+D-1. Scores are float32 with the scale 1/sqrt(D) applied
after the product, keys at or past ``n_valid`` get -1e9, the softmax is
float32, the probabilities are rounded to v's dtype before the PV product,
and the output is float32. Query rows at or past ``n_valid`` hold finite
values the caller slices off.

- ``vit_attention_tm(q, k, v, H, n_valid)``: N padded by the caller
  (``DinoV3ViT`` pads once for all blocks);
- ``vit_attention_tm(..., sin=, cos=)``: the (N, D) float32 tables, the same
  for every head, rotate q and k first: x * cos + rotate_half(x) * sin in
  float32, rounded back to the input dtype;
- ``vit_attention(q, k, v, H, n_valid)``: any N. The TPU kernel transposes to
  head-major and pads N for Mosaic; the result is the same function.

Each launches its entry of ``csrc/vit_attention.cu`` on CUDA tensors and runs
its ``_plain`` version otherwise (``_cuda.launches``), for any N and head dims to 128 (a wider
head raises a ValueError).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from genpose2_tpu_torch.ops import _cuda


def _roped(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, num_heads: int):
    """x (B, N, C) with every head rotated by the (N, D) tables, in float32,
    rounded back to x's dtype."""
    B, N, C = x.shape
    D = C // num_heads
    xf = x.float().reshape(B, N, num_heads, D)
    rot = torch.cat([-xf[..., D // 2:], xf[..., :D // 2]], dim=-1)
    out = xf * cos.float()[None, :, None] + rot * sin.float()[None, :, None]
    return out.reshape(B, N, C).to(x.dtype)


def vit_attention_tm_plain(q, k, v, num_heads: int, n_valid: Optional[int] = None,
                           sin: Optional[torch.Tensor] = None, cos: Optional[torch.Tensor] = None):
    B, N, C = q.shape
    D = C // num_heads
    n_valid = N if n_valid is None else n_valid
    if sin is not None:
        q, k = _roped(q, sin, cos, num_heads), _roped(k, sin, cos, num_heads)

    def heads(t):
        return t.float().reshape(B, N, num_heads, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(D))
    mask = torch.where(torch.arange(N, device=q.device) < n_valid, 0.0, -1e9)
    p = torch.softmax(scores + mask, dim=-1).to(v.dtype).float()
    return (p @ heads(v)).transpose(1, 2).reshape(B, N, C)


def vit_attention_plain(q, k, v, num_heads: int, n_valid: Optional[int] = None):
    return vit_attention_tm_plain(q, k, v, num_heads, n_valid)


@functools.lru_cache(maxsize=None)
def _max_tokens(device_index: int, head_dim: int, bf16: int) -> int:
    lib = _cuda.library("vit_attention")
    lib.gp2_vit_attention_max_tokens.argtypes = [ctypes.c_int, ctypes.c_int]
    with torch.cuda.device(device_index):
        return lib.gp2_vit_attention_max_tokens(head_dim, bf16)


def vit_attention_max_tokens(head_dim: int, dtype: torch.dtype, device=None) -> int:
    """The kernel's route switch on the card (the current one when ``device``
    is None) at this head dim and dtype: up to this many tokens a block holds
    one head's K and V whole, past it K and V stream through shared memory in
    key windows (0: the head dim is not supported)."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return _max_tokens(index if index is not None else torch.cuda.current_device(), head_dim,
                       int(dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_tables: int):
    fn = getattr(_cuda.library("vit_attention"), name)
    fn.argtypes = [ctypes.c_void_p] * (4 + n_tables) + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vit_attention_cuda(entry, key, q, k, v, num_heads, n_valid, tables=()):
    B, N, C = q.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16) or C % num_heads:
        raise ValueError(f"dtype {q.dtype}, C={C}, {num_heads} heads: the kernel takes "
                         "float32 or bfloat16 and heads dividing C")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t, name, q.dtype, (B, N, C), dev)
    for name, t in zip(("sin", "cos"), tables):
        _cuda.require(t, name, torch.float32, (N, C // num_heads), dev)
    D = C // num_heads
    if vit_attention_max_tokens(D, q.dtype, dev) == 0:
        raise ValueError(f"head dim {D}: the kernel takes head dims up to 128")
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    fn = _entry(entry, len(tables))
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in tables),
              out.data_ptr(), B, N, C, num_heads, n_valid, 1.0 / math.sqrt(D),
              int(q.dtype == torch.bfloat16), _cuda.stream_ptr(q))
    _cuda.check(_cuda.library("vit_attention"), code, key)
    _cuda.launch_counts[key] += 1
    return out


def vit_attention_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     n_valid: Optional[int] = None, sin: Optional[torch.Tensor] = None,
                     cos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, N, C) -> (B, N, C) float32; keys >= n_valid masked; with
    ``sin``/``cos`` (N, C // num_heads) RoPE on q and k inside the kernel."""
    n_valid = q.shape[1] if n_valid is None else n_valid
    if not _cuda.launches(q):
        return vit_attention_tm_plain(q, k, v, num_heads, n_valid, sin, cos)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if sin is None:
        return _vit_attention_cuda("gp2_vit_attention", "vit_attention", q, k, v, num_heads,
                                   n_valid)
    tables = (sin.float().contiguous(), cos.float().contiguous())
    return _vit_attention_cuda("gp2_vit_attention_rope", "vit_attention_rope", q, k, v,
                               num_heads, n_valid, tables)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """q, k, v (B, N, C), any N -> (B, N, C) float32; keys >= n_valid masked."""
    n_valid = q.shape[1] if n_valid is None else n_valid
    if not _cuda.launches(q):
        return vit_attention_plain(q, k, v, num_heads, n_valid)
    return _vit_attention_cuda("gp2_vit_attention_unpadded", "vit_attention_unpadded",
                               q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
                               n_valid)
