"""Token-major multi-head self-attention of the ViT backbone (port of
genpose2_tpu/ops/vit_attention.py:vit_attention_tm, rope=False).

q, k, v (B, N, C) stay in the layout the qkv projection gives them; head h is
columns h*D .. h*D+D-1. Scores are float32 with the scale 1/sqrt(D) applied
after the product, keys at or past ``n_valid`` get -1e9, the softmax is
float32, the probabilities are rounded to v's dtype before the PV product,
and the output is float32. Query rows at or past ``n_valid`` hold finite
values the caller slices off.

``vit_attention_tm`` launches ``csrc/vit_attention.cu`` on CUDA tensors and
runs ``vit_attention_tm_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from genpose2_tpu_torch.ops import _cuda


def vit_attention_tm_plain(q, k, v, num_heads: int, n_valid: Optional[int] = None):
    B, N, C = q.shape
    D = C // num_heads
    n_valid = N if n_valid is None else n_valid

    def heads(t):
        return t.float().reshape(B, N, num_heads, D).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(D))
    mask = torch.where(torch.arange(N, device=q.device) < n_valid, 0.0, -1e9)
    p = torch.softmax(scores + mask, dim=-1).to(v.dtype).float()
    return (p @ heads(v)).transpose(1, 2).reshape(B, N, C)


def _vit_attention_cuda(q, k, v, num_heads, n_valid):
    B, N, C = q.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16) or C % num_heads:
        raise ValueError(f"dtype {q.dtype}, C={C}, {num_heads} heads: the kernel takes "
                         "float32 or bfloat16 and heads dividing C")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t, name, q.dtype, (B, N, C), dev)
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    lib = _cuda.library("vit_attention")
    lib.gp2_vit_attention.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.gp2_vit_attention.restype = ctypes.c_int
    code = lib.gp2_vit_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N,
                                 C, num_heads, n_valid, 1.0 / math.sqrt(C // num_heads),
                                 int(q.dtype == torch.bfloat16), _cuda.stream_ptr(q))
    _cuda.check(lib, code, "vit_attention")
    _cuda.launch_counts["vit_attention"] += 1
    return out


def vit_attention_tm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     n_valid: Optional[int] = None) -> torch.Tensor:
    """q, k, v (B, N, C) -> (B, N, C) float32; keys >= n_valid masked."""
    n_valid = q.shape[1] if n_valid is None else n_valid
    if q.device.type == "cpu":
        return vit_attention_tm_plain(q, k, v, num_heads, n_valid)
    return _vit_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
                               n_valid)
