"""Attention with a relative-position bias from the points' coordinates (port
of genpose2_tpu/ops/relpe_attention.py:relpe_attention).

``relpe_attention(xyz, q, k, v, pe, H)`` is
``softmax(split_heads(q) split_heads(k)^T / sqrt(D) + pe(xyz)) split_heads(v)``
for pre-projected q, k, v (B, M, C) and an
``EfficientRelativePositionalEncoding`` ``pe``, returned token-major
(B, M, C) float32 (before ``wo``). With ``compute_dtype='bfloat16'`` q, k, v
are rounded to bf16 and so are the probabilities before the PV product; the
bias, the scores and the softmax stay float32.

On CUDA tensors it launches ``csrc/relpe_attention.cu``, which builds the bias
per query tile from xyz and never writes a (B, H, M, M) tensor; the bias MLP's
second layers and the fusion layer are folded into per-head constants first
(``fold_pe``). The kernel takes 8 heads of an even width D = C / 8 up to
128 (the flagship's widest stage); a wider head raises RuntimeError with
CUDA's invalid-value code. Otherwise (``_cuda.launches``) it runs ``relpe_attention_plain``: the
module math (build the bias, then softmax attention), a few objects at a time.
"""

from __future__ import annotations

import ctypes
import math

import torch

from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ode_rk4 import compute_dtype_of

_PLAIN_ROWS = 8  # objects per step of the plain version: its bias is (rows, H, M, M)


def relpe_attention_plain(xyz, q, k, v, pe, num_heads: int,
                          compute_dtype: str = "float32") -> torch.Tensor:
    cdt = compute_dtype_of(compute_dtype)
    rows = _PLAIN_ROWS
    B, M, C = q.shape
    H, D = num_heads, C // num_heads
    outs = []
    for s in range(0, B, rows):
        def heads(t):
            return t[s:s + rows].to(cdt).float().reshape(-1, M, H, D).transpose(1, 2)

        bias = pe(xyz[s:s + rows].float())
        scores = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(D)) + bias
        p = torch.softmax(scores, dim=-1).to(cdt).float()
        outs.append((p @ heads(v)).transpose(1, 2).reshape(-1, M, C))
    return torch.cat(outs)


def fold_pe(pe) -> torch.Tensor:
    """The kernel's constants, float32, in csrc/relpe_attention.cu's order:
    w1d[16] b1d[16] w1r[3][16] b1r[16] wfd[16][H] wfr[16][H] bc[H], with
    wfd = W2d @ Wf[:H], wfr = W2r @ Wf[H:], bc = b2d @ Wf[:H] + b2r @ Wf[H:] + bf
    (weights as (in, out))."""
    H = pe.num_heads
    d0, d2 = pe.distance_encoder[0], pe.distance_encoder[2]
    r0, r2 = pe.direction_encoder[0], pe.direction_encoder[2]
    wf = pe.fusion.weight.float().t()  # (2H, H)
    wfd = d2.weight.float().t() @ wf[:H]
    wfr = r2.weight.float().t() @ wf[H:]
    bc = d2.bias.float() @ wf[:H] + r2.bias.float() @ wf[H:] + pe.fusion.bias.float()
    parts = [d0.weight[:, 0], d0.bias, r0.weight.t(), r0.bias, wfd, wfr, bc]
    return torch.cat([p.detach().float().reshape(-1) for p in parts]).contiguous()


def _relpe_cuda(xyz, q, k, v, pe, num_heads, compute_dtype):
    cdt = compute_dtype_of(compute_dtype)
    B, M, C = q.shape
    dev = q.device
    if num_heads != 8 or C % (2 * num_heads):
        raise ValueError(f"C={C}, {num_heads} heads; the kernel takes 8 heads of an even width")
    _cuda.require(xyz, "xyz", torch.float32, (B, M, 3), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t, name, cdt, (B, M, C), dev)
    consts = fold_pe(pe).to(dev)
    out = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    lib = _cuda.library("relpe_attention")
    lib.gp2_relpe_attention.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.gp2_relpe_attention.restype = ctypes.c_int
    code = lib.gp2_relpe_attention(xyz.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   consts.data_ptr(), out.data_ptr(), B, M, C, num_heads,
                                   1.0 / math.sqrt(C // num_heads), int(cdt == torch.bfloat16),
                                   _cuda.stream_ptr(q))
    _cuda.check(lib, code, "relpe_attention")
    _cuda.launch_counts["relpe_attention"] += 1
    return out


def relpe_attention(xyz: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pe,
                    num_heads: int, compute_dtype: str = "float32") -> torch.Tensor:
    """xyz (B, M, 3); q, k, v (B, M, C) -> (B, M, C) float32 attention output."""
    if not _cuda.launches(q):
        return relpe_attention_plain(xyz, q, k, v, pe, num_heads, compute_dtype)
    cdt = compute_dtype_of(compute_dtype)
    return _relpe_cuda(xyz.detach().float().contiguous(), q.to(cdt).contiguous(),
                       k.to(cdt).contiguous(), v.to(cdt).contiguous(), pe, num_heads,
                       compute_dtype)
