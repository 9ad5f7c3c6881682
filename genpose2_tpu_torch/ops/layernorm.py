"""LayerNorm with or without a residual add (port of
genpose2_tpu/ops/layernorm.py: fast_residual_layernorm, fast_add_layernorm and
fast_layernorm).

All three treat (B, N, D) as B*N independent rows. The sum is float32, the
statistics are float32 over that unrounded sum, eps is 1e-6 (flax's
LayerNorm default, which every LayerNorm of the port uses):

- ``fast_residual_layernorm(x, h, scale, bias)`` = LN(x + h), the post-norm
  rel-PE transformer blocks of the Fus encoder;
- ``fast_add_layernorm(x, h, gamma, scale, bias)`` = (x + gamma*h,
  LN(x + gamma*h)), the ViT block's layer-scale residual plus norm2 on the
  bf16 stream; only the written sum is rounded to the output dtype;
- ``fast_layernorm(x, scale, bias)`` = LN(x) in x's dtype, block 0's norm1
  on the ViT's bf16 stream when the block tails are deferred.

Each launches ``csrc/layernorm.cu`` on CUDA tensors and runs its ``_plain``
version on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from genpose2_tpu_torch.ops import _cuda

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics -> float32."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fast_residual_layernorm_plain(x, h, scale, bias, eps: float = LN_EPS):
    return layer_norm(x.float() + h.float(), scale, bias, eps).to(x.dtype)


def fast_layernorm_plain(x, scale, bias, eps: float = LN_EPS):
    return layer_norm(x, scale, bias, eps).to(x.dtype)


def fast_add_layernorm_plain(x, h, gamma, scale, bias, eps: float = LN_EPS):
    x2 = x.float() + h.float() * gamma.float()
    return x2.to(x.dtype), layer_norm(x2, scale, bias, eps).to(x.dtype)


def _check(x, h, vectors):
    """Check the operands (h may be None); returns (rows, D)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {x.dtype}; the kernel takes float32 or bfloat16")
    D = x.shape[-1]
    if D > 1024:
        raise ValueError(f"row width {D}; the kernel takes at most 1024")
    if h is not None:
        _cuda.require(h, "h", x.dtype, tuple(x.shape), x.device)
    for name, t in vectors.items():
        _cuda.require(t, name, torch.float32, (D,), x.device)
    return x.numel() // D, D


def _ln_cuda(x, scale, bias, eps):
    rows, D = _check(x, None, {"scale": scale, "bias": bias})
    ln = torch.empty_like(x)
    lib = _cuda.library("layernorm")
    lib.gp2_ln.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                   ctypes.c_int, ctypes.c_void_p]
    lib.gp2_ln.restype = ctypes.c_int
    code = lib.gp2_ln(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), ln.data_ptr(), rows, D,
                      eps, int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    _cuda.check(lib, code, "layernorm")
    _cuda.launch_counts["layernorm"] += 1
    return ln


def _residual_ln_cuda(x, h, scale, bias, eps):
    rows, D = _check(x, h, {"scale": scale, "bias": bias})
    ln = torch.empty_like(x)
    lib = _cuda.library("layernorm")
    lib.gp2_residual_ln.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_float, ctypes.c_int,
                                                             ctypes.c_void_p]
    lib.gp2_residual_ln.restype = ctypes.c_int
    code = lib.gp2_residual_ln(x.data_ptr(), h.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                               ln.data_ptr(), rows, D, eps, int(x.dtype == torch.bfloat16),
                               _cuda.stream_ptr(x))
    _cuda.check(lib, code, "residual_layernorm")
    _cuda.launch_counts["residual_layernorm"] += 1
    return ln


def _add_ln_cuda(x, h, gamma, scale, bias, eps):
    rows, D = _check(x, h, {"gamma": gamma, "scale": scale, "bias": bias})
    x2, ln = torch.empty_like(x), torch.empty_like(x)
    lib = _cuda.library("layernorm")
    lib.gp2_add_ln.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_float, ctypes.c_int,
                                                        ctypes.c_void_p]
    lib.gp2_add_ln.restype = ctypes.c_int
    code = lib.gp2_add_ln(x.data_ptr(), h.data_ptr(), gamma.data_ptr(), scale.data_ptr(),
                          bias.data_ptr(), x2.data_ptr(), ln.data_ptr(), rows, D, eps,
                          int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    _cuda.check(lib, code, "add_layernorm")
    _cuda.launch_counts["add_layernorm"] += 1
    return x2, ln


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def fast_residual_layernorm(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float = LN_EPS):
    """LN(x + h) over the last axis: x, h (..., D) -> (..., D) in x's dtype."""
    if x.device.type == "cpu":
        return fast_residual_layernorm_plain(x, h, scale, bias, eps)
    return _residual_ln_cuda(x.contiguous(), h.contiguous(), _vec(scale), _vec(bias), eps)


def fast_add_layernorm(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS):
    """(x + gamma*h, LN(x + gamma*h)), both in x's dtype (h must match it)."""
    if x.device.type == "cpu":
        return fast_add_layernorm_plain(x, h, gamma, scale, bias, eps)
    return _add_ln_cuda(x.contiguous(), h.contiguous(), _vec(gamma), _vec(scale), _vec(bias),
                        eps)


def fast_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = LN_EPS):
    """LN(x) over the last axis with float32 statistics, in x's dtype."""
    if x.device.type == "cpu":
        return fast_layernorm_plain(x, scale, bias, eps)
    return _ln_cuda(x.contiguous(), _vec(scale), _vec(bias), eps)
