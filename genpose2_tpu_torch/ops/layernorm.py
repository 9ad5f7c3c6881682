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

Each launches ``csrc/layernorm.cu`` on CUDA tensors (rows of up to 8,192:
past 1,024 the kernel's wide route, a block a row) and runs its ``_plain``
version otherwise (``_cuda.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genpose2_tpu_torch.ops import _cuda

LN_EPS = 1e-6
MAX_WIDTH = 8192  # csrc/layernorm.cu: rows past 1,024 take its wide route


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
    if D > MAX_WIDTH:
        raise ValueError(f"row width {D}; the kernel takes at most {MAX_WIDTH}")
    if h is not None:
        _cuda.require(h, "h", x.dtype, tuple(x.shape), x.device)
    for name, t in vectors.items():
        _cuda.require(t, name, torch.float32, (D,), x.device)
    return x.numel() // D, D


@functools.lru_cache(maxsize=None)
def _entry(lib: ctypes.CDLL, name: str, pointers: int):
    """The library's entry ``name`` with its argument types set, once per
    loaded library (a wrapper call costs more host time than the kernel
    takes on the card)."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(key, name, args, x, rows, D, eps):
    """Launch entry ``name`` on the tensors ``args`` (x first)."""
    lib = _cuda.library("layernorm")
    code = _entry(lib, name, len(args))(*(t.data_ptr() for t in args), rows, D, eps,
                                        int(x.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    _cuda.check(lib, code, key)
    _cuda.launch_counts[key] += 1


def _ln_cuda(x, scale, bias, eps):
    rows, D = _check(x, None, {"scale": scale, "bias": bias})
    ln = torch.empty_like(x)
    _launch("layernorm", "gp2_ln", (x, scale, bias, ln), x, rows, D, eps)
    return ln


def _residual_ln_cuda(x, h, scale, bias, eps):
    rows, D = _check(x, h, {"scale": scale, "bias": bias})
    ln = torch.empty_like(x)
    _launch("residual_layernorm", "gp2_residual_ln", (x, h, scale, bias, ln), x, rows, D, eps)
    return ln


def _add_ln_cuda(x, h, gamma, scale, bias, eps):
    rows, D = _check(x, h, {"gamma": gamma, "scale": scale, "bias": bias})
    x2, ln = torch.empty_like(x), torch.empty_like(x)
    _launch("add_layernorm", "gp2_add_ln", (x, h, gamma, scale, bias, x2, ln), x, rows, D, eps)
    return x2, ln


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def fast_residual_layernorm(x: torch.Tensor, h: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float = LN_EPS):
    """LN(x + h) over the last axis: x, h (..., D) -> (..., D) in x's dtype."""
    if not _cuda.launches(x):
        return fast_residual_layernorm_plain(x, h, scale, bias, eps)
    return _residual_ln_cuda(x.contiguous(), h.contiguous(), _vec(scale), _vec(bias), eps)


def fast_add_layernorm(x: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, eps: float = LN_EPS):
    """(x + gamma*h, LN(x + gamma*h)), both in x's dtype (h must match it)."""
    if not _cuda.launches(x):
        return fast_add_layernorm_plain(x, h, gamma, scale, bias, eps)
    return _add_ln_cuda(x.contiguous(), h.contiguous(), _vec(gamma), _vec(scale), _vec(bias),
                        eps)


def fast_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = LN_EPS):
    """LN(x) over the last axis with float32 statistics, in x's dtype."""
    if not _cuda.launches(x):
        return fast_layernorm_plain(x, scale, bias, eps)
    return _ln_cuda(x.contiguous(), _vec(scale), _vec(bias), eps)
