"""The work of the ViT backbone's kernels at a cell's shapes, counted over the
frozen reference's plain backbone as ``costs.py`` counts the RK4 and SA
launches: each input byte read once, each output byte written once.

- ``vit_attention_cost``: one ``vit_attention_tm`` launch over B images of
  N tokens (``n_valid`` of them real), H heads of C / H: q, k and v read
  and the float32 output written for the real tokens, the two products over
  real queries and real keys, five float32 operations a score (scale, mask,
  max, exp, sum);
- ``add_layernorm_cost``: one ``fast_add_layernorm`` launch over rows of D:
  x and h read, the sum and the norm written, gamma, scale and bias read
  once, eight float32 operations an element.

``costed(vit_module, costs)`` records each call of the reference's
``vit_attention_tm_plain`` and ``fast_add_layernorm_plain`` inside the block
under 'vit_attention.*' and 'add_layernorm.*' (bytes, ops, least time,
launches)."""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from bench_port.harness.costs import product_kind
from bench_port.harness.reference_run import _add


def vit_attention_cost(B: int, N: int, C: int, H: int, n_valid: int,
                       dtype: str) -> Tuple[float, Dict[str, float]]:
    esize = 2 if dtype == "bfloat16" else 4
    hd = C // H
    nbytes = B * n_valid * C * (3 * esize + 4)
    scores = B * H * n_valid * n_valid
    return nbytes, {dtype: 2 * 2 * scores * hd, "float32_other": 5 * scores}


def add_layernorm_cost(rows: int, D: int, dtype: str) -> Tuple[float, Dict[str, float]]:
    esize = 2 if dtype == "bfloat16" else 4
    return 4 * rows * D * esize + 3 * D * 4, {"float32_other": 8 * rows * D}


@contextlib.contextmanager
def costed(vit_module, costs: Dict[str, float]):
    """Record the ViT kernels' launches of the block (see the docstring);
    ``vit_module`` is the reference's ``models.vit``."""
    attend, add_ln = vit_module.vit_attention_tm_plain, vit_module.fast_add_layernorm_plain

    def attend_counted(q, k, v, num_heads, n_valid=None, *args, **kwargs):
        B, N, C = q.shape
        _add(costs, "vit_attention", *vit_attention_cost(
            B, N, C, num_heads, N if n_valid is None else n_valid, product_kind(q.dtype)))
        return attend(q, k, v, num_heads, n_valid, *args, **kwargs)

    def add_ln_counted(x, *args, **kwargs):
        D = x.shape[-1]
        _add(costs, "add_layernorm", *add_layernorm_cost(
            x.numel() // D, D, "bfloat16" if x.dtype == torch.bfloat16 else "float32"))
        return add_ln(x, *args, **kwargs)

    vit_module.vit_attention_tm_plain = attend_counted
    vit_module.fast_add_layernorm_plain = add_ln_counted
    try:
        yield
    finally:
        vit_module.vit_attention_tm_plain, vit_module.fast_add_layernorm_plain = attend, add_ln
