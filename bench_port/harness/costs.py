"""The yardstick's peaks and the work a cell's shapes need.

Peaks: NVIDIA's published dense rates for one H100 SXM. float32 products
count at TF32's rate: no float32-accurate product (3xTF32 included) beats
the tensor cores' float32-input rate. Other float32 work counts at the FMA
pipes' rate.

- ``ProductFlops``: the product FLOPs of whatever runs inside it, by the
  dtype of the product's first operand (``torch.utils.flop_counter``'s
  formulas), counted over the benchmark's plain reference.
- ``rk4_cost`` / ``sa_stage_cost``: bytes and operations of one fused RK4
  integration and one SA stage launch (copies of chip_smoke.py's
  ``rk4_cost`` and ``sa_cost``): each input byte read once, each output byte
  written once."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK = {
    "bfloat16": 989e12,   # bf16 products, tensor cores
    "float32": 495e12,    # float32 products: TF32's rate
    "float32_other": 67e12,  # float32 work outside products
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, ops: Dict[str, float]) -> float:
    """The least time the chip needs: the larger of the bytes' time and the
    operations' time (summed over kinds)."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def product_kind(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype in (torch.bfloat16, torch.float16) else "float32"


class ProductFlops(TorchDispatchMode):
    """Counts product FLOPs by kind ('bfloat16' / 'float32') of the ops run
    inside it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            first = next(a for a in args if isinstance(a, torch.Tensor))
            self.flops[product_kind(first.dtype)] += formula(*args, **kwargs, out_val=out)
        return out


def rk4_cost(D: int, P1: int, P2: int, H1: int, rows: int, steps: int,
             dtype: str) -> Tuple[float, Dict[str, float]]:
    """(bytes, ops) of one fused RK4 call: x in and out, the static rows, the
    weights once, the time tables; 4 stages a step of the four products over
    every row."""
    macs = D * P1 + P1 * P2 + P2 * H1 + H1 * D
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = rows * D * 8 + rows * H1 * 4 + macs * esize + steps * (3 * H1 + 7) * 4
    return nbytes, {dtype: steps * 4 * rows * 2 * macs}


def sa_stage_cost(B: int, N: int, M: int, scales: Sequence[dict],
                  dtype: str) -> Tuple[float, Dict[str, float]]:
    """(bytes, ops) of one SA stage launch over B clouds of N points and M
    centroids. Each scale: ``h1`` (its projection's width), ``weights`` (the
    MLP's (in, out) shapes), ``affine_values`` (its affines' values),
    ``c_out`` and ``rows`` (grouped rows: each centroid's neighbours in the
    ball, at most nsample, at least 1)."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = 12 * B * (N + M)
    other, mm = 9 * B * M * N, 0  # distance tests; the MLP products
    for sc in scales:
        h1 = sc["h1"]
        macs = sum(i * o for i, o in sc["weights"])
        nbytes += B * N * h1 * esize + B * M * h1 * 4
        nbytes += macs * esize + 2 * 4 * sc["affine_values"]
        nbytes += B * M * sc["c_out"] * 4
        other += sc["rows"] * 4 * h1
        mm += sc["rows"] * 2 * macs
    return nbytes, {"float32_other": other, dtype: mm}
