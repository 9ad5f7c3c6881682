# Frozen copy of genpose2_tpu_torch/ops/__init__.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Point, sampler, attention and LayerNorm ops. Each op with a kernel
launches it on CUDA tensors and runs its plain PyTorch version on CPU
tensors."""

from bench_port.reference.ops.ball_query import ball_count, ball_query
from bench_port.reference.ops.fps import furthest_point_sample
from bench_port.reference.ops.fused_sa import fused_sa_stage
from bench_port.reference.ops.grouping import gather_points, group_points
from bench_port.reference.ops.interpolate import three_interpolate, three_nn
from bench_port.reference.ops.layernorm import (fast_add_layernorm, fast_layernorm,
                                              fast_residual_layernorm)
from bench_port.reference.ops.ode_rk4 import fused_rk4_integrate
from bench_port.reference.ops.relpe_attention import relpe_attention
from bench_port.reference.ops.vit_attention import vit_attention, vit_attention_tm

__all__ = [
    "ball_count",
    "ball_query",
    "fast_add_layernorm",
    "fast_layernorm",
    "fast_residual_layernorm",
    "furthest_point_sample",
    "fused_sa_stage",
    "gather_points",
    "group_points",
    "fused_rk4_integrate",
    "relpe_attention",
    "three_interpolate",
    "three_nn",
    "vit_attention",
    "vit_attention_tm",
]
