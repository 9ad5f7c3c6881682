# Frozen copy of genpose2_tpu_torch/ops/__init__.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Point, sampler, attention and LayerNorm ops. Each op with a kernel
launches it on CUDA tensors and runs its plain PyTorch version on CPU
tensors."""

from bench_port.reference_vit7b.ops.ball_query import ball_count, ball_query
from bench_port.reference_vit7b.ops.fps import furthest_point_sample
from bench_port.reference_vit7b.ops.fused_sa import fused_sa_stage
from bench_port.reference_vit7b.ops.grouping import gather_points, group_points
from bench_port.reference_vit7b.ops.interpolate import three_interpolate, three_nn
from bench_port.reference_vit7b.ops.layernorm import (fast_add_layernorm, fast_layernorm,
                                              fast_residual_layernorm)
from bench_port.reference_vit7b.ops.ode_rk4 import fused_rk4_integrate
from bench_port.reference_vit7b.ops.relpe_attention import relpe_attention
from bench_port.reference_vit7b.ops.vit_attention import vit_attention, vit_attention_tm

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
