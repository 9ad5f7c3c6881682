"""Point, sampler, attention and LayerNorm ops. Each op with a kernel
launches it on CUDA tensors and runs its plain PyTorch version on CPU
tensors or inside ``_cuda.plain_versions()``: ``_cuda.launches`` decides."""

from genpose2_tpu_torch.ops.ball_query import ball_count, ball_query
from genpose2_tpu_torch.ops.fps import furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage
from genpose2_tpu_torch.ops.grouping import gather_points, group_points
from genpose2_tpu_torch.ops.interpolate import three_interpolate, three_nn
from genpose2_tpu_torch.ops.layernorm import (fast_add_layernorm, fast_layernorm,
                                              fast_residual_layernorm)
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate
from genpose2_tpu_torch.ops.relpe_attention import relpe_attention
from genpose2_tpu_torch.ops.vit_attention import vit_attention, vit_attention_tm

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
