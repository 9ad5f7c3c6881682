"""Point and sampler ops. Each op with a kernel launches it on CUDA tensors
and runs its plain PyTorch version on CPU tensors."""

from genpose2_tpu_torch.ops.ball_query import ball_count, ball_query
from genpose2_tpu_torch.ops.fps import furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage
from genpose2_tpu_torch.ops.grouping import gather_points, group_points
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate

__all__ = [
    "ball_count",
    "ball_query",
    "furthest_point_sample",
    "fused_sa_stage",
    "gather_points",
    "group_points",
    "fused_rk4_integrate",
]
