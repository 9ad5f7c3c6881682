from genpose2_tpu_torch.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from genpose2_tpu_torch.eval.metrics import (
    PoseMetrics,
    SYM_NONE,
    batch_criterion,
    calibrate_rotation,
    compute_metrics,
    iou_3d,
    rot_error_deg,
    sym_label,
)

__all__ = [
    "aggregate_candidates",
    "analytic_bbox_lengths",
    "PoseMetrics",
    "SYM_NONE",
    "batch_criterion",
    "calibrate_rotation",
    "compute_metrics",
    "iou_3d",
    "rot_error_deg",
    "sym_label",
]
