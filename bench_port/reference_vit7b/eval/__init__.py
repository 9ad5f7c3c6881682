# Frozen copy of genpose2_tpu_torch/eval/__init__.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
from bench_port.reference_vit7b.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from bench_port.reference_vit7b.eval.metrics import (
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
