# Frozen copy of genpose2_tpu_torch/eval/__init__.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
from bench_port.reference.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from bench_port.reference.eval.metrics import (
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
