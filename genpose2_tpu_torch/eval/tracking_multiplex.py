"""Multi-video tracking multiplexer (port of
genpose2_tpu/eval/tracking_multiplex.py): one tracking step takes the next
frames of many concurrent video streams, concatenated up to an object budget.

Up to ``max_streams`` streams are open; a step visits them in order and takes
each one's next frame until the next frame would overflow ``object_budget``
(that frame is put back for the next step) or the step is within 8 objects
of the budget. A finished stream is closed and the next unopened video takes
its place. A frame with more objects than the budget is admitted alone and
run in budget-size slices (objects are independent, so slicing is exact).
Each stream carries its own previous pose, the first one from its first
frame's noised ground truth. The JAX package pads every step to the budget
so that its jitted step compiles once; the port runs the step at its own
size.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.eval.metrics import PoseMetrics, batch_criterion, compute_metrics
from genpose2_tpu_torch.eval.tracking import PoseTracker


class _Stream:
    def __init__(self, video, sid):
        self.video = video
        self.sid = sid
        self.frame_idx = 0
        self.prev_pose = None
        self.results: List[dict] = []

    def next_frame(self):
        if self.frame_idx >= len(self.video):
            return None
        try:
            batch = self.video[self.frame_idx]
        except ValueError:
            return None  # a failed video (its dataset has logged it)
        self.frame_idx += 1
        return batch


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def track_videos_multiplexed(tracker: PoseTracker, videos: Iterable,
                             generator: Optional[torch.Generator] = None, max_streams: int = 30,
                             object_budget: int = 128, pose_mode: str = "rot_matrix",
                             progress: Optional[Callable] = None, *,
                             init_noise: Optional[Sequence[dict]] = None,
                             priors: Optional[Sequence[torch.Tensor]] = None) -> List[List[dict]]:
    """Track every video; each video is a sequence of collated raw frames
    (``process_batch``'s input, with ``bbox_side_len``, ``sym_info`` and
    ``class_label``). Returns per video a list of per-frame results on the
    host: rotation, translation, lengths and the frame's gt_rotation,
    gt_translation, gt_lengths, sym_info and class_label.

    Draws come from ``generator`` unless given: ``init_noise[v]`` the first
    frame's noise draws of video v (``PoseTracker.init_from_gt``'s
    ``noise``), ``priors[s]`` the sampler's prior rows (objects x K, 9) of
    step s, in the step's object order."""
    videos = list(videos)
    dev = tracker.score_agent.device
    pending = list(range(len(videos)))
    active: List[_Stream] = []
    finished: Dict[int, List[dict]] = {}
    K = tracker.cfg.eval.eval_repeat_num

    def refill():
        while len(active) < max_streams and pending:
            vid = pending.pop(0)
            active.append(_Stream(videos[vid], vid))

    refill()
    step_i = 0
    while active:
        chunks, total, done = [], 0, []
        for s in list(active):
            raw = s.next_frame()
            if raw is None:
                finished[s.sid] = s.results
                done.append(s)
                continue
            batch = process_batch(raw, pose_mode, device=dev)
            n = batch["pts"].shape[0]
            if total + n > object_budget and total > 0:
                s.frame_idx -= 1  # put the frame back
                break
            chunks.append((s, batch, n))
            total += n
            if total > object_budget - 8 or n > object_budget:
                break
        for s in done:
            active.remove(s)
        refill()
        if not chunks:
            continue

        big = {k: torch.cat([c[1][k] for c in chunks], dim=0) for k in chunks[0][1]}
        for s, batch, n in chunks:
            if s.prev_pose is None:
                s.prev_pose = tracker.init_from_gt(
                    batch["gt_rotation"], batch["gt_translation"], generator=generator,
                    noise=None if init_noise is None else init_noise[s.sid])
        prev = torch.cat([s.prev_pose for s, _, _ in chunks], dim=0)
        step_prior = None if priors is None else priors[step_i].to(dev)
        step_i += 1
        outs = []
        for off in range(0, total, object_budget):
            sl = slice(off, off + object_budget)
            prior = None if step_prior is None else step_prior[off * K:(off + object_budget) * K]
            outs.append(tracker.step({k: v[sl] for k, v in big.items()}, prev[sl], generator,
                                     prior))
        out = {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

        off = 0
        for s, batch, n in chunks:
            sl = slice(off, off + n)
            s.prev_pose = out["prev_pose"][sl]
            s.results.append({
                "rotation": _host(out["rotation"][sl]),
                "translation": _host(out["translation"][sl]),
                "lengths": _host(out["lengths"][sl]),
                "gt_rotation": _host(batch["gt_rotation"]),
                "gt_translation": _host(batch["gt_translation"]),
                "gt_lengths": _host(batch["bbox_side_len"]),
                "sym_info": _host(batch["sym_info"]),
                "class_label": _host(batch["class_label"]),
            })
            off += n
            if progress:
                progress(n)
    return [finished.get(i, []) for i in range(len(videos))]


def tracking_metrics(all_video_results) -> PoseMetrics:
    """The per-frame results of every video -> the metric family."""
    ious, degs, shts, cls = [], [], [], []
    for results in all_video_results:
        for r in results:
            iou, deg, sht = batch_criterion(
                *(torch.as_tensor(r[k]) for k in ("rotation", "translation", "lengths",
                                                  "gt_rotation", "gt_translation", "gt_lengths",
                                                  "sym_info")))
            ious.append(_host(iou))
            degs.append(_host(deg))
            shts.append(_host(sht))
            cls.append(np.asarray(r["class_label"]))
    return compute_metrics(np.concatenate(ious), np.concatenate(degs), np.concatenate(shts),
                           class_labels=np.concatenate(cls))
