"""Video pose tracking with the previous pose as the sampler's prior (port of
genpose2_tpu/eval/tracking.py). Per frame:

1. the previous frame's pose (9D, camera frame) is re-centred on the current
   cloud (translation minus ``pts_center``);
2. the ODE warm-starts at T0 = 0.25 from that pose plus prior noise at T0;
3. the candidates are energy-ranked at t = 1e-5, retained, clustered and
   averaged as in the single-frame path;
4. the averaged pose is the next frame's prior. The first frame starts from
   the noised ground truth or from a given pose.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from genpose2_tpu_torch.so3.noise import add_noise_to_RT
from genpose2_tpu_torch.so3.rotations import matrix_to_rot6d_cols


class PoseTracker:
    """``score_state`` / ``energy_state``: train states whose EMA weights
    every stage runs, as the JAX tracker does; without them the agents' own
    weights run. ``with_image_features`` needs none: the backbone is frozen."""

    def __init__(self, cfg: Config, score_agent, energy_agent=None,
                 scale_fn: Optional[Callable] = None, T0: float = 0.25, num_steps: int = 100,
                 *, score_state=None, energy_state=None):
        if cfg.model.pose_mode != "rot_matrix":
            raise ValueError("the tracker's state is the 9-D rot_matrix pose (as in the JAX "
                             "package): tracking needs pose_mode='rot_matrix', not "
                             f"{cfg.model.pose_mode!r}")
        self.cfg = cfg
        self.score_agent = score_agent
        self.score_state = score_state
        self.energy_agent = energy_agent
        self.energy_state = energy_state
        self.scale_fn = scale_fn
        self.T0 = T0
        self.num_steps = num_steps

    def init_from_gt(self, gt_rotation: torch.Tensor, gt_translation: torch.Tensor,
                     r_deg: float = 5.0, t_std: float = 0.03,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[dict] = None) -> torch.Tensor:
        """The first frame's prior from the noised ground truth: (B, 9).
        ``noise`` may give the draws (``axis``, ``angle_z``, ``t_z`` of
        ``so3.noise.add_noise_to_RT``)."""
        R, t = add_noise_to_RT(gt_rotation, gt_translation, r_deg, t_std, generator,
                               **(noise or {}))
        return torch.cat([matrix_to_rot6d_cols(R), t], dim=-1)

    def init_from_pose(self, rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
        return torch.cat([matrix_to_rot6d_cols(rotation), translation], dim=-1)

    @torch.no_grad()
    def step(self, batch: dict, prev_pose: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             prior: Optional[torch.Tensor] = None) -> dict:
        """One tracking step for a batch of objects (``process_batch``
        output); prev_pose (B, 9) camera frame. ``prior`` (B * K, 9) is the
        sampler's start noise, else drawn with ``generator``. Returns rotation
        (B, 3, 3), translation (B, 3), lengths (B, 3) and prev_pose (B, 9)
        for the next frame."""
        s = self.score_agent
        init_x = prev_pose.to(s.device, torch.float32).clone()
        init_x[..., -3:] -= batch["pts_center"].to(s.device)
        # the backbone and the score encoder run once per frame
        batch = s.with_image_features(batch)
        feats = s.extract_features(batch, state=self.score_state)
        poses = s.sample_candidates(batch, repeat_num=self.cfg.eval.eval_repeat_num, T0=self.T0,
                                    init_x=init_x, method="fixed", num_steps=self.num_steps,
                                    features=feats, generator=generator, prior=prior,
                                    state=self.score_state)
        energy = None
        if self.energy_agent is not None:
            energy = self.energy_agent.get_energy(batch, poses, fixed_t=1e-5,
                                                  state=self.energy_state)
        ev = self.cfg.eval
        agg = aggregate_candidates(poses, energy, retain_ratio=ev.retain_ratio,
                                   clustering=ev.clustering, eps=ev.clustering_eps,
                                   minpts_ratio=ev.clustering_minpts_ratio)
        R, t = agg["rotation"], agg["translation"]
        if self.scale_fn is not None:
            lengths = self.scale_fn(batch, R, t, pts_feat=feats[0])
        else:
            lengths = analytic_bbox_lengths(batch["pts"], R, t)
        return {"rotation": R, "translation": t, "lengths": lengths.clamp(min=1e-3),
                "prev_pose": torch.cat([matrix_to_rot6d_cols(R), t], dim=-1)}


def track_video(tracker: PoseTracker, frames: Sequence[dict],
                generator: Optional[torch.Generator] = None, first_frame_init: str = "gt_noise",
                init_noise: Optional[dict] = None,
                priors: Optional[Sequence[torch.Tensor]] = None) -> list:
    """Track one video: ``frames`` are ``process_batch`` outputs with the same
    objects in the same order, the first carrying ``gt_rotation`` and
    ``gt_translation``. ``init_noise`` gives the first frame's noise draws and
    ``priors`` each frame's sampler prior; otherwise both come from
    ``generator``. Returns per frame {rotation, translation, lengths} on the
    host."""
    results, prev = [], None
    for i, batch in enumerate(frames):
        if prev is None:
            R, t = batch["gt_rotation"], batch["gt_translation"]
            if first_frame_init == "gt_noise":
                prev = tracker.init_from_gt(R, t, generator=generator, noise=init_noise)
            else:
                prev = tracker.init_from_pose(R, t)
        out = tracker.step(batch, prev, generator, None if priors is None else priors[i])
        prev = out["prev_pose"]
        results.append({k: v.cpu() for k, v in out.items() if k != "prev_pose"})
    return results
