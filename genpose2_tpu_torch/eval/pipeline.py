"""Staged single-frame evaluation (port of genpose2_tpu/eval/pipeline.py).

Five stages, each cached under ``out_dir`` as the JAX package caches them
and skipped when its file exists: score sampling (``pred_pose.npz``), energy
scoring (``pred_energy.npz``), aggregation (``aggregated_rot.npz``,
``aggregated_trans.npz``), box sizes (``lengths.npz``), then the criteria and
the metrics (``metrics.json``). ``run_streaming`` runs every stage per batch
instead and caches per batch (``batch_000000.npz``, ...).

Each stage's output is a list of numpy arrays, one per batch. Draws come from
a ``torch.Generator``; ``priors`` (one (B * K, 9) tensor per batch) gives the
sampler's start noise instead, as the parity tests hand over the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from genpose2_tpu_torch.eval.metrics import PoseMetrics, batch_criterion, compute_metrics
from genpose2_tpu_torch.utils.profiling import span, to_host


def _stage(path):
    return path is not None and os.path.exists(path)


def _save_list(path, arrays):
    np.savez(path, **{f"b{i}": np.asarray(a) for i, a in enumerate(arrays)})


def _load_list(path):
    d = np.load(path)
    return [d[f"b{i}"] for i in range(len(d.files))]


def _host(x: torch.Tensor) -> np.ndarray:
    return to_host(x).numpy()


def _prior(priors, i):
    return None if priors is None else priors[i]


class SingleFrameEvaluator:
    """Drives the staged pipeline over batches of labelled objects (the
    ``process_batch`` keys plus ``gt_rotation``, ``gt_translation``,
    ``bbox_side_len``, ``sym_info`` and ``class_label``).

    Without an energy agent the candidates aggregate with equal energies;
    without ``scale_fn(batch, R, t, pts_feat=None)`` the box sizes are the
    rotated cloud's extent. ``score_state`` / ``energy_state``: train states
    whose EMA weights the agents run, as in ``PoseTracker``.
    ``cfg.sampler.mode`` picks the sampler as the JAX evaluator does: 'ode'
    runs the fixed-grid RK4 sampler, every other mode ('rk45', 'euler',
    'pc', 'edm') goes to ``sample_candidates`` as its method, with
    ``cfg.sampler.sampling_steps`` steps."""

    def __init__(self, cfg: Config, score_agent, energy_agent=None,
                 scale_fn: Optional[Callable] = None, out_dir: Optional[str] = None, *,
                 score_state=None, energy_state=None):
        self.cfg = cfg
        self.score_agent = score_agent
        self.score_state = score_state
        self.energy_agent = energy_agent
        self.energy_state = energy_state
        self.scale_fn = scale_fn
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    @property
    def method(self) -> str:
        mode = self.cfg.sampler.mode
        return "fixed" if mode == "ode" else mode

    def _path(self, name):
        return os.path.join(self.out_dir, name) if self.out_dir else None

    def _sample(self, batch, generator, prior, features=None):
        ev = self.cfg.eval
        return self.score_agent.sample_candidates(
            batch, repeat_num=ev.eval_repeat_num, T0=ev.T0, method=self.method,
            num_steps=self.cfg.sampler.sampling_steps, features=features, generator=generator,
            prior=prior, state=self.score_state)

    def _energy(self, batch, poses, features=None):
        if self.energy_agent is None:
            return None
        return self.energy_agent.get_energy(batch, poses, fixed_t=1e-5, features=features,
                                            state=self.energy_state)

    def _aggregate(self, poses, energy):
        ev = self.cfg.eval
        return aggregate_candidates(poses, energy, retain_ratio=ev.retain_ratio,
                                    clustering=ev.clustering, eps=ev.clustering_eps,
                                    minpts_ratio=ev.clustering_minpts_ratio,
                                    pose_mode=self.cfg.model.pose_mode)

    def _lengths(self, batch, R, t, pts_feat=None):
        if self.scale_fn is not None:
            lengths = self.scale_fn(batch, R, t, pts_feat=pts_feat)
        else:
            lengths = analytic_bbox_lengths(batch["pts"].to(R), R, t)
        return torch.clamp(lengths, min=1e-3)

    def _write_metrics(self, metrics: PoseMetrics):
        if self.out_dir:
            with open(self._path("metrics.json"), "w") as f:
                json.dump(metrics.to_dict(), f, indent=2, default=str)

    # ------------------------------------------------------------- stages
    def inference_score(self, batches: List[dict], generator=None,
                        priors: Optional[Sequence[torch.Tensor]] = None) -> List[np.ndarray]:
        """Candidate poses (B, K, D), camera frame, one array per batch."""
        path = self._path("pred_pose.npz")
        if _stage(path):
            return _load_list(path)
        out = [_host(self._sample(b, generator, _prior(priors, i)))
               for i, b in enumerate(batches)]
        if path:
            _save_list(path, out)
        return out

    def inference_energy(self, batches, all_poses) -> List[np.ndarray]:
        """Energies (B, K, 2) of the candidates at t = 1e-5; ones without an
        energy agent."""
        path = self._path("pred_energy.npz")
        if _stage(path):
            return _load_list(path)
        if self.energy_agent is None:
            return [np.ones((p.shape[0], p.shape[1], 2), np.float32) for p in all_poses]
        dev = self.energy_agent.device
        out = [_host(self._energy(b, torch.as_tensor(p, device=dev)))
               for b, p in zip(batches, all_poses)]
        if path:
            _save_list(path, out)
        return out

    def aggregate(self, all_poses, all_energy):
        """(rotations (B, 3, 3), translations (B, 3)), one array of each per
        batch."""
        rot_path, trans_path = self._path("aggregated_rot.npz"), self._path("aggregated_trans.npz")
        if _stage(rot_path) and _stage(trans_path):
            return _load_list(rot_path), _load_list(trans_path)
        dev = self.score_agent.device
        rots, transs = [], []
        for poses, energy in zip(all_poses, all_energy):
            agg = self._aggregate(torch.as_tensor(poses, device=dev),
                                  torch.as_tensor(energy, device=dev))
            rots.append(_host(agg["rotation"]))
            transs.append(_host(agg["translation"]))
        if rot_path:
            _save_list(rot_path, rots)
            _save_list(trans_path, transs)
        return rots, transs

    def inference_scale(self, batches, rots, transs) -> List[np.ndarray]:
        """Box side lengths (B, 3), at least 1 mm. ``scale_fn`` gets no
        feature here: it runs the score encoder itself."""
        path = self._path("lengths.npz")
        if _stage(path):
            return _load_list(path)
        dev = self.score_agent.device
        out = [_host(self._lengths(b, torch.as_tensor(R, device=dev),
                                   torch.as_tensor(t, device=dev)))
               for b, R, t in zip(batches, rots, transs)]
        if path:
            _save_list(path, out)
        return out

    def criterion_and_metrics(self, batches, rots, transs, lengths) -> PoseMetrics:
        """The per-object criteria of every batch and their metrics (written
        to ``metrics.json``)."""
        dev = self.score_agent.device
        ious, degs, shts, cls = [], [], [], []
        for batch, R, t, L in zip(batches, rots, transs, lengths):
            iou, deg, sht = batch_criterion(
                torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev),
                torch.as_tensor(L, device=dev), batch["gt_rotation"], batch["gt_translation"],
                batch["bbox_side_len"], batch["sym_info"])
            ious.append(_host(iou))
            degs.append(_host(deg))
            shts.append(_host(sht))
            cls.append(np.asarray(torch.as_tensor(batch["class_label"]).cpu()))
        metrics = compute_metrics(np.concatenate(ious), np.concatenate(degs),
                                  np.concatenate(shts), class_labels=np.concatenate(cls))
        self._write_metrics(metrics)
        return metrics

    # ---------------------------------------------------------------- run
    def run(self, batches: Iterable[dict], generator: Optional[torch.Generator] = None,
            priors: Optional[Sequence[torch.Tensor]] = None) -> PoseMetrics:
        """Every stage over all batches -> PoseMetrics. The frozen backbone's
        features are attached to each batch first, so that no later stage
        (score, energy, scale) runs the backbone."""
        batches = [self.score_agent.with_image_features(b) for b in batches]
        poses = self.inference_score(batches, generator, priors)
        energy = self.inference_energy(batches, poses)
        rots, transs = self.aggregate(poses, energy)
        lengths = self.inference_scale(batches, rots, transs)
        return self.criterion_and_metrics(batches, rots, transs, lengths)

    # ---------------------------------------------------------- streaming
    @span("eval.batch", unit=True)
    def _run_one(self, batch: dict, generator=None, prior=None) -> dict:
        """Every stage for one batch; per-object results on the host. The
        backbone and the score encoder run once: the image features ride the
        batch into the energy agent, and the score feature feeds both the
        sampler and ``scale_fn``."""
        s = self.score_agent
        batch = s.with_image_features(batch)
        feats = s.extract_features(batch, state=self.score_state)
        poses = self._sample(batch, generator, prior, features=feats)
        agg = self._aggregate(poses, self._energy(batch, poses))
        R, t = agg["rotation"], agg["translation"]
        lengths = self._lengths(batch, R, t, pts_feat=feats[0])
        with span("criterion"):
            iou, deg, sht = batch_criterion(R, t, lengths, batch["gt_rotation"],
                                            batch["gt_translation"], batch["bbox_side_len"],
                                            batch["sym_info"])
        out = {"rotation": R, "translation": t, "lengths": lengths, "iou": iou, "deg": deg,
               "sht": sht, "class_label": torch.as_tensor(batch["class_label"])}
        return {k: _host(v) for k, v in out.items()}

    def run_streaming(self, batch_iter: Iterable[dict], generator: Optional[torch.Generator] = None,
                      priors: Optional[Sequence[torch.Tensor]] = None) -> PoseMetrics:
        """Every stage per batch of an iterator, keeping only per-object
        results; with ``out_dir`` each batch's results are cached in
        ``batch_{i:06d}.npz`` and a cached batch is not run again."""
        acc = {k: [] for k in ("iou", "deg", "sht", "class_label")}
        for i, batch in enumerate(batch_iter):
            path = self._path(f"batch_{i:06d}.npz")
            if _stage(path):
                out = dict(np.load(path))
            else:
                out = self._run_one(batch, generator, _prior(priors, i))
                if path:
                    np.savez(path, **out)
            for k in acc:
                acc[k].append(out[k])
        metrics = compute_metrics(np.concatenate(acc["iou"]), np.concatenate(acc["deg"]),
                                  np.concatenate(acc["sht"]),
                                  class_labels=np.concatenate(acc["class_label"]))
        self._write_metrics(metrics)
        return metrics
