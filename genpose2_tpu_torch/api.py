"""Inference over raw RGB-D frames (port of genpose2_tpu/api.py:GenPose2TPU).

``GenPose2`` bundles the score, energy and scale agents behind one
``inference(frame, prev_pose, tracking)`` call: detection mode integrates
from T0 = 0.55, tracking mode warm-starts from the previous pose at
T0 = 0.15. Per call: the host front end (crops and clouds, numpy), the ViT
once, one score-encoder forward shared by the sampler and ScaleNet, the
energy agent on the same ViT layers, aggregation, then ScaleNet (or the
cloud's extent along the estimated axes when there is no scale agent).

    engine = GenPose2(cfg, score="score.pth", energy="energy.pth", scale="scale.pth")
    result = engine.inference(frame)                                 # detection
    result = engine.inference(frame, prev_pose=result["prev_pose"], tracking=True)

Weights are state dicts in the reference torch layout, bare or wrapped as
the reference saves them (``{'model_state_dict': sd, ...}``), or paths to
``torch.save`` files of either: ``weights.py`` makes them from the JAX
package's variables, and a published reference ``.pth`` loads as it is.
``dino.*`` entries go to the frozen backbone (with a warning when the agent
has none); entries the port does not build (the reference Fus encoder's
GroupAll-stage ``relative_pos_encoders`` and its fusions' ``downsample``,
both dead in the reference; ``img_encoder`` in a ``dino='global'`` model)
are dropped and named in one warning; a missing entry raises. The agents run
on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np
import torch

from genpose2_tpu_torch.config import Config, default_config
from genpose2_tpu_torch.data.infer_dataset import frame_to_object_batch
from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.device import resolve_device
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from genpose2_tpu_torch.so3.rotations import matrix_to_rot6d_cols
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.utils.profiling import span, to_host

Weights = Union[None, bool, str, dict]
DINO_PREFIX = "dino."


def _state_dict(weights: Weights) -> Optional[dict]:
    if isinstance(weights, str):
        return torch.load(weights, map_location="cpu", weights_only=True)
    return None if weights is True else weights


def _load_exact(module: torch.nn.Module, state_dict: dict, what: str) -> None:
    """Load exactly the entries ``module`` holds: a missing one raises, the
    ones it does not build are dropped and named in one warning."""
    own = module.state_dict().keys()
    missing = [k for k in own if k not in state_dict]
    if missing:
        raise KeyError(f"{what}: the state dict lacks {len(missing)} entries: "
                       f"{', '.join(missing)}")
    extra = sorted(k for k in state_dict if k not in own)
    if extra:
        warnings.warn(f"{what}: dropped {len(extra)} entries the port does not build: "
                      f"{', '.join(extra)}", stacklevel=3)
    module.load_state_dict({k: state_dict[k] for k in own})


def load_pose_weights(agent: PoseAgent, state_dict: dict) -> None:
    """A GFObjectPose state dict (bare or wrapped) into the agent: ``dino.*``
    entries into the frozen backbone, the rest into the model."""
    state_dict = state_dict.get("model_state_dict", state_dict)
    dino = {k[len(DINO_PREFIX):]: v for k, v in state_dict.items() if k.startswith(DINO_PREFIX)}
    _load_exact(agent.model, {k: v for k, v in state_dict.items()
                              if not k.startswith(DINO_PREFIX)}, "GFObjectPose")
    if dino and agent.provider is None:
        warnings.warn(f"the state dict embeds {len(dino)} DINO backbone tensors but the agent "
                      "has no backbone: backbone weights not loaded", stacklevel=2)
    elif dino:
        agent.provider.vit.load_state_dict(dino)


def load_scale_weights(agent: ScaleAgent, state_dict: dict) -> None:
    """A ScaleNet state dict (bare or wrapped) into the agent."""
    _load_exact(agent.model, state_dict.get("model_state_dict", state_dict), "ScaleNet")


class GenPose2:
    """End-user inference over raw RGB-D frames.

    ``score`` / ``energy`` / ``scale``: a state dict, a path to one, or True
    for the agent with its initial weights; ``energy`` or ``scale`` None
    leaves that agent out."""

    def __init__(self, cfg: Optional[Config] = None, score: Weights = True,
                 energy: Weights = None, scale: Weights = None, single_T0: float = 0.55,
                 tracking_T0: float = 0.15, num_steps: int = 100, device=None):
        self.cfg = cfg or default_config()
        self.single_T0 = single_T0
        self.tracking_T0 = tracking_T0
        self.num_steps = num_steps
        self.device = resolve_device(device)
        self.score_agent = PoseAgent(self.cfg, "score", device=self.device)
        self._load(self.score_agent, score)
        self.energy_agent = None
        if energy is not None:
            self.energy_agent = PoseAgent(self.cfg, "energy", device=self.device)
            self._load(self.energy_agent, energy)
        self.scale_agent = None
        if scale is not None:
            pts_dim = sum(m[-1] for m in self.cfg.model.pointnet2.mlps[-1])
            self.scale_agent = ScaleAgent(self.cfg, pts_dim=pts_dim, device=self.device)
            sd = _state_dict(scale)
            if sd is not None:
                load_scale_weights(self.scale_agent, sd)

    @staticmethod
    def _load(agent: PoseAgent, weights: Weights) -> None:
        sd = _state_dict(weights)
        if sd is not None:
            load_pose_weights(agent, sd)

    def front_end(self, frame: dict, mask_ids=None) -> Optional[dict]:
        """The host part of a call: every object's crops and cloud as a
        collated numpy batch (``mask_ids`` included), or None."""
        return frame_to_object_batch(frame["color"], frame["depth"], frame["mask"],
                                     frame["intrinsics"], self.cfg.data, mask_ids=mask_ids)

    @torch.no_grad()
    @span("serve.request", unit=True)
    def serve_batch(self, raw: dict, prev_pose: Optional[torch.Tensor] = None,
                    tracking: bool = False, generator: Optional[torch.Generator] = None,
                    prior: Optional[torch.Tensor] = None,
                    energy_t: Optional[torch.Tensor] = None) -> dict:
        """The device part of a call on the front end's batch. Returns
        ``batch`` (on the device), ``features`` (the score encoder's),
        ``rgb_features`` (dino='global': the global rgb feature, else None),
        ``candidates`` (n, K, D), ``energy``, ``aggregate`` and ``lengths``.
        Randomness: the sampler's prior (n * K, D) and the detection-mode
        energy times (n * K, 1) come from ``generator`` (seed 0 when None)
        unless ``prior`` / ``energy_t`` give them."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        with span("collate"):
            batch = process_batch(raw, self.cfg.model.pose_mode, self.device)
        if tracking and prev_pose is not None:
            if self.cfg.model.pose_mode != "rot_matrix":
                raise ValueError("tracking warm-starts from prev_pose, the 9-D rot_matrix pose "
                                 "(as in the JAX package): it needs pose_mode='rot_matrix', "
                                 f"not {self.cfg.model.pose_mode!r}")
            T0 = self.tracking_T0
            init_x = torch.as_tensor(prev_pose, dtype=torch.float32, device=self.device).clone()
            init_x[..., -3:] -= batch["pts_center"]
        else:
            T0, init_x = self.single_T0, None
        s = self.score_agent
        batch = s.with_image_features(batch)
        feats = s.extract_features(batch)
        poses = s.sample_candidates(batch, repeat_num=self.cfg.eval.eval_repeat_num, T0=T0,
                                    init_x=init_x, method="fixed", num_steps=self.num_steps,
                                    features=feats, generator=generator, prior=prior)
        energy = None
        if self.energy_agent is not None:
            energy = self.energy_agent.get_energy(batch, poses, fixed_t=None,
                                                  generator=generator, t=energy_t)
        ev = self.cfg.eval
        agg = aggregate_candidates(poses, energy, retain_ratio=ev.retain_ratio,
                                   clustering=ev.clustering, eps=ev.clustering_eps,
                                   minpts_ratio=ev.clustering_minpts_ratio,
                                   pose_mode=self.cfg.model.pose_mode)
        if self.scale_agent is not None:
            lengths = self.scale_agent.predict(feats[0], agg["rotation"])
        else:
            lengths = analytic_bbox_lengths(batch["pts"], agg["rotation"], agg["translation"])
        return {"batch": batch, "features": feats[0], "rgb_features": feats[1],
                "candidates": poses, "energy": energy, "aggregate": agg, "lengths": lengths}

    def inference(self, frame: dict, prev_pose: Optional[torch.Tensor] = None,
                  tracking: bool = False, generator: Optional[torch.Generator] = None,
                  mask_ids=None, prior: Optional[torch.Tensor] = None,
                  energy_t: Optional[torch.Tensor] = None) -> Optional[dict]:
        """frame: {color (H, W, 3) uint8, depth (H, W) meters, mask (H, W)
        int, intrinsics {fx, fy, cx, cy, width, height}}. Returns pose
        (n, 4, 4), lengths (n, 3) clipped at 1e-3, mask_ids (n,) as numpy, and
        prev_pose (n, 9) (rotation's first two columns, translation; camera
        frame) for the next call; None when no object has usable depth.
        ``generator``, ``prior`` and ``energy_t`` as in ``serve_batch``."""
        raw = self.front_end(frame, mask_ids)
        if raw is None:
            return None
        out = self.serve_batch(raw, prev_pose, tracking, generator, prior, energy_t)
        R, t = out["aggregate"]["rotation"], out["aggregate"]["translation"]
        pose44 = np.tile(np.eye(4, dtype=np.float32), (R.shape[0], 1, 1))
        pose44[:, :3, :3] = to_host(R).numpy()
        pose44[:, :3, 3] = to_host(t).numpy()
        return {"pose": pose44,
                "lengths": np.clip(to_host(out["lengths"]).numpy(), 1e-3, None),
                "mask_ids": raw["mask_ids"],
                "prev_pose": torch.cat([matrix_to_rot6d_cols(R), t], dim=-1)}
