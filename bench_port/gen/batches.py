"""The one general generator of the cells' inputs, from the seed and a
cell's traffic parameters: labelled batches of synthetic objects (the copy
of the port's ``SyntheticPoseData`` beside this file) with, where the
configuration reads images, noise crops and each point's pixel; the host
form of a batch that ``serve_batch`` takes; and the sampler's start noise
and energy times per unit, drawn in unit order from a generator of their
own, so the same seed gives the same inputs whatever a run's length."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_port.gen.synthetic import SyntheticPoseData


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream of draws (weights, inputs, priors)."""
    return (int(seed) * 16 + stream) % (2 ** 63)


def labelled_batches(seed: int, count: int, objects: int, num_points: int, shapes: List[str],
                     img_size: int = 0, device="cpu") -> List[Dict[str, torch.Tensor]]:
    """``count`` batches of ``objects`` objects, shapes in turn, class label
    the shape's index; with ``img_size`` 256-px style N(0, 1) crops
    ``roi_rgb`` (B, S, S, 3) and each point's pixel ``roi_xs`` /
    ``roi_ys``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    out = []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        b = SyntheticPoseData(num_points, shape).batch(gen, objects)
        b["class_label"] = torch.full((objects,), shapes.index(shape), dtype=torch.int32,
                                      device=device)
        if img_size:
            S = img_size
            b["roi_rgb"] = torch.randn(objects, S, S, 3, generator=gen, device=device)
            b["roi_xs"] = torch.randint(0, S, (objects, num_points), generator=gen, device=device)
            b["roi_ys"] = torch.randint(0, S, (objects, num_points), generator=gen, device=device)
        out.append(b)
    return out


def host_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The collated numpy batch a caller hands ``serve_batch``: the
    camera-frame cloud and the pose, plus the crops where there are any."""
    raw = {"pcl_in": batch["cam_pts"], "rotation": batch["gt_rotation"],
           "translation": batch["gt_translation"]}
    for k in ("roi_rgb", "roi_xs", "roi_ys"):
        if k in batch:
            raw[k] = batch[k]
    return {k: v.detach().cpu().numpy() for k, v in raw.items()}


def prior_std(sde_cfg, T0: float) -> float:
    """The VE marginal std at T0, by the frozen reference's SDE of ``sde_cfg`` (the
    reference's SDEConfig)."""
    from bench_port.reference.diffusion.sde import init_sde

    return float(init_sde(sde_cfg).marginal_std(torch.tensor(T0, dtype=torch.float32)))


class UnitDraws:
    """Per-unit draws in unit order: ``prior(i)`` (rows, D) from the VE
    prior at T0 (N(0, 1) times the marginal std at T0, as
    ``SDE.prior_sample``), and ``energy_t(i)`` (rows, 1) from U[lo, hi).
    Unit i's draws are the same whatever was asked before; each is kept for
    the reference."""

    def __init__(self, seed: int, rows: int, dim: int, std_T0: float, device="cpu",
                 t_range=None):
        self.rows, self.dim, self.std, self.device = rows, dim, std_T0, device
        self.t_range = t_range
        self.gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
        self.drawn: Dict[int, dict] = {}

    def _draw(self, i: int) -> dict:
        while len(self.drawn) <= i:
            d = {"prior": torch.randn(self.rows, self.dim, generator=self.gen,
                                      device=self.device) * self.std}
            if self.t_range is not None:
                lo, hi = self.t_range
                d["energy_t"] = (torch.rand(self.rows, 1, generator=self.gen, device=self.device)
                                 * (hi - lo) + lo)
            self.drawn[len(self.drawn)] = d
        return self.drawn[i]

    def prior(self, i: int) -> torch.Tensor:
        return self._draw(i)["prior"]

    def energy_t(self, i: int) -> torch.Tensor:
        return self._draw(i)["energy_t"]

    def __getitem__(self, i: int) -> torch.Tensor:  # a priors sequence for run_streaming
        return self.prior(i)
