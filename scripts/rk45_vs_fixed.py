#!/usr/bin/env python3
"""How far the adaptive RK45 sampler (cfg.sampler's atol / rtol 1e-5) lands
from 500 fixed RK4 steps from the same prior, at tiny_test_config on the CPU
with random weights drawn as chip_smoke.py draws them: the bound that
chip_smoke.py's samplers phase holds its float32 rk45 candidates to against
the fused RK4 kernel.

    python3 scripts/rk45_vs_fixed.py [--seeds 6]

Prints one line a seed (rk45's steps, max |rk45 - fixed|) and the worst.
"""

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from genpose2_tpu_torch.config import tiny_test_config  # noqa: E402
from genpose2_tpu_torch.training.agent import PoseAgent  # noqa: E402


def randomize(module, gen):
    """chip_smoke.py's random weights: every parameter moved by N(0, 0.02),
    BatchNorm statistics drawn."""
    for p in module.parameters():
        p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    for name, b in module.named_buffers():
        if name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
        elif name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=gen) * 0.05)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    torch.set_grad_enabled(False)
    cfg = tiny_test_config()
    cfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, max_rk45_steps=2000))
    worst = 0.0
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        agent = PoseAgent(cfg, "score", device="cpu")
        randomize(agent.model, gen)
        pts = torch.rand(4, cfg.model.num_points, 3, generator=gen) * 0.3 \
            + torch.tensor([0.0, 0.0, 0.6])
        batch = {"pts": pts, "pts_center": pts.mean(1)}
        prior = agent.sde.prior_sample((4 * 16, 9), T=0.55, generator=gen)
        stats = {}
        rk45 = agent.sample_candidates(batch, repeat_num=16, T0=0.55, prior=prior, stats=stats)
        fixed = agent.sample_candidates(batch, repeat_num=16, T0=0.55, method="fixed",
                                        num_steps=500, prior=prior)
        err = float((rk45 - fixed).abs().max())
        worst = max(worst, err)
        print(f"seed {seed}: rk45 {int(stats['nsteps'])} steps, max |rk45 - fixed 500| {err}")
    print(f"worst {worst}")


if __name__ == "__main__":
    main()
