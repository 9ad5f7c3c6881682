"""Random weights from the seed for configurations too large for one draw a
kind (``weights.randomize`` draws every parameter's noise in one buffer: 54
GB of float32 for two 6.7-billion-parameter backbones).

The same moves as ``weights.randomize`` (parameters by N(0, 0.02), BatchNorm
running means from N(0, 0.05^2), running variances from U[0.5, 1.5)), with
each kind's values the stream of fixed-size chunks drawn one after another
from one device generator and handed to the leaves in order. A cell uses
one of the two draws on both sides, so the program and the frozen reference
build the same weights from the seed.

``build`` is ``agents.build`` with this draw."""

from __future__ import annotations

import importlib
from typing import Sequence

import torch

from bench_port.gen.batches import sub_seed
from bench_port.harness import agents
from bench_port.harness.agents import modules_of, seed_init
from bench_port.harness.weights import _leaves

CHUNK = 1 << 26  # values a draw: 256 MB of float32


@torch.no_grad()
def randomize_chunked(modules: Sequence[torch.nn.Module], seed: int, device,
                      chunk: int = CHUNK) -> int:
    """Move every module's weights as the module docstring says; returns the
    number of values used."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = 0
    for leaves, draw in zip(_leaves(modules), (
            lambda: torch.randn(chunk, generator=gen, device=device) * 0.02,
            lambda: torch.randn(chunk, generator=gen, device=device) * 0.05,
            lambda: torch.rand(chunk, generator=gen, device=device) + 0.5)):
        values, at = None, chunk
        for t in leaves:
            flat, done = t.view(-1), 0
            is_param = isinstance(t, torch.nn.Parameter)
            while done < flat.numel():
                if at == chunk:
                    values, at = draw(), 0
                k = min(flat.numel() - done, chunk - at)
                v = values[at:at + k].to(t.dtype)
                if is_param:
                    flat[done:done + k].add_(v)
                else:
                    flat[done:done + k].copy_(v)
                done, at = done + k, at + k
            total += flat.numel()
    return total


def build(package: str, spec: dict, seed: int, device):
    """(cfg, score agent, energy agent, scale agent) of ``package`` with the
    seed's weights, drawn in chunks; the agents built as ``agents.build``
    builds them."""
    agent_mod = importlib.import_module(f"{package}.training.agent")
    cfg = agents.config(package, spec)
    seed_init(seed)
    s = agent_mod.PoseAgent(cfg, "score", device=device)
    e = agent_mod.PoseAgent(cfg, "energy", device=device)
    pts_dim = sum(m[-1] for m in cfg.model.pointnet2.mlps[-1])
    sc = agent_mod.ScaleAgent(cfg, pts_dim=pts_dim, device=device)
    randomize_chunked(modules_of(s, e, sc), sub_seed(seed, 3), device)
    return cfg, s, e, sc
