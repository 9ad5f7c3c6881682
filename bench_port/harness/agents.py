"""The agents of a configuration, in the port or in the frozen reference,
with the random weights of the seed.

Both sides build their modules in the same order (score, energy, scale)
under ``torch.manual_seed`` of the weights' seed, then ``weights.randomize``
moves every module's weights with draws from one device generator: the
reference makes the same weights from the seed without taking any from the
program."""

from __future__ import annotations

import importlib

import torch

from bench_port.gen.batches import sub_seed
from bench_port.harness import configs
from bench_port.harness.weights import randomize

PORT = "genpose2_tpu_torch"
REFERENCE = "bench_port.reference"


def config(package: str, spec: dict):
    return configs.build(importlib.import_module(f"{package}.config"), spec)


def modules_of(score, energy=None, scale=None):
    """The modules whose weights are drawn, in the order they are drawn."""
    out = []
    for agent in (score, energy):
        if agent is not None:
            out.append(agent.model)
            if agent.provider is not None:
                out.append(agent.provider.vit)
    if scale is not None:
        out.append(scale.model)
    return out


def seed_init(seed: int) -> None:
    torch.manual_seed(sub_seed(seed, 0))


def draw_weights(seed: int, device, score, energy=None, scale=None) -> None:
    randomize(modules_of(score, energy, scale), sub_seed(seed, 3), device)


def build(package: str, spec: dict, seed: int, device, energy: bool = True,
          scale: bool = True):
    """(cfg, score agent, energy agent or None, scale agent or None) of
    ``package`` with the seed's weights."""
    agent_mod = importlib.import_module(f"{package}.training.agent")
    cfg = config(package, spec)
    seed_init(seed)
    s = agent_mod.PoseAgent(cfg, "score", device=device)
    e = agent_mod.PoseAgent(cfg, "energy", device=device) if energy else None
    sc = None
    if scale:
        pts_dim = sum(m[-1] for m in cfg.model.pointnet2.mlps[-1])
        sc = agent_mod.ScaleAgent(cfg, pts_dim=pts_dim, device=device)
    draw_weights(seed, device, s, e, sc)
    return cfg, s, e, sc


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax to 448),
    as an fp8 product takes its operands; returned in float32."""
    x32 = x.float()
    scale = x32.abs().amax().clamp(min=1e-30) / 448.0
    return (x32 / scale).to(torch.float8_e4m3fn).float() * scale


def engine(ctx):
    """(cfg, the port's ``GenPose2`` with the seed's weights), at the cell's
    ``T0`` and ``num_steps``; it builds its agents as ``build`` does."""
    from genpose2_tpu_torch.api import GenPose2

    p = ctx.params
    cfg = config(PORT, ctx.cell.config)
    seed_init(ctx.seed)
    eng = GenPose2(cfg, score=True, energy=True, scale=True, single_T0=p["T0"],
                   num_steps=p["num_steps"], device=ctx.device)
    draw_weights(ctx.seed, ctx.device, eng.score_agent, eng.energy_agent, eng.scale_agent)
    return cfg, eng


class precision:
    """The reference's precision inside the block: the configuration's
    (float32 products with TF32 off; the backbone's bf16 products as the
    configuration states them), or with ``control`` the control's, the
    nearest precision below each: float32 products in TF32, and the
    backbone's bf16 products from fp8 (e4m3, per-tensor scale) operands;
    with ``control="tf32_only"`` the float32 products alone."""

    def __init__(self, control=False):
        assert control in (False, True, "tf32_only"), control
        self.control, self.fp8 = bool(control), control is True

    def __enter__(self):
        from bench_port.reference.models import vit

        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, vit.mm, vit.dense)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.control
        if self.control and self.fp8:
            mm, dense = vit.mm, vit.dense

            def mm_fp8(a, w, dt):
                return mm(_fp8(a), _fp8(w), dt) if dt == torch.bfloat16 else mm(a, w, dt)

            def dense_fp8(x, lin, dt):
                if dt != torch.bfloat16:
                    return dense(x, lin, dt)
                return _fp8(x).to(dt) @ _fp8(lin.weight.t()).to(dt) + lin.bias.to(dt)

            vit.mm, vit.dense = mm_fp8, dense_fp8

    def __exit__(self, *exc):
        from bench_port.reference.models import vit

        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, vit.mm, vit.dense = self.saved
