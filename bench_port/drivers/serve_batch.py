"""Entry: ``GenPose2.serve_batch`` in single-frame mode on collated host
batches, the batch caller's request (no front end).

Traffic keys: ``objects`` (a request), ``pool`` (distinct requests, sent in
turn), ``shapes``, ``num_steps``, ``T0``, ``judge_units``, ``limits``. Each
request's start noise and energy times (U[1e-5, 1e-4), the detection
mode's) come from the seed and go to the program and to the reference
alike. A unit is one request, from the host batch handed over to its
aggregated poses and lengths read back on the host; its work is objects x K
candidates."""

from __future__ import annotations

from bench_port.gen.batches import UnitDraws, host_batch, labelled_batches, prior_std
from bench_port.harness import agents
from bench_port.harness.reference_run import gaps, maybe_costed, rk4_costs, run_unit, worst
from bench_port.harness.runner import closed_loop

ENERGY_T = (1e-5, 1e-4)  # the detection mode's energy times (training/agent.py:RANK_T)


def _inputs(ctx, cfg):
    """(the pool of host requests, the per-unit draws) of the seed."""
    p = ctx.params
    img = cfg.model.img_size if cfg.model.dino == "pointwise" else 0
    pool = labelled_batches(ctx.seed, p["pool"], p["objects"], cfg.model.num_points,
                            p["shapes"], img, ctx.device)
    std = prior_std(agents.config(agents.REFERENCE, ctx.cell.config).sde, p["T0"])
    draws = UnitDraws(ctx.seed, p["objects"] * cfg.eval.eval_repeat_num, cfg.model.pose_dim,
                      std, ctx.device, t_range=ENERGY_T)
    return [host_batch(b) for b in pool], draws


def reference(ctx, units, control=False, program=None):
    """The frozen reference's outputs of ``units`` (as eval_streaming's),
    from its agents built as ``GenPose2`` builds them."""
    from bench_port.reference.data.loader import process_batch

    p = ctx.params
    cfg, s, e, sc = agents.build(agents.REFERENCE, ctx.cell.config, ctx.seed, ctx.device)
    raw, draws = _inputs(ctx, cfg)
    outs = []
    for n, i in enumerate(units):
        batch = process_batch(raw[i % len(raw)], cfg.model.pose_mode, ctx.device)
        with agents.precision(control):
            out = run_unit(cfg, s, e, sc, batch, draws.prior(i), K=cfg.eval.eval_repeat_num,
                           T0=p["T0"], steps=p["num_steps"], fixed_t=None,
                           energy_t=draws.energy_t(i),
                           follow=None if program is None else program[i],
                           count=maybe_costed(ctx.costs, ctx.trace and n == 0))
        outs.append({k: None if v is None else v.cpu() for k, v in out.items()})
    if ctx.trace:
        rk4_costs(cfg, s, p["objects"] * cfg.eval.eval_repeat_num, p["num_steps"], ctx.costs)
    return outs


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, self.engine = agents.engine(ctx)
        self.K = cfg.eval.eval_repeat_num
        self.raw, self.draws = _inputs(ctx, cfg)
        self.outputs = {}
        eng, sp = self.engine, ctx.spans
        sp.wrap(eng.score_agent, "with_image_features", "agents.with_image_features")
        sp.wrap(eng.score_agent, "extract_features", "agents.extract_features")
        sp.wrap(eng.score_agent, "sample_candidates", "sampler.sample_candidates")
        sp.wrap(eng.energy_agent, "get_energy", "agents.get_energy")
        sp.wrap(eng.scale_agent, "predict", "agents.scale")

    def _request(self, i: int, draws: UnitDraws) -> dict:
        out = self.engine.serve_batch(self.raw[i % len(self.raw)], prior=draws.prior(i),
                                      energy_t=draws.energy_t(i))
        agg = out["aggregate"]
        host = {"rotation": agg["rotation"].cpu(), "translation": agg["translation"].cpu(),
                "lengths": out["lengths"].cpu()}  # the caller's read of its answer
        return {"candidates": out["candidates"], "energy": out["energy"], **host}

    def warmup(self) -> None:
        d = self.draws
        warm = UnitDraws(self.ctx.seed + 1, d.rows, d.dim, d.std, self.ctx.device,
                         t_range=ENERGY_T)
        for i in range(2):
            self._request(i, warm)

    def window(self, t0: float, seconds: float, record) -> None:
        objects = self.ctx.params["objects"]
        work = {"candidates": objects * self.K, "objects": objects}

        def step(i):
            self.outputs[i] = self._request(i, self.draws)
            return work

        closed_loop(step, t0, seconds, record)

    def release(self) -> None:
        for o in self.outputs.values():
            for k in ("candidates", "energy"):
                o[k] = o[k].detach().cpu()
        self.engine = self.draws = None

    def judge(self, units):
        refs = reference(self.ctx, units, program=self.outputs)
        return worst([gaps(self.outputs[i], r) for i, r in zip(units, refs)])
