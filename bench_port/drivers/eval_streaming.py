"""Entry: ``SingleFrameEvaluator.run_streaming`` over batches of labelled
synthetic objects, the dataset evaluator's path.

Traffic keys: ``objects`` (a batch), ``pool`` (distinct batches, used in
turn), ``shapes``, ``judge_units``, ``limits``. The evaluator's settings
(K, steps, T0, energy time, aggregation) are the configuration's ``eval``
and ``sampler``; the sampler's start noise of each batch comes from the
seed (``gen/batches.py:UnitDraws``) and is handed to the evaluator and to
the reference alike. A unit is one batch, from its hand-over to its
per-object results on the host; its work is objects x K candidates.

Of each unit the driver keeps the candidates, energies and per-object
results, and the backbone's output (``features``) while the unit may still
be judged (``runner.judgeable``): a batch's tapped layers are 150 MB, so at
most ``judge_units`` + 1 batches' are held on the card at a time, by
reference, without a copy."""

from __future__ import annotations

import time

import torch

from bench_port.gen.batches import UnitDraws, labelled_batches, prior_std
from bench_port.harness import agents
from bench_port.harness.reference_run import gaps, maybe_costed, rk4_costs, run_unit, worst
from bench_port.harness.runner import judgeable


def _inputs(ctx, cfg):
    """(the pool of batches, the per-unit draws) of the seed."""
    p = ctx.params
    img = cfg.model.img_size if cfg.model.dino == "pointwise" else 0
    pool = labelled_batches(ctx.seed, p["pool"], p["objects"], cfg.model.num_points,
                            p["shapes"], img, ctx.device)
    K = cfg.eval.eval_repeat_num
    std = prior_std(agents.config(agents.REFERENCE, ctx.cell.config).sde, cfg.eval.T0)
    return pool, UnitDraws(ctx.seed, p["objects"] * K, cfg.model.pose_dim, std, ctx.device)


def reference(ctx, units, control=False, program=None):
    """The frozen reference's outputs of ``units`` from the seed's weights
    and inputs, at the configuration's precision or the control's
    (``agents.precision``); with ``program`` ({unit: its outputs}) also the
    stages that follow the program's (``run_unit``)."""
    cfg, s, e, sc = agents.build(agents.REFERENCE, ctx.cell.config, ctx.seed, ctx.device)
    pool, draws = _inputs(ctx, cfg)
    outs = []
    for n, i in enumerate(units):
        with agents.precision(control):
            out = run_unit(cfg, s, e, sc, pool[i % len(pool)], draws.prior(i),
                           K=cfg.eval.eval_repeat_num, T0=cfg.eval.T0,
                           steps=cfg.sampler.sampling_steps, fixed_t=1e-5, clamp_lengths=True,
                           follow=None if program is None else program[i],
                           count=maybe_costed(ctx.costs, ctx.trace and n == 0))
        outs.append({k: None if v is None else v.cpu() for k, v in out.items()})
    if ctx.trace:
        rk4_costs(cfg, s, ctx.params["objects"] * cfg.eval.eval_repeat_num,
                  cfg.sampler.sampling_steps, ctx.costs)
    return outs


class Session:
    def __init__(self, ctx):
        from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator

        self.ctx = ctx
        cfg, s, e, sc = agents.build(agents.PORT, ctx.cell.config, ctx.seed, ctx.device)
        self.K = cfg.eval.eval_repeat_num
        self.pool, self.draws = _inputs(ctx, cfg)

        def scale_fn(batch, R, t, pts_feat=None):
            if pts_feat is None:
                pts_feat, _ = s.extract_features(batch)
            return sc.predict(pts_feat, R)

        self.ev = SingleFrameEvaluator(cfg, s, e, scale_fn=scale_fn, out_dir=None)
        self.outputs = {}  # unit -> what the program produced
        self._unit = 0
        self._capture(self.ev)
        sp = ctx.spans
        sp.wrap(s, "with_image_features", "agents.with_image_features")
        sp.wrap(s, "extract_features", "agents.extract_features")
        sp.wrap(self.ev, "_sample", "sampler.sample_candidates")
        sp.wrap(self.ev, "_energy", "agents.get_energy")
        sp.wrap(self.ev, "_aggregate", "evaluation.aggregate")
        sp.wrap(self.ev, "_lengths", "agents.scale")

    def _capture(self, ev) -> None:
        """Keep each unit's backbone output, candidates and energies, which
        run_streaming does not return, and its per-object results."""
        def keep(key, fn, part=None):
            def kept(*args, **kwargs):
                out = fn(*args, **kwargs)
                value = out if part is None else out.get(part)
                if value is not None:
                    self.outputs.setdefault(self._unit, {})[key] = value
                return out
            return kept

        s = ev.score_agent
        s.with_image_features = keep("features", s.with_image_features, "dino_layers")
        ev._sample = keep("candidates", ev._sample)
        ev._energy = keep("energy", ev._energy)
        ev._run_one = keep("results", ev._run_one)

    def _drop_features(self) -> None:
        """Let go of the backbone output of every unit no longer judgeable."""
        keep = judgeable(self.ctx.units, self.ctx.seed, int(self.ctx.params["judge_units"]))
        for i, o in self.outputs.items():
            if i not in keep:
                o.pop("features", None)

    def warmup(self) -> None:
        d = self.draws
        warm = UnitDraws(self.ctx.seed + 1, d.rows, d.dim, d.std, self.ctx.device)
        self.ev.run_streaming(iter(self.pool[:1]), priors=warm)
        self.outputs.clear()

    def window(self, t0: float, seconds: float, record) -> None:
        objects = self.ctx.params["objects"]
        work = {"candidates": objects * self.K, "objects": objects}
        P = len(self.pool)

        def batches():
            i, start = 0, t0
            while True:
                self._unit = i
                yield self.pool[i % P]
                end = time.perf_counter()  # run_streaming asks again once unit i is on the host
                record(start, end, work)
                self._drop_features()
                if end - t0 >= seconds:
                    return
                i, start = i + 1, end

        self.ev.run_streaming(batches(), priors=self.draws)

    def release(self) -> None:
        for o in self.outputs.values():
            o.update(o.pop("results"))
            for k in ("candidates", "energy"):
                o[k] = o[k].detach().cpu()
            if "features" in o:
                o["features"] = torch.stack(o["features"]).cpu()
        self.ev = self.pool = self.draws = None

    def judge(self, units):
        refs = reference(self.ctx, units, program=self.outputs)
        return worst([gaps(self.outputs[i], r) for i, r in zip(units, refs)])
