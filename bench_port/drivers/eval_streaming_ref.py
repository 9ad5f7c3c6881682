"""Entry: ``SingleFrameEvaluator.run_streaming``, as ``eval_streaming`` (its
traffic, its unit, what it keeps, its judge: its ``Session`` and inputs),
with the frozen reference package named by the cell file's ``reference``
key, so that a configuration the first frozen copy cannot build brings a
copy of its own. Both sides draw the seed's weights in chunks
(``harness/chunked_weights.py``).

The cell file's ``reference``:

- ``package``: the frozen copy (e.g. ``bench_port.reference_vit7b``);
- ``backbone_gap``: how far the frozen copy's backbone output may stray
  from the package's ``dinov3_plain`` (written from the published DINOv3
  description, independent of the port) on the same crops and weights:
  every judged unit holds it there at the configuration's precision, on the
  run's device, and the run stops if it strays, so the frozen copy cannot
  share a semantic error with the program it judges.

In a traced run the judge also counts the ViT kernels' launches
(``harness/vit_costs.py``) and the frozen copy's SA stage launches over the
reference's first judged unit."""

from __future__ import annotations

import contextlib
import importlib
import sys

import torch

from bench_port.harness import agents, chunked_weights, vit_costs
from bench_port.harness.costs import sa_stage_cost
from bench_port.harness.manifest import load_driver
from bench_port.harness.reference_run import (_add, _gap, gaps, maybe_costed, rk4_costs, run_unit,
                                              worst)

_base = load_driver("eval_streaming")


class precision:
    """``agents.precision`` for the frozen copy ``package``: inside the block
    float32 products with TF32 off and the backbone's bf16 products as the
    configuration states them, or with ``control`` the nearest precision
    below each (TF32; fp8 e4m3 operands with a scale a tensor), with
    ``control="tf32_only"`` the float32 products alone."""

    def __init__(self, package: str, control=False):
        assert control in (False, True, "tf32_only"), control
        self.vit = importlib.import_module(f"{package}.models.vit")
        self.control, self.fp8 = bool(control), control is True

    def __enter__(self):
        b, vit = torch.backends, self.vit
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, vit.mm, vit.dense)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.control
        if self.control and self.fp8:
            mm, dense, fp8 = vit.mm, vit.dense, agents._fp8

            def mm_fp8(a, w, dt):
                return mm(fp8(a), fp8(w), dt) if dt == torch.bfloat16 else mm(a, w, dt)

            def dense_fp8(x, lin, dt):
                if dt != torch.bfloat16:
                    return dense(x, lin, dt)
                return fp8(x).to(dt) @ fp8(lin.weight.t()).to(dt) + lin.bias.to(dt)

            vit.mm, vit.dense = mm_fp8, dense_fp8

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, self.vit.mm, self.vit.dense = self.saved


@contextlib.contextmanager
def _sa_recorded(package: str, costs):
    """``reference_run.costed``'s record of each SA stage launch
    ('sa_stage.*'), for the frozen copy ``package`` (``costed`` patches the
    first copy's module)."""
    fast_encoder = importlib.import_module(f"{package}.models.fast_encoder")
    ball_count = importlib.import_module(f"{package}.ops.ball_query").ball_count_plain
    plain_stage = fast_encoder.fused_sa_stage_plain

    def recording(xyz, new_xyz, projs, centers, affines_list, weights_list, radii, nsamples):
        B, N, M = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        scales = []
        for s in range(len(radii)):
            cnt = ball_count(xyz, new_xyz, radii[s]).clamp(max=nsamples[s]).clamp(min=1)
            ws = weights_list[s]
            scales.append({"h1": projs[s].shape[-1],
                           "weights": [(w.shape[0], w.shape[1]) for w in ws],
                           "affine_values": sum(a.numel() for a, _ in affines_list[s]),
                           "c_out": ws[-1].shape[1] if ws else projs[s].shape[-1],
                           "rows": int(cnt.sum())})
        kind = "bfloat16" if projs[0].dtype == torch.bfloat16 else "float32"
        _add(costs, "sa_stage", *sa_stage_cost(B, N, M, scales, kind))
        return plain_stage(xyz, new_xyz, projs, centers, affines_list, weights_list, radii,
                           nsamples)

    fast_encoder.fused_sa_stage_plain = recording
    try:
        yield
    finally:
        fast_encoder.fused_sa_stage_plain = plain_stage


@contextlib.contextmanager
def _counted(ctx, package: str, vit):
    """The unit's product FLOPs and kernel costs (``costs.py``), and the
    ViT kernels' launches, into ``ctx.costs``."""
    with maybe_costed(ctx.costs, True), _sa_recorded(package, ctx.costs), \
            vit_costs.costed(vit, ctx.costs):
        yield


def backbone_gap(package: str, cfg, provider, rgb, features) -> float:
    """The widest gap of the frozen copy's tapped layers ``features``
    (stacked) from ``dinov3_plain``'s on the crops ``rgb`` with the
    provider's ViT weights, each relative to the plain layer's largest
    value, at the configuration's precision."""
    plain = importlib.import_module(f"{package}.dinov3_plain")
    vit = provider.vit
    dtype = torch.bfloat16 if cfg.model.backbone_dtype == "bfloat16" else torch.float32
    with precision(package):
        taps = plain.forward(vit.state_dict(), provider._pixels(rgb), provider.layer_ids,
                             vit.num_heads, dtype, cfg.model.patch_size)
    return max(_gap(f, t, relative=True) for f, t in zip(features, taps))


def reference(ctx, units, control=False, program=None):
    """The frozen reference's outputs of ``units`` from the seed's weights
    and inputs, at the configuration's precision or the control's
    (``precision``); with ``program`` ({unit: its outputs}) also the stages
    that follow the program's (``run_unit``). At the configuration's
    precision each unit's backbone output is held to the plain DINOv3
    (``backbone_gap``)."""
    ref = ctx.params["reference"]
    package = ref["package"]
    cfg, s, e, sc = chunked_weights.build(package, ctx.cell.config, ctx.seed, ctx.device)
    pool, draws = _base._inputs(ctx, cfg)
    vit = importlib.import_module(f"{package}.models.vit")
    outs = []
    for n, i in enumerate(units):
        batch = pool[i % len(pool)]
        with precision(package, control):
            out = run_unit(cfg, s, e, sc, batch, draws.prior(i),
                           K=cfg.eval.eval_repeat_num, T0=cfg.eval.T0,
                           steps=cfg.sampler.sampling_steps, fixed_t=1e-5, clamp_lengths=True,
                           follow=None if program is None else program[i],
                           count=_counted(ctx, package, vit) if ctx.trace and n == 0 else None)
        if not control:
            g = backbone_gap(package, cfg, s.provider, batch["roi_rgb"], out["features"])
            print(f"bench_port: unit {i}: the reference's backbone {g!r} from the plain "
                  f"DINOv3 (at most {ref['backbone_gap']!r})", file=sys.stderr, flush=True)
            if not g <= ref["backbone_gap"]:
                raise RuntimeError(f"the frozen reference's backbone strays from the plain "
                                   f"DINOv3 by {g!r} on unit {i} (at most "
                                   f"{ref['backbone_gap']!r}): the reference is at fault")
        outs.append({k: None if v is None else v.cpu() for k, v in out.items()})
    if ctx.trace:
        rk4_costs(cfg, s, ctx.params["objects"] * cfg.eval.eval_repeat_num,
                  cfg.sampler.sampling_steps, ctx.costs)
    return outs


class Session(_base.Session):
    """``eval_streaming``'s session with the agents' weights drawn in chunks,
    judged against the cell's reference."""

    def __init__(self, ctx):
        from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator

        self.ctx = ctx
        cfg, s, e, sc = chunked_weights.build(agents.PORT, ctx.cell.config, ctx.seed, ctx.device)
        self.K = cfg.eval.eval_repeat_num
        self.pool, self.draws = _base._inputs(ctx, cfg)

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

    def judge(self, units):
        refs = reference(self.ctx, units, program=self.outputs)
        return worst([gaps(self.outputs[i], r) for i, r in zip(units, refs)])
