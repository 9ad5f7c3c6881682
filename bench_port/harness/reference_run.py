"""A unit of the pose pipeline through the frozen reference, and the gaps
between what the program produced and what the reference produces.

The reference's agents run their plain code paths (``plain=True``; its op
wrappers have no kernel branch besides) at the configuration's precision:
float32 products with TF32 off, the backbone in the configuration's dtype.
The backbone is held apart from the stages after it: the reference's own
backbone on the unit's crops gives ``features``, against which the
program's backbone output is compared (``vit_gap``), and the stages after
it run on the program's backbone output, so the numbers of those stages
measure them alone and not the backbone's bf16 rounding as well. In a
traced run ``count`` counts the unit's product FLOPs and records each SA
stage's shapes and grouped rows for the kernel costs."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from bench_port.harness.costs import ProductFlops, least_seconds, rk4_cost, sa_stage_cost


@torch.no_grad()
def run_unit(cfg, score, energy, scale, batch: dict, prior: torch.Tensor, *, K: int, T0: float,
             steps: int, fixed_t: Optional[float] = 1e-5,
             energy_t: Optional[torch.Tensor] = None, init_x: Optional[torch.Tensor] = None,
             clamp_lengths: bool = False, follow: Optional[Dict[str, torch.Tensor]] = None,
             count=None) -> Dict[str, torch.Tensor]:
    """The reference's unit from the batch and the draws: the backbone's
    tapped layers (``features``, stacked; None without a backbone),
    candidates, energies, aggregate, lengths. With ``follow`` (what the
    program produced for this unit) the stages after the backbone take the
    program's ``features``, and the reference also gives the stages it
    cannot reach on its own across a rounding that reorders a retained set:
    the aggregation of the program's candidates and energies
    (``agg_rotation``, ``agg_translation``) and ScaleNet on the reference's
    feature at the program's rotation (``lengths_at_rotation``). ``count``:
    a context manager around the unit's own stages (``maybe_costed``)."""
    from bench_port.reference.eval.aggregate import aggregate_candidates

    ev = cfg.eval

    def aggregate(poses, en):
        return aggregate_candidates(poses, en, retain_ratio=ev.retain_ratio,
                                    clustering=ev.clustering, eps=ev.clustering_eps,
                                    minpts_ratio=ev.clustering_minpts_ratio,
                                    pose_mode=cfg.model.pose_mode)

    def sizes(R):
        lengths = scale.predict(feats[0], R)
        return torch.clamp(lengths, min=1e-3) if clamp_lengths else lengths

    with count or contextlib.nullcontext():
        b = score.with_image_features(batch, True)
        features = torch.stack(b["dino_layers"]) if "dino_layers" in b else None
        if follow is not None and follow.get("features") is not None:
            b = dict(batch, dino_layers=list(follow["features"].to(features.device)))
        feats = score.extract_features(b, True)
        poses = score.sample_candidates(b, repeat_num=K, T0=T0, init_x=init_x, method="fixed",
                                        num_steps=steps, features=feats, prior=prior,
                                        plain=True)
        en = None
        if energy is not None:
            en = energy.get_energy(b, poses, fixed_t=fixed_t, t=energy_t, plain=True)
        agg = aggregate(poses, en)
        lengths = sizes(agg["rotation"])
    out = {"features": features, "candidates": poses, "energy": en,
           "rotation": agg["rotation"], "translation": agg["translation"], "lengths": lengths}
    if follow is not None:
        dev = poses.device
        theirs = aggregate(follow["candidates"].to(dev),
                           None if follow.get("energy") is None else follow["energy"].to(dev))
        out.update(agg_rotation=theirs["rotation"], agg_translation=theirs["translation"],
                   lengths_at_rotation=sizes(torch.as_tensor(follow["rotation"]).to(dev)))
    return out


NUMBERS = ("vit_gap", "cand_gap", "energy_gap", "agg_gap", "length_gap")  # what gaps() reads


def _gap(a, b, relative=False) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    g = float((a - b).abs().max())
    return g / max(float(b.abs().max()), 1e-30) if relative else g


def gaps(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared for one unit (``ref`` from ``run_unit`` with
    ``follow``): where there is a backbone, the widest gap of its tapped
    layers (``vit_gap``, each layer relative to its largest reference
    value); the widest gap of the candidates (absolute: unit columns and
    meters) and of the energies (relative to the reference's largest),
    both from the same inputs and backbone output; of the program's
    aggregate against the reference's aggregation of the program's own
    candidates and energies (``agg_gap``: rotation entries and meters); and
    of the program's box sizes against ScaleNet on the reference's feature
    at the program's rotation (``length_gap``, relative to the largest
    side)."""
    out = {"cand_gap": _gap(program["candidates"], ref["candidates"]),
           "agg_gap": max(_gap(program["rotation"], ref["agg_rotation"]),
                          _gap(program["translation"], ref["agg_translation"])),
           "length_gap": _gap(program["lengths"], ref["lengths_at_rotation"], relative=True)}
    if ref.get("energy") is not None:
        out["energy_gap"] = _gap(program["energy"], ref["energy"], relative=True)
    if ref.get("features") is not None:
        out["vit_gap"] = max(_gap(p, r, relative=True)
                             for p, r in zip(program["features"], ref["features"]))
    return out


def worst(per_unit: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(d[k] for d in per_unit) for k in per_unit[0]}


def _add(costs: Dict[str, float], kernel: str, nbytes: float, ops: Dict[str, float]) -> None:
    """One launch of ``kernel``: its bytes, operations by kind, least time."""
    costs[f"{kernel}.bytes"] = costs.get(f"{kernel}.bytes", 0.0) + nbytes
    for k, v in ops.items():
        costs[f"{kernel}.ops.{k}"] = costs.get(f"{kernel}.ops.{k}", 0.0) + v
    costs[f"{kernel}.bound_s"] = costs.get(f"{kernel}.bound_s", 0.0) + least_seconds(nbytes, ops)
    costs[f"{kernel}.launches"] = costs.get(f"{kernel}.launches", 0.0) + 1


@contextlib.contextmanager
def costed(costs: Dict[str, float]):
    """Count the block's product FLOPs by kind into ``costs`` ('flops.<kind>')
    and each SA stage launch's bytes, operations and least time ('sa_stage.*')."""
    from bench_port.reference.models import fast_encoder
    from bench_port.reference.ops.ball_query import ball_count_plain

    plain_stage = fast_encoder.fused_sa_stage_plain

    def recording(xyz, new_xyz, projs, centers, affines_list, weights_list, radii, nsamples):
        B, N, M = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        scales = []
        for s in range(len(radii)):
            cnt = ball_count_plain(xyz, new_xyz, radii[s]).clamp(max=nsamples[s]).clamp(min=1)
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
    counter = ProductFlops()
    try:
        with counter:
            yield
    finally:
        fast_encoder.fused_sa_stage_plain = plain_stage
    for kind, n in counter.flops.items():
        costs[f"flops.{kind}"] = costs.get(f"flops.{kind}", 0.0) + n


def maybe_costed(costs: Dict[str, float], on: bool):
    return costed(costs) if on else contextlib.nullcontext()


def rk4_costs(cfg, score, rows: int, steps: int, costs: Dict[str, float]) -> None:
    """The fused RK4 call's bytes and ops at the unit's rows and steps, from
    the widths of the reference's score net as the fused kernel folds it: D
    (pose), P1 and P2 (the pose MLP), H1 (the heads' first layers side by
    side)."""
    net = score.model.pose_score_net
    pe = net.pose_encoder
    H1 = sum(getattr(net, n)[0].weight.shape[0] for n in net.head_names())
    _add(costs, "rk4", *rk4_cost(cfg.model.pose_dim, pe[0].weight.shape[0],
                                 pe[2].weight.shape[0], H1, rows, steps, cfg.model.score_dtype))
