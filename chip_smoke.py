#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one card and hold every
kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:
  device    nvidia-smi's name and power limit, torch's device name;
  build     nvcc of the four kernel sources, all started together;
  reference the tiny_test_config score agent on the card against the plain
            versions on the CPU (the plain versions are held against the JAX
            package by tests/test_torch_port_*.py);
  kernels   each kernel against its plain version on the card, at the shapes
            of the main path, in float32 and in bf16 (discrete outputs exact);
  request   four requests through PoseAgent / ScaleAgent at full width
            (B=64 objects, 1024 points, K=50 candidates, 50 RK4 steps from
            T0=0.55, energies at t=1e-5, retain 0.4 with clustering): three in
            float32, one in bf16 settings. Launch counts are reset just before
            and read just after each request; the score encoder's feature and
            the candidates are recomputed with the plain versions on the card;
  timing    CUDA-event times of each kernel and its plain version at the main
            path's shapes, with the bound from this run's shapes and data.
  profile   torch.profiler device time by kernel name over one float32
            request, and the device's busy share against the warm requests.
Then the kernels table, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero and prints no
such line; so does a machine without a card, or a directory without the
package.
"""

import json
import os
import subprocess
import sys
import time
import traceback

SEED = 0
B, N, K, STEPS, T0 = 64, 1024, 50, 50, 0.55
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores; dense bf16
FAILED = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name):
    def wrap(fn):
        def run(*args, **kw):
            try:
                return fn(*args, **kw)
            except Exception as e:  # report every phase, then fail at the end
                FAILED.append(name)
                emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]})
                return None
        return run
    return wrap


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def object_clouds(gen, device):
    """B camera-frame clouds of N points on ellipsoid surfaces, 4-15 cm
    semi-axes, 0.5-1.2 m from the camera, 2 mm noise."""
    import torch

    d = torch.randn(B, N, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    axes = torch.rand(B, 1, 3, generator=gen) * 0.11 + 0.04
    center = torch.rand(B, 1, 3, generator=gen) * torch.tensor([0.6, 0.6, 0.7]) \
        + torch.tensor([-0.3, -0.3, 0.5])
    pts = d * axes + center + torch.randn(B, N, 3, generator=gen) * 0.002
    return pts.to(device)


def randomize(module, gen):
    """Random weights from a seed: every parameter moved by N(0, 0.02) (the
    output layers start at zero), BatchNorm statistics drawn."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.02)
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.05)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import genpose2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 3

    import dataclasses

    from genpose2_tpu_torch.config import default_config, tiny_test_config
    from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
    from genpose2_tpu_torch.models.fast_encoder import stage_arguments
    from genpose2_tpu_torch.models.scorenet import fast_score_weights
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain
    from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
    from genpose2_tpu_torch.ops.grouping import gather_points
    from genpose2_tpu_torch.ops.ode_rk4 import (compute_dtype_of, fused_rk4_integrate,
                                                fused_rk4_plain)
    from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave nothing"
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    @phase("build")
    def build():
        t0 = time.perf_counter()
        rep = _cuda.build()
        emit({"phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 2),
              "nvcc_seconds": {k: round(v["seconds"], 2) for k, v in rep.items()}})

    build()
    if FAILED:
        return 1

    def config(dtype):
        cfg = default_config()
        model = dataclasses.replace(
            cfg.model, dino="none", backbone="none", score_dtype=dtype,
            pointnet2=dataclasses.replace(cfg.model.pointnet2, compute_dtype=dtype))
        return cfg.replace(model=model)

    gen = torch.Generator().manual_seed(SEED)
    cfg32 = config("float32")
    score = PoseAgent(cfg32, "score", device=dev)
    energy = PoseAgent(cfg32, "energy", device=dev)
    scale = ScaleAgent(cfg32, device=dev)
    for agent in (score, energy, scale):
        randomize(agent.model, gen)
    agents = {"float32": (score, energy, scale)}
    for dtype in ("bfloat16",):
        cfg = config(dtype)
        s, e = PoseAgent(cfg, "score", device=dev), PoseAgent(cfg, "energy", device=dev)
        s.model.load_state_dict(score.model.state_dict())
        e.model.load_state_dict(energy.model.state_dict())
        agents[dtype] = (s, e, scale)
    plain_samplers = {}
    for dtype, (s, _, _) in agents.items():
        cfg = s.cfg.replace(sampler=dataclasses.replace(s.cfg.sampler, fused_fixed=False))
        plain_samplers[dtype] = PoseAgent(cfg, "score", device=dev)
        plain_samplers[dtype].model.load_state_dict(s.model.state_dict())

    @phase("reference")
    def reference():
        tiny = tiny_test_config()
        cpu = PoseAgent(tiny, "score", device="cpu")
        randomize(cpu.model, gen)
        card = PoseAgent(tiny, "score", device=dev)
        card.model.load_state_dict(cpu.model.state_dict())
        pts = torch.rand(4, tiny.model.num_points, 3, generator=gen) * 0.3
        prior = torch.randn(4 * 8, 9, generator=gen) * 0.5
        batch = {"pts": pts, "pts_center": pts.mean(1)}
        f_cpu, _ = cpu.extract_features(batch)
        f_card, _ = card.extract_features({k: v.to(dev) for k, v in batch.items()})
        p_cpu = cpu.sample_candidates(batch, repeat_num=8, T0=T0, num_steps=10, prior=prior)
        p_card = card.sample_candidates({k: v.to(dev) for k, v in batch.items()}, repeat_num=8,
                                        T0=T0, num_steps=10, prior=prior)
        errs = {"feature": max_err(f_card.cpu(), f_cpu), "candidates": max_err(p_card.cpu(), p_cpu)}
        emit({"phase": "reference", "config": "tiny_test_config", "max_abs_err": errs,
              "tolerance": {"feature": "rtol=atol=1e-4", "candidates": "rtol=1e-4, atol=5e-4"}})
        torch.testing.assert_close(f_card.cpu(), f_cpu, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(p_card.cpu(), p_cpu, rtol=1e-4, atol=5e-4)

    reference()

    # ------------------------------------------------- kernels vs plain versions
    pts0 = object_clouds(gen, dev)
    results = {}  # kernel entry name -> numbers for the kernels line

    def sa_stage_inputs(encoder, pts, pcfg):
        """Each grouped stage's kernel arguments as the main path forms them
        (density order at N >= 1024), the stages chained through the plain
        versions; plus each scale's real rows (min(count, nsample), or 1)."""
        dt = compute_dtype_of(pcfg.compute_dtype)
        S = gather_points(pts, fps_plain(pts, pcfg.npoints[0]))
        xyz, feats, stages = pts, None, []
        for sa in encoder.SA_modules:
            if sa.npoint is None:
                break
            nxs = S[:, :sa.npoint].contiguous()
            inv = None
            if xyz.shape[1] >= 1024:
                cnt = ball_count_plain(xyz, nxs, max(sa.radii))
                order = torch.argsort(-cnt, dim=1, stable=True)
                inv = torch.argsort(order, dim=1)
                nxs = gather_points(nxs, order).contiguous()
            inp = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
            args = stage_arguments(sa, inp, nxs, pcfg.use_xyz, dt)
            rows = [int(ball_count_plain(xyz, nxs, r).clamp(max=ns).clamp(min=1).sum())
                    for r, ns in zip(sa.radii, sa.nsamples)]
            stages.append((xyz.contiguous(), nxs, args, sa.radii, sa.nsamples, rows))
            out = fused_sa_stage_plain(xyz, nxs, *args, sa.radii, sa.nsamples)
            feats = out if inv is None else gather_points(out, inv)
            xyz = S[:, :sa.npoint]
        return stages

    def sa_cost(stage, dtype):
        xyz, nxs, (projs, centers, affs, wss), radii, nsamples, rows = stage
        Bn, Nn, Mn = xyz.shape[0], xyz.shape[1], nxs.shape[1]
        esize = 2 if dtype == "bfloat16" else 4
        nbytes = 12 * Bn * (Nn + Mn)
        ops = 9 * Bn * Mn * Nn  # distance tests
        for s in range(len(radii)):
            h1 = projs[s].shape[-1]
            nbytes += Bn * Nn * h1 * esize + Bn * Mn * h1 * 4
            macs = sum(w.shape[0] * w.shape[1] for w in wss[s])
            nbytes += macs * esize + sum(2 * 4 * a.numel() for a, _ in affs[s])
            c_out = wss[s][-1].shape[1] if wss[s] else h1
            nbytes += Bn * Mn * c_out * 4
            ops += rows[s] * (2 * macs + 4 * h1)
        return nbytes, ops

    @phase("kernels")
    def kernels():
        # FPS and ball count (float32 only)
        idx_k = furthest_point_sample(pts0, 512)
        idx_p = fps_plain(pts0, 512)
        fps_mismatch = int((idx_k != idx_p).sum())
        S = gather_points(pts0, idx_p)
        cnt_k = ball_count(pts0, S, 0.02)
        cnt_p = ball_count_plain(pts0, S, 0.02)
        bc_mismatch = int((cnt_k != cnt_p).sum())
        results["fps"] = {"max_abs_err": float(fps_mismatch), "tolerance": "exact"}
        results["ball_count"] = {"max_abs_err": float(bc_mismatch), "tolerance": "exact"}
        line = {"phase": "kernels", "fps_index_mismatches": fps_mismatch,
                "ball_count_mismatches": bc_mismatch, "sa": {}, "rk4": {}}
        ok = fps_mismatch == 0 and bc_mismatch == 0
        for dtype, (s, _, _) in agents.items():
            pcfg = s.cfg.model.pointnet2
            stages = sa_stage_inputs(s.model.pts_encoder, pts0, pcfg)
            errs, rel = [], []
            for xyz, nxs, args, radii, nsamples, _ in stages:
                k = fused_sa_stage(xyz, nxs, *args, radii, nsamples)
                p = fused_sa_stage_plain(xyz, nxs, *args, radii, nsamples)
                errs.append(max_err(k, p))
                rel.append(errs[-1] / max(float(p.abs().max()), 1e-30))
            # f32: the same products summed in another order; bf16: the same
            # bf16 operands, plus rare flips of one bf16 rounding
            tol = 1e-4 if dtype == "float32" else 2e-2
            ok = ok and max(rel) <= tol
            name = "fused_sa_stage" if dtype == "float32" else "fused_sa_stage.bf16"
            results[name] = {"max_abs_err": max(errs), "tolerance": f"{tol} of max|plain|",
                             "stages": stages}
            line["sa"][dtype] = {"max_abs_err": errs, "err_over_max": rel,
                                 "real_rows": [st[5] for st in stages],
                                 "slots": [[st[1].shape[0] * st[1].shape[1] * n
                                            for n in st[4]] for st in stages]}
            # RK4 at the main path's shape: 3200 rows, 50 steps
            feat, _ = s.extract_features({"pts": pts0}, plain=True)
            w = fast_score_weights(s.model.pose_score_net, feat.repeat_interleave(K, 0))
            x0 = s.sde.prior_sample((B * K, 9), T=T0, generator=gen).to(dev)
            xk = fused_rk4_integrate(x0, w, s.sde, T0, STEPS, dtype)
            xp = fused_rk4_plain(x0, w, s.sde, T0, STEPS, dtype)
            err = max_err(xk, xp)
            scale_ = float(xp.abs().max())
            # f32: the JAX package's bound for the fused kernel against the
            # scan; bf16: the kernel keeps the t rows in f32 where the scan
            # rounds them into its bf16 product, so it is looser
            tol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
            close = bool(torch.allclose(xk, xp, atol=tol[0], rtol=tol[1]))
            ok = ok and close and bool(torch.isfinite(xk).all())
            name = "fused_rk4" if dtype == "float32" else "fused_rk4.bf16"
            results[name] = {"max_abs_err": err, "tolerance": f"atol={tol[0]:.3g}, rtol={tol[1]}",
                             "args": (x0, w, s.sde)}
            line["rk4"][dtype] = {"max_abs_err": err, "max_abs": scale_, "within": close}
        line["ok"] = ok
        line["tolerance"] = {k: v["tolerance"] for k, v in results.items()}
        emit(line)
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version")

    kernels()

    # ---------------------------------------------------------------- requests
    per_request = []

    def new_request(dtype):
        pts = object_clouds(gen, dev)
        prior = agents[dtype][0].sde.prior_sample((B * K, 9), T=T0, generator=gen).to(dev)
        return {"pts": pts, "pts_center": pts.mean(1)}, prior

    def serve(dtype, batch, prior):
        """One request through the agents, as a user calls them."""
        s, e, sc = agents[dtype]
        feats = s.extract_features(batch)
        poses = s.sample_candidates(batch, repeat_num=K, T0=T0, num_steps=STEPS,
                                    features=feats, prior=prior)
        en = e.get_energy(batch, poses, fixed_t=1e-5)
        ev = s.cfg.eval
        agg = aggregate_candidates(poses, en, retain_ratio=ev.retain_ratio,
                                   clustering=ev.clustering, eps=ev.clustering_eps,
                                   minpts_ratio=ev.clustering_minpts_ratio)
        lengths = sc.predict(feats[0], agg["rotation"])
        return feats, poses, en, agg, lengths

    @phase("request")
    def requests():
        expected = {"fps": 2, "ball_count": 2, "fused_sa_stage": 8, "fused_rk4": 1}
        ok = True
        for r, dtype in enumerate(("float32", "float32", "float32", "bfloat16")):
            s = agents[dtype][0]
            batch, prior = new_request(dtype)
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            feats, poses, en, agg, lengths = serve(dtype, batch, prior)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: _cuda.launch_counts[k] for k in expected}

            R = agg["rotation"]
            eye = torch.eye(3, device=dev).expand_as(R)
            orth = float((R.transpose(1, 2) @ R - eye).abs().max())
            det = float((torch.linalg.det(R) - 1).abs().max())
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (feats[0], poses, en, R, agg["translation"], lengths))
            shapes = [tuple(feats[0].shape), tuple(poses.shape), tuple(en.shape),
                      tuple(lengths.shape)]
            f_plain, _ = s.extract_features(batch, plain=True)
            p_plain = plain_samplers[dtype].sample_candidates(
                batch, repeat_num=K, T0=T0, num_steps=STEPS, features=(feats[0], None),
                prior=prior)
            f_err = max_err(feats[0], f_plain) / max(float(f_plain.abs().max()), 1e-30)
            p_err = max_err(poses, p_plain)
            # feature: max error over max |plain|, as in the kernels phase;
            # candidates: the JAX package's bound for its fused kernel against
            # its scan after denoise and renormalisation (f32), and the bf16
            # bound of the kernels phase carried through those steps (bf16)
            f_tol, p_tol = (1e-4, 5e-4) if dtype == "float32" else (2e-2, 2e-2)
            good = (counts == expected and finite and orth < 1e-4 and det < 1e-4
                    and shapes == [(B, 1024), (B, K, 9), (B, K, 2), (B, 3)]
                    and f_err <= f_tol and p_err <= p_tol)
            ok = ok and good
            per_request.append({"dtype": dtype, "counts": counts, "ms": ms})
            emit({"phase": "request", "index": r, "dtype": dtype, "ok": good, "request_ms": ms,
                  "launches": counts, "finite": finite, "orthonormality_err": orth,
                  "det_err": det, "shapes": shapes, "feature_err_over_max": f_err,
                  "feature_tol": f_tol, "candidates_max_abs_err": p_err,
                  "candidates_tol": p_tol})
        if not ok:
            raise AssertionError("a request failed its checks")

    requests()

    # ------------------------------------------------------------------ timing
    table = []

    @phase("timing")
    def timing():
        launches = {}
        for req in per_request:
            for k, v in req["counts"].items():
                key = k if req["dtype"] == "float32" or k in ("fps", "ball_count") else f"{k}.bf16"
                launches[key] = launches.get(key, 0) + v

        def entry(name, source, replaces, ms, plain_ms, nbytes, ops, dtype):
            b, by = bound_ms(nbytes, ops, dtype)
            r = results.get(name, {})
            table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                          "launches": launches.get(name, 0), "max_abs_err": r.get("max_abs_err"),
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                          "library_ms": None})

        ms = cuda_ms(lambda: furthest_point_sample(pts0, 512), 20)
        pms = cuda_ms(lambda: fps_plain(pts0, 512), 3)
        entry("fps", "genpose2_tpu_torch/ops/csrc/fps.cu", "genpose2_tpu/ops/fps.py:114",
              ms, pms, B * N * 12 + B * 512 * 4, 511 * B * N * 10, "float32")
        S = gather_points(pts0, fps_plain(pts0, 512))
        ms = cuda_ms(lambda: ball_count(pts0, S, 0.02), 50)
        pms = cuda_ms(lambda: ball_count_plain(pts0, S, 0.02), 10)
        entry("ball_count", "genpose2_tpu_torch/ops/csrc/ball_count.cu",
              "genpose2_tpu/ops/ball_query_pallas.py:178", ms, pms,
              B * (N + 512) * 12 + B * 512 * 4, 9 * B * 512 * N, "float32")
        per_stage = {}
        for dtype, name in (("float32", "fused_sa_stage"), ("bfloat16", "fused_sa_stage.bf16")):
            stages = results[name]["stages"]
            ks, ps, nb, ops = [], [], 0, 0
            for st in stages:
                xyz, nxs, args, radii, nsamples, _ = st
                ks.append(cuda_ms(lambda: fused_sa_stage(xyz, nxs, *args, radii, nsamples), 10))
                ps.append(cuda_ms(lambda: fused_sa_stage_plain(xyz, nxs, *args, radii,
                                                               nsamples), 3))
                b_, o_ = sa_cost(st, dtype)
                nb, ops = nb + b_, ops + o_
            per_stage[dtype] = {"kernel_ms": ks, "plain_ms": ps}
            entry(name, "genpose2_tpu_torch/ops/csrc/fused_sa.cu",
                  "genpose2_tpu/ops/fused_sa.py:629", sum(ks), sum(ps), nb, ops, dtype)
        for dtype, name in (("float32", "fused_rk4"), ("bfloat16", "fused_rk4.bf16")):
            x0, w, sde = results[name]["args"]
            R, D = x0.shape
            H1 = w["static"].shape[1]
            P1 = w["pose_mlp"]["Dense_0"]["kernel"].shape[1]
            P2 = w["pose_mlp"]["Dense_1"]["kernel"].shape[1]
            macs = D * P1 + P1 * P2 + P2 * H1 + H1 * D
            esize = 2 if dtype == "bfloat16" else 4
            nbytes = R * D * 8 + R * H1 * 4 + macs * esize + STEPS * (3 * H1 + 7) * 4
            ops = STEPS * 4 * R * 2 * macs
            ms = cuda_ms(lambda: fused_rk4_integrate(x0, w, sde, T0, STEPS, dtype), 5)
            pms = cuda_ms(lambda: fused_rk4_plain(x0, w, sde, T0, STEPS, dtype), 2)
            entry(name, "genpose2_tpu_torch/ops/csrc/ode_rk4.cu",
                  "genpose2_tpu/ops/ode_rk4.py:233", ms, pms, nbytes, ops, dtype)
        emit({"phase": "timing", "ok": True, "sa_per_stage_ms": per_stage,
              "request_ms": [r["ms"] for r in per_request],
              "note": "ms of fused_sa_stage entries: the four stage launches of one encoder "
                      "forward; launches: summed over the four requests"})

    timing()

    @phase("profile")
    def profile():
        """Device time by kernel name over one float32 request, and the
        device's busy share against the unprofiled warm request time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        batch, prior = new_request("float32")
        serve("float32", batch, prior)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve("float32", batch, prior)
            torch.cuda.synchronize()
        rows = [(ev.device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        warm = [r["ms"] for r in per_request[1:] if r["dtype"] == "float32"]
        emit({"phase": "profile", "ok": True, "device_ms": busy,
              "warm_request_ms": sum(warm) / max(len(warm), 1),
              "busy_share": busy / (sum(warm) / max(len(warm), 1)) if warm else None,
              "top": [{"ms": t, "calls": c, "name": k[:120]} for t, c, k in rows[:20]]})

    profile()

    emit({"kernels": table})
    print(smi_line, flush=True)
    if FAILED:
        print(f"chip_smoke: failed phases: {FAILED}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
