#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one card and hold every
kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:
  device    nvidia-smi's name and power limit, torch's device name;
  build     nvcc of the seven kernel sources, all started together;
  reference tiny_test_config (dino='none') and tiny_flagship_config
            (dino='pointwise') agents on the card against the plain versions
            on the CPU (the plain versions are held against the JAX package by
            tests/test_torch_port_*.py); each stage gets the CPU's input;
  kernels   each kernel against its plain version on the card, at the shapes
            of the main paths, in float32 and in bf16 (discrete outputs exact);
  request   requests through PoseAgent / ScaleAgent at full width (B=64
            objects, 1024 points, K=50 candidates, 50 RK4 steps from T0=0.55,
            energies at t=1e-5, retain 0.4 with clustering): dino='none' once
            in float32 and once in bf16; the flagship dino='pointwise' path
            (DINOv3 ViT-S+/16 on 256-px crops, ImgEncoder, Fus PointNet++)
            twice in bench.py's all-bf16 settings and once in float32. The ViT
            runs once per request and the energy agent reuses its layers.
            Launch counts are reset just before and read just after each
            request; the score feature and the candidates are recomputed with
            the plain versions on the card;
  timing    CUDA-event times of each kernel, its plain version and, where one
            PyTorch call computes the same function, that call, at the main
            paths' shapes, with the bound from this run's shapes and data;
  profile   torch.profiler device time by kernel name over one bf16 flagship
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
B, N, K, STEPS, T0, S = 64, 1024, 50, 50, 0.55, 256
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


def bound_ms(nbytes, ops):
    """ops: {dtype: operations}; the operations' time is the sum over types."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS[dt] for dt, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


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

    import torch.nn.functional as F

    from genpose2_tpu_torch.config import (ModelConfig, PointNet2Config, default_config,
                                           tiny_flagship_config, tiny_test_config)
    from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
    from genpose2_tpu_torch.models.attention import EfficientRelativePositionalEncoding
    from genpose2_tpu_torch.models.fast_encoder import stage_arguments
    from genpose2_tpu_torch.models.scorenet import fast_score_weights
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain
    from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
    from genpose2_tpu_torch.ops.grouping import gather_points
    from genpose2_tpu_torch.ops.layernorm import (LN_EPS, fast_add_layernorm,
                                                  fast_add_layernorm_plain,
                                                  fast_residual_layernorm,
                                                  fast_residual_layernorm_plain)
    from genpose2_tpu_torch.ops.ode_rk4 import (compute_dtype_of, fused_rk4_integrate,
                                                fused_rk4_plain)
    from genpose2_tpu_torch.ops.relpe_attention import relpe_attention, relpe_attention_plain
    from genpose2_tpu_torch.ops.vit_attention import vit_attention_tm, vit_attention_tm_plain
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

    def none_config(dtype):
        cfg = default_config()
        model = dataclasses.replace(
            cfg.model, dino="none", backbone="none", score_dtype=dtype,
            pointnet2=dataclasses.replace(cfg.model.pointnet2, compute_dtype=dtype))
        return cfg.replace(model=model)

    def flagship_config(dtype):
        """bench.py's flagship config (bf16), or the same in float32."""
        return default_config().replace(model=ModelConfig(
            dino="pointwise", pointnet2=PointNet2Config(compute_dtype=dtype),
            backbone_dtype=dtype, score_dtype=dtype))

    gen = torch.Generator().manual_seed(SEED)

    def make_agents(config):
        """{dtype: (score, energy, scale, plain sampler)}, one set of random
        weights shared by the dtypes."""
        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = config(dtype)
            s, e = PoseAgent(cfg, "score", device=dev), PoseAgent(cfg, "energy", device=dev)
            plain_cfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, fused_fixed=False))
            ps = PoseAgent(plain_cfg, "score", device=dev)
            if not out:
                for agent in (s, e):
                    randomize(agent.model, gen)
                    if agent.provider is not None:
                        randomize(agent.provider.vit, gen)
                sc = ScaleAgent(cfg, device=dev)
                randomize(sc.model, gen)
            else:
                s0, e0, sc, _ = out["float32"]
                s.model.load_state_dict(s0.model.state_dict())
                e.model.load_state_dict(e0.model.state_dict())
                if s.provider is not None:
                    s.provider.vit.load_state_dict(s0.provider.vit.state_dict())
            ps.model.load_state_dict(s.model.state_dict())
            if ps.provider is not None:
                ps.provider.vit.load_state_dict(s.provider.vit.state_dict())
            out[dtype] = (s, e, sc, ps)
        return out

    paths = {"none": make_agents(none_config), "pointwise": make_agents(flagship_config)}

    @phase("reference")
    def reference():
        line = {"phase": "reference"}
        for name, tiny in (("tiny_test_config", tiny_test_config()),
                           ("tiny_flagship_config", tiny_flagship_config())):
            cpu = PoseAgent(tiny, "score", device="cpu")
            randomize(cpu.model, gen)
            card = PoseAgent(tiny, "score", device=dev)
            card.model.load_state_dict(cpu.model.state_dict())
            m = tiny.model
            pts = torch.rand(4, m.num_points, 3, generator=gen) * 0.3
            prior = torch.randn(4 * 8, 9, generator=gen) * 0.5
            batch = {"pts": pts, "pts_center": pts.mean(1)}
            errs, tol = {}, {}
            if m.dino == "pointwise":
                randomize(cpu.provider.vit, gen)
                card.provider.vit.load_state_dict(cpu.provider.vit.state_dict())
                batch["roi_rgb"] = torch.randn(4, m.img_size, m.img_size, 3, generator=gen)
                batch["roi_xs"] = torch.randint(0, m.img_size, (4, m.num_points), generator=gen)
                batch["roi_ys"] = torch.randint(0, m.img_size, (4, m.num_points), generator=gen)
                l_cpu = cpu.with_image_features(batch)["dino_layers"]
                l_card = card.with_image_features({k: v.to(dev) for k, v in batch.items()})
                errs["dino_layers"] = max(max_err(a.cpu(), b) for a, b in
                                          zip(l_card["dino_layers"], l_cpu))
                tol["dino_layers"] = 1e-4  # float32 summation order through 2 blocks
                batch["dino_layers"] = l_cpu
            on_card = {k: (v.to(dev) if torch.is_tensor(v) else [t.to(dev) for t in v])
                       for k, v in batch.items()}
            f_cpu, _ = cpu.extract_features(batch)
            f_card, _ = card.extract_features(on_card)
            p_cpu = cpu.sample_candidates(batch, repeat_num=8, T0=T0, num_steps=10,
                                          features=(f_cpu, None), prior=prior)
            p_card = card.sample_candidates(on_card, repeat_num=8, T0=T0, num_steps=10,
                                            features=(f_cpu.to(dev), None), prior=prior)
            errs["feature"] = max_err(f_card.cpu(), f_cpu)
            errs["candidates"] = max_err(p_card.cpu(), p_cpu)
            # the JAX package's float32 bounds: encoder (tests/test_models.py:446),
            # fused RK4 against the scan (tests/test_ode_fused.py:112)
            tol["feature"], tol["candidates"] = 2e-4, 5e-4
            line[name] = {"max_abs_err": errs, "tolerance": tol}
            emit(dict(line, config=name))
            for k in errs:
                assert errs[k] <= tol[k], f"{name} {k}: {errs[k]} > {tol[k]}"

    reference()

    # ------------------------------------------------- kernels vs plain versions
    pts0 = object_clouds(gen, dev)
    results = {}  # kernel entry name -> numbers for the kernels line

    def sa_stage_inputs(encoder, pts, pcfg):
        """Each grouped stage's kernel arguments as the dino='none' path forms
        them (density order at N >= 1024), the stages chained through the
        plain versions; plus each scale's real rows (min(count, nsample), or 1)."""
        dt = compute_dtype_of(pcfg.compute_dtype)
        S_ = gather_points(pts, fps_plain(pts, pcfg.npoints[0]))
        xyz, feats, stages = pts, None, []
        for sa in encoder.SA_modules:
            if sa.npoint is None:
                break
            nxs = S_[:, :sa.npoint].contiguous()
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
            xyz = S_[:, :sa.npoint]
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

    # the Fus encoder's grouped stages: (M, C) of the rel-PE block after each
    fus_cfg = flagship_config("float32").model.pointnet2
    fus_stages = [(m, sum(w[-1] for w in mlps))
                  for m, mlps in zip(fus_cfg.npoints, fus_cfg.mlps) if m is not None]
    H_PE = fus_cfg.num_heads
    S0 = gather_points(pts0, fps_plain(pts0, fus_cfg.npoints[0]))
    pe_mod = EfficientRelativePositionalEncoding(H_PE).to(dev)
    randomize(pe_mod, gen)
    vit_cfg = flagship_config("float32").model
    vit_heads, vit_dim = 6, vit_cfg.dino_dim
    n_valid = 5 + (S // vit_cfg.patch_size) ** 2  # cls + 4 storage + 256 patches

    def relpe_inputs(M, C):
        def r(*shape):
            return torch.randn(*shape, generator=gen).to(dev)
        return S0[:, :M].contiguous(), r(B, M, C), r(B, M, C), r(B, M, C)

    relpe_in = [relpe_inputs(M, C) for M, C in fus_stages]
    ln_in = [tuple(torch.randn(B, M, C, generator=gen).to(dev) for _ in range(2))
             + tuple(torch.randn(C, generator=gen).to(dev) for _ in range(2))
             for M, C in fus_stages]
    vit_in = {dtype: tuple(torch.randn(B, n_valid + (-n_valid) % sub, vit_dim,
                                       generator=gen).to(dev, compute_dtype_of(dtype))
                           for _ in range(3))
              for dtype, sub in (("float32", 8), ("bfloat16", 16))}
    add_in = tuple(torch.randn(B, vit_in["bfloat16"][0].shape[1], vit_dim, generator=gen)
                   .to(dev, torch.bfloat16) for _ in range(2)) \
        + tuple(torch.randn(vit_dim, generator=gen).to(dev) for _ in range(3))

    @phase("kernels")
    def kernels():
        # FPS and ball count (float32 only)
        idx_k = furthest_point_sample(pts0, 512)
        idx_p = fps_plain(pts0, 512)
        fps_mismatch = int((idx_k != idx_p).sum())
        cnt_k = ball_count(pts0, S0, 0.02)
        cnt_p = ball_count_plain(pts0, S0, 0.02)
        bc_mismatch = int((cnt_k != cnt_p).sum())
        results["fps"] = {"max_abs_err": float(fps_mismatch), "tolerance": "exact"}
        results["ball_count"] = {"max_abs_err": float(bc_mismatch), "tolerance": "exact"}
        line = {"phase": "kernels", "fps_index_mismatches": fps_mismatch,
                "ball_count_mismatches": bc_mismatch, "sa": {}, "rk4": {}, "relpe": {},
                "residual_ln": {}, "vit": {}}
        ok = fps_mismatch == 0 and bc_mismatch == 0
        for dtype, (s, _, _, _) in paths["none"].items():
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
                                 "real_rows": [st[5] for st in stages]}
            # RK4 at the main path's shape: 3200 rows, 50 steps
            feat, _ = s.extract_features({"pts": pts0}, plain=True)
            w = fast_score_weights(s.model.pose_score_net, feat.repeat_interleave(K, 0))
            x0 = s.sde.prior_sample((B * K, 9), T=T0, generator=gen).to(dev)
            xk = fused_rk4_integrate(x0, w, s.sde, T0, STEPS, dtype)
            xp = fused_rk4_plain(x0, w, s.sde, T0, STEPS, dtype)
            err = max_err(xk, xp)
            # f32: the JAX package's bound for the fused kernel against the
            # scan; bf16: the kernel keeps the t rows in f32 where the scan
            # rounds them into its bf16 product, so it is looser
            tol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
            close = bool(torch.allclose(xk, xp, atol=tol[0], rtol=tol[1]))
            ok = ok and close and bool(torch.isfinite(xk).all())
            name = "fused_rk4" if dtype == "float32" else "fused_rk4.bf16"
            results[name] = {"max_abs_err": err, "tolerance": f"atol={tol[0]:.3g}, rtol={tol[1]}",
                             "args": (x0, w, s.sde)}
            line["rk4"][dtype] = {"max_abs_err": err, "within": close}

        # rel-PE attention at the Fus encoder's four stage shapes; the JAX
        # package's bounds for its kernel (tests/test_ops.py:395, 405)
        for dtype, (rtol, atol) in (("float32", (2e-4, 2e-5)), ("bfloat16", (2e-2, 2e-2))):
            errs, within = [], True
            for xyz, q, k, v in relpe_in:
                got = relpe_attention(xyz, q, k, v, pe_mod, H_PE, dtype)
                want = relpe_attention_plain(xyz, q, k, v, pe_mod, H_PE, dtype)
                errs.append(max_err(got, want))
                within = within and bool(torch.allclose(got, want, rtol=rtol, atol=atol))
            ok = ok and within
            name = "relpe_attention" if dtype == "float32" else "relpe_attention.bf16"
            results[name] = {"max_abs_err": max(errs), "tolerance": f"rtol={rtol}, atol={atol}"}
            line["relpe"][dtype] = {"max_abs_err": errs, "within": within}
        # residual LayerNorm at the four stage shapes (float32 on the path;
        # bf16 too): the JAX LayerNorm bound 1e-5, bf16 outputs 2e-2
        for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            errs, within = [], True
            for x, h, sc, bi in ln_in:
                xd, hd = x.to(compute_dtype_of(dtype)), h.to(compute_dtype_of(dtype))
                got = fast_residual_layernorm(xd, hd, sc, bi)
                want = fast_residual_layernorm_plain(xd, hd, sc, bi)
                errs.append(max_err(got, want))
                within = within and bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                                        atol=tol))
            ok = ok and within
            name = "residual_layernorm" if dtype == "float32" else "residual_layernorm.bf16"
            results[name] = {"max_abs_err": max(errs), "tolerance": f"rtol=atol={tol}"}
            line["residual_ln"][dtype] = {"max_abs_err": errs, "within": within}
        # add + LayerNorm on the ViT's bf16 stream (64, 272, 384)
        x2k, lnk = fast_add_layernorm(*add_in)
        x2p, lnp = fast_add_layernorm_plain(*add_in)
        err = max(max_err(x2k, x2p), max_err(lnk, lnp))
        within = bool(torch.allclose(x2k.float(), x2p.float(), rtol=2e-2, atol=2e-2)
                      and torch.allclose(lnk.float(), lnp.float(), rtol=2e-2, atol=2e-2))
        ok = ok and within
        results["add_layernorm"] = {"max_abs_err": err, "tolerance": "rtol=atol=2e-2 (bf16 out)"}
        line["add_ln"] = {"max_abs_err": err, "within": within}
        # ViT attention, (64, 264, 384) float32 and (64, 272, 384) bf16, on the
        # n_valid real rows: the JAX bounds (tests/test_ops.py:546, 566)
        for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            q, k, v = vit_in[dtype]
            got = vit_attention_tm(q, k, v, vit_heads, n_valid)
            want = vit_attention_tm_plain(q, k, v, vit_heads, n_valid)
            err = max_err(got[:, :n_valid], want[:, :n_valid])
            within = bool(torch.allclose(got[:, :n_valid], want[:, :n_valid], rtol=tol, atol=tol)
                          and torch.isfinite(got).all())
            ok = ok and within
            name = "vit_attention" if dtype == "float32" else "vit_attention.bf16"
            results[name] = {"max_abs_err": err, "tolerance": f"rtol=atol={tol}"}
            line["vit"][dtype] = {"max_abs_err": err, "within": within}
        line["ok"] = ok
        line["tolerance"] = {k: v["tolerance"] for k, v in results.items()}
        emit(line)
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version")

    kernels()

    # ---------------------------------------------------------------- requests
    per_request = []

    def new_request(path, dtype):
        pts = object_clouds(gen, dev)
        prior = paths[path][dtype][0].sde.prior_sample((B * K, 9), T=T0, generator=gen).to(dev)
        batch = {"pts": pts, "pts_center": pts.mean(1)}
        if path == "pointwise":
            batch["roi_rgb"] = torch.randn(B, S, S, 3, generator=gen).to(dev)
            batch["roi_xs"] = torch.randint(0, S, (B, N), generator=gen).to(dev)
            batch["roi_ys"] = torch.randint(0, S, (B, N), generator=gen).to(dev)
        return batch, prior

    def serve(path, dtype, raw, prior):
        """One request through the agents, as a user calls them: the backbone
        once (score agent), its layers shared with the energy agent."""
        s, e, sc, _ = paths[path][dtype]
        batch = s.with_image_features(raw)
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

    def expected_counts(path, dtype):
        want = dict.fromkeys(_cuda.KERNELS, 0)
        want.update(fps=2, ball_count=2, fused_sa_stage=8, fused_rk4=1)
        if path == "pointwise":
            want.update(relpe_attention=8, residual_layernorm=16, vit_attention=12,
                        add_layernorm=12 if dtype == "bfloat16" else 0)
        return want

    @phase("request")
    def requests():
        ok = True
        order = [("none", "float32"), ("none", "bfloat16"), ("pointwise", "bfloat16"),
                 ("pointwise", "bfloat16"), ("pointwise", "float32")]
        for r, (path, dtype) in enumerate(order):
            s, _, _, ps = paths[path][dtype]
            raw, prior = new_request(path, dtype)
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            feats, poses, en, agg, lengths = serve(path, dtype, raw, prior)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {k: _cuda.launch_counts[k] for k in _cuda.KERNELS}

            R = agg["rotation"]
            eye = torch.eye(3, device=dev).expand_as(R)
            orth = float((R.transpose(1, 2) @ R - eye).abs().max())
            det = float((torch.linalg.det(R) - 1).abs().max())
            finite = all(bool(torch.isfinite(t).all()) for t in
                         (feats[0], poses, en, R, agg["translation"], lengths))
            shapes = [tuple(feats[0].shape), tuple(poses.shape), tuple(en.shape),
                      tuple(lengths.shape)]
            f_plain, _ = s.extract_features(s.with_image_features(raw, plain=True), plain=True)
            p_plain = ps.sample_candidates(raw, repeat_num=K, T0=T0, num_steps=STEPS,
                                           features=(feats[0], None), prior=prior)
            f_err = rel_err(feats[0], f_plain)
            p_err = max_err(poses, p_plain)
            # feature: max error over max |plain| (f32: summation order through
            # the ViT and the encoders; bf16: flips of bf16 roundings carried
            # through 12 ViT blocks and 5 encoder stages); candidates: the JAX
            # package's bound for its fused kernel against its scan after
            # denoise and renormalisation (f32), the kernels phase's bf16
            # bound carried through those steps (bf16)
            if dtype == "float32":
                f_tol, p_tol = (1e-4 if path == "none" else 2e-4), 5e-4
            else:
                f_tol, p_tol = (2e-2 if path == "none" else 5e-2), 2e-2
            want_counts = expected_counts(path, dtype)
            good = (counts == want_counts and finite and orth < 1e-4 and det < 1e-4
                    and shapes == [(B, 1024), (B, K, 9), (B, K, 2), (B, 3)]
                    and f_err <= f_tol and p_err <= p_tol)
            ok = ok and good
            per_request.append({"path": path, "dtype": dtype, "counts": counts, "ms": ms})
            emit({"phase": "request", "index": r, "path": path, "dtype": dtype, "ok": good,
                  "request_ms": ms, "launches": counts, "expected": want_counts,
                  "finite": finite, "orthonormality_err": orth, "det_err": det,
                  "shapes": shapes, "feature_err_over_max": f_err, "feature_tol": f_tol,
                  "candidates_max_abs_err": p_err, "candidates_tol": p_tol})
        if not ok:
            raise AssertionError("a request failed its checks")

    requests()

    # ------------------------------------------------------------------ timing
    table = []

    @phase("timing")
    def timing():
        dtyped = ("fused_sa_stage", "fused_rk4", "relpe_attention", "vit_attention")
        launches = {}
        for req in per_request:
            for k, v in req["counts"].items():
                key = f"{k}.bf16" if req["dtype"] == "bfloat16" and k in dtyped else k
                launches[key] = launches.get(key, 0) + v

        def entry(name, source, replaces, ms, plain_ms, nbytes, ops, library_ms=None):
            b, by = bound_ms(nbytes, ops)
            r = results.get(name, {})
            table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                          "launches": launches.get(name, 0), "max_abs_err": r.get("max_abs_err"),
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                          "library_ms": library_ms})

        csrc = "genpose2_tpu_torch/ops/csrc/"
        ms = cuda_ms(lambda: furthest_point_sample(pts0, 512), 20)
        pms = cuda_ms(lambda: fps_plain(pts0, 512), 2)
        entry("fps", csrc + "fps.cu", "genpose2_tpu/ops/fps.py:114",
              ms, pms, B * N * 12 + B * 512 * 4, {"float32": 511 * B * N * 10})
        ms = cuda_ms(lambda: ball_count(pts0, S0, 0.02), 50)
        pms = cuda_ms(lambda: ball_count_plain(pts0, S0, 0.02), 10)
        entry("ball_count", csrc + "ball_count.cu",
              "genpose2_tpu/ops/ball_query_pallas.py:178", ms, pms,
              B * (N + 512) * 12 + B * 512 * 4, {"float32": 9 * B * 512 * N})
        per_stage = {}
        for dtype, name in (("float32", "fused_sa_stage"), ("bfloat16", "fused_sa_stage.bf16")):
            stages = results[name]["stages"]
            ks, ps, nb, ops = [], [], 0, 0
            for st in stages:
                xyz, nxs, args, radii, nsamples, _ = st
                ks.append(cuda_ms(lambda: fused_sa_stage(xyz, nxs, *args, radii, nsamples), 10))
                ps.append(cuda_ms(lambda: fused_sa_stage_plain(xyz, nxs, *args, radii,
                                                               nsamples), 2))
                b_, o_ = sa_cost(st, dtype)
                nb, ops = nb + b_, ops + o_
            per_stage[name] = {"kernel_ms": ks, "plain_ms": ps}
            entry(name, csrc + "fused_sa.cu", "genpose2_tpu/ops/fused_sa.py:629",
                  sum(ks), sum(ps), nb, {dtype: ops})
        for dtype, name in (("float32", "fused_rk4"), ("bfloat16", "fused_rk4.bf16")):
            x0, w, sde = results[name]["args"]
            R, D = x0.shape
            H1 = w["static"].shape[1]
            P1 = w["pose_mlp"]["Dense_0"]["kernel"].shape[1]
            P2 = w["pose_mlp"]["Dense_1"]["kernel"].shape[1]
            macs = D * P1 + P1 * P2 + P2 * H1 + H1 * D
            esize = 2 if dtype == "bfloat16" else 4
            nbytes = R * D * 8 + R * H1 * 4 + macs * esize + STEPS * (3 * H1 + 7) * 4
            ms = cuda_ms(lambda: fused_rk4_integrate(x0, w, sde, T0, STEPS, dtype), 5)
            pms = cuda_ms(lambda: fused_rk4_plain(x0, w, sde, T0, STEPS, dtype), 1)
            entry(name, csrc + "ode_rk4.cu", "genpose2_tpu/ops/ode_rk4.py:233", ms, pms,
                  nbytes, {dtype: STEPS * 4 * R * 2 * macs})

        # rel-PE: the four stage launches of one encoder forward. Bias per
        # (query, key) pair: ~14 operations for dist and the unit vector, 10 per
        # hidden channel (16), 4 per channel and head; softmax ~5 per score;
        # the two products 2 * 2 * D per score (in the compute dtype)
        for dtype in ("float32", "bfloat16"):
            name = "relpe_attention" if dtype == "float32" else "relpe_attention.bf16"
            esize = 2 if dtype == "bfloat16" else 4
            cdt = compute_dtype_of(dtype)
            ks, ps, nb, f32_ops, mm_ops = [], [], 0, 0, 0
            for (M, C), (xyz, q, k, v) in zip(fus_stages, relpe_in):
                qd, kd, vd = q.to(cdt), k.to(cdt), v.to(cdt)
                ks.append(cuda_ms(lambda: relpe_attention(xyz, qd, kd, vd, pe_mod, H_PE, dtype),
                                  10))
                ps.append(cuda_ms(lambda: relpe_attention_plain(xyz, qd, kd, vd, pe_mod, H_PE,
                                                                dtype), 2))
                pairs = B * M * M
                nb += B * M * 12 + 3 * B * M * C * esize + B * M * C * 4
                f32_ops += pairs * (14 + 16 * 10 + 16 * H_PE * 4) + 5 * pairs * H_PE
                mm_ops += 4 * pairs * C  # H heads x 2 products x 2 D
            per_stage[name] = {"kernel_ms": ks, "plain_ms": ps}
            entry(name, csrc + "relpe_attention.cu", "genpose2_tpu/ops/relpe_attention.py:216",
                  sum(ks), sum(ps), nb, {"float32": f32_ops, dtype: mm_ops} if dtype != "float32"
                  else {"float32": f32_ops + mm_ops})

        # residual LN: the eight launches of one encoder forward (two per stage);
        # library: F.layer_norm of the precomputed sum x + h (float32)
        ks, ps, ls, nb, ops = [], [], [], 0, 0
        for x, h, sc, bi in ln_in:
            s_ = x + h
            ks.append(2 * cuda_ms(lambda: fast_residual_layernorm(x, h, sc, bi), 20))
            ps.append(2 * cuda_ms(lambda: fast_residual_layernorm_plain(x, h, sc, bi), 5))
            ls.append(2 * cuda_ms(lambda: F.layer_norm(s_, s_.shape[-1:], sc, bi, LN_EPS), 20))
            nb += 2 * (3 * x.numel() * 4 + 2 * sc.numel() * 4)
            ops += 2 * 9 * x.numel()
        per_stage["residual_layernorm"] = {"kernel_ms": ks, "plain_ms": ps, "library_ms": ls}
        entry("residual_layernorm", csrc + "layernorm.cu", "genpose2_tpu/ops/layernorm.py:126",
              sum(ks), sum(ps), nb, {"float32": ops}, sum(ls))

        # add + LN: one launch on (64, 272, 384) bf16; library: F.layer_norm of
        # the precomputed bf16 sum
        x, h, g, sc, bi = add_in
        s_ = (x.float() + h.float() * g).to(torch.bfloat16)
        ms = cuda_ms(lambda: fast_add_layernorm(*add_in), 50)
        pms = cuda_ms(lambda: fast_add_layernorm_plain(*add_in), 10)
        lms = cuda_ms(lambda: F.layer_norm(s_, s_.shape[-1:], sc.to(torch.bfloat16),
                                           bi.to(torch.bfloat16), LN_EPS), 50)
        entry("add_layernorm", csrc + "layernorm.cu", "genpose2_tpu/ops/layernorm.py:79",
              ms, pms, 4 * x.numel() * 2 + 3 * g.numel() * 4, {"float32": 11 * x.numel()}, lms)

        # ViT attention: one launch; library: scaled_dot_product_attention over
        # the n_valid real tokens, head-major
        for dtype in ("float32", "bfloat16"):
            name = "vit_attention" if dtype == "float32" else "vit_attention.bf16"
            q, k, v = vit_in[dtype]
            Np = q.shape[1]
            esize = q.element_size()
            hd = vit_dim // vit_heads

            def heads(t):
                return t[:, :n_valid].reshape(B, n_valid, vit_heads, hd).transpose(1, 2) \
                    .contiguous()

            qh, kh, vh = heads(q), heads(k), heads(v)
            ms = cuda_ms(lambda: vit_attention_tm(q, k, v, vit_heads, n_valid), 20)
            pms = cuda_ms(lambda: vit_attention_tm_plain(q, k, v, vit_heads, n_valid), 5)
            lms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)
            scores = B * vit_heads * Np * Np
            entry(name, csrc + "vit_attention.cu", "genpose2_tpu/ops/vit_attention.py:203",
                  ms, pms, 3 * B * Np * vit_dim * esize + B * Np * vit_dim * 4,
                  {dtype: 4 * scores * hd, "float32": 5 * scores} if dtype != "float32"
                  else {"float32": 4 * scores * hd + 5 * scores}, lms)
        emit({"phase": "timing", "ok": True, "per_stage_ms": per_stage,
              "request_ms": [{"path": r["path"], "dtype": r["dtype"], "ms": r["ms"]}
                             for r in per_request],
              "note": "ms of fused_sa_stage and relpe_attention entries: the four stage launches "
                      "of one encoder forward; residual_layernorm: its eight launches; "
                      "launches: summed over the requests"})

    timing()

    @phase("profile")
    def profile():
        """Device time by kernel name over one bf16 flagship request, and the
        device's busy share against the unprofiled warm request time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        raw, prior = new_request("pointwise", "bfloat16")
        t0 = time.perf_counter()
        serve("pointwise", "bfloat16", raw, prior)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve("pointwise", "bfloat16", raw, prior)
            torch.cuda.synchronize()
        rows = [(ev.device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        emit({"phase": "profile", "ok": True, "request": "pointwise bfloat16",
              "device_ms": busy, "warm_request_ms": warm_ms, "busy_share": busy / warm_ms,
              "top": [{"ms": t, "calls": c, "name": k[:120]} for t, c, k in rows[:25]]})

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
