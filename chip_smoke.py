#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one card and
hold every kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Every weight and input is drawn from seed 0. ``--reference-seeds N`` builds
the kernels and runs only the reference phase's checks, with seeds 0..N-1.

Phases, one JSON line each:
  device    nvidia-smi's name and power limit, torch's device name;
  build     nvcc of the eight kernel sources, all started together;
  reference tiny_test_config (dino='none') and tiny_flagship_config
            (dino='pointwise') agents on the card against the plain versions
            on the CPU (the plain versions are held against the JAX package by
            tests/test_torch_port_*.py); each stage gets the CPU's input; and
            one score train step of each (loss, gradients, parameters); then
            the serving stages of tiny_flagship_config with dino='global' and
            of tiny_flagship_config with a bf16 backbone and both ViT
            switches on; its weights and inputs from generators of its own;
  kernels   each kernel against its plain version on the card, at the shapes
            of the main paths, in float32 and in bf16 (discrete outputs exact);
            ball query and FPS also at each grouped stage of the training
            path's module forward, and ball query's edge cases; the per-scale
            SA kernel and the SA kernel from indices at the dense
            configuration's stage 0 (B=64, N=2048, M=512, both scales) and
            at their edge cases; the ViT's switch kernels: LayerNorm at
            (64 x 272, 384), the unpadded attention at (64, 261, 384) and the
            in-kernel RoPE attention at the padded flagship shape with the
            flagship's tables;
  request   requests through PoseAgent / ScaleAgent at full width (B=64
            objects, 1024 points, K=50 candidates, 50 RK4 steps from T0=0.55,
            energies at t=1e-5, retain 0.4 with clustering): dino='none' once
            in float32 and once in bf16; the flagship dino='pointwise' path
            (DINOv3 ViT-S+/16 on 256-px crops, ImgEncoder, Fus PointNet++)
            twice in bench.py's all-bf16 settings and once in float32; the
            dense configuration (the flagship at 2,048 points, whose stage 0
            runs one SA kernel per scale) once in bf16 and once in float32;
            the flagship with both ViT switches on (in-kernel RoPE, deferred
            block tails) once in bf16 and once in float32; dino='global'
            (the class token of the ViT, the PointNet++ module encoder in
            eval form, the rgb rows of the heads) with the DINOv3 backbone in
            bf16 and in float32 and the DINOv2 backbone in bf16; and one
            DINOv3 block on an unpadded 261-token axis (B=64) per dtype.
            The ViT runs once per request and the energy agent reuses its
            output.
            Launch counts are reset just before and read just after each
            request; the score feature and the candidates are recomputed with
            the plain versions on the card;
  frame     GenPose2 (the frame entry point) on a synthetic 640x480 RGB-D
            frame of 12 ellipsoids: the flagship (1,024 points) for one
            detection call and 10 tracking calls, the dense configuration for
            one detection call and 3 tracking calls, each with the host
            front end's and the device's ms and exact launch counts; then
            dino='global' (DINOv3, bf16) for one detection call and 3 tracking
            calls; the detection calls again through the plain versions on
            the card;
  train     flagship score train steps as scripts/bench_train.py takes them
            (B=64, N=1024, 256-px N(0,1) crops, repeat_num 20, Adam): 5 in its
            float32 setting and 5 in its bf16 setting, each step's launch
            counts exactly FPS 4, ball query 8, ViT attention 12, add+LN 12;
            a kernel step against the same step with the plain versions; a
            step replayed bit for bit; an energy step with ranking, a
            ScaleAgent step, and a score step at TrainConfig.batch_size;
  timing    CUDA-event times of each kernel, its plain version and, where one
            PyTorch call computes the same function, that call, at the main
            paths' shapes, with the bound from this run's shapes and data; the
            three ViT attention entries also at a frame call's batch (12
            objects), beside SDPA at the same batch;
  profile   torch.profiler device time by kernel name over one bf16 flagship
            request, one bf16 dino='global' request, one flagship train step
            and the device part of one bf16 tracking call of each frame
            configuration, and the device's busy share against the same work
            unprofiled.
Then the kernels table, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero and prints no
such line; so does a machine without a card, or a directory without the
package.
"""

import contextlib
import cProfile
import json
import math
import os
import pstats
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


def object_clouds(gen, device, count=B, n=N):
    """``count`` camera-frame clouds of n points on ellipsoid surfaces, 4-15 cm
    semi-axes, 0.5-1.2 m from the camera, 2 mm noise."""
    import torch

    d = torch.randn(count, n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    axes = torch.rand(count, 1, 3, generator=gen) * 0.11 + 0.04
    center = torch.rand(count, 1, 3, generator=gen) * torch.tensor([0.6, 0.6, 0.7]) \
        + torch.tensor([-0.3, -0.3, 0.5])
    pts = d * axes + center + torch.randn(count, n, 3, generator=gen) * 0.002
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


def no_dropout(cfg):
    """The config with the Fus encoder's dropout and input jitter at 0."""
    import dataclasses

    pn2 = dataclasses.replace(cfg.model.pointnet2, dropout=0.0, input_jitter=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, pointnet2=pn2))


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one card (see the module "
                                             "docstring); no arguments run every phase.")
    ap.add_argument("--reference-seeds", type=int, default=0, metavar="N",
                    help="only build the kernels and run the reference phase's checks with "
                         "seeds 0..N-1, one line per seed and config")
    args = ap.parse_args()
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

    import numpy as np
    import torch.nn.functional as F

    from genpose2_tpu_torch.api import GenPose2
    from genpose2_tpu_torch.config import (ModelConfig, PointNet2Config, default_config,
                                           tiny_flagship_config, tiny_test_config)
    from genpose2_tpu_torch.data import native, synthetic_frame
    from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
    from genpose2_tpu_torch.models.attention import EfficientRelativePositionalEncoding
    from genpose2_tpu_torch.models.fast_encoder import stage_arguments
    from genpose2_tpu_torch.models.scorenet import fast_score_weights
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.models import pointnet2 as pointnet2_module
    from genpose2_tpu_torch.models import vit as vit_module
    from genpose2_tpu_torch.models.vit import rope_tables
    from genpose2_tpu_torch.ops.ball_query import (ball_count, ball_count_plain, ball_query,
                                                   ball_query_plain)
    from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from genpose2_tpu_torch.ops.fused_sa import (fused_group_mlp_pool, fused_group_mlp_pool_plain,
                                                 fused_sa_scale, fused_sa_scale_plain,
                                                 fused_sa_stage, fused_sa_stage_plain)
    from genpose2_tpu_torch.ops.grouping import gather_points
    from genpose2_tpu_torch.ops.layernorm import (LN_EPS, fast_add_layernorm,
                                                  fast_add_layernorm_plain, fast_layernorm,
                                                  fast_layernorm_plain,
                                                  fast_residual_layernorm,
                                                  fast_residual_layernorm_plain)
    from genpose2_tpu_torch.ops.ode_rk4 import (compute_dtype_of, fused_rk4_integrate,
                                                fused_rk4_plain)
    from genpose2_tpu_torch.ops.relpe_attention import relpe_attention, relpe_attention_plain
    from genpose2_tpu_torch.ops.vit_attention import (vit_attention, vit_attention_plain,
                                                      vit_attention_tm, vit_attention_tm_plain)
    from genpose2_tpu_torch.so3.rotations import matrix_to_rot6d_cols
    from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
    from genpose2_tpu_torch.training.optim import global_norm

    # module initialisation draws from torch's global generators, which are
    # otherwise seeded anew in every process
    torch.manual_seed(SEED)
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

    def dense_config(dtype):
        """The flagship at 2,048 points: stage 0 of each encoder runs one SA
        kernel per scale, as the JAX package routes it."""
        cfg = flagship_config(dtype)
        return cfg.replace(model=dataclasses.replace(cfg.model, num_points=2 * N),
                           data=dataclasses.replace(cfg.data, num_points=2 * N))

    def global_config(dtype, backbone="dinov3_vits16plus"):
        """The flagship settings with dino='global': the backbone's class token
        and the PointNet++ module encoder on the cloud alone."""
        cfg = flagship_config(dtype)
        return cfg.replace(model=dataclasses.replace(cfg.model, dino="global",
                                                     backbone=backbone))

    @contextlib.contextmanager
    def vit_switches(on=True):
        """Both ViT switches (in-kernel RoPE, deferred block tails) set to
        ``on`` inside the block, restored after."""
        saved = vit_module._INKERNEL_ROPE, vit_module._DEFER_TAIL
        vit_module._INKERNEL_ROPE = vit_module._DEFER_TAIL = on
        try:
            yield
        finally:
            vit_module._INKERNEL_ROPE, vit_module._DEFER_TAIL = saved

    gen = torch.Generator().manual_seed(SEED)

    def to_card(batch):
        return {k: (v.to(dev) if torch.is_tensor(v) else [t.to(dev) for t in v])
                for k, v in batch.items()}

    def make_agents(config):
        """{dtype: (score, energy, scale)}, one set of random weights shared
        by the dtypes."""
        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = config(dtype)
            s, e = PoseAgent(cfg, "score", device=dev), PoseAgent(cfg, "energy", device=dev)
            if not out:
                for agent in (s, e):
                    randomize(agent.model, gen)
                    if agent.provider is not None:
                        randomize(agent.provider.vit, gen)
                sc = ScaleAgent(cfg, device=dev)
                randomize(sc.model, gen)
            else:
                s0, e0, sc = out["float32"]
                s.model.load_state_dict(s0.model.state_dict())
                e.model.load_state_dict(e0.model.state_dict())
                if s.provider is not None:
                    s.provider.vit.load_state_dict(s0.provider.vit.state_dict())
            out[dtype] = (s, e, sc)
        return out

    @phase("reference")
    def reference():
        """The tiny configs' weights and inputs come from generators of their
        own, seeded here, so that no draw added before this phase changes
        them. The train-step gradients are discontinuous: where a ReLU's
        input lies within float32 noise of 0, the card and the CPU can put
        it on either side, and the gradients then differ by more than their
        bound. Some draws hold such an input
        (``--reference-seeds`` counts them); seed 0 holds none."""
        torch.manual_seed(SEED)
        rgen = torch.Generator().manual_seed(SEED)
        line = {"phase": "reference"}
        for name, errs, tol in reference_errors(rgen):
            line[name] = {"max_abs_err": errs, "tolerance": tol}
            emit(dict(line, config=name))
            for k in tol:
                assert errs[k] <= tol[k], f"{name} {k}: {errs[k]} > {tol[k]}"

    def serving_errors(tiny, rgen):
        """A tiny config's score agent, card against CPU: the backbone's
        output, the point (and global rgb) feature from the CPU's image
        features, the candidates from the CPU's features. Returns (CPU agent,
        card agent, the batch with the CPU's image features, errors,
        tolerances)."""
        cpu = PoseAgent(tiny, "score", device="cpu")
        randomize(cpu.model, rgen)
        card = PoseAgent(tiny, "score", device=dev)
        card.model.load_state_dict(cpu.model.state_dict())
        m = tiny.model
        pts = torch.rand(4, m.num_points, 3, generator=rgen) * 0.3
        prior = torch.randn(4 * 8, 9, generator=rgen) * 0.5
        batch = {"pts": pts, "pts_center": pts.mean(1)}
        errs, tol = {}, {}
        if m.dino != "none":
            randomize(cpu.provider.vit, rgen)
            card.provider.vit.load_state_dict(cpu.provider.vit.state_dict())
            batch["roi_rgb"] = torch.randn(4, m.img_size, m.img_size, 3, generator=rgen)
            if m.dino == "pointwise":
                batch["roi_xs"] = torch.randint(0, m.img_size, (4, m.num_points), generator=rgen)
                batch["roi_ys"] = torch.randint(0, m.img_size, (4, m.num_points), generator=rgen)
            else:
                d = torch.randn(4, 3, generator=rgen)
                batch["roi_center_dir"] = d / d.norm(dim=-1, keepdim=True)
            key = "dino_global" if m.dino == "global" else "dino_layers"
            l_cpu = cpu.with_image_features(batch)[key]
            l_card = card.with_image_features(to_card(batch))[key]
            errs[key] = max(max_err(a.cpu(), b) for a, b in zip(l_card, l_cpu))
            # float32: summation order through 2 blocks; a bf16 backbone: flips
            # of bf16 roundings (the CPU tests' bf16 bound against JAX)
            tol[key] = 1e-4 if m.backbone_dtype == "float32" else 5e-2
            batch[key] = l_cpu
        on_card = to_card(batch)
        f_cpu, r_cpu = cpu.extract_features(batch)
        f_card, r_card = card.extract_features(on_card)
        feats = (f_cpu.to(dev), None if r_cpu is None else r_cpu.to(dev))
        p_cpu = cpu.sample_candidates(batch, repeat_num=8, T0=T0, num_steps=10,
                                      features=(f_cpu, r_cpu), prior=prior)
        p_card = card.sample_candidates(on_card, repeat_num=8, T0=T0, num_steps=10,
                                        features=feats, prior=prior)
        errs["feature"] = max_err(f_card.cpu(), f_cpu)
        errs["candidates"] = max_err(p_card.cpu(), p_cpu)
        # the JAX package's float32 bounds: encoder (tests/test_models.py:446),
        # fused RK4 against the scan (tests/test_ode_fused.py:112)
        tol["feature"], tol["candidates"] = 2e-4, 5e-4
        if r_cpu is not None:
            # the same class token on both sides, sin/cos of 2^k * direction
            errs["rgb_feature"], tol["rgb_feature"] = max_err(r_card.cpu(), r_cpu), 1e-5
        return cpu, card, batch, errs, tol

    def reference_errors(rgen):
        """Yield (config name, errors, tolerances) of the tiny configs: both
        serving and a train step for tiny_test_config and
        tiny_flagship_config, serving for dino='global' and for the switched
        bf16 backbone."""
        for name, tiny in (("tiny_test_config", tiny_test_config()),
                           ("tiny_flagship_config", tiny_flagship_config())):
            cpu, card, batch, errs, tol = serving_errors(tiny, rgen)
            errs.update(train_step_card_vs_cpu(tiny, cpu, card, batch, rgen))
            # loss: float32 summation order (cuBLAS against the CPU's); gradients:
            # the CPU tests' bound against JAX, 5e-4 of the largest entry
            # (tests/test_torch_port_train_step.py); parameters after both
            # sides take the CPU's gradients: the same float32 clip, Adam and
            # EMA operations, the CPU tests' 1e-6 of max(1, |p|)
            tol.update(train_loss_rel=1e-4, train_grad_err_over_max=5e-4,
                       train_param_err=1e-6, train_ema_err=1e-6)
            yield name, errs, tol
        base = tiny_flagship_config()
        for name, model, switched in (
                ("tiny_global_config", dataclasses.replace(base.model, dino="global"), False),
                ("tiny_flagship_switched_bf16",
                 dataclasses.replace(base.model, backbone_dtype="bfloat16"), True)):
            with vit_switches(switched):
                errs, tol = serving_errors(base.replace(model=model), rgen)[3:]
            yield name, errs, tol

    def train_step_card_vs_cpu(tiny, cpu, card, batch, rgen):
        """One score train step of the same weights, batch and explicit draws
        on the card and on the CPU (dropout and jitter 0, the CPU's ViT
        layers on both sides); then both sides update with the CPU's
        gradients (Adam's first step is about lr * sign(g), which flips on
        gradients near zero) and each with its own BatchNorm statistics."""
        tcfg = no_dropout(tiny)
        t_cpu = PoseAgent(tcfg, "score", device="cpu")
        t_card = PoseAgent(tcfg, "score", device=dev)
        t_cpu.model.load_state_dict(cpu.model.state_dict())
        t_card.model.load_state_dict(cpu.model.state_dict())
        Bt = batch["pts"].shape[0]
        R = tcfg.train.repeat_num
        tb = dict(batch, zero_mean_gt_pose=torch.randn(Bt, 9, generator=rgen) * 0.5)
        draws = {"t": torch.rand(R, Bt, 1, generator=rgen) * (1 - card.sde.eps) + card.sde.eps,
                 "z": torch.randn(R, Bt, 9, generator=rgen)}
        s_cpu, s_card = t_cpu.init_state(), t_card.init_state()
        l_cpu, _, g_cpu, st_cpu = t_cpu.loss_and_grads(s_cpu, tb, draws=draws)
        l_card, _, g_card, st_card = t_card.loss_and_grads(s_card, to_card(tb), draws=draws)
        g_cpu = [torch.zeros_like(p) if g is None else g for p, g in zip(s_cpu.params.values(),
                                                                         g_cpu.values())]
        g_card = [torch.zeros_like(p) if g is None else g.cpu()
                  for p, g in zip(s_cpu.params.values(), g_card.values())]
        t_cpu.apply_gradients(s_cpu, l_cpu, g_cpu, st_cpu)
        t_card.apply_gradients(s_card, l_card, [g.to(dev) for g in g_cpu], st_card)
        gmax = max(float(g.abs().max()) for g in g_cpu)
        l_card, l_cpu = float(l_card.detach()), float(l_cpu.detach())

        def state_err(a, b):
            return max(max_err(x.cpu(), y) / max(1.0, float(y.abs().max()))
                       for x, y in zip(a.values(), b.values()))

        return {"train_loss": [l_card, l_cpu],
                "train_grad_norm": [float(global_norm(g_card)), float(global_norm(g_cpu))],
                "train_loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
                "train_grad_err_over_max": max(max_err(a, b) for a, b in zip(g_card, g_cpu)) / gmax,
                "train_param_err": state_err(s_card.params, s_cpu.params),
                "train_ema_err": state_err(s_card.ema_params, s_cpu.ema_params)}

    if args.reference_seeds:
        over = 0
        for seed in range(args.reference_seeds):
            torch.manual_seed(seed)
            rgen = torch.Generator().manual_seed(seed)
            for name, errs, tol in reference_errors(rgen):
                bad = [k for k in tol if errs[k] > tol[k]]
                over += bool(bad)
                emit({"phase": "reference_sweep", "seed": seed, "config": name,
                      "over_tolerance": bad, "max_abs_err": errs})
        emit({"phase": "reference_sweep", "seeds": args.reference_seeds,
              "draws_over_tolerance": over})
        return 0

    reference()
    paths = {"none": make_agents(none_config), "pointwise": make_agents(flagship_config),
             "dense": make_agents(dense_config), "global": make_agents(global_config),
             "global_dinov2": make_agents(lambda dt: global_config(dt, "dinov2_vits16"))}
    paths["switched"] = paths["pointwise"]  # the flagship's agents, both ViT switches on

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
    # the ViT's switch kernels: LayerNorm of the (64, 272, 384) stream, the
    # attention on the 261 real tokens, the in-kernel RoPE tables of the
    # flagship (256 patches, identity rows for the prefix and the pad rows)
    ln_vit_in = {dtype: (add_in[0].to(compute_dtype_of(dtype)),) + add_in[3:]
                 for dtype in ("float32", "bfloat16")}
    unpadded_in = {dtype: tuple(t[:, :n_valid].contiguous() for t in vit_in[dtype])
                   for dtype in vit_in}

    def flagship_tables(n_pad):
        """sin, cos (n_pad, head_dim) float32 as DinoV3ViT builds them for
        256-px crops, before the per-head tiling."""
        periods = paths["pointwise"]["bfloat16"][0].provider.vit.rope_embed.periods
        g = S // vit_cfg.patch_size
        sn, cs = rope_tables(periods, g, g)
        hd = sn.shape[1]
        return (torch.cat([sn.new_zeros(5, hd), sn, sn.new_zeros(n_pad - n_valid, hd)]),
                torch.cat([cs.new_ones(5, hd), cs, cs.new_ones(n_pad - n_valid, hd)]))

    rope_in = {dtype: flagship_tables(t[0].shape[1]) for dtype, t in vit_in.items()}

    # the training path's grouped stages: FPS on each stage's own points
    # (N = 1024, 512, 256, 128), both scales' ball queries on its centroids
    bq_stages, fps_stages = [], []
    xyz_k = pts0
    for npoint, radii, nsamples in zip(fus_cfg.npoints, fus_cfg.radii, fus_cfg.nsamples):
        if npoint is None:
            break
        fps_stages.append((xyz_k, npoint))
        new_k = gather_points(xyz_k, fps_plain(xyz_k, npoint)).contiguous()
        bq_stages += [(xyz_k, new_k, r, ns) for r, ns in zip(radii, nsamples)]
        xyz_k = new_k
    bq_edges = {  # no hit at all; N not a multiple of 32; nsample above 32; M below a tile
        "zero_hits": (pts0, (S0[:, :100] + 10.0).contiguous(), 0.02, 32),
        "n1000": (pts0[:, :1000].contiguous(), S0[:, :300].contiguous(), 0.04, 32),
        "nsample64": (pts0, S0.contiguous(), 0.05, 64),
        "m20": (pts0, S0[:, :20].contiguous(), 0.02, 16),
    }

    # the dense configuration's stage 0: both scales' kernel arguments as the
    # Fus score encoder forms them (per-point DINO features N(0, 1)),
    # centroids in density order
    pts_dense = object_clouds(gen, dev, B, 2 * N)

    def dense_stage0(s):
        sa, pcfg = s.model.pts_encoder.SA_modules[0], s.cfg.model.pointnet2
        nxs = gather_points(pts_dense, fps_plain(pts_dense, sa.npoint))
        cnt = ball_count_plain(pts_dense, nxs, max(sa.radii))
        nxs = gather_points(nxs, torch.argsort(-cnt, dim=1, stable=True)).contiguous()
        feats = torch.randn(B, 2 * N, s.cfg.model.dino_dim, generator=gen).to(dev)
        args = stage_arguments(sa, torch.cat([pts_dense, feats], -1), nxs, pcfg.use_xyz,
                               compute_dtype_of(pcfg.compute_dtype))
        return nxs, args, sa.radii, sa.nsamples

    dense0 = {dtype: dense_stage0(paths["dense"][dtype][0]) for dtype in ("float32", "bfloat16")}

    def scale_cases(dtype):
        """(name, kernel call, plain call) of each scale of the dense stage 0
        through both kernels, then the edge cases: no hit, N not a multiple
        of 32, nsample 64, indices outside [0, N) and repeated."""
        nxs, (projs, centers, affs, wss), radii, nsamples = dense0[dtype]
        cases = []
        for sc in range(len(radii)):
            op, r, ns = (projs[sc], centers[sc], affs[sc], wss[sc]), radii[sc], nsamples[sc]
            idx = ball_query_plain(pts_dense, nxs, r, ns)
            cases.append((f"scale{sc}", lambda op=op, r=r, ns=ns: fused_sa_scale(pts_dense, nxs, *op, r, ns),
                          lambda op=op, r=r, ns=ns: fused_sa_scale_plain(pts_dense, nxs, *op, r, ns)))
            cases.append((f"indices{sc}", lambda op=op, idx=idx: fused_group_mlp_pool(op[0], idx, *op[1:]),
                          lambda op=op, idx=idx: fused_group_mlp_pool_plain(op[0], idx, *op[1:])))
        p0, c0, a0, w0 = projs[0], centers[0], affs[0], wss[0]
        far = (nxs[:, :100] + 10.0).contiguous()
        c100 = c0[:, :100].contiguous()
        cases.append(("zero_hits", lambda: fused_sa_scale(pts_dense, far, p0, c100, a0, w0, 0.02, 32),
                      lambda: fused_sa_scale_plain(pts_dense, far, p0, c100, a0, w0, 0.02, 32)))
        x1000, p1000 = pts_dense[:, :1000].contiguous(), p0[:, :1000].contiguous()
        n300, c300 = nxs[:, :300].contiguous(), c0[:, :300].contiguous()
        cases.append(("n1000", lambda: fused_sa_scale(x1000, n300, p1000, c300, a0, w0, 0.04, 32),
                      lambda: fused_sa_scale_plain(x1000, n300, p1000, c300, a0, w0, 0.04, 32)))
        cases.append(("nsample64", lambda: fused_sa_scale(pts_dense, nxs, p0, c0, a0, w0, 0.05, 64),
                      lambda: fused_sa_scale_plain(pts_dense, nxs, p0, c0, a0, w0, 0.05, 64)))
        bad = ball_query_plain(pts_dense, nxs, 0.05, 48)
        bad[:, :50, 3] = -1
        bad[:, 50:100, 5] = 2 * N
        bad[:, 100:150, 1:] = bad[:, 100:150, :1]
        bad[:, 150:200, 24:] = bad[:, 150:200, :24]
        bad[:, 200] = -7
        cases.append(("bad_indices", lambda: fused_group_mlp_pool(p0, bad, c0, a0, w0),
                      lambda: fused_group_mlp_pool_plain(p0, bad, c0, a0, w0)))
        return cases

    @phase("kernels")
    def kernels():
        # ball query at the training path's eight stage shapes and the edge
        # cases, FPS at the later stages' N; both exact
        bq_mis, bq_hits = [], []
        for xyz, nxs, r, ns in list(bq_stages) + list(bq_edges.values()):
            k, p = ball_query(xyz, nxs, r, ns), ball_query_plain(xyz, nxs, r, ns)
            bq_mis.append(int((k != p).sum()))
            bq_hits.append(float(ball_count_plain(xyz, nxs, r).float().mean()))
        fps_mis = [int((furthest_point_sample(x, n) != fps_plain(x, n)).sum())
                   for x, n in fps_stages[1:]]
        results["ball_query"] = {"max_abs_err": float(sum(bq_mis)), "tolerance": "exact"}
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
                "residual_ln": {}, "vit": {},
                "ball_query": {"cases": [f"N{x.shape[1]}_M{c.shape[1]}_r{r}_S{ns}"
                                         for x, c, r, ns in bq_stages] + list(bq_edges),
                               "index_mismatches": bq_mis, "mean_hits": bq_hits},
                "fps_train_stages": {"N": [x.shape[1] for x, _ in fps_stages[1:]],
                                     "index_mismatches": fps_mis}}
        ok = fps_mismatch == 0 and bc_mismatch == 0 and not any(bq_mis) and not any(fps_mis)
        for dtype, (s, _, _) in paths["none"].items():
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
        # the ViT's switch kernels at the flagship shapes, to the bounds above:
        # LayerNorm 1e-5 / 2e-2 (bf16 out), both attentions 1e-5 / 2e-2 on the
        # real rows
        line["vit_switch"] = {}
        for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
            sfx = "" if dtype == "float32" else ".bf16"
            x, sc, bi = ln_vit_in[dtype]
            q, k, v = vit_in[dtype]
            sn, cs = rope_in[dtype]
            pairs = {"layernorm": (fast_layernorm(x, sc, bi), fast_layernorm_plain(x, sc, bi)),
                     "vit_attention_unpadded": (vit_attention(*unpadded_in[dtype], vit_heads),
                                                vit_attention_plain(*unpadded_in[dtype],
                                                                    vit_heads)),
                     "vit_attention_rope": tuple(
                         f(q, k, v, vit_heads, n_valid, sin=sn, cos=cs)[:, :n_valid]
                         for f in (vit_attention_tm, vit_attention_tm_plain))}
            errs = {}
            for name, (got, want) in pairs.items():
                errs[name] = max_err(got, want)
                within = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
                              and torch.isfinite(got).all())
                ok = ok and within
                results[name + sfx] = {"max_abs_err": errs[name], "tolerance": f"rtol=atol={tol}"}
            line["vit_switch"][dtype] = errs
        # the per-scale SA kernel and the SA kernel from indices: the dense
        # stage 0 and the edge cases, to the stage kernel's bounds
        line["sa_dense_stage0"] = {}
        for dtype in ("float32", "bfloat16"):
            tol = 1e-4 if dtype == "float32" else 2e-2
            errs = {}
            for name, kern, plain in scale_cases(dtype):
                k, p = kern(), plain()
                errs[name] = (max_err(k, p), rel_err(k, p))
                ok = ok and errs[name][1] <= tol and bool(torch.isfinite(k).all())
            sfx = "" if dtype == "float32" else ".bf16"
            for op, keys in (("fused_sa_scale", ("scale", "zero_hits", "n1000", "nsample64")),
                             ("fused_group_mlp_pool", ("indices", "bad_indices"))):
                mine = [e for n, e in errs.items() if n.startswith(keys)]
                results[op + sfx] = {"max_abs_err": max(e[0] for e in mine),
                                     "tolerance": f"{tol} of max|plain|"}
            line["sa_dense_stage0"][dtype] = {n: {"max_abs_err": e[0], "err_over_max": e[1]}
                                              for n, e in errs.items()}
        line["ok"] = ok
        line["tolerance"] = {k: v["tolerance"] for k, v in results.items()}
        emit(line)
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version")

    kernels()

    # ---------------------------------------------------------------- requests
    per_request = []

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read just
        after; returns (result, ms on the host clock, counts)."""
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        return out, ms, {k: _cuda.launch_counts[k] for k in _cuda.KERNELS}

    def new_request(path, dtype):
        n_pts = paths[path][dtype][0].cfg.model.num_points
        pts = object_clouds(gen, dev, B, n_pts)
        prior = paths[path][dtype][0].sde.prior_sample((B * K, 9), T=T0, generator=gen).to(dev)
        batch = {"pts": pts, "pts_center": pts.mean(1)}
        if path != "none":
            batch["roi_rgb"] = torch.randn(B, S, S, 3, generator=gen).to(dev)
        if path.startswith("global"):
            d = torch.randn(B, 3, generator=gen)
            batch["roi_center_dir"] = (d / d.norm(dim=-1, keepdim=True)).to(dev)
        elif path != "none":
            batch["roi_xs"] = torch.randint(0, S, (B, n_pts), generator=gen).to(dev)
            batch["roi_ys"] = torch.randint(0, S, (B, n_pts), generator=gen).to(dev)
        return batch, prior

    def serve(path, dtype, raw, prior):
        """One request through the agents, as a user calls them: the backbone
        once (score agent), its layers shared with the energy agent."""
        s, e, sc = paths[path][dtype]
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
        """Launches per request, as the JAX package routes it."""
        bf16 = dtype == "bfloat16"
        want = dict.fromkeys(_cuda.KERNELS, 0)
        if path.startswith("global"):
            # the module encoder of the score and of the energy agent: FPS per
            # grouped stage, a ball query per scale; the DINOv2 ViT is plain
            want.update(fps=8, ball_query=16, fused_rk4=1)
            if path == "global":
                want.update(vit_attention=12, add_layernorm=12 if bf16 else 0)
            return want
        want.update(fps=2, ball_count=2, fused_sa_stage=8, fused_rk4=1)
        if path != "none":
            want.update(relpe_attention=8, residual_layernorm=16, vit_attention=12,
                        add_layernorm=12 if bf16 else 0)
        if path == "switched":  # RoPE in every attention; bf16: the tails deferred
            want.update(vit_attention=0, vit_attention_rope=12, layernorm=int(bf16),
                        add_layernorm=23 if bf16 else 0)
        if path == "dense":  # stage 0 of both encoders: one launch per scale
            want.update(fused_sa_stage=6, fused_sa_scale=4)
        return want

    @phase("request")
    def requests():
        ok = True
        order = [("none", "float32"), ("none", "bfloat16"), ("pointwise", "bfloat16"),
                 ("pointwise", "bfloat16"), ("pointwise", "float32"), ("dense", "bfloat16"),
                 ("dense", "float32"), ("switched", "bfloat16"), ("switched", "float32"),
                 ("global", "bfloat16"), ("global", "float32"), ("global_dinov2", "bfloat16")]
        for r, (path, dtype) in enumerate(order):
            with vit_switches(path == "switched"):
                good = request(r, path, dtype)
            ok = ok and good
        ok = unpadded_blocks() and ok
        if not ok:
            raise AssertionError("a request failed its checks")

    def request(r, path, dtype):
        """One request of the path, its checks, its line; returns whether it
        passed."""
        s = paths[path][dtype][0]
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
        f_plain, r_plain = s.extract_features(s.with_image_features(raw, plain=True),
                                              plain=True)
        p_plain = s.sample_candidates(raw, repeat_num=K, T0=T0, num_steps=STEPS, plain=True,
                                      features=feats, prior=prior)
        f_err = rel_err(feats[0], f_plain)
        if r_plain is not None:  # the global rgb feature: the feature's bound
            f_err = max(f_err, rel_err(feats[1], r_plain))
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
        per_request.append({"path": path, "dtype": dtype, "counts": counts, "ms": ms})
        emit({"phase": "request", "index": r, "path": path, "dtype": dtype, "ok": good,
              "request_ms": ms, "launches": counts, "expected": want_counts,
              "finite": finite, "orthonormality_err": orth, "det_err": det,
              "shapes": shapes, "feature_err_over_max": f_err, "feature_tol": f_tol,
              "candidates_max_abs_err": p_err, "candidates_tol": p_tol})
        return good

    def unpadded_blocks():
        """Block 0 of the flagship backbone on an unpadded 261-token axis (B=64),
        the route of DinoV3Attention for such an axis: one unpadded attention
        launch per call (bf16: also the add+LN), against the plain block."""
        ok = True
        for dtype in ("float32", "bfloat16"):
            vit = paths["pointwise"][dtype][0].provider.vit
            x = torch.randn(B, n_valid, vit_dim, generator=gen).to(dev, compute_dtype_of(dtype))
            sn, cs = (t.repeat(1, vit_heads) for t in flagship_tables(n_valid))
            (y, pend), ms, counts = counted(
                lambda: vit.blocks[0](x, sn, cs, n_valid, vit.dtype, False))
            y_plain, _ = vit.blocks[0](x, sn, cs, n_valid, vit.dtype, True)
            want = dict.fromkeys(_cuda.KERNELS, 0)
            want.update(vit_attention_unpadded=1, add_layernorm=int(dtype == "bfloat16"))
            # one block: f32 summation order; bf16 a flipped rounding of the stream
            err, tol = rel_err(y, y_plain), (1e-4 if dtype == "float32" else 2e-2)
            good = (counts == want and pend is None and err <= tol
                    and tuple(y.shape) == (B, n_valid, vit_dim) and bool(torch.isfinite(y).all()))
            ok = ok and good
            per_request.append({"path": "unpadded_block", "dtype": dtype, "counts": counts,
                                "ms": ms})
            emit({"phase": "request", "path": "unpadded_block", "dtype": dtype, "ok": good,
                  "block_ms": ms, "launches": counts, "expected": want,
                  "err_over_max": err, "tol": tol})
        return ok

    requests()

    # ------------------------------------------------------------------ train
    per_train = []
    TRAIN_STEPS, RANK_K = 5, 5

    def train_config(setting):
        """scripts/bench_train.py's settings: 'float32' is ModelConfig(dino=
        'pointwise') (the backbone stays bf16 by default); 'bfloat16' also
        runs the SA stack and the score dtype in bf16."""
        if setting == "bfloat16":
            return flagship_config("bfloat16")
        return default_config().replace(model=ModelConfig(dino="pointwise"))

    def train_batch(count=B):
        """Clouds, ground-truth poses (a random rotation's two columns and a
        few cm of translation), 256-px N(0, 1) crops and uniform pixels."""
        pts = object_clouds(gen, dev, count)
        q, _ = torch.linalg.qr(torch.randn(count, 3, 3, generator=gen))
        gt = torch.cat([q[:, :, 0], q[:, :, 1], torch.randn(count, 3, generator=gen) * 0.05], -1)
        return {"pts": pts, "zero_mean_gt_pose": gt.to(dev),
                "roi_rgb": torch.randn(count, S, S, 3, generator=gen).to(dev),
                "roi_xs": torch.randint(0, S, (count, N), generator=gen).to(dev),
                "roi_ys": torch.randint(0, S, (count, N), generator=gen).to(dev)}

    def train_counts(vit):
        want = dict.fromkeys(_cuda.KERNELS, 0)
        want.update(fps=4, ball_query=8)
        if vit:
            want.update(vit_attention=12, add_layernorm=12)
        return want

    def clone_state(st):
        return {"step": st.step, "ema_updates": st.ema_updates,
                "count": st.opt_state["count"],
                "tensors": [t.detach().clone() for t in state_tensors(st)]}

    def state_tensors(st):
        return [*st.params.values(), *st.buffers.values(), *st.ema_params.values(),
                *st.opt_state["mu"], *st.opt_state["nu"]]

    def restore_state(st, saved):
        st.step, st.ema_updates = saved["step"], saved["ema_updates"]
        st.opt_state["count"] = saved["count"]
        with torch.no_grad():
            for t, v in zip(state_tensors(st), saved["tensors"]):
                t.copy_(v)

    train_agents = {}

    @phase("train")
    def train():
        ok = True
        for setting in ("float32", "bfloat16"):
            cfg = train_config(setting)
            agent = PoseAgent(cfg, "score", device=dev)
            randomize(agent.model, gen)
            randomize(agent.provider.vit, gen)
            state = agent.init_state()
            train_agents[setting] = (agent, state)
            start = clone_state(state)
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            steps = []
            for _ in range(TRAIN_STEPS):
                batch = train_batch()
                (_, m), ms, counts = counted(lambda: agent.train_step(state, batch, g))
                loss = float(m["loss"])
                good = counts == train_counts(True) and math.isfinite(loss)
                ok = ok and good
                steps.append({"ms": ms, "loss": loss, "grad_norm": float(m["grad_norm"]),
                              "lr": m["lr"], "launches": counts, "ok": good})
                per_train.append(counts)
            n_p, n_b = len(state.params), len(state.buffers)
            now = state_tensors(state)
            moved = [not torch.equal(a, b) for a, b in zip(now, start["tensors"])]
            moved = {"params": sum(moved[:n_p]), "buffers": sum(moved[n_p:n_p + n_b]),
                     "ema": sum(moved[n_p + n_b:2 * n_p + n_b]),
                     "of": {"params": n_p, "buffers": n_b, "ema": n_p}}
            # every BatchNorm statistic moves; a parameter stays only where its
            # gradient is 0 on every step (the ImgEncoder's, behind the
            # stop-gradient, and the one-token GroupAll block's query and key)
            good = (moved["buffers"] == n_b and moved["params"] >= 0.9 * n_p
                    and moved["ema"] >= 0.9 * n_p and state.step == TRAIN_STEPS)
            ok = ok and good
            warm = sorted(st_["ms"] for st_ in steps[1:])
            emit({"phase": "train", "setting": setting, "ok": good and all(x["ok"] for x in steps),
                  "batch": B, "repeat_num": cfg.train.repeat_num, "optimizer": cfg.train.optimizer,
                  "steps": steps, "expected": train_counts(True), "moved": moved,
                  "warm_step_ms_median": warm[len(warm) // 2],
                  "samples_per_s": 1e3 * B / warm[len(warm) // 2]})

        agent, state = train_agents["float32"]
        batch = agent.with_image_features(train_batch())  # both runs take these ViT layers
        # one step with the kernels against the same step with the plain
        # versions, same state and generator seed; every ball query's indices
        recorded = {"kernel": [], "plain": []}

        def recording(fn, key):
            def run(*a):
                out = fn(*a)
                recorded[key].append(out)
                return out
            return run

        pointnet2_module.ball_query = recording(ball_query, "kernel")
        pointnet2_module.ball_query_plain = recording(ball_query_plain, "plain")
        try:
            # loss_and_grads changes neither the model nor the state
            l_k, _, g_k, _ = agent.loss_and_grads(state, batch,
                                                  torch.Generator(dev).manual_seed(7))
            l_p, _, g_p, _ = agent.loss_and_grads(state, batch,
                                                  torch.Generator(dev).manual_seed(7), plain=True)
        finally:
            pointnet2_module.ball_query = ball_query
            pointnet2_module.ball_query_plain = ball_query_plain
        ks = [g for g in g_k.values() if g is not None]
        ps = [g for g in g_p.values() if g is not None]
        gmax = max(float(g.abs().max()) for g in ps)
        idx_equal = (len(recorded["kernel"]) == len(recorded["plain"]) == 8 and
                     all(torch.equal(a, b) for a, b in zip(recorded["kernel"], recorded["plain"])))
        l_k, l_p = float(l_k.detach()), float(l_p.detach())
        cmp = {"loss": [l_k, l_p], "loss_rel": abs(l_k - l_p) / abs(l_p),
               "grad_err_over_max": max(max_err(a, b) for a, b in zip(ks, ps)) / gmax,
               "ball_query_indices_equal": idx_equal,
               "tolerance": {"loss_rel": 1e-5, "grad_err_over_max": 5e-4}}
        # FPS and ball-query indices are exact, so both runs do the same
        # float32 work; the CPU tests' bound stands in for summation order
        good = idx_equal and cmp["loss_rel"] <= 1e-5 and cmp["grad_err_over_max"] <= 5e-4
        ok = ok and good
        emit({"phase": "train", "check": "kernel_vs_plain_step", "ok": good, **cmp})

        # the same step twice from the same state and seed: bit-identical
        saved = clone_state(state)
        runs = []
        for _ in range(2):
            restore_state(state, saved)
            _, m = agent.train_step(state, batch, torch.Generator(dev).manual_seed(9))
            runs.append((m["loss"].clone(), [p.detach().clone() for p in state.params.values()]))
        loss_same = bool(torch.equal(runs[0][0], runs[1][0]))
        params_same = sum(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        same = loss_same and params_same == len(runs[0][1])
        ok = ok and same
        emit({"phase": "train", "check": "replay", "ok": same, "loss": float(runs[0][0]),
              "loss_identical": loss_same, "params_identical": params_same,
              "of": len(runs[0][1])})

        # energy agent with ranking candidates (second-order DSM); the batch
        # carries its ViT layers, so the backbone does not run
        cfg = train_config("float32")
        e_agent = PoseAgent(cfg, "energy", device=dev)
        randomize(e_agent.model, gen)
        e_state = e_agent.init_state()
        cand = torch.randn(B, RANK_K, 9, generator=gen) * 0.5
        e_batch = dict(batch, candidate_poses=cand.to(dev),
                       candidate_metrics=torch.rand(B, RANK_K, 2, generator=gen).to(dev))
        (_, m), ms, counts = counted(
            lambda: e_agent.train_step(e_state, e_batch, torch.Generator(dev).manual_seed(11)))
        good = counts == train_counts(False) and math.isfinite(float(m["loss"]))
        ok = ok and good
        per_train.append(counts)
        emit({"phase": "train", "check": "energy_with_ranking", "ok": good, "ms": ms,
              "loss": float(m["loss"]), "ranking_loss": float(m["ranking_loss"]),
              "launches": counts, "expected": train_counts(False)})

        # ScaleAgent on the score encoder's eval feature, 64 noised axes each
        sc = ScaleAgent(cfg, device=dev)
        randomize(sc.model, gen)
        sc_state = sc.init_state()
        feat, _ = agent.extract_features(batch)
        q, _ = torch.linalg.qr(torch.randn(B * cfg.train.scale_batch_size, 3, 3, generator=gen))
        sc_batch = {"pts_feat": feat,
                    "axes_training": q.reshape(B, cfg.train.scale_batch_size, 3, 3).to(dev),
                    "gt_length": (torch.rand(B, 3, generator=gen) * 0.25 + 0.05).to(dev)}
        (_, m), ms, _ = counted(lambda: sc.train_step(sc_state, sc_batch))
        good = math.isfinite(float(m["loss"])) and sc_state.step == 1
        ok = ok and good
        emit({"phase": "train", "check": "scale", "ok": good, "ms": ms, "loss": float(m["loss"]),
              "rows": B * cfg.train.scale_batch_size})

        # one score step at TrainConfig.batch_size, with its peak memory
        big = cfg.train.batch_size
        big_batch = train_batch(big)
        torch.cuda.reset_peak_memory_stats()
        (_, m), ms, counts = counted(lambda: agent.train_step(state, big_batch,
                                                              torch.Generator(dev).manual_seed(13)))
        good = counts == train_counts(True) and math.isfinite(float(m["loss"]))
        ok = ok and good
        per_train.append(counts)
        emit({"phase": "train", "check": "batch_size", "ok": good, "batch": big, "ms": ms,
              "samples_per_s": 1e3 * big / ms, "loss": float(m["loss"]),
              "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches": counts})
        if not ok:
            raise AssertionError("a training check failed")

    train()

    # ------------------------------------------------------------------- frame
    per_frame = []
    frame_runs = {}  # (config, dtype) -> (engine, last front-end batch, its prior pose)
    FRAME_W, FRAME_H, FOCAL, N_OBJ = 640, 480, 600.0, 12

    def pose_weights(agent):
        """The agent's GFObjectPose state dict, its backbone under dino."""
        sd = dict(agent.model.state_dict())
        if agent.provider is not None:
            sd.update({f"dino.{k}": v for k, v in agent.provider.vit.state_dict().items()})
        return sd

    @phase("frame")
    def frames():
        """GenPose2 as a user calls it, on the request phase's weights: the
        host front end, then the device part, per call; detection, then
        tracking fed with the previous call's pose. The detection call again
        through the plain versions on the card: the same crops and clouds,
        the plain feature against the kernels' (the request phase's bounds)
        and the plain sampler on the kernels' feature."""
        ok = True
        frng = np.random.default_rng(SEED)
        objs = synthetic_frame.random_scene(frng, N_OBJ, FRAME_W, FRAME_H, FOCAL)
        seq = []
        for _ in range(11):
            seq.append(synthetic_frame.render(frng, objs, FRAME_W, FRAME_H, FOCAL))
            objs = synthetic_frame.moved(frng, objs)
        branch = "native" if native.available() else "numpy"
        summary = []
        for path, dtype, calls in (("pointwise", "bfloat16", 11), ("dense", "bfloat16", 4),
                                   ("pointwise", "float32", 1), ("global", "bfloat16", 4)):
            s, e, sc = paths[path][dtype]
            engine = GenPose2(s.cfg, score=pose_weights(s), energy=pose_weights(e),
                              scale=sc.model.state_dict(), device=dev)
            Kf = engine.cfg.eval.eval_repeat_num
            prev, host, device = None, [], []
            for i in range(calls):
                tracking = i > 0
                t0 = time.perf_counter()
                raw = engine.front_end(seq[i])
                host.append(1e3 * (time.perf_counter() - t0))
                n = len(raw["mask_ids"])
                T0f = engine.tracking_T0 if tracking else engine.single_T0
                prior = s.sde.prior_sample((n * Kf, 9), T=T0f, generator=gen).to(dev)
                et = (torch.rand(n * Kf, 1, generator=gen) * 9e-5 + 1e-5).to(dev)
                out, ms, counts = counted(lambda: engine.serve_batch(raw, prev, tracking,
                                                                     prior=prior, energy_t=et))
                device.append(ms)
                agg = out["aggregate"]
                R, t = agg["rotation"], agg["translation"]
                prev = torch.cat([matrix_to_rot6d_cols(R), t], dim=-1)
                want_counts = expected_counts(path, dtype)
                finite = all(bool(torch.isfinite(x).all()) for x in
                             (out["features"], out["candidates"], out["energy"], R, t,
                              out["lengths"]))
                good = (counts == want_counts and finite and n == N_OBJ
                        and list(raw["mask_ids"]) == list(range(1, N_OBJ + 1))
                        and tuple(out["candidates"].shape) == (n, Kf, 9))
                rec = {"phase": "frame", "config": path, "dtype": dtype, "call": i,
                       "tracking": tracking, "objects": n, "points": raw["pcl_in"].shape[1],
                       "native_branch": branch, "host_front_end_ms": host[-1],
                       "device_ms": ms, "launches": counts, "expected": want_counts,
                       "finite": finite}
                if not tracking:
                    again = engine.front_end(seq[i])
                    same_host = all(np.array_equal(raw[k], again[k])
                                    for k in ("pcl_in", "roi_rgb", "roi_xs", "roi_ys"))
                    plain = engine.serve_batch(raw, None, False, prior=prior, energy_t=et,
                                               plain=True)
                    p_plain = engine.score_agent.sample_candidates(
                        out["batch"], repeat_num=Kf, T0=T0f, num_steps=engine.num_steps,
                        features=(out["features"], out["rgb_features"]), prior=prior,
                        plain=True)
                    f_err = rel_err(out["features"], plain["features"])
                    if plain["rgb_features"] is not None:
                        f_err = max(f_err, rel_err(out["rgb_features"], plain["rgb_features"]))
                    p_err = max_err(out["candidates"], p_plain)
                    # the request phase's bounds
                    f_tol, p_tol = (2e-4, 5e-4) if dtype == "float32" else (5e-2, 2e-2)
                    good = good and same_host and f_err <= f_tol and p_err <= p_tol
                    rec.update(host_output_identical=same_host, feature_err_over_max=f_err,
                               feature_tol=f_tol, candidates_max_abs_err=p_err,
                               candidates_tol=p_tol)
                rec["ok"] = good
                ok = ok and good
                per_frame.append({"dtype": dtype, "counts": counts})
                emit(rec)
            frame_runs[(path, dtype)] = (engine, raw, prev)
            warm = device[1:] or device
            summary.append({"config": path, "dtype": dtype, "calls": calls,
                            "points": engine.cfg.data.num_points,
                            "host_front_end_ms_mean": sum(host) / len(host),
                            "device_ms_first": device[0],
                            "device_ms_warm_mean": sum(warm) / len(warm)})
        # where the host front end's time goes: one frame under cProfile
        prof = cProfile.Profile()
        prof.runcall(frame_runs[("pointwise", "bfloat16")][0].front_end, seq[0])
        stats = pstats.Stats(prof).sort_stats("tottime")
        hot = [{"function": f"{fn[0].split('/')[-1]}:{fn[1]}:{fn[2]}", "calls": st[1],
                "tottime_ms": 1e3 * st[2], "cumtime_ms": 1e3 * st[3]}
               for fn, st in sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:10]]
        emit({"phase": "frame", "ok": ok, "native_branch": branch, "frame": [FRAME_W, FRAME_H],
              "objects": N_OBJ, "summary": summary, "front_end_profile_top": hot})
        if not ok:
            raise AssertionError("a frame call failed its checks")

    frames()

    # ------------------------------------------------------------------ timing
    table = []

    @phase("timing")
    def timing():
        per_stage = {}
        dtyped = ("fused_sa_stage", "fused_rk4", "relpe_attention", "vit_attention",
                  "fused_sa_scale", "fused_group_mlp_pool", "layernorm", "vit_attention_unpadded",
                  "vit_attention_rope")
        launches = {}
        for req in per_request + per_frame:
            for k, v in req["counts"].items():
                key = f"{k}.bf16" if req["dtype"] == "bfloat16" and k in dtyped else k
                launches[key] = launches.get(key, 0) + v
        for counts in per_train:  # the training backbone is bf16 in both settings
            for k, v in counts.items():
                key = f"{k}.bf16" if k == "vit_attention" else k
                launches[key] = launches.get(key, 0) + v

        def entry(name, source, replaces, ms, plain_ms, nbytes, ops, library_ms=None, **extra):
            b, by = bound_ms(nbytes, ops)
            r = results.get(name, {})
            table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                          "launches": launches.get(name, 0), "max_abs_err": r.get("max_abs_err"),
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                          "library_ms": library_ms, **extra})

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
        # ball query: the eight launches of one training step's encoder
        # forward. Operations: 8 per distance test (3 subtractions, 3
        # products, 2 sums), over the points each centroid scans before its
        # nsample-th hit (all N when it has fewer hits), from this run's data
        ks, ps, bs, nb, ops = [], [], [], 0, 0
        for xyz, nxs, r, ns in bq_stages:
            ks.append(cuda_ms(lambda: ball_query(xyz, nxs, r, ns), 20))
            ps.append(cuda_ms(lambda: ball_query_plain(xyz, nxs, r, ns), 2))
            Bn, Nn, Mn = xyz.shape[0], xyz.shape[1], nxs.shape[1]
            idx = ball_query_plain(xyz, nxs, r, ns)
            full = ball_count_plain(xyz, nxs, r) >= ns
            scanned = torch.where(full, idx[..., ns - 1].long() + 1,
                                  torch.full_like(full, Nn, dtype=torch.long))
            nb_, ops_ = 12 * Bn * (Nn + Mn) + 4 * Bn * Mn * ns, 8 * int(scanned.sum())
            bs.append(bound_ms(nb_, {"float32": ops_})[0])
            nb, ops = nb + nb_, ops + ops_
        per_stage["ball_query"] = {"kernel_ms": ks, "plain_ms": ps, "bound_ms": bs}
        entry("ball_query", csrc + "ball_query.cu", "genpose2_tpu/ops/ball_query_pallas.py:139",
              sum(ks), sum(ps), nb, {"float32": ops})
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
        # the per-scale SA kernel and the SA kernel from indices: the two
        # scale launches of the dense stage 0 (B=64, N=2048, M=512). Bound:
        # the MLP chain's operations over the real rows of this run's data
        # (min(count, nsample), or 1), plus for the scale kernel 9 per
        # distance test over the points each centroid scans before its
        # nsample-th hit (all N when it has fewer)
        for dtype in ("float32", "bfloat16"):
            sfx = "" if dtype == "float32" else ".bf16"
            nxs, (projs, centers, affs, wss), radii, nsamples = dense0[dtype]
            esize = 2 if dtype == "bfloat16" else 4
            Bn, Nn, Mn = pts_dense.shape[0], pts_dense.shape[1], nxs.shape[1]
            t_ = {k: [] for k in ("scale", "scale_plain", "idx", "idx_plain")}
            cost = {"scale": [0, 0, 0], "idx": [0, 0, 0]}  # bytes, f32 ops, MLP ops
            for sc in range(len(radii)):
                op, r, ns = (projs[sc], centers[sc], affs[sc], wss[sc]), radii[sc], nsamples[sc]
                idx = ball_query_plain(pts_dense, nxs, r, ns)
                t_["scale"].append(cuda_ms(lambda: fused_sa_scale(pts_dense, nxs, *op, r, ns), 10))
                t_["scale_plain"].append(cuda_ms(
                    lambda: fused_sa_scale_plain(pts_dense, nxs, *op, r, ns), 2))
                t_["idx"].append(cuda_ms(lambda: fused_group_mlp_pool(op[0], idx, *op[1:]), 10))
                t_["idx_plain"].append(cuda_ms(
                    lambda: fused_group_mlp_pool_plain(op[0], idx, *op[1:]), 2))
                cnt = ball_count_plain(pts_dense, nxs, r)
                rows = int(cnt.clamp(max=ns).clamp(min=1).sum())
                scanned = int(torch.where(cnt >= ns, idx[..., ns - 1].long() + 1,
                                          torch.full_like(cnt, Nn, dtype=torch.long)).sum())
                h1 = op[0].shape[-1]
                macs = sum(w.shape[0] * w.shape[1] for w in op[3])
                c_out = op[3][-1].shape[1] if op[3] else h1
                common = (Bn * Nn * h1 * esize + Bn * Mn * h1 * 4 + macs * esize
                          + sum(2 * 4 * a.numel() for a, _ in op[2]) + Bn * Mn * c_out * 4)
                mlp_ops = rows * (2 * macs + 4 * h1)
                for key, extra, scan in (("scale", 12 * Bn * (Nn + Mn), 9 * scanned),
                                         ("idx", 4 * Bn * Mn * ns, 0)):
                    cost[key][0] += common + extra
                    cost[key][1] += scan
                    cost[key][2] += mlp_ops
            per_stage["fused_sa_scale" + sfx] = {"kernel_ms": t_["scale"],
                                                 "plain_ms": t_["scale_plain"]}
            per_stage["fused_group_mlp_pool" + sfx] = {"kernel_ms": t_["idx"],
                                                       "plain_ms": t_["idx_plain"]}
            for name, key in (("fused_sa_scale", "scale"), ("fused_group_mlp_pool", "idx")):
                nb, f32_ops, mlp_ops = cost[key]
                ops = ({"float32": f32_ops + mlp_ops} if dtype == "float32"
                       else {"float32": f32_ops, dtype: mlp_ops})
                replaces = {"fused_sa_scale": "genpose2_tpu/ops/fused_sa.py:337",
                            "fused_group_mlp_pool": "genpose2_tpu/ops/fused_sa.py:121"}[name]
                entry(name + sfx, csrc + "fused_sa.cu", replaces, sum(t_[key]),
                      sum(t_[key + "_plain"]), nb, ops)
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

        # the three ViT attention entries, one launch each, at the request's
        # B=64 and at a frame call's B=12 (N_OBJ, the first objects of the same
        # inputs): the padded axis (rope=False and RoPE) and the unpadded
        # 261 tokens. Operations: 4 per score element per head-dim column (the
        # two products) in the input type, 5 per score element (scale, mask,
        # max, exp, sum) in float32; RoPE adds 6 per q and k element and the
        # two tables. Library: scaled_dot_product_attention on the 261 real
        # tokens, head-major (for RoPE after the elementwise rotation in the
        # input dtype)
        hd = vit_dim // vit_heads

        def vit_timing(dtype, Bt, run, plain, library, n_tok, rope):
            esize = 2 if dtype == "bfloat16" else 4
            scores = Bt * vit_heads * n_tok * n_tok
            rope_ops = 6 * 2 * Bt * n_tok * vit_dim if rope else 0
            ops = ({dtype: 4 * scores * hd, "float32": 5 * scores + rope_ops}
                   if dtype != "float32" else {"float32": 4 * scores * hd + 5 * scores + rope_ops})
            nbytes = (3 * Bt * n_tok * vit_dim * esize + Bt * n_tok * vit_dim * 4
                      + (2 * n_tok * hd * 4 if rope else 0))
            ms, lms = cuda_ms(run, 20), cuda_ms(library, 20)
            pms = cuda_ms(plain, 5) if plain is not None else None
            return ms, pms, lms, nbytes, ops

        def heads(t):
            Bt = t.shape[0]
            return t[:, :n_valid].reshape(Bt, n_valid, vit_heads, hd).transpose(1, 2).contiguous()

        for dtype in ("float32", "bfloat16"):
            sfx = "" if dtype == "float32" else ".bf16"
            for name, rope in (("vit_attention", False), ("vit_attention_unpadded", False),
                               ("vit_attention_rope", True)):
                measured = {}
                for Bt in (B, N_OBJ):
                    src = unpadded_in[dtype] if name == "vit_attention_unpadded" else vit_in[dtype]
                    q, k, v = (t[:Bt].contiguous() for t in src)
                    qh, kh, vh = heads(q), heads(k), heads(v)
                    sn, cs = rope_in[dtype]
                    n_tok = q.shape[1]
                    if name == "vit_attention_unpadded":
                        def run(q=q, k=k, v=v):
                            return vit_attention(q, k, v, vit_heads)

                        def plain(q=q, k=k, v=v):
                            return vit_attention_plain(q, k, v, vit_heads)
                    else:
                        tab = {"sin": sn, "cos": cs} if rope else {}

                        def run(q=q, k=k, v=v, tab=tab):
                            return vit_attention_tm(q, k, v, vit_heads, n_valid, **tab)

                        def plain(q=q, k=k, v=v, tab=tab):
                            return vit_attention_tm_plain(q, k, v, vit_heads, n_valid, **tab)
                    if rope:
                        sn_h, cs_h = sn[:n_valid].to(q.dtype), cs[:n_valid].to(q.dtype)

                        def library(qh=qh, kh=kh, vh=vh, sn_h=sn_h, cs_h=cs_h):
                            def rot(t):
                                return t * cs_h + torch.cat([-t[..., hd // 2:], t[..., :hd // 2]],
                                                            -1) * sn_h
                            return F.scaled_dot_product_attention(rot(qh), rot(kh), vh)
                    else:
                        def library(qh=qh, kh=kh, vh=vh):
                            return F.scaled_dot_product_attention(qh, kh, vh)
                    measured[Bt] = vit_timing(dtype, Bt, run,
                                              plain if Bt == B else None, library, n_tok, rope)
                ms, pms, lms, nbytes, ops = measured[B]
                ms12, _, lms12, nbytes12, ops12 = measured[N_OBJ]
                b12, _ = bound_ms(nbytes12, ops12)
                line = "107" if name == "vit_attention_unpadded" else "203"
                entry(name + sfx, csrc + "vit_attention.cu",
                      "genpose2_tpu/ops/vit_attention.py:" + line, ms, pms, nbytes, ops, lms,
                      frame_batch={"B": N_OBJ, "ms": ms12, "library_ms": lms12,
                                   "bound_ms": b12})

        # the ViT's switch kernels, one launch each. LayerNorm of the stream
        # (64, 272, 384): 8 operations per element; library: F.layer_norm in
        # the stream's dtype
        for dtype in ("float32", "bfloat16"):
            sfx = "" if dtype == "float32" else ".bf16"
            x, sc, bi = ln_vit_in[dtype]
            ms = cuda_ms(lambda: fast_layernorm(x, sc, bi), 50)
            pms = cuda_ms(lambda: fast_layernorm_plain(x, sc, bi), 10)
            lms = cuda_ms(lambda: F.layer_norm(x, x.shape[-1:], sc.to(x.dtype), bi.to(x.dtype),
                                               LN_EPS), 50)
            entry("layernorm" + sfx, csrc + "layernorm.cu", "genpose2_tpu/ops/layernorm.py:154",
                  ms, pms, 2 * x.numel() * x.element_size() + 2 * sc.numel() * 4,
                  {"float32": 8 * x.numel()}, lms)
        emit({"phase": "timing", "ok": True, "per_stage_ms": per_stage,
              "request_ms": [{"path": r["path"], "dtype": r["dtype"], "ms": r["ms"]}
                             for r in per_request],
              "note": "ms of fused_sa_stage and relpe_attention entries: the four stage launches "
                      "of one encoder forward; fused_sa_scale and fused_group_mlp_pool: the two "
                      "scale launches of the dense stage 0; library_ms of vit_attention_rope: "
                      "the elementwise rotation of q and k, then SDPA; the ViT attention "
                      "entries' frame_batch: the same launch at a frame call's batch; "
                      "residual_layernorm: its "
                      "eight "
                      "launches; ball_query: the eight launches of one training step; "
                      "launches: summed over the requests, the frame calls and the counted "
                      "train steps"})

    timing()

    @phase("profile")
    def profile():
        """Device time by kernel name over one bf16 flagship request and one
        float32-setting flagship train step, and the device's busy share
        against the unprofiled warm time of the same work."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        def profiled(name, fn):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            warm_ms = 1e3 * (time.perf_counter() - t0)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            rows = [(ev.device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows)
            emit({"phase": "profile", "ok": True, "run": name, "device_ms": busy,
                  "warm_ms": warm_ms, "busy_share": busy / warm_ms,
                  "top": [{"ms": t, "calls": c, "name": k[:120]} for t, c, k in rows[:25]]})

        raw, prior = new_request("pointwise", "bfloat16")
        profiled("request pointwise bfloat16", lambda: serve("pointwise", "bfloat16", raw, prior))
        graw, gprior = new_request("global", "bfloat16")
        profiled("request global bfloat16", lambda: serve("global", "bfloat16", graw, gprior))
        for path in ("pointwise", "dense"):  # a bf16 tracking call's device part
            if (path, "bfloat16") in frame_runs:
                engine, fraw, fprev = frame_runs[(path, "bfloat16")]
                profiled(f"frame {path} bfloat16 tracking",
                         lambda: engine.serve_batch(fraw, fprev, True))
        if "float32" in train_agents:
            agent, state = train_agents["float32"]
            batch = train_batch()
            g = torch.Generator(device=dev).manual_seed(SEED + 2)
            profiled("train step float32 setting", lambda: agent.train_step(state, batch, g))

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
