#!/usr/bin/env python3
"""Time the port's warm flagship bf16 request and warm tracking call, for
comparing two checkouts of the port on one card.

    python3 scripts/ab_torch_serving.py --root DIR [--label NAME] [--reps N]

imports ``genpose2_tpu_torch`` from the checkout at DIR (its kernels built
there) and drives it with this script's own settings, so two checkouts run
the same work: chip_smoke.py's flagship bf16 request (B=64 objects, 1,024
points, K=50, 50 RK4 steps from T0 0.55, energies, aggregation, scale) and
GenPose2's device part (``serve_batch``) of a tracking call on a synthetic
640x480 frame of 12 objects (K=50, 100 steps from T0 0.15). Weights and
inputs are drawn from seed 0. Times are on the host clock around calls that
end in a synchronize, after two warm-up calls; then one call of each under
torch.profiler gives the card's kernel time. Run the checkouts alternately
(A, B, B, A) in one session: each process prints one JSON line.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_smoke():
    """chip_smoke.py of this script's checkout, by path: its seed and helpers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(fn):
    """The card's kernel time (ms) of one call of fn, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose genpose2_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=8, help="timed calls of each kind")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    smoke = load_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import genpose2_tpu_torch
    from genpose2_tpu_torch.api import GenPose2
    from genpose2_tpu_torch.config import ModelConfig, PointNet2Config, default_config
    from genpose2_tpu_torch.data import synthetic_frame
    from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.so3.rotations import matrix_to_rot6d_cols

    if not os.path.abspath(genpose2_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {genpose2_tpu_torch.__file__}, not from {root}")
    torch.manual_seed(smoke.SEED)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(smoke.SEED)
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0

    dtype = "bfloat16"
    cfg = default_config().replace(model=ModelConfig(
        dino="pointwise", pointnet2=PointNet2Config(compute_dtype=dtype),
        backbone_dtype=dtype, score_dtype=dtype))
    engine = GenPose2(cfg, score=True, energy=True, scale=True, device=dev)
    s, e, sc = engine.score_agent, engine.energy_agent, engine.scale_agent
    for agent in (s, e):
        smoke.randomize(agent.model, gen)
        if agent.provider is not None:
            smoke.randomize(agent.provider.vit, gen)
    smoke.randomize(sc.model, gen)

    # the request: chip_smoke.py's flagship bf16 request
    B, K, S = smoke.B, smoke.K, smoke.S
    pts = smoke.object_clouds(gen, dev, B, cfg.model.num_points)
    raw = {"pts": pts, "pts_center": pts.mean(1),
           "roi_rgb": torch.randn(B, S, S, 3, generator=gen).to(dev),
           "roi_xs": torch.randint(0, S, (B, cfg.model.num_points), generator=gen).to(dev),
           "roi_ys": torch.randint(0, S, (B, cfg.model.num_points), generator=gen).to(dev)}
    prior = s.sde.prior_sample((B * K, 9), T=smoke.T0, generator=gen).to(dev)

    def request():
        batch = s.with_image_features(raw)
        feats = s.extract_features(batch)
        poses = s.sample_candidates(batch, repeat_num=K, T0=smoke.T0, method="fixed",
                                    num_steps=smoke.STEPS, features=feats, prior=prior)
        en = e.get_energy(batch, poses, fixed_t=1e-5)
        ev = cfg.eval
        agg = aggregate_candidates(poses, en, retain_ratio=ev.retain_ratio,
                                   clustering=ev.clustering, eps=ev.clustering_eps,
                                   minpts_ratio=ev.clustering_minpts_ratio)
        return sc.predict(feats[0], agg["rotation"])

    # the tracking call: a detection call on frame 0, then tracking calls on
    # frame 1 fed with the detection's pose (the front end, on the host, is
    # run once and not timed)
    frng = np.random.default_rng(smoke.SEED)
    W, H, focal, n_obj = 640, 480, 600.0, 12
    objs = synthetic_frame.random_scene(frng, n_obj, W, H, focal)
    f0 = engine.front_end(synthetic_frame.render(frng, objs, W, H, focal))
    f1 = engine.front_end(synthetic_frame.render(frng, synthetic_frame.moved(frng, objs),
                                                 W, H, focal))
    agg = engine.serve_batch(f0, None, False)["aggregate"]
    prev = torch.cat([matrix_to_rot6d_cols(agg["rotation"]), agg["translation"]], dim=-1)

    def tracking():
        return engine.serve_batch(f1, prev, True)

    out = {"label": args.label or root, "root": root, "build_s": build_s}
    for name, fn in (("request", request), ("tracking", tracking)):
        for _ in range(2):
            wall_ms(fn)
        _cuda.reset_launch_counts()
        times = [wall_ms(fn) for _ in range(args.reps)]
        relpe = _cuda.launch_counts["relpe_attention"] / args.reps
        out[name] = {"wall_ms": times, "wall_ms_median": statistics.median(times),
                     "device_ms": kernel_ms(fn), "relpe_launches_per_call": relpe}
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
