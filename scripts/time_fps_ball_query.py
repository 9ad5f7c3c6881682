#!/usr/bin/env python3
"""Time FPS and ball query on one card beside a parent checkout's kernels,
and time the variants their launch plans choose among; every run's indices
are checked against the plain versions.

    python3 scripts/time_fps_ball_query.py --parent DIR [--out FILE]
        [--phases fps,fps_wide,ball_query]

Shapes are the paths': FPS picks min(N/2, 512) of N in (128, 256, 512, 1024,
2048) points (the module encoder's chain, the fast encoder's 1,024 -> 512,
the dense path's 2,048 -> 512) of B in (12, 64, 192) of chip_smoke.py's
ellipsoid clouds; ``fps_wide``: the wide route at B = 12, 16,384 -> 512 and
32,768 -> 1,024 (alternated only; a parent that refuses them records the
error); ball query at the module encoder's eight launches (stage N / M
1024/512 ... 128/64, both radii and nsample of ``PointNet2Config``,
centroids by FPS) at B = 64, 12 and 192.

Parent against plan: DIR's ``fps.cu`` and ``ball_query.cu`` are built with
the port's nvcc flags and swapped into the port's wrappers
(``_cuda._libs``), so both run the same host path. They alternate parent,
plan, plan, parent; each turn records ``events_ms`` (CUDA events around 20
back-to-back wrapper calls, host work included) and ``device_ms``
(torch.profiler, chip_smoke.py's). FPS per pick: (device ms at npoint picks -
at 2 picks) / (npoint - 2).

Variants: each source is built once more, with ``-Xptxas -v`` (its registers
and spills go to FILE), beside an entry that takes the plan's choice from
the caller (FPS: warps and points a thread; ball query: warps, one centroid
each). ``queued_ms``: CUDA events around launches queued behind a busy-wait
kernel, so that the card runs them without host gaps. The build, the
swap and the log are ``kernel_ab.py``'s.

Prints one JSON line per measurement and writes them to FILE.
"""

import argparse
import ctypes
import itertools
import os
import sys

from kernel_ab import ROOT, Log, build_all, checked, library_of, load_smoke, stream

# the sources with an entry that takes the plan's choice (same translation unit)
VARIANT_ENTRIES = {
    "fps": """#include "fps.cu"
extern "C" int gp2_fps_variant(const float* xyz, int B, int N, int npoint, int warps, int p,
                               int* out, void* stream) {
  FpsPlan plan;
  fps_layout(N, warps, p, 0, &plan);
  return static_cast<int>(launch_plan(xyz, B, N, npoint, plan, nullptr, out, stream));
}
""",
    "ball_query": """#include "ball_query.cu"
extern "C" int gp2_ball_query_variant(const float* xyz, const float* new_xyz, int B, int N,
                                      int M, float r2, int nsample, int warps, int* out,
                                      void* stream) {
  BallQueryPlan plan;
  ball_query_layout(B, N, M, warps, &plan);
  return static_cast<int>(launch_plan(xyz, new_xyz, B, N, M, r2, nsample, plan, out, stream));
}
""",
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose fps.cu and ball_query.cu to time beside")
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "time_fps_ball_query.jsonl"))
    ap.add_argument("--phases", default="fps,fps_wide,ball_query",
                    help="comma-separated, of fps, fps_wide and ball_query")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("time_fps_ball_query: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from genpose2_tpu_torch.config import PointNet2Config
    from genpose2_tpu_torch.ops.ball_query import ball_query, ball_query_plain, radius_sq
    from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from genpose2_tpu_torch.ops.grouping import gather_points

    smoke = load_smoke()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(smoke.SEED)
    log = Log(args.out)
    emit = log.emit
    libs, ptxas = build_all(args.parent, os.path.join(ROOT, ".chipcheck", "fps_bq_build"),
                            VARIANT_ENTRIES)
    for name, lines in ptxas.items():
        emit({"ptxas": name, "lines": lines})
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fps_var, bq_var = libs["variant", "fps"], libs["variant", "ball_query"]
    fps_var.gp2_fps_variant.argtypes = [ptr] + [c_int] * 5 + [ptr, ptr]
    bq_var.gp2_ball_query_variant.argtypes = [ptr, ptr] + [c_int] * 3 + [ctypes.c_float] \
        + [c_int] * 2 + [ptr, ptr]
    queued_ms = smoke.queued_ms

    turns = ("parent", "plan", "plan", "parent")

    # ------------------------------------------------------------------ FPS
    fps_shapes = itertools.product((12, 64, 192), (128, 256, 512, 1024, 2048))
    for B, N in fps_shapes if "fps" in phases else ():
        xyz = smoke.object_clouds(gen, dev, B, N).contiguous()
        npoint = min(N // 2, 512)
        want = fps_plain(xyz, npoint)
        out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
        shape = {"kernel": "fps", "B": B, "N": N, "npoint": npoint}
        for warps, p in itertools.product((1, 2, 4, 8, 16), (4, 8, 16, 32)):
            slots = warps * 32 * p
            if slots < N or slots > max(2 * N, 128) or slots > 8192:
                continue

            def var(n, warps=warps, p=p):
                checked(fps_var.gp2_fps_variant(xyz.data_ptr(), B, N, n, warps, p,
                                                out.data_ptr(), stream()), "fps")
            out.fill_(-5)
            var(npoint)
            mism = int((out != want).sum())
            ms, ms2 = queued_ms(lambda: var(npoint), 5), queued_ms(lambda: var(2), 20)
            emit({**shape, "variant": f"w{warps}_p{p}", "queued_ms": ms, "queued_ms_2picks": ms2,
                  "per_pick_us": 1e3 * (ms - ms2) / (npoint - 2), "mismatches": mism})
        for i, turn in enumerate(turns):
            with library_of(libs, turn, "fps"):
                got = furthest_point_sample(xyz, npoint)
                ms, ms2 = (smoke.device_ms(lambda n=n: furthest_point_sample(xyz, n), "fps_kernel")
                           for n in (npoint, 2))
                ev = smoke.cuda_ms(lambda: furthest_point_sample(xyz, npoint), 20)
            emit({**shape, "variant": turn, "turn": i, "events_ms": ev, "device_ms": ms,
                  "device_ms_2picks": ms2, "per_pick_us": 1e3 * (ms - ms2) / (npoint - 2),
                  "mismatches": int((got != want).sum())})

    # the wide route past 8,192 points (chip_smoke.py's shapes), alternated
    # only: a parent without the route refuses these clouds, and its turns
    # record the error
    for B, N, npoint in ((12, 16384, 512), (12, 32768, 1024)) if "fps_wide" in phases else ():
        xyz = smoke.object_clouds(gen, dev, B, N).contiguous()
        want = fps_plain(xyz, npoint)
        shape = {"kernel": "fps", "B": B, "N": N, "npoint": npoint}
        for i, turn in enumerate(turns):
            with library_of(libs, turn, "fps"):
                try:
                    got = furthest_point_sample(xyz, npoint)
                    ms, ms2 = (smoke.device_ms(lambda n=n: furthest_point_sample(xyz, n), "fps_")
                               for n in (npoint, 2))
                    qv = smoke.queued_ms(lambda: furthest_point_sample(xyz, npoint), 3)
                except (RuntimeError, ValueError) as err:
                    emit({**shape, "variant": turn, "turn": i, "error": str(err)})
                    continue
            emit({**shape, "variant": turn, "turn": i, "device_ms": ms, "queued_ms": qv,
                  "device_ms_2picks": ms2, "per_pick_us": 1e3 * (ms - ms2) / (npoint - 2),
                  "mismatches": int((got != want).sum())})

    # ------------------------------------------------------------ ball query
    cfg = PointNet2Config()
    for B in (64, 12, 192) if "ball_query" in phases else ():
        stages, xyz_k = [], smoke.object_clouds(gen, dev, B, 1024)
        for npoint, radii, nsamples in zip(cfg.npoints, cfg.radii, cfg.nsamples):
            if npoint is None:
                break
            new_k = gather_points(xyz_k, fps_plain(xyz_k, npoint)).contiguous()
            stages += [(xyz_k.contiguous(), new_k, r, ns) for r, ns in zip(radii, nsamples)]
            xyz_k = new_k
        totals = {}
        for si, (xyz, nxs, r, ns) in enumerate(stages):
            Bn, Nn, Mn = xyz.shape[0], xyz.shape[1], nxs.shape[1]
            want = ball_query_plain(xyz, nxs, r, ns)
            out = torch.empty((Bn, Mn, ns), dtype=torch.int32, device=dev)
            shape = {"kernel": "ball_query", "B": Bn, "N": Nn, "M": Mn, "radius": r,
                     "nsample": ns, "stage": si}
            for warps in (1, 2, 4, 8):
                def var(warps=warps):
                    checked(bq_var.gp2_ball_query_variant(
                        xyz.data_ptr(), nxs.data_ptr(), Bn, Nn, Mn, radius_sq(r), ns, warps,
                        out.data_ptr(), stream()), "ball_query")
                out.fill_(-5)
                var()
                mism = int((out != want).sum())
                ms = queued_ms(var, 20)
                key = f"w{warps}"
                totals[key] = totals.get(key, 0.0) + ms
                emit({**shape, "variant": key, "queued_ms": ms, "mismatches": mism})
            for i, turn in enumerate(turns):
                with library_of(libs, turn, "ball_query"):
                    def call():
                        return ball_query(xyz, nxs, r, ns)
                    got = call()
                    ev, dv = smoke.cuda_ms(call, 20), smoke.device_ms(call, "ball_query_kernel")
                for k, v in ((f"{turn}{i}_events", ev), (f"{turn}{i}_device", dv)):
                    totals[k] = totals.get(k, 0.0) + v
                emit({**shape, "variant": turn, "turn": i, "events_ms": ev, "device_ms": dv,
                      "mismatches": int((got != want).sum())})
        emit({"kernel": "ball_query", "B": B, "eight_launches_ms": totals})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
