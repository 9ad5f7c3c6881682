#!/usr/bin/env python3
"""Time FPS and ball query on one card beside a parent checkout's kernels,
and time the variants their launch plans choose among; every run's indices
are checked against the plain versions.

    python3 scripts/time_fps_ball_query.py --parent DIR [--out FILE]

Shapes are the paths': FPS picks min(N/2, 512) of N in (128, 256, 512, 1024,
2048) points (the module encoder's chain, the fast encoder's 1,024 -> 512,
the dense path's 2,048 -> 512) of B in (12, 64, 192) of chip_smoke.py's
ellipsoid clouds; ball query at the module encoder's eight launches (stage N
/ M 1024/512 ... 128/64, both radii and nsample of ``PointNet2Config``,
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
kernel, so that the card runs them without host gaps.

Prints one JSON line per measurement and writes them to FILE.
"""

import argparse
import contextlib
import ctypes
import importlib.util
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sources with an entry that takes the plan's choice (same translation unit)
VARIANT_ENTRIES = {
    "fps": """#include "fps.cu"
extern "C" int gp2_fps_variant(const float* xyz, int B, int N, int npoint, int warps, int p,
                               int* out, void* stream) {
  FpsPlan plan;
  fps_layout(N, warps, p, &plan);
  return static_cast<int>(launch_plan(xyz, B, N, npoint, plan, out, stream));
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


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_all(parent, out_dir):
    """{("parent" | "variant", name): loaded library, ...}, one nvcc each, all
    started together; the variants' ptxas reports beside them."""
    from genpose2_tpu_torch.ops import _cuda

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("fps", "ball_query"):
        src = os.path.join(out_dir, f"{name}_variant.cu")
        with open(src, "w") as f:
            f.write(VARIANT_ENTRIES[name])
        jobs = {("variant", name): (str(_cuda.CSRC), src, ["-Xptxas", "-v"]),
                ("parent", name): (os.path.join(parent, "genpose2_tpu_torch", "ops", "csrc"),
                                   None, [])}
        for key, (csrc, src_, extra) in jobs.items():
            out = os.path.join(out_dir, f"lib{key[0]}_{name}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *extra, "-I", csrc, "-o", out,
                   src_ or os.path.join(csrc, f"{name}.cu")]
            procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True), out)
    libs, ptxas = {}, {}
    for key, (proc, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}: {err}")
        libs[key] = ctypes.CDLL(out)
        if key[0] == "variant":
            ptxas[key[1]] = [ln.strip() for ln in err.splitlines()
                             if "entry function" in ln or "registers" in ln or "spill" in ln]
    return libs, ptxas


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose fps.cu and ball_query.cu to time beside")
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "time_fps_ball_query.jsonl"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_fps_ball_query: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from genpose2_tpu_torch.config import PointNet2Config
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.ops.ball_query import ball_query, ball_query_plain, radius_sq
    from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
    from genpose2_tpu_torch.ops.grouping import gather_points

    smoke = load_smoke()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(smoke.SEED)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    sink = open(args.out, "w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    emit({"device": smi, "torch": torch.__version__})
    libs, ptxas = build_all(args.parent, os.path.join(ROOT, ".chipcheck", "fps_bq_build"))
    for name, lines in ptxas.items():
        emit({"ptxas": name, "lines": lines})
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fps_var, bq_var = libs["variant", "fps"], libs["variant", "ball_query"]
    fps_var.gp2_fps_variant.argtypes = [ptr] + [c_int] * 5 + [ptr, ptr]
    bq_var.gp2_ball_query_variant.argtypes = [ptr, ptr] + [c_int] * 3 + [ctypes.c_float] \
        + [c_int] * 2 + [ptr, ptr]
    for name in ("fps", "ball_query"):
        _cuda.library(name)  # this checkout's, built before any swap

    def queued_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # a few ms of busy-wait: the launches queue behind it
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    @contextlib.contextmanager
    def library_of(turn, name):
        """The wrapper's library: this checkout's ("plan") or the parent's."""
        own = _cuda._libs[name]
        if turn == "parent":
            _cuda._libs[name] = libs["parent", name]
        try:
            yield
        finally:
            _cuda._libs[name] = own

    def checked(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    turns = ("parent", "plan", "plan", "parent")

    # ------------------------------------------------------------------ FPS
    for B, N in itertools.product((12, 64, 192), (128, 256, 512, 1024, 2048)):
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
            with library_of(turn, "fps"):
                got = furthest_point_sample(xyz, npoint)
                ms, ms2 = (smoke.device_ms(lambda n=n: furthest_point_sample(xyz, n), "fps_kernel")
                           for n in (npoint, 2))
                ev = smoke.cuda_ms(lambda: furthest_point_sample(xyz, npoint), 20)
            emit({**shape, "variant": turn, "turn": i, "events_ms": ev, "device_ms": ms,
                  "device_ms_2picks": ms2, "per_pick_us": 1e3 * (ms - ms2) / (npoint - 2),
                  "mismatches": int((got != want).sum())})

    # ------------------------------------------------------------ ball query
    cfg = PointNet2Config()
    for B in (64, 12, 192):
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
                with library_of(turn, "ball_query"):
                    def call():
                        return ball_query(xyz, nxs, r, ns)
                    got = call()
                    ev, dv = smoke.cuda_ms(call, 20), smoke.device_ms(call, "ball_query_kernel")
                for k, v in ((f"{turn}{i}_events", ev), (f"{turn}{i}_device", dv)):
                    totals[k] = totals.get(k, 0.0) + v
                emit({**shape, "variant": turn, "turn": i, "events_ms": ev, "device_ms": dv,
                      "mismatches": int((got != want).sum())})
        emit({"kernel": "ball_query", "B": B, "eight_launches_ms": totals})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
