#!/usr/bin/env python3
"""Time ball count and the LayerNorm kernels on one card beside a parent
checkout's, and time the variants of the new designs; every run's output is
checked against the plain version.

    python3 scripts/time_ball_count_layernorm.py --parent DIR [--out FILE]

Shapes are the paths' (chip_smoke.py's clouds and draws): ball count at the
dense stage's centroid order, M = 512 centroids (FPS picks) of 1,024 points,
r = 0.02, at a request's B = 64 and a frame call's B = 12, and of the dense
path's 2,048 points at B = 64; ``fast_layernorm`` on the ViT's (64, 272,
384) stream in bf16 and float32; ``fast_add_layernorm`` on the same bf16
stream; ``fast_residual_layernorm`` at the Fus encoder's four stage shapes
(float32, B = 64).

Parent against this checkout: DIR's ``ball_count.cu`` and ``layernorm.cu``
are built with the port's nvcc flags and swapped into the port's wrappers
(``_cuda._libs``), so both run the same host path. They alternate parent,
new, new, parent; each turn records ``device_ms`` (torch.profiler,
chip_smoke.py's ``device_ms``: the kernel alone; null when the profiler
recorded no launch), ``queued_ms`` (chip_smoke.py's: CUDA events around
launches queued behind a busy-wait kernel, the kernels without the host's
gaps) and ``events_ms`` (CUDA events around 50 back-to-back wrapper calls,
host work included); and for
``fast_layernorm`` and ``fast_add_layernorm`` (bf16) the events of each
tree's own wrapper module with its own kernel.

Variants, from a translation unit of their own that includes each source
and adds an entry taking the choice (built with ``-Xptxas -v``: registers and
spills go to FILE): ball count's (centroid lanes, centroids a thread) at each
shape; LayerNorm's scalar and vector routes at D = 384 (every entry takes
the vector one there), each by ``queued_ms``. The build, the swap and the
log are ``kernel_ab.py``'s, as in time_fps_ball_query.py.

Prints one JSON line per measurement and writes them to FILE.
"""

import argparse
import ctypes
import importlib.util
import os
import sys

from kernel_ab import ROOT, Log, build_all, checked, library_of, load_smoke, stream

VARIANT_ENTRIES = {
    "ball_count": """#include "ball_count.cu"
extern "C" int gp2_ball_count_variant(const float* xyz, const float* new_xyz, int B, int N, int M,
                                      float r2, int lanes, int cpt, int* out, void* stream) {
  BallCountPlan plan;
  ball_count_layout(B, N, M, lanes, cpt, &plan);
  return static_cast<int>(launch_plan(xyz, new_xyz, B, N, M, r2, plan, out, stream));
}
""",
    "layernorm": """#include "layernorm.cu"
template <typename T>
cudaError_t variant(const void* x, const float* sc, const float* bi, void* ln, int rows, int D,
                    float eps, int route, cudaStream_t s) {
  if (D != 384) return cudaErrorInvalidValue;
  return route == 0
             ? launch_vpt<T, 12>(x, nullptr, nullptr, sc, bi, nullptr, ln, rows, D, eps, s)
             : launch_vec<T, 3>(x, nullptr, nullptr, sc, bi, nullptr, ln, rows, D, eps, s);
}
extern "C" int gp2_ln_variant(const void* x, const float* sc, const float* bi, void* ln,
                              int rows, int D, float eps, int bf16, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? variant<__nv_bfloat16>(x, sc, bi, ln, rows, D, eps, route, s)
                               : variant<float>(x, sc, bi, ln, rows, D, eps, route, s));
}
""",
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose ball_count.cu and layernorm.cu to time beside")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "results", "time_ball_count_layernorm.jsonl"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_ball_count_layernorm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain, radius_sq
    from genpose2_tpu_torch.ops.fps import fps_plain
    from genpose2_tpu_torch.ops.grouping import gather_points
    from genpose2_tpu_torch.ops.layernorm import (LN_EPS, fast_add_layernorm,
                                                  fast_add_layernorm_plain, fast_layernorm,
                                                  fast_layernorm_plain, fast_residual_layernorm,
                                                  fast_residual_layernorm_plain)

    smoke = load_smoke()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(smoke.SEED)
    log = Log(args.out)
    emit = log.emit
    libs, ptxas = build_all(args.parent, os.path.join(ROOT, ".chipcheck", "bc_ln_build"),
                            VARIANT_ENTRIES)
    for name, lines in ptxas.items():
        emit({"ptxas": name, "lines": lines})
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    bc_var, ln_var = libs["variant", "ball_count"], libs["variant", "layernorm"]
    bc_var.gp2_ball_count_variant.argtypes = [ptr, ptr] + [c_int] * 3 + [ctypes.c_float] \
        + [c_int] * 2 + [ptr, ptr]
    ln_var.gp2_ln_variant.argtypes = [ptr] * 4 + [c_int] * 2 + [ctypes.c_float] + [c_int] * 2 \
        + [ptr]

    def queued_ms(fn, reps=50):
        return smoke.queued_ms(fn, reps)

    turns = ("parent", "new", "new", "parent")

    def alternate(shape, name, kernel, call, check):
        """parent, new, new, parent through the wrapper; each turn's device,
        queued and events ms, and whether check(call()) held."""
        for i, turn in enumerate(turns):
            with library_of(libs, turn, name):
                ok = check(call())
                try:
                    dv = smoke.device_ms(call, kernel, reps=20)
                except smoke.ProfilerMiss:  # no launch recorded: queued_ms stands
                    dv = None
                qv, ev = smoke.queued_ms(call, 50), smoke.cuda_ms(call, 50)
            emit({**shape, "variant": turn, "turn": i, "device_ms": dv, "queued_ms": qv,
                  "events_ms": ev, "exact" if name == "ball_count" else "within": ok})

    # ---------------------------------------------------------- ball count
    for B, N in ((64, 1024), (12, 1024), (64, 2048)):
        xyz = smoke.object_clouds(gen, dev, B, N).contiguous()
        nxs = gather_points(xyz, fps_plain(xyz, 512)).contiguous()
        want = ball_count_plain(xyz, nxs, 0.02)
        out = torch.empty((B, 512), dtype=torch.int32, device=dev)
        shape = {"kernel": "ball_count", "B": B, "N": N, "M": 512, "radius": 0.02}
        for lanes, cpt in ((32, 4), (32, 2), (16, 4), (16, 2), (8, 4), (8, 2), (8, 1)):
            def var(lanes=lanes, cpt=cpt):
                checked(bc_var.gp2_ball_count_variant(xyz.data_ptr(), nxs.data_ptr(), B, N, 512,
                                                      radius_sq(0.02), lanes, cpt,
                                                      out.data_ptr(), stream()), "ball_count")
            out.fill_(-5)
            var()
            emit({**shape, "variant": f"l{lanes}_c{cpt}", "queued_ms": queued_ms(var),
                  "mismatches": int((out != want).sum())})
        alternate(shape, "ball_count", "ball_count_kernel", lambda: ball_count(xyz, nxs, 0.02),
                  lambda got: bool(torch.equal(got, want)))

    # ----------------------------------------------------------- LayerNorm
    def close(tol):
        def check(pair):
            got, want = pair
            return bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
        return check

    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        x = torch.randn(B_VIT, N_VIT, D_VIT, generator=gen).to(dev, dtype)
        sc, bi = (torch.randn(D_VIT, generator=gen).to(dev) for _ in range(2))
        want = fast_layernorm_plain(x, sc, bi)
        ln = torch.empty_like(x)
        shape = {"kernel": "layernorm", "dtype": str(dtype), "shape": [B_VIT, N_VIT, D_VIT]}
        for route in (0, 1):
            def var(route=route):
                checked(ln_var.gp2_ln_variant(x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                              ln.data_ptr(), B_VIT * N_VIT, D_VIT, LN_EPS,
                                              int(dtype == torch.bfloat16), route, stream()),
                        "ln")
            var()
            emit({**shape, "variant": ("scalar", "vector")[route], "queued_ms": queued_ms(var),
                  "within": close(tol)((ln, want))})
        alternate(shape, "layernorm", "ln_", lambda: (fast_layernorm(x, sc, bi), want),
                  close(tol))
    x, h = (torch.randn(B_VIT, N_VIT, D_VIT, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    g, sc, bi = (torch.randn(D_VIT, generator=gen).to(dev) for _ in range(3))
    want = fast_add_layernorm_plain(x, h, g, sc, bi)

    def add_ok(pair):
        (x2, ln), (wx2, wln) = pair
        return close(2e-2)((x2, wx2)) and close(2e-2)((ln, wln))
    alternate({"kernel": "add_layernorm", "dtype": "bf16", "shape": [B_VIT, N_VIT, D_VIT]},
              "layernorm", "ln_", lambda: (fast_add_layernorm(x, h, g, sc, bi), want), add_ok)
    for M, C in RESIDUAL_STAGES:
        x, h = (torch.randn(64, M, C, generator=gen).to(dev) for _ in range(2))
        sc, bi = (torch.randn(C, generator=gen).to(dev) for _ in range(2))
        want = fast_residual_layernorm_plain(x, h, sc, bi)
        alternate({"kernel": "residual_layernorm", "dtype": "float32", "shape": [64, M, C]},
                  "layernorm", "ln_", lambda: (fast_residual_layernorm(x, h, sc, bi), want),
                  close(1e-5))
    # the whole call, the parent's wrapper module with its kernel against
    # this checkout's: events around back-to-back calls (the wrappers' host
    # work is most of a LayerNorm call)
    spec = importlib.util.spec_from_file_location(
        "parent_layernorm", os.path.join(args.parent, "genpose2_tpu_torch", "ops", "layernorm.py"))
    parent_ln = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_ln)
    import genpose2_tpu_torch.ops.layernorm as own_ln
    x = torch.randn(B_VIT, N_VIT, D_VIT, generator=gen).to(dev, torch.bfloat16)
    h = torch.randn(B_VIT, N_VIT, D_VIT, generator=gen).to(dev, torch.bfloat16)
    g, sc, bi = (torch.randn(D_VIT, generator=gen).to(dev) for _ in range(3))
    for i, turn in enumerate(turns):
        mod = parent_ln if turn == "parent" else own_ln
        with library_of(libs, turn, "layernorm"):
            ev = {"layernorm": smoke.cuda_ms(lambda: mod.fast_layernorm(x, sc, bi), 50),
                  "add_layernorm": smoke.cuda_ms(lambda: mod.fast_add_layernorm(x, h, g, sc, bi),
                                                 50)}
        emit({"kernel": "layernorm_wrapper", "dtype": "bf16", "shape": [B_VIT, N_VIT, D_VIT],
              "variant": turn, "turn": i, "events_ms": ev})
    log.close()
    return 0


# the ViT's stream: 64 crops of 261 tokens padded to 272, width 384
B_VIT, N_VIT, D_VIT = 64, 272, 384
# the Fus encoder's rel-PE blocks: (M, C) after each grouped stage of
# PointNet2Config (chip_smoke.py's fus_stages)
RESIDUAL_STAGES = ((512, 96), (256, 256), (128, 512), (64, 1024))

if __name__ == "__main__":
    sys.exit(main())
