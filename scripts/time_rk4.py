#!/usr/bin/env python3
"""Time the fused RK4 kernel on one card beside a parent checkout's, and
time the variants its launch plan chooses among; every turn's output is
checked against the plain version.

    python3 scripts/time_rk4.py --parent DIR [--out FILE] [--also DIR ...]
        [--phases alternate,variants] [--dtypes float32,bfloat16]

Shapes (D = 9, H1 = 768 unless named; chip_smoke.py's draws): the request
(3,200 rows, 50 steps, T0 0.55), a tracking call (600 rows, 100 steps, T0
0.15), the pose modes' widths (D = 7 and 6, H1 = 512) at both, and the
benchmark's cells (6,400 rows, 100 and 500 steps, T0 0.55), in float32 and
bf16.

Parent against this checkout (``alternate``): DIR's ``ode_rk4.cu`` is built
with the port's nvcc flags; both take the same operands
(``ops/ode_rk4.py:rk4_operands``) and alternate parent, new, new, parent.
Each turn records ``device_ms`` (torch.profiler, chip_smoke.py's: the kernel
alone) and whether the output is within the gpu tests' bounds of the plain
version (float32 2e-4 / 1e-4, bf16 1e-2).

Variants (``variants``): this checkout's source once more, with ``-Xptxas
-v`` (registers and spills go to FILE), beside an entry that takes the row
tile and the ring (float32, the wgmma route: rows a multiple of 8, nbuf
16-row slots; bf16, mma.sync: slots of kRingBytes / slot_div bytes, nbuf of
them; rows 0: the plan's choice) from the caller, timed at the cells'
shape, the request's and a tracking call's. The parent's turns time the
float32 mma.sync route beside the wgmma route.

``--also DIR``: another build of ``ode_rk4.cu`` with this checkout's entry
(a copy edited to leave something out, or to stage the weights another
way), timed at the same shapes with the plan's choice and at the cells'
shape with the rings of ALSO_RINGS; ``within`` says whether its output kept
to the bounds (a copy that leaves work out does not).

Prints one JSON line per measurement and writes them to FILE.
"""

import argparse
import ctypes
import os
import subprocess
import sys

from kernel_ab import ROOT, Log, build_all, checked, load_smoke, stream

VARIANT_ENTRIES = {
    "ode_rk4": """#include "ode_rk4.cu"
extern "C" int gp2_rk4_variant(const float* x0, float* out, const float* stat,
                               const float* trows, const float* scal, const void* w0,
                               const float* b0, const void* w1, const float* b1, const void* wp,
                               const void* w2, const float* b2, int R, int D, int P1, int P2,
                               int H1, int n, int bf16, void* stream, int rows, int slot_div,
                               int nbuf, int wgmma) {
  Params P = {x0, out, stat, trows, scal, w0, b0, w1, b1, wp, w2, b2, R, D, P1, P2, H1, n};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = rows == 0 ? rk4_route(R, D, P1, P2, H1, bf16, sms, &P.plan)
                 : wgmma    ? rk4_wgmma_layout(R, D, P1, P2, sms, rows, nbuf, &P.plan)
                            : rk4_layout(R, D, P1, P2, bf16, sms, rows, slot_div, nbuf, &P.plan);
  if (rc != 0) return -1;
  return static_cast<int>(launch_plan(P, bf16, static_cast<cudaStream_t>(stream)));
}
""",
}

# (label, rows, steps, T0, D, head)
SHAPES = [("request", 3200, 50, 0.55, 9, "Rx_Ry_and_T"),
          ("tracking", 600, 100, 0.15, 9, "Rx_Ry_and_T"),
          ("request_D7", 3200, 50, 0.55, 7, "R_and_T"),
          ("tracking_D7", 600, 100, 0.15, 7, "R_and_T"),
          ("request_D6", 3200, 50, 0.55, 6, "RT"),
          ("tracking_D6", 600, 100, 0.15, 6, "RT"),
          ("cells_100", 6400, 100, 0.55, 9, "Rx_Ry_and_T"),
          ("cells_500", 6400, 500, 0.55, 9, "Rx_Ry_and_T")]

# (rows, slot_div, nbuf, wgmma) at a shape's rows: float32 on the wgmma
# route (slot_div unused), bf16 on mma.sync
VARIANTS = {6400: [(56, 0, 3, 1), (56, 0, 2, 1), (64, 0, 3, 1), (48, 0, 3, 1)],
            3200: [(32, 0, 3, 1), (24, 0, 3, 1), (40, 0, 3, 1)],
            600: [(16, 0, 3, 1), (16, 0, 2, 1)]}
BF16_VARIANTS = {6400: [(64, 1, 4, 0), (64, 1, 2, 0)]}
ALSO_RINGS = {"float32": [(64, 0, 3, 1)],
              "bfloat16": [(64, 1, 2, 0), (64, 1, 4, 0)]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout whose ode_rk4.cu to time beside")
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "time_rk4.jsonl"))
    ap.add_argument("--also", action="append", default=[],
                    help="a directory holding another ode_rk4.cu to time at the cells' shape")
    ap.add_argument("--phases", default="alternate,variants")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("time_rk4: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from genpose2_tpu_torch.diffusion.sde import init_sde
    from genpose2_tpu_torch.models.scorenet import PoseScoreNet, fast_score_weights
    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_plain, rk4_operands

    smoke = load_smoke()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda:0")
    log = Log(args.out)
    emit = log.emit
    build_dir = os.path.join(ROOT, ".chipcheck", "rk4_build")
    libs, ptxas = build_all(args.parent, build_dir, VARIANT_ENTRIES)
    for name, lines in ptxas.items():
        emit({"ptxas": name, "lines": lines})
    procs = {}
    for d in args.also:
        label = os.path.basename(os.path.normpath(d))
        src = os.path.join(build_dir, f"{label}_variant.cu")
        with open(src, "w") as f:
            f.write(VARIANT_ENTRIES["ode_rk4"])
        out = os.path.join(build_dir, f"lib{label}.so")
        procs[label] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", d, "-I", str(_cuda.CSRC),
             "-o", out, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    also = {}
    for label, (proc, out) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {label}: {err}")
        emit({"ptxas": label, "lines": [ln.strip() for ln in err.splitlines()
                                         if "registers" in ln or "spill" in ln]})
        also[label] = ctypes.CDLL(out)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    own = _cuda.library("ode_rk4")
    own.gp2_rk4.argtypes = [ptr] * 12 + [c_int] * 7 + [ptr, ptr]  # the stream, rounds
    parent = libs["parent", "ode_rk4"]
    # the stream, rounds and a null for the out-pointer of an entry that still has
    # a second one (a C function ignores an argument past its own)
    parent.gp2_rk4.argtypes = [ptr] * 12 + [c_int] * 7 + [ptr, ptr, ptr]
    for lib in [libs["variant", "ode_rk4"], *also.values()]:
        lib.gp2_rk4_variant.argtypes = [ptr] * 12 + [c_int] * 7 + [ptr] + [c_int] * 4

    gen = torch.Generator().manual_seed(smoke.SEED + 20)
    sde = init_sde("ve")
    nets = {}
    for D, head in ((9, "Rx_Ry_and_T"), (7, "R_and_T"), (6, "RT")):
        net = PoseScoreNet(sde.marginal_std, D, head, 1024).to(dev)
        smoke.randomize(net, gen)
        w = fast_score_weights(net, torch.randn(6400, 1024, generator=gen).to(dev))
        x0 = sde.prior_sample((6400, D), T=0.55, generator=gen).to(dev)
        nets[D] = (x0, w)

    def operands(D, rows, steps, T0, dtype):
        x0, w = nets[D]
        w = {**w, "static": w["static"][:rows].contiguous()}
        return rk4_operands(x0[:rows].contiguous(), w, sde, T0, steps, dtype)

    def call(kind, tensors, ints, variant=None):
        ptrs = [t.data_ptr() for t in tensors]
        if kind == "parent":
            code = parent.gp2_rk4(*ptrs, *ints, stream(), None, None)
        elif kind == "new":
            code = own.gp2_rk4(*ptrs, *ints, stream(), None)
        else:
            code = kind.gp2_rk4_variant(*ptrs, *ints, stream(), *variant)
        checked(code, f"rk4 {variant}")
        return tensors[1]

    def within(got, want, dtype):
        atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
        return bool(torch.isfinite(got).all() and torch.allclose(got, want, atol=atol, rtol=rtol))

    def device_ms(fn, reps):
        try:
            return smoke.device_ms(fn, "rk4_kernel", reps=reps)
        except smoke.ProfilerMiss:
            return None

    plains = {}

    def plain(label, D, rows, steps, T0, dtype):
        if (label, dtype) not in plains:
            x0, w = nets[D]
            w = {**w, "static": w["static"][:rows].contiguous()}
            plains[label, dtype] = fused_rk4_plain(x0[:rows].contiguous(), w, sde, T0, steps,
                                                   dtype)
        return plains[label, dtype]

    for dtype in args.dtypes.split(","):
        for label, rows, steps, T0, D, head in SHAPES:
            tensors, ints = operands(D, rows, steps, T0, dtype)
            shape = {"shape": label, "dtype": dtype, "R": rows, "steps": steps, "T0": T0, "D": D,
                     "H1": ints[4]}
            reps = 3 if rows * steps >= 6400 * 500 else 5
            if "alternate" in phases:
                want = plain(label, D, rows, steps, T0, dtype)
                for i, turn in enumerate(("parent", "new", "new", "parent")):
                    def fn(turn=turn):
                        return call(turn, tensors, ints)
                    ok = within(fn().clone(), want, dtype)
                    emit({**shape, "variant": turn, "turn": i, "device_ms": device_ms(fn, reps),
                          "within": ok})
            if "variants" in phases and label in ("request", "tracking", "cells_100"):
                table = VARIANTS if dtype == "float32" else BF16_VARIANTS
                for v in table.get(rows, []):
                    def fn(v=v):
                        return call(libs["variant", "ode_rk4"], tensors, ints, v)
                    ok = within(fn().clone(), plain(label, D, rows, steps, T0, dtype), dtype)
                    emit({**shape, "variant": "rows{}_div{}_nbuf{}_wgmma{}".format(*v),
                          "device_ms": device_ms(fn, reps), "within": ok})
            if label in ("request", "tracking", "cells_100"):
                rings = ALSO_RINGS[dtype] if label == "cells_100" else []
                for name, lib in also.items():
                    for v in [(0, 0, 0, 0)] + rings:
                        def fn(v=v, lib=lib):
                            return call(lib, tensors, ints, v)
                        ok = within(fn().clone(), plain(label, D, rows, steps, T0, dtype), dtype)
                        emit({**shape, "variant": f"{name}_rows{v[0]}_div{v[1]}_nbuf{v[2]}_wgmma{v[3]}",
                              "device_ms": device_ms(fn, reps), "within": ok})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
