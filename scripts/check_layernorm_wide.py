"""The LayerNorm kernel's wide route and the ViT attention at head dim 128 on
one card, beside a parent checkout's LayerNorm kernel.

    python3 scripts/check_layernorm_wide.py --parent DIR [--out FILE]

1. Rows to 1,024 (D 48, 96, 190, 384, 1,024; float32 and bf16; aligned and
   one element off): each of the three entries of this checkout's
   ``layernorm.cu`` against DIR's, bit for bit.
2. Device times (``torch.profiler``, ``chip_smoke.py:device_ms``) and the
   bytes' bound at 3.35 TB/s: ``fast_add_layernorm``, ``fast_layernorm``
   and ``fast_residual_layernorm`` on the DINOv3 ViT-7B's bf16 stream (128 x
   272 rows of 4,096) and at 1,280; ``vit_attention_tm`` at 128 crops, 32
   heads of 128, 272 tokens (261 real), with its least time
   (``bench_port/harness/vit_costs.py``'s count: the bytes of the real rows,
   the products at 989 TFLOP/s).

One JSON line a measurement on standard output and in FILE."""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM = 3.35e12


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout whose layernorm.cu to hold to")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "check_layernorm_wide.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from genpose2_tpu_torch.ops import _cuda
    from genpose2_tpu_torch.ops import layernorm as ln
    from genpose2_tpu_torch.ops.vit_attention import vit_attention_tm, vit_attention_tm_plain
    from scripts.kernel_ab import load_smoke

    smoke = load_smoke()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")

    dev = torch.device("cuda")
    emit({"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()})
    build = os.path.join(ROOT, "chiprun_out", "parent_layernorm")
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, "libparent_layernorm.so")
    csrc = os.path.join(args.parent, "genpose2_tpu_torch", "ops", "csrc")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", csrc, "-o", so,
                    os.path.join(csrc, "layernorm.cu")], check=True)
    parent = ctypes.CDLL(so)
    parent.gp2_strerror.argtypes = [ctypes.c_int]
    parent.gp2_strerror.restype = ctypes.c_char_p
    own = _cuda.library("layernorm")

    def both(fn):
        outs = []
        for lib in (own, parent):
            _cuda._libs["layernorm"] = lib
            outs.append(fn())
        _cuda._libs["layernorm"] = own
        return outs

    g = torch.Generator().manual_seed(0)
    mismatches = 0
    for dt in (torch.float32, torch.bfloat16):
        for D in (48, 96, 190, 384, 1024):
            for rows in (111, 17409):
                for off in (0, 1):
                    def r(*shape):
                        n = 1
                        for s in shape:
                            n *= s
                        t = torch.randn(n + off, generator=g).to(dev, dt)
                        return t[off:].view(shape)
                    x, h = r(rows, D), r(rows, D)
                    gamma, scale, bias = (torch.randn(D, generator=g).to(dev) for _ in range(3))
                    pairs = {"ln": both(lambda: ln.fast_layernorm(x, scale, bias)),
                             "residual_ln": both(lambda: ln.fast_residual_layernorm(x, h, scale,
                                                                                   bias)),
                             "add_ln": [torch.cat(p) for p in both(
                                 lambda: ln.fast_add_layernorm(x, h, gamma, scale, bias))]}
                    same = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
                    mismatches += sum(not v for v in same.values())
                    emit({"check": "bit_identical_to_parent", "dtype": str(dt), "D": D,
                          "rows": rows, "offset": off, "same": same})
    emit({"check": "bit_identical_to_parent", "mismatches": mismatches})

    for D in (4096, 1280):
        rows = 128 * 272
        x, h = (torch.randn(rows, D, generator=g).to(dev, torch.bfloat16) for _ in range(2))
        gamma, scale, bias = (torch.randn(D, generator=g).to(dev) for _ in range(3))
        for name, fn, nbytes in (
                ("add_layernorm", lambda: ln.fast_add_layernorm(x, h, gamma, scale, bias),
                 4 * rows * D * 2),
                ("layernorm", lambda: ln.fast_layernorm(x, scale, bias), 2 * rows * D * 2),
                ("residual_layernorm", lambda: ln.fast_residual_layernorm(x, h, scale, bias),
                 3 * rows * D * 2)):
            ms = smoke.device_ms(fn, "ln_wide_kernel")
            emit({"time": name, "dtype": "bf16", "rows": rows, "D": D, "device_ms": ms,
                  "bound_ms": 1e3 * nbytes / HBM,
                  "roofline_pct": 100 * nbytes / HBM / (ms * 1e-3)})

    B, N, nv, H, C = 128, 272, 261, 32, 4096
    q, k, v = (torch.randn(B, N, C, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    ms = smoke.device_ms(lambda: vit_attention_tm(q, k, v, H, nv), "vit_attention_bf16_kernel")
    err = float((vit_attention_tm(q, k, v, H, nv)[:, :nv]
                 - vit_attention_tm_plain(q, k, v, H, nv)[:, :nv]).abs().max())
    nbytes = B * nv * C * (3 * 2 + 4)
    flops = 4 * B * H * nv * nv * (C // H)
    least = max(nbytes / HBM, flops / 989e12 + 5 * B * H * nv * nv / 67e12)
    emit({"time": "vit_attention_tm", "dtype": "bf16", "shape": [B, N, nv, H, C // H],
          "device_ms": ms, "bound_ms": 1e3 * least, "roofline_pct": 100 * least / (ms * 1e-3),
          "max_abs_err_vs_plain": err})
    out.close()
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
