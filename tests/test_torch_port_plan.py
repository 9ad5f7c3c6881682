"""The launch plans of the tensor-core kernels (ops/csrc/plan.cuh), on the CPU.

plan.cuh is plain C++: the host compiler builds it here into a small library
with its C functions exported, so the plans that ode_rk4.cu, fused_sa.cu and
relpe_attention.cu launch with are checked without a card: for the flagship
request, a tracking or frame call, the dense configuration and the tests'
shapes, each plan fits a block's 227 KB of shared memory, its sections do
not overlap and start 16-byte aligned, and the tiles are the ones the source
notes describe.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from genpose2_tpu_torch.config import PointNet2Config, tiny_test_config

CSRC = Path(__file__).resolve().parents[1] / "genpose2_tpu_torch" / "ops" / "csrc"
SMEM_LIMIT = 232448  # 227 KB: the dynamic shared memory of one H100 block
H100_SMS = 132
RK4_FIELDS = ("rows", "nbuf", "ring_elems", "dpad", "ldp", "ldq", "w2_rows", "smem_bytes",
              "off_state", "off_scratch", "off_p", "off_q", "off_w2", "off_ring")
SA_FIELDS = ("rows", "centroids", "nbuf", "ring_elems", "lda", "ldb", "max_cout", "idx_stride", "smem_bytes",
             "off_acc", "off_xyz", "off_idx", "off_nrow", "off_rstart", "off_rowc", "off_rowp",
             "off_a", "off_b", "off_ring")
RELPE_FIELDS = ("heads", "warps", "tq", "kc", "nbuf", "dp", "ldkv", "ldb", "blocks", "smem_bytes",
                "off_cst", "off_qxyz", "off_kxyz", "off_bias", "off_k", "off_v")


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("plan") / "libplan.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-DGP2_PLAN_EXPORTS",
                    "-I", str(CSRC), "-o", str(out), "-"], input='#include "plan.cuh"\n',
                   text=True, check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.gp2_rk4_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.gp2_sa_plan.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.gp2_relpe_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def rk4_plan(lib, R, bf16, D=9, P1=256, P2=256, H1=768, sms=H100_SMS):
    out = (ctypes.c_int * len(RK4_FIELDS))()
    if lib.gp2_rk4_plan(R, D, P1, P2, H1, int(bf16), sms, out) != 0:
        return None
    return dict(zip(RK4_FIELDS, out))


def sa_plan(lib, mlps, nsamples, n_staged, bf16):
    n = len(mlps)
    widths = []
    for ws in mlps:
        widths += list(ws) + [0] * (5 - len(ws))
    out = (ctypes.c_int * len(SA_FIELDS))()
    rc = lib.gp2_sa_plan(n, (ctypes.c_int * n)(*nsamples),
                         (ctypes.c_int * n)(*[len(ws) - 1 for ws in mlps]),
                         (ctypes.c_int * len(widths))(*widths), n_staged, int(bf16), out)
    return None if rc != 0 else dict(zip(SA_FIELDS, out))


def _assert_layout(plan, sections):
    """Sections (offset field, bytes) in order: aligned, disjoint, within
    smem_bytes, which is within the limit."""
    assert plan["smem_bytes"] <= SMEM_LIMIT
    end = 0
    for field, nbytes in sections:
        assert plan[field] % 16 == 0 and plan[field] >= end, field
        end = plan[field] + nbytes
    assert end == plan["smem_bytes"]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("R,rows", [
    (1, 16), (37, 16), (100, 16),  # the tests' shapes
    (600, 16),                     # a tracking call: 12 objects x 50 candidates, 38 blocks
    (3200, 32),                    # a request: 64 x 50, 100 blocks in one round
    (6400, 32),                    # two rounds of 32-row blocks
])
def test_rk4_plan(plan_lib, bf16, R, rows):
    p = rk4_plan(plan_lib, R, bf16)
    assert p is not None and p["rows"] == rows
    # bf16: W2 resident (768 rows of 24), a ring 3 deep; float32: W2
    # resident and a ring 2 deep at 16 rows, W2 streamed with the rest at 32
    assert p["w2_rows"] == (768 if bf16 or rows == 16 else 0)
    assert p["nbuf"] == (3 if bf16 else 2)
    es = 2 if bf16 else 4
    assert p["ring_elems"] * es == 33792
    assert p["ldp"] == 256 + (8 if bf16 else 4) and p["ldq"] == 768 + (8 if bf16 else 4)
    _assert_layout(p, [("off_state", 4 * 6 * rows * p["dpad"]), ("off_scratch", 4 * 2048),
                       ("off_p", es * rows * p["ldp"]), ("off_q", es * rows * p["ldq"]),
                       ("off_w2", es * p["w2_rows"] * 24),
                       ("off_ring", es * p["nbuf"] * p["ring_elems"])])

def test_rk4_plan_refuses(plan_lib):
    assert rk4_plan(plan_lib, 100, True, D=17) is None  # the last product holds 16 columns
    assert rk4_plan(plan_lib, 0, True) is None
    assert rk4_plan(plan_lib, 100, False, H1=4096) is None  # no tile fits 227 KB


CFG = PointNet2Config()
# (name, mlps, nsamples, points staged) of every grouped stage kernel launch:
# the ClsMSG stages at 1,024 points (flagship, dino='none'), the dense
# configuration's stage 0 at 2,048 (one launch per scale), the tests' shapes
SA_CASES = [(f"stage{i}", CFG.mlps[i], CFG.nsamples[i], n)
            for i, n in zip(range(4), (1024, 512, 256, 128))]
SA_CASES += [(f"dense_stage0_scale{s}", (CFG.mlps[0][s],), (CFG.nsamples[0][s],), 2048)
             for s in range(2)]
SA_CASES += [("test_stage", ((16, 48, 40), (32, 48, 40)), (8, 32), 700),
             ("test_scale", ((32, 48, 40),), (64,), 512),
             ("test_indices", ((32, 48, 40),), (40,), 0),
             ("test_no_layer", ((32,),), (16,), 700)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,mlps,nsamples,n_staged", SA_CASES, ids=[c[0] for c in SA_CASES])
def test_sa_plan(plan_lib, bf16, name, mlps, nsamples, n_staged):
    p = sa_plan(plan_lib, mlps, nsamples, n_staged, bf16)
    assert p is not None
    # 64-row chunks and a ring 3 deep everywhere; float32's stage 3 (256 ->
    # 384 -> 512) fits them with 4 centroids a block and half-size ring tiles
    f32_stage3 = name == "stage3" and not bf16
    assert p["rows"] == 64 and p["nbuf"] == 3
    assert p["centroids"] == (4 if f32_stage3 else 16)
    assert p["ring_elems"] * (2 if bf16 else 4) <= (16896 if f32_stage3 else 33792)
    es = 2 if bf16 else 4
    pad = 8 if bf16 else 4
    r16 = lambda n: (n + 15) // 16 * 16  # noqa: E731
    # the gather and odd layers' outputs alternate with even layers' outputs
    ping = max([16] + [ws[0] for ws in mlps]
               + [ws[l + 1] for ws in mlps for l in range(1, len(ws) - 2, 2)])
    pong = max([16] + [ws[l + 1] for ws in mlps for l in range(0, len(ws) - 2, 2)])
    assert p["lda"] == r16(ping) + pad and p["ldb"] == r16(pong) + pad
    assert p["max_cout"] == max(ws[-1] for ws in mlps)
    assert p["idx_stride"] == sum(nsamples)
    rows = p["rows"]
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    tc = p["centroids"]
    _assert_layout(p, [("off_acc", 4 * r4(tc * p["max_cout"])), ("off_xyz", 4 * 3 * r4(n_staged)),
                       ("off_idx", 4 * r4(tc * p["idx_stride"])), ("off_nrow", 4 * tc * 4),
                       ("off_rstart", 4 * r4(tc + 1)), ("off_rowc", 4 * rows), ("off_rowp", 4 * rows),
                       ("off_a", es * rows * p["lda"]), ("off_b", es * rows * p["ldb"]),
                       ("off_ring", es * p["nbuf"] * p["ring_elems"])])

def test_sa_plan_refuses(plan_lib):
    assert sa_plan(plan_lib, ((32, 48, 40),) * 5, (16,) * 5, 100, True) is None  # 5 scales
    assert sa_plan(plan_lib, ((32, 4096, 40),), (16,), 100, False) is None  # too wide


def relpe_plan(lib, B, M, C, bf16, sms=H100_SMS):
    out = (ctypes.c_int * len(RELPE_FIELDS))()
    if lib.gp2_relpe_plan(B, M, C, 8, int(bf16), sms, out) != 0:
        return None
    return dict(zip(RELPE_FIELDS, out))


_TINY = tiny_test_config().model.pointnet2
# (name, B, M, C) of rel-PE launches: the Fus encoder's four stages (M
# points, C = the stage's summed widths, 8 heads of D = C / 8) at a
# request's B = 64 and a frame call's B = 12, the tiny configs' stages, the
# gpu tests' M = 37 and a ragged M = 200
RELPE_CASES = [(f"stage{i}_B{b}", b, m, sum(w[-1] for w in CFG.mlps[i]))
               for b in (64, 12) for i, m in enumerate(CFG.npoints) if m is not None]
RELPE_CASES += [(f"tiny_stage{i}", 4, m, sum(w[-1] for w in _TINY.mlps[i]))
                for i, m in enumerate(_TINY.npoints) if m is not None]
RELPE_CASES += [("test_M37", 2, 37, 32), ("ragged_M200", 2, 200, 96)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,B,M,C", RELPE_CASES, ids=[c[0] for c in RELPE_CASES])
def test_relpe_plan(plan_lib, bf16, name, B, M, C):
    p = relpe_plan(plan_lib, B, M, C, bf16)
    assert p is not None
    D, es = C // 8, 2 if bf16 else 4
    # D padded to the mma's depth (bf16 m16n8k16, float32 m16n8k8), at most 128
    assert p["dp"] >= D and p["dp"] % (16 if bf16 else 8) == 0 and p["dp"] <= 128
    assert p["heads"] in (8, 4, 2, 1) and p["warps"] in (8, 4)
    assert p["tq"] == 16 * p["warps"] // p["heads"]  # one (head, 16 rows) task a warp
    assert p["kc"] == 32 and p["nbuf"] == 2
    assert p["ldkv"] == p["dp"] + (8 if bf16 else 4) and p["ldb"] == p["kc"] + 8
    assert p["blocks"] == B * -(-M // p["tq"]) * (8 // p["heads"])
    if name.startswith("stage0"):  # a request and a frame call fill the 132 SMs
        assert p["blocks"] >= H100_SMS and p["heads"] == 8
    if name.startswith("stage"):  # the flagship stages leave room for two blocks an SM
        assert 2 * p["smem_bytes"] <= SMEM_LIMIT
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    kv = es * p["nbuf"] * p["heads"] * p["kc"] * p["ldkv"]
    _assert_layout(p, [("off_cst", 4 * r4(16 * 24 + 8)), ("off_qxyz", 4 * r4(3 * p["tq"])),
                       ("off_kxyz", 4 * r4(p["nbuf"] * p["kc"] * 3)),
                       ("off_bias", 4 * p["heads"] * p["tq"] * p["ldb"]),
                       ("off_k", kv), ("off_v", kv)])


def test_relpe_plan_refuses(plan_lib):
    assert relpe_plan(plan_lib, 2, 64, 2048, True) is None  # D = 256: past the widest mma depth
    assert relpe_plan(plan_lib, 2, 64, 72, False) is None   # D = 9: odd
    assert relpe_plan(plan_lib, 0, 64, 96, False) is None
