"""The launch plans of the port's kernels (ops/csrc/plan.cuh), on the CPU.

plan.cuh is plain C++: the host compiler builds it here into a small library
with its C functions exported, so the plans that ode_rk4.cu, fused_sa.cu,
relpe_attention.cu, fps.cu, ball_query.cu, ball_count.cu, vit_attention.cu
and layernorm.cu launch with are checked without a card: for the flagship request, a tracking or frame call, the dense
configuration, the training path and the tests' shapes, each plan fits a
block's 227 KB of shared memory, its sections do not overlap and start
16-byte aligned, and the tiles are the ones the source notes describe.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

from genpose2_tpu_torch.config import PointNet2Config, tiny_test_config
from genpose2_tpu_torch.ops.fps import MAX_REGISTER_POINTS

CSRC = Path(__file__).resolve().parents[1] / "genpose2_tpu_torch" / "ops" / "csrc"
SMEM_LIMIT = 232448  # 227 KB: the dynamic shared memory of one H100 block
H100_SMS = 132
RK4_FIELDS = ("rows", "rounds", "nbuf", "ring_elems", "dpad", "ldp", "ldq", "smem_bytes",
              "off_state", "off_p", "off_q", "off_ring", "off_bar", "wgmma", "off_xt")
SA_FIELDS = ("rows", "centroids", "nbuf", "ring_elems", "lda", "ldb", "max_cout", "idx_stride", "smem_bytes",
             "off_acc", "off_xyz", "off_idx", "off_nrow", "off_rstart", "off_rowc", "off_rowp",
             "off_a", "off_b", "off_ring")
RELPE_FIELDS = ("heads", "warps", "tq", "kc", "nbuf", "dp", "ldkv", "ldb", "blocks", "smem_bytes",
                "off_cst", "off_qxyz", "off_kxyz", "off_bias", "off_k", "off_v")
FPS_FIELDS = ("warps", "p", "wide", "smem_bytes", "off_x", "off_y", "off_z", "off_val",
              "off_idx")
BQ_FIELDS = ("warps", "blocks", "tile", "smem_bytes", "off_xyz")
BC_FIELDS = ("lanes", "cpt", "splits", "centroids", "blocks", "tile", "smem_bytes", "off_pts",
             "off_cnt")
VIT_FIELDS = ("dp", "windowed", "keys", "smem_bytes")


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
    lib.gp2_rk4_route.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.gp2_sa_plan.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.gp2_relpe_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gp2_fps_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gp2_ball_query_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.gp2_ball_count_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gp2_vit_attention_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gp2_ln_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def rk4_plan(lib, R, bf16, D=9, P1=256, P2=256, H1=768, sms=H100_SMS):
    out = (ctypes.c_int * len(RK4_FIELDS))()
    if lib.gp2_rk4_plan(R, D, P1, P2, H1, int(bf16), sms, out) != 0:
        return None
    return dict(zip(RK4_FIELDS, out))


def rk4_route(lib, R, bf16, D=9, P1=256, P2=256, H1=768, sms=H100_SMS):
    """The plan gp2_rk4 launches (its ``wgmma`` field names the route)."""
    out = (ctypes.c_int * len(RK4_FIELDS))()
    if lib.gp2_rk4_route(R, D, P1, P2, H1, int(bf16), sms, out) != 0:
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


def _assert_rk4_layout(p, bf16):
    """The RK4 plan's sections in order: the f32 state (x, the stage input,
    four slopes), P, Q (also the last product's partial sums: 8 consumer
    warps x rows x 16 f32), the ring, its 2 x nbuf mbarriers."""
    es = 2 if bf16 else 4
    rows = p["rows"]
    q_bytes = max(es * rows * p["ldq"], 4 * 8 * rows * 16)
    _assert_layout(p, [("off_state", 4 * 6 * rows * p["dpad"]), ("off_p", es * rows * p["ldp"]),
                       ("off_q", q_bytes), ("off_ring", es * p["nbuf"] * p["ring_elems"]),
                       ("off_bar", 16 * p["nbuf"])])
    # the TMA's boxes land 128-byte aligned
    assert p["off_ring"] % 128 == 0 and p["ring_elems"] * es % 128 == 0
    assert (p["wgmma"], p["off_xt"]) == (0, 0)


def _assert_rk4_wgmma_layout(p):
    """The wgmma route's sections in order: P and Q (the activations'
    high and low TF32 parts, rows x 256 f32 each, which also hold the 8
    consumer warps' partial slopes), the stage input's two parts (a panel of
    32 f32 a row each), the state, the ring of 16-row float32 slots, the
    barriers, then 1,024 bytes for the kernel to put P on a 1,024-byte
    boundary; the K-major panels (rows x 128 bytes) keep that alignment."""
    rows = p["rows"]
    assert p["wgmma"] == 1 and rows % 8 == 0 and 16 <= rows <= 64
    assert (p["ldp"], p["ldq"], p["ring_elems"]) == (32, 32, 16 * 264)
    assert 4 * 8 * ((rows + 15) // 16 * 16) * 16 <= p["off_xt"]
    sections = [("off_p", 4 * rows * 256), ("off_q", 4 * rows * 256), ("off_xt", 2 * 4 * rows * 32),
                ("off_state", 4 * 6 * rows * p["dpad"]), ("off_ring", 4 * p["nbuf"] * p["ring_elems"]),
                ("off_bar", 16 * p["nbuf"])]
    assert p["off_p"] == 0 and p["off_ring"] % 128 == 0
    for field in ("off_q", "off_xt"):
        assert p[field] % 1024 == 0, field
    _assert_layout({**p, "smem_bytes": p["smem_bytes"] - 1024}, sections)
    assert p["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("R,rows,rounds", [
    (1, 16, 1), (37, 16, 1), (100, 16, 1),  # the tests' shapes
    (600, 16, 1),                     # a tracking call: 12 objects x 50 candidates, 38 blocks
    (3200, 32, 1),                    # a request: 64 x 50, 100 blocks of 32
    (6400, 64, 1),                    # the benchmark's batch of 128 x 50: 100 blocks of 64
    (4300, 48, 1),                    # 33 rows an SM: 90 blocks of 48
    (64 * 132, 64, 1),                # the most one round holds
    (64 * 132 + 1, 64, 2),            # past it, 64-row blocks in rounds
    (20000, 64, 3),
])
def test_rk4_plan(plan_lib, bf16, R, rows, rounds):
    """The smallest row tile (a multiple of 16, at most 64) that puts every
    block on the card in one round; the ring four full-size slots deep,
    three at 48 float32 rows, two at 64."""
    p = rk4_plan(plan_lib, R, bf16)
    assert p is not None and (p["rows"], p["rounds"]) == (rows, rounds)
    es = 2 if bf16 else 4
    ring = {48: (3, 33792), 64: (2, 33792)}.get(rows, (4, 33792)) if not bf16 else (4, 33792)
    assert (p["nbuf"], p["ring_elems"] * es) == ring
    # the activations are at most 256 wide: product 3's output stays in registers
    assert p["ldp"] == 256 + (8 if bf16 else 4) and p["ldq"] == 256 + (8 if bf16 else 4)
    _assert_rk4_layout(p, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [7, 6])  # the quaternion modes (R_and_T), euler_xyz (RT)
@pytest.mark.parametrize("R,rows", [(600, 16), (3200, 32), (6400, 64)])
def test_rk4_plan_pose_mode_widths(plan_lib, bf16, D, R, rows):
    """H1 = 512 (two 256-wide heads, or RT's one 512-wide head): the tiles
    of the 768-wide plan, the layout inside 227 KB."""
    p = rk4_plan(plan_lib, R, bf16, D=D, H1=512)
    assert p is not None and (p["rows"], p["rounds"]) == (rows, 1)
    assert p["dpad"] == 8
    assert p["ldq"] == 256 + (8 if bf16 else 4)
    _assert_rk4_layout(p, bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("R", [600, 3200, 6400])
def test_rk4_plan_widest_state(plan_lib, bf16, R):
    """D = 16, the widest the last product holds: the state's rows of 16
    still leave the ring of D = 9."""
    p = rk4_plan(plan_lib, R, bf16, D=16)
    want = rk4_plan(plan_lib, R, bf16)
    assert p is not None and p["dpad"] == 16
    assert (p["nbuf"], p["ring_elems"]) == (want["nbuf"], want["ring_elems"])
    _assert_rk4_layout(p, bf16)


@pytest.mark.parametrize("R,rows,rounds", [
    (600, 16, 1),                     # a tracking call: 38 blocks of 16
    (3200, 32, 1),                    # a request: 100 blocks of 32
    (4300, 40, 1),                    # 33 rows an SM: 108 blocks of 40
    (6400, 56, 1),                    # the benchmark's cells: 115 blocks of 56
    (64 * 132, 64, 1),                # the most one round holds
    (64 * 132 + 1, 64, 2),            # past it, 64-row blocks in rounds
])
def test_rk4_route_float32_wgmma(plan_lib, R, rows, rounds):
    """float32 takes the wgmma route at every row count the port launches:
    the smallest multiple of 8 rows (16 to 64) that puts every block on the
    card in one round, the ring three 16-row slots deep."""
    p = rk4_route(plan_lib, R, False)
    assert p is not None and p["wgmma"] == 1
    assert (p["rows"], p["rounds"], p["nbuf"]) == (rows, rounds, 3)
    _assert_rk4_wgmma_layout(p)


@pytest.mark.parametrize("R", [1, 37, 600, 3200, 4300, 6400, 64 * 132, 64 * 132 + 1])
def test_rk4_route_bf16_mma_sync(plan_lib, R):
    """bf16 never takes the wgmma route: its plan is rk4_plan's."""
    p = rk4_route(plan_lib, R, True)
    assert p is not None and p["wgmma"] == 0
    assert p == rk4_plan(plan_lib, R, True)


@pytest.mark.parametrize("D", [6, 7, 9, 16])
@pytest.mark.parametrize("H1", [512, 768])
@pytest.mark.parametrize("R", [600, 3200, 6400, 64 * 132])
def test_rk4_route_wgmma_layout_fits(plan_lib, D, H1, R):
    """The wgmma route's layout fits 227 KB at every pose width (D = 6, 7,
    9 and the widest, 16) and both heads' widths, with three ring slots."""
    p = rk4_route(plan_lib, R, False, D=D, H1=H1)
    assert p is not None and p["wgmma"] == 1 and p["nbuf"] == 3
    assert p["dpad"] == (D + 3) // 4 * 4
    _assert_rk4_wgmma_layout(p)


def test_rk4_route_float32_only_256_wide_pose_mlp(plan_lib):
    """float32 runs only on the wgmma route, whose activations are 256 wide:
    a 512-wide pose MLP is refused there (bf16 still plans it)."""
    for P1, P2 in ((512, 256), (256, 512)):
        assert rk4_route(plan_lib, 3200, False, P1=P1, P2=P2) is None
        p = rk4_route(plan_lib, 3200, True, P1=P1, P2=P2)
        assert p is not None and p["wgmma"] == 0


def test_rk4_plan_refuses(plan_lib):
    assert rk4_plan(plan_lib, 100, True, D=17) is None  # the last product holds 16 columns
    assert rk4_plan(plan_lib, 0, True) is None
    assert rk4_plan(plan_lib, 100, False, H1=4096) is None  # past 8 chunks of 256 columns
    # widths the TMA's boxes do not tile: the score net's are multiples of 256
    assert rk4_plan(plan_lib, 100, False, H1=700) is None
    assert rk4_plan(plan_lib, 100, True, P1=128) is None
    assert rk4_plan(plan_lib, 100, True, P2=320) is None
    assert rk4_route(plan_lib, 100, False, D=17) is None
    assert rk4_route(plan_lib, 100, False, H1=700) is None


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


def fps_plan(lib, N, B, sms=H100_SMS):
    out = (ctypes.c_int * len(FPS_FIELDS))()
    if lib.gp2_fps_plan(N, B, sms, out) != 0:
        return None
    return dict(zip(FPS_FIELDS, out))


# FPS launches: the module encoder's chain N = 1024 / 512 / 256 / 128 and the
# fast encoder's N = 1024 (B = 64 a request, 12 a frame call, 192 the
# batch-192 train step), the dense path's N = 2048, and the gpu tests' N
FPS_CASES = [(N, B) for N in (128, 256, 512, 1024, 2048) for B in (12, 64, 192)]
FPS_CASES += [(N, B) for N in (77, 1000, 4096, 8192) for B in (1, 140)] + [(4096, 64), (8192, 64)]


@pytest.mark.parametrize("N,B", FPS_CASES, ids=[f"N{n}_B{b}" for n, b in FPS_CASES])
def test_fps_plan(plan_lib, N, B):
    p = fps_plan(plan_lib, N, B)
    assert p is not None
    threads = 32 * p["warps"]
    # every point in a register slot, at most 32 a thread, and under 2N slots
    assert threads * p["p"] >= N and p["p"] <= 32 and threads * p["p"] < max(2 * N, 256)
    assert p["warps"] in (1, 2, 4, 8, 16) and p["p"] in (4, 8, 16, 32)
    assert p["wide"] == 0
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    _assert_layout(p, [("off_x", 4 * r4(N)), ("off_y", 4 * r4(N)), ("off_z", 4 * r4(N)),
                       ("off_val", 4 * r4(2 * p["warps"])), ("off_idx", 4 * r4(2 * p["warps"]))])


def test_fps_wide_route_starts_past_the_wrappers_constant(plan_lib):
    # ops/fps.py allocates the wide route's scratch past MAX_REGISTER_POINTS
    assert fps_plan(plan_lib, MAX_REGISTER_POINTS, 64)["wide"] == 0
    assert fps_plan(plan_lib, MAX_REGISTER_POINTS + 1, 64)["wide"] == 1


def test_fps_plan_refuses(plan_lib):
    # no cloud or no object; every N >= 1 has a plan (the wide route past 8,192)
    assert fps_plan(plan_lib, 0, 4) is None
    assert fps_plan(plan_lib, 1024, 0) is None
    assert fps_plan(plan_lib, 1024, 4, sms=0) is None


# the wide route: just past the register plan's 8,192 points, the gpu tests'
# and chip_smoke.py's 16,384 and 32,768 at a frame call's 12 objects and at
# B = 1 and 64, and larger clouds
FPS_WIDE_CASES = [(N, B) for N in (8193, 16384, 32768) for B in (1, 12, 64)]
FPS_WIDE_CASES += [(32769, 2), (40000, 2), (100000, 12)]


@pytest.mark.parametrize("N,B", FPS_WIDE_CASES, ids=[f"N{n}_B{b}" for n, b in FPS_WIDE_CASES])
def test_fps_wide_plan(plan_lib, N, B):
    p = fps_plan(plan_lib, N, B)
    # 32 warps, the running distances in the wrapper's global scratch (no
    # registers a thread), which the wrapper allocates past its constant
    assert p is not None and p["wide"] == 1 and p["warps"] == 32 and p["p"] == 0
    assert N > MAX_REGISTER_POINTS
    # no coordinates in shared memory: only the 32 warps' partials
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    _assert_layout(p, [("off_x", 0), ("off_y", 0), ("off_z", 0), ("off_val", 4 * r4(64)),
                       ("off_idx", 4 * r4(64))])


def bq_plan(lib, B, N, M, nsample, sms=H100_SMS):
    out = (ctypes.c_int * len(BQ_FIELDS))()
    if lib.gp2_ball_query_plan(B, N, M, nsample, sms, out) != 0:
        return None
    return dict(zip(BQ_FIELDS, out))


# ball query launches: both scales of the module encoder's four stages (N / M
# = 1024 / 512 ... 128 / 64) at B = 64 (a train step, the global request),
# 192 (the batch-192 train step) and 12 (a global frame call), and the gpu
# tests' shapes
BQ_CASES = [(B, n, n // 2, ns) for B in (64, 192, 12) for n in (1024, 512, 256, 128)
            for ns in CFG.nsamples[0]]
BQ_CASES += [(2, 33, 20, 16), (2, 127, 50, 32), (2, 129, 50, 32), (64, 1024, 509, 32),
             (3, 77, 20, 16), (2, 512, 256, 64)]


@pytest.mark.parametrize("B,N,M,nsample", BQ_CASES,
                         ids=[f"B{b}_N{n}_M{m}_S{s}" for b, n, m, s in BQ_CASES])
def test_ball_query_plan(plan_lib, B, N, M, nsample):
    p = bq_plan(plan_lib, B, N, M, nsample)
    assert p is not None
    assert p["warps"] in (1, 2, 4, 8)
    assert p["blocks"] == B * -(-M // p["warps"])  # one centroid a warp
    if B >= 64:  # the training path's stages fill the 132 SMs
        assert p["blocks"] >= H100_SMS
    assert p["tile"] == N  # the whole cloud in one tile
    _assert_layout(p, [("off_xyz", 4 * (-(-3 * N // 4) * 4))])  # the cloud, 12 bytes a point


# clouds past one tile: just past it, the old whole-cloud limit (~19,370
# points) and the gpu tests' and chip_smoke.py's 32,768 at B = 1 and 12
BQ_TILED_CASES = [(1, 4097, 64, 32), (2, 20000, 64, 32), (1, 32768, 512, 32),
                  (12, 32768, 512, 64), (3, 100000, 200, 16)]


@pytest.mark.parametrize("B,N,M,nsample", BQ_TILED_CASES,
                         ids=[f"B{b}_N{n}_M{m}_S{s}" for b, n, m, s in BQ_TILED_CASES])
def test_ball_query_tiled_plan(plan_lib, B, N, M, nsample):
    p = bq_plan(plan_lib, B, N, M, nsample)
    assert p is not None and p["blocks"] == B * -(-M // p["warps"])
    # 4,096-point tiles: whole 128-point windows, 48 KB
    assert p["tile"] == 4096 and p["tile"] % 128 == 0
    _assert_layout(p, [("off_xyz", 12 * 4096)])


def test_ball_query_plan_refuses(plan_lib):
    # no object, centroid, point or slot; any N >= 1 has a plan (tiles)
    assert bq_plan(plan_lib, 0, 128, 64, 32) is None
    assert bq_plan(plan_lib, 2, 128, 64, 0) is None
    assert bq_plan(plan_lib, 2, 128, 0, 32) is None
    assert bq_plan(plan_lib, 2, 0, 64, 32) is None


def bc_plan(lib, B, N, M, sms=H100_SMS):
    out = (ctypes.c_int * len(BC_FIELDS))()
    if lib.gp2_ball_count_plan(B, N, M, sms, out) != 0:
        return None
    return dict(zip(BC_FIELDS, out))


# ball count launches: the dense stage's centroid order at a request's B = 64
# and a frame call's 12 (M = 512 of 1,024 points, and of the dense path's
# 2,048), and the gpu tests' shapes (N 77-32,768, B 1-140, ragged M)
BC_CASES = [(B, N, 512) for B in (64, 12) for N in (1024, 2048)]
BC_CASES += [(1, 77, 20), (3, 1024, 300), (140, 512, 256), (2, 2047, 129), (2, 2049, 129),
             (1, 32768, 512), (12, 32768, 512), (5, 0, 7)]


@pytest.mark.parametrize("B,N,M", BC_CASES, ids=[f"B{b}_N{n}_M{m}" for b, n, m in BC_CASES])
def test_ball_count_plan(plan_lib, B, N, M):
    p = bc_plan(plan_lib, B, N, M)
    assert p is not None
    assert (p["lanes"], p["cpt"]) in ((32, 4), (32, 2), (16, 2), (8, 2), (8, 1))
    assert p["lanes"] * p["splits"] == 256 and p["centroids"] == p["lanes"] * p["cpt"]
    assert p["blocks"] == B * -(-M // p["centroids"])
    r4 = -(-N // 4) * 4
    assert p["tile"] == min(r4, 2048)
    # the busiest SM holds no more centroids than under any other option
    load = -(-p["blocks"] // H100_SMS) * p["centroids"]
    for lanes, cpt in ((32, 4), (32, 2), (16, 2), (8, 2), (8, 1)):
        assert load <= -(-(B * -(-M // (lanes * cpt))) // H100_SMS) * lanes * cpt
    if B in (12, 64) and M == 512:  # more than one block an SM
        assert p["blocks"] > H100_SMS
    _assert_layout(p, [("off_pts", 16 * p["tile"]), ("off_cnt", 4 * -(-p["centroids"] // 4) * 4)])


def test_ball_count_plan_choices(plan_lib):
    # a request: 128 centroids a block, 256 blocks; a frame call: 16, 384
    assert {k: bc_plan(plan_lib, 64, 1024, 512)[k] for k in ("lanes", "cpt", "blocks")} == \
        {"lanes": 32, "cpt": 4, "blocks": 256}
    assert {k: bc_plan(plan_lib, 12, 1024, 512)[k] for k in ("lanes", "cpt", "blocks")} == \
        {"lanes": 8, "cpt": 2, "blocks": 384}
    assert bc_plan(plan_lib, 0, 1024, 512) is None and bc_plan(plan_lib, 2, 1024, 0) is None


def vit_plan(lib, N, D, bf16, limit=SMEM_LIMIT):
    out = (ctypes.c_int * len(VIT_FIELDS))()
    if lib.gp2_vit_attention_plan(N, D, int(bf16), limit, out) != 0:
        return None
    return dict(zip(VIT_FIELDS, out))


# (N, head dim, bf16, windowed): the flagship's 272 / 264 padded and 261
# unpadded tokens, the tiny configs' head dim 8, the old caps (896 bf16, 416
# float32 at head dim 64) and one past them, crops of 512 and 640 px (1,029
# and 1,605 tokens), head dim 128
VIT_CASES = [(272, 64, True, 0), (261, 64, True, 0), (264, 64, False, 0), (261, 64, False, 0),
             (40, 8, True, 0), (40, 8, False, 0), (896, 64, True, 0), (897, 64, True, 1),
             (416, 64, False, 0), (417, 64, False, 1), (1029, 64, True, 1),
             (1605, 64, True, 1), (1029, 64, False, 1), (1605, 64, False, 1),
             (1605, 128, True, 1), (1605, 128, False, 1), (1605, 16, False, 1)]


@pytest.mark.parametrize("N,D,bf16,windowed", VIT_CASES,
                         ids=[f"N{n}_D{d}_{'bf16' if b else 'f32'}" for n, d, b, _ in VIT_CASES])
def test_vit_attention_plan(plan_lib, N, D, bf16, windowed):
    p = vit_plan(plan_lib, N, D, bf16)
    assert p is not None and p["windowed"] == windowed
    dp = (64 if D <= 64 else 128) if bf16 else next(d for d in (16, 32, 64, 128) if D <= d)
    assert p["dp"] == dp
    # the whole head, or a window of about 64 KB of K and V
    assert p["keys"] == (-(-N // 16) * 16 if not windowed else
                         {True: {64: 256, 128: 128}, False: {16: 128, 32: 128, 64: 128,
                                                             128: 64}}[bf16][dp])
    row = 2 * 128 * (dp // 64) if bf16 else 2 * 4 * (dp + 4)
    assert p["smem_bytes"] == p["keys"] * row + (1024 if bf16 else 0) <= SMEM_LIMIT
    if windowed:
        assert p["smem_bytes"] <= 68 * 1024  # three blocks an SM
        # the whole head would not fit: the route switch is the shared memory
        assert -(-N // 16) * 16 * row + (1024 if bf16 else 0) > SMEM_LIMIT


def test_vit_attention_plan_refuses(plan_lib):
    # head dims above 128 (and none) stay refused; no token, no plan
    assert vit_plan(plan_lib, 272, 136, True) is None
    assert vit_plan(plan_lib, 272, 136, False) is None
    assert vit_plan(plan_lib, 272, 0, True) is None
    assert vit_plan(plan_lib, 0, 64, True) is None


def ln_plan(lib, D, vec):
    out = (ctypes.c_int * 3)()
    if lib.gp2_ln_plan(D, int(vec), out) != 0:
        return None
    return dict(zip(("wide", "piece", "pieces"), out))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("D", [1, 48, 96, 128, 129, 190, 256, 384, 385, 512, 513, 1024, 1025,
                               1030, 1280, 2048, 2049, 4096, 4099, 8192])
def test_layernorm_plan(plan_lib, D, vec):
    """Rows to 1,024 keep the warp-a-row routes they had before the wide
    route (the same instantiations: a lane's pieces of 4, or elements), and
    rows past it take a 256-thread block a row; every piece of a row has a
    lane or thread, and no smaller instantiation would hold it."""
    p = ln_plan(plan_lib, D, vec)
    if D <= 1024:
        steps = [128, 256, 384, 512, 1024]
        counts = [1, 2, 3, 4, 8] if vec else [4, 8, 12, 16, 32]
        assert p == {"wide": 0, "piece": 4 if vec else 1,
                     "pieces": counts[next(k for k, s in enumerate(steps) if D <= s)]}
        threads = 32
    else:
        assert p["wide"] == 1 and p["piece"] == (4 if vec else 1)
        threads = 256
    held = threads * p["pieces"] * p["piece"]
    assert held >= D
    smaller = {0: {True: [1, 2, 3, 4, 8], False: [4, 8, 12, 16, 32]},
               1: {True: [2, 4, 8], False: [8, 16, 32]}}[p["wide"]][vec]
    below = [c for c in smaller if c < p["pieces"]]
    assert not below or threads * max(below) * p["piece"] < D


def test_layernorm_plan_refuses(plan_lib):
    assert ln_plan(plan_lib, 8193, True) is None and ln_plan(plan_lib, 8193, False) is None
    assert ln_plan(plan_lib, 0, True) is None
