"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips inside the test where there is no
card. The module imports neither JAX nor the JAX package, so it also runs on
a machine with the card and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_port_gpu.py

Discrete outputs (FPS indices, ball counts) must match exactly; float outputs
to the tolerance stated at each assert.
"""

import contextlib
import copy
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

import genpose2_tpu_torch.models.vit as port_vit
from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import default_config, tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.data import synthetic_frame
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.models.attention import EfficientRelativePositionalEncoding
from genpose2_tpu_torch.models.scorenet import PoseScoreNet, fast_score_weights
from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ball_query import (ball_count, ball_count_plain, ball_query,
                                               ball_query_plain)
from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import (fused_group_mlp_pool, fused_group_mlp_pool_plain,
                                             fused_sa_scale, fused_sa_scale_plain, fused_sa_stage,
                                             fused_sa_stage_plain)
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.models.vit import rope_tables
from genpose2_tpu_torch.ops.layernorm import (fast_add_layernorm, fast_add_layernorm_plain,
                                              fast_layernorm, fast_layernorm_plain,
                                              fast_residual_layernorm,
                                              fast_residual_layernorm_plain)
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate, fused_rk4_plain
from genpose2_tpu_torch.ops.relpe_attention import relpe_attention, relpe_attention_plain
from genpose2_tpu_torch.ops.vit_attention import (vit_attention, vit_attention_max_tokens,
                                                  vit_attention_plain, vit_attention_tm,
                                                  vit_attention_tm_plain)
from genpose2_tpu_torch.training.agent import PoseAgent

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p + torch.randn(p.shape, generator=g) * 0.05)
        for name, b in module.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
            elif name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
    return module


@pytest.mark.parametrize("cloud", ["uniform", "duplicates", "all_equal"])
@pytest.mark.parametrize("B", [1, 4, 12, 64, 140])  # 140: more objects than SMs
@pytest.mark.parametrize("N", [77, 128, 1000, 1024, 2048, 4096, 8192])  # 4096, 8192: 16 warps
def test_fps_kernel_matches_plain(card, N, B, cloud):
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)
    if cloud == "duplicates":  # exact copies tie; ties go to the lowest index
        k = min(88, N - N // 2)
        xyz[:, N // 2:N // 2 + k] = xyz[:, :k]
    elif cloud == "all_equal":  # every distance 0: every pick is index 0
        xyz[:] = xyz[:, :1]
    x = torch.from_numpy(xyz).to(card)
    for npoint in (1, 2, N // 4, N):
        before = _cuda.launch_counts["fps"]
        got = furthest_point_sample(x, npoint)
        assert _cuda.launch_counts["fps"] == before + 1
        assert got.dtype == torch.int32 and got.shape == (B, npoint)
        torch.testing.assert_close(got, fps_plain(x, npoint), rtol=0, atol=0)
        if cloud == "all_equal":
            assert not got.any()


@pytest.mark.parametrize("B,N,npoint,cloud", [
    (1, 8193, 64, "uniform"),        # one point past the register plan: the wide route
    (12, 16384, 512, "uniform"),     # chip_smoke.py's shapes (a frame call's 12 objects)
    (12, 32768, 1024, "uniform"),
    (2, 20000, 300, "duplicates"),   # ties across the wide route's threads
    (1, 9000, 9000, "uniform"),      # every point picked
    (2, 40000, 256, "uniform"),      # a larger cloud
    (3, 32769, 64, "all_equal"),     # every distance 0
])
def test_fps_kernel_refuses_past_its_plan(card, B, N, npoint, cloud):
    """Past the register plan's 8,192 points the wide route runs, exact, one
    launch; what no plan covers (npoint past N) raises before any launch and
    never runs the plain version."""
    rng = np.random.default_rng(N + B)
    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)
    if cloud == "duplicates":  # every point four times, far apart in index
        xyz[:, N // 4:] = np.tile(xyz[:, :N // 4], (1, 4, 1))[:, :N - N // 4]
    elif cloud == "all_equal":
        xyz[:] = xyz[:, :1]
    x = torch.from_numpy(xyz).to(card)
    before = _cuda.launch_counts["fps"]
    got = furthest_point_sample(x, npoint)
    assert _cuda.launch_counts["fps"] == before + 1
    torch.testing.assert_close(got, fps_plain(x, npoint), rtol=0, atol=0)
    with pytest.raises(ValueError, match="npoint"):
        furthest_point_sample(x, N + 1)
    assert _cuda.launch_counts["fps"] == before + 1


def test_ball_count_kernel_matches_plain(card):
    rng = np.random.default_rng(8)
    xyz = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(3, 1024, 3)).astype(np.float32)).to(card)
    new_xyz = xyz[:, :300].contiguous()
    torch.testing.assert_close(ball_count(xyz, new_xyz, 0.1), ball_count_plain(xyz, new_xyz, 0.1),
                               rtol=0, atol=0)


def _ellipsoids(rng, B, N):
    """chip_smoke.py's clouds: ellipsoid surfaces of 4-15 cm semi-axes."""
    d = rng.normal(size=(B, N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rng.uniform([-0.3, -0.3, 0.5], [0.3, 0.3, 1.2], size=(B, 1, 3))
    return (d * rng.uniform(0.04, 0.15, size=(B, 1, 3)) + c
            + rng.normal(0, 0.002, size=(B, N, 3))).astype(np.float32)


@pytest.mark.parametrize("B,N,M,radius,cloud", [
    (64, 1024, 512, 0.02, "ellipsoid"),    # the dense stage's centroid order, a request
    (12, 1024, 512, 0.02, "ellipsoid"),    # a frame call (8 lanes x 2 centroids a block)
    (64, 2048, 512, 0.02, "ellipsoid"),    # the dense path: one tile of 2,048
    (1, 77, 20, 0.25, "uniform"),          # fewer points than a thread's groups
    (140, 512, 256, 0.1, "uniform"),       # more objects than SMs
    (3, 1024, 300, 0.1, "uniform"),        # M not a multiple of the block's centroids
    (2, 2047, 129, 0.2, "uniform"),        # one point short of a 2,048-point tile
    (2, 2049, 129, 0.2, "uniform"),        # one point into the second tile; odd N
    (1, 32768, 512, 0.05, "uniform"),      # 16 tiles
    (12, 32768, 512, 0.02, "ellipsoid"),
    (2, 512, 64, 0.25, "grid"),            # points at the radius: d2 == r2 is no hit
    (3, 1000, 50, 0.1, "all_equal"),       # every point on every centroid
    (2, 5, 3, 0.1, "empty_radius"),        # no hit at all
])
def test_ball_count_kernel_shapes(card, B, N, M, radius, cloud):
    """Counts equal the plain version's at the paths' shapes, N 77-32,768,
    B 1-140, across tile edges, with ties at the radius and an all-equal
    cloud; one launch."""
    rng = np.random.default_rng(N + M)
    if cloud == "ellipsoid":
        xyz = _ellipsoids(rng, B, N)
    elif cloud == "grid":  # multiples of 1/8, exact in float32: d2 == 1/16 == r2 occurs
        xyz = (rng.integers(0, 8, size=(B, N, 3)) * 0.125).astype(np.float32)
    else:
        xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)
        if cloud == "all_equal":
            xyz[:] = xyz[:, :1]
    new_xyz = xyz[:, rng.choice(N, M, replace=N < M)].copy()
    if cloud == "empty_radius":
        new_xyz += 10.0
    x, c = torch.from_numpy(xyz).to(card), torch.from_numpy(new_xyz).to(card)
    before = _cuda.launch_counts["ball_count"]
    got = ball_count(x, c, radius)
    assert _cuda.launch_counts["ball_count"] == before + 1
    want = ball_count_plain(x, c, radius)
    assert got.dtype == torch.int32 and got.shape == (B, M)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if cloud == "grid":  # the ties were there to be missed
        d2 = ((x[:, None] - c[:, :, None]) ** 2).sum(-1)
        assert bool((d2 == 0.0625).any())
    if cloud == "all_equal":
        assert bool((got == N).all())
    if cloud == "empty_radius":
        assert not got.any()


@pytest.mark.parametrize("B,M,nsample,far_hits", [
    (2, 64, 32, False),   # random hits in every tile; fewer than nsample: every tile scanned
    (1, 512, 8, False),   # early exits at different tiles
    (2, 37, 16, True),    # centroid 0's hits at the tile edges
])
def test_ball_query_tiles(card, B, M, nsample, far_hits):
    """N = 32,768: eight 4,096-point tiles; hits in ascending order across
    tile edges, padding with the first hit, all zeros without hits."""
    N = 32768
    rng = np.random.default_rng(M + nsample)
    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, rng.choice(N, M, replace=False)].copy()
    if far_hits:
        new_xyz[:, 0] = 5.0
        new_xyz[:, 1] = 9.0  # no hit
        edges = [4094, 4095, 4096, 4097, 8191, 8192, 12288, 32767]
        xyz[:, edges] = 5.0 + rng.uniform(-0.01, 0.01, size=(B, len(edges), 3))
    x, c = torch.from_numpy(xyz).to(card), torch.from_numpy(new_xyz).to(card)
    before = _cuda.launch_counts["ball_query"]
    got = ball_query(x, c, 0.05, nsample)
    assert _cuda.launch_counts["ball_query"] == before + 1
    torch.testing.assert_close(got, ball_query_plain(x, c, 0.05, nsample), rtol=0, atol=0)
    if far_hits:
        want0 = edges[:nsample] + [edges[0]] * (nsample - len(edges))
        assert got[:, 0].tolist() == [want0] * B
        assert not got[:, 1].any()


@pytest.mark.parametrize("B,N,M,radius,nsample,far", [
    (4, 1024, 512, 0.1, 32, False),  # a dense stage
    (2, 1000, 300, 0.2, 32, False),  # N not a multiple of 32, past the 32-point window
    (2, 512, 256, 0.3, 64, False),   # nsample above 32, above many hit counts
    (3, 77, 20, 0.25, 16, False),    # M below one block's tile
    (2, 256, 40, 0.1, 8, True),      # no hit at all: every slot 0
    (2, 33, 20, 0.3, 16, False),     # one point past a 32-point sub-slot
    (2, 127, 50, 0.3, 32, False),    # one point short of a 128-point window
    (2, 129, 50, 0.3, 32, False),    # one point past it
    (64, 1024, 509, 0.05, 32, False),  # M not a multiple of the plan's 8 centroids a block
    (192, 256, 128, 0.08, 32, False),  # the batch-192 train step's stage 2 shape
])
def test_ball_query_kernel_matches_plain(card, B, N, M, radius, nsample, far):
    rng = np.random.default_rng(18)
    xyz = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)).to(card)
    new_xyz = xyz[:, :M].contiguous() + (10.0 if far else 0.0)
    before = _cuda.launch_counts["ball_query"]
    got = ball_query(xyz, new_xyz, radius, nsample)
    assert got.dtype == torch.int32 and got.shape == (B, M, nsample)
    torch.testing.assert_close(got, ball_query_plain(xyz, new_xyz, radius, nsample),
                               rtol=0, atol=0)
    assert _cuda.launch_counts["ball_query"] == before + 1


@pytest.mark.parametrize("last", [31, 127, 128, 255, 511])
@pytest.mark.parametrize("nsample", [16, 32])
def test_ball_query_window_edges(card, last, nsample):
    """Centroid 0's nsample-th hit is point ``last``: the last point of a
    32-point sub-slot (31), of a 128-point window (127, 255, 511) or the first
    of the next (128); hits after it are dropped, the rest stay in order."""
    rng = np.random.default_rng(last + nsample)
    B, N, M = 2, 512, 37
    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, 0] = 5.0
    for b in range(B):
        hits = np.sort(rng.choice(last, nsample - 1, replace=False)).tolist() + [last]
        hits += rng.choice(np.arange(last + 1, N), min(5, N - 1 - last), replace=False).tolist()
        xyz[b, hits] = 5.0 + rng.uniform(-0.02, 0.02, size=(len(hits), 3))
    x, c = torch.from_numpy(xyz).to(card), torch.from_numpy(new_xyz).to(card)
    got = ball_query(x, c, 0.05, nsample)
    torch.testing.assert_close(got, ball_query_plain(x, c, 0.05, nsample), rtol=0, atol=0)
    assert (got[:, 0, -1] == last).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("num_layers", [0, 2])
def test_fused_sa_kernel_matches_plain(card, bf16, num_layers):
    rng = np.random.default_rng(9)
    B, N, M = 2, 700, 40
    radii, nsamples = (0.1, 0.3), (8, 32)
    h1s = (16, 32)
    dt = torch.bfloat16 if bf16 else torch.float32

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card, dtype)

    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3))
    new_xyz = np.concatenate([xyz[:, : M - 1], np.full((B, 1, 3), 5.0)], axis=1)
    projs, centers, affines, weights = [], [], [], []
    for s in range(2):
        ws = [h1s[s]] + [48, 40][:num_layers]
        projs.append(t(rng.normal(size=(B, N, h1s[s])), dt))
        centers.append(t(rng.normal(size=(B, M, h1s[s]))))
        affines.append([(t(rng.uniform(0.5, 1.5, size=w)), t(rng.normal(size=w))) for w in ws])
        weights.append([t(rng.normal(size=(a, b)) / np.sqrt(a), dt)
                        for a, b in zip(ws[:-1], ws[1:])])
    args = (t(xyz), t(new_xyz), projs, centers, affines, weights, radii, nsamples)
    # f32: the same products summed in another order; bf16: the same bf16
    # operands on both sides, and a rare flip of one bf16 rounding
    tol = 1e-2 if bf16 else 1e-4
    torch.testing.assert_close(fused_sa_stage(*args), fused_sa_stage_plain(*args),
                               rtol=tol, atol=tol)


def _sa_scale_operands(rng, card, B, N, M, h1, num_layers, dt):
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card, dtype)

    ws = [h1] + [48, 40][:num_layers]
    proj = t(rng.normal(size=(B, N, h1)), dt)
    center = t(rng.normal(size=(B, M, h1)))
    affines = [(t(rng.uniform(0.5, 1.5, size=w)), t(rng.normal(size=w))) for w in ws]
    weights = [t(rng.normal(size=(a, b)) / np.sqrt(a), dt) for a, b in zip(ws[:-1], ws[1:])]
    return t, proj, center, affines, weights


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,N,M,radius,nsample,num_layers,far", [
    (2, 2048, 512, 0.1, 32, 2, False),  # the dense stage 0
    (2, 1000, 300, 0.2, 32, 2, False),  # N not a multiple of 32
    (2, 512, 256, 0.3, 64, 2, False),   # nsample 64
    (2, 256, 40, 0.1, 16, 2, True),     # no hit at all: the point-0 row
    (2, 700, 40, 0.2, 16, 0, False),    # no MLP layer: the projection pooled
])
def test_fused_sa_scale_kernel_matches_plain(card, bf16, B, N, M, radius, nsample, num_layers,
                                             far):
    rng = np.random.default_rng(21)
    dt = torch.bfloat16 if bf16 else torch.float32
    t, proj, center, affines, weights = _sa_scale_operands(rng, card, B, N, M, 32, num_layers,
                                                           dt)
    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3))
    new_xyz = xyz[:, :M] + (10.0 if far else 0.0)
    args = (t(xyz), t(new_xyz), proj, center, affines, weights, radius, nsample)
    before = _cuda.launch_counts["fused_sa_scale"]
    got = fused_sa_scale(*args)
    assert _cuda.launch_counts["fused_sa_scale"] == before + 1
    # as the stage kernel: f32 summation order; bf16 one flipped rounding
    tol = 1e-2 if bf16 else 1e-4
    torch.testing.assert_close(got, fused_sa_scale_plain(*args), rtol=tol, atol=tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_group_mlp_pool_kernel_matches_plain(card, bf16):
    rng = np.random.default_rng(22)
    B, N, M, S = 2, 1000, 300, 40
    dt = torch.bfloat16 if bf16 else torch.float32
    _, proj, center, affines, weights = _sa_scale_operands(rng, card, B, N, M, 32, 2, dt)
    idx = rng.integers(0, N, size=(B, M, S))
    idx[:, :20, 3] = -1  # outside [0, N): a zero row
    idx[:, 20:40, 7] = N
    idx[:, 40:60, 1:] = idx[:, 40:60, :1]  # one point in every slot
    idx[:, 60:80, 20:] = idx[:, 60:80, :20]  # repeats across the 32-slot window
    idx[:, 80] = -5  # every slot outside
    idx = torch.from_numpy(idx.astype(np.int32)).to(card)
    before = _cuda.launch_counts["fused_group_mlp_pool"]
    got = fused_group_mlp_pool(proj, idx, center, affines, weights)
    assert _cuda.launch_counts["fused_group_mlp_pool"] == before + 1
    tol = 1e-2 if bf16 else 1e-4
    torch.testing.assert_close(got, fused_group_mlp_pool_plain(proj, idx, center, affines,
                                                               weights), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["ve", "vp", "subvp"])
def test_rk4_kernel_matches_plain(card, mode):
    sde = init_sde(mode)
    net = _randomize(PoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T", 64), 10).to(card)
    g = torch.Generator().manual_seed(11)
    feat = torch.randn(100, 64, generator=g).to(card)
    x0 = (torch.randn(100, 9, generator=g) * 0.7).to(card)
    with torch.no_grad():
        w = fast_score_weights(net, feat)
        got = fused_rk4_integrate(x0, w, sde, 0.8, 10)
        want = fused_rk4_plain(x0, w, sde, 0.8, 10)
    # the JAX package's own bound for the fused kernel against the scan
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["ve", "vp", "subvp"])
@pytest.mark.parametrize("R,steps,T0", [
    (1, 50, 0.55),      # one row: a block of 16 rows with 15 empty
    (37, 50, 0.55),     # a partial last tile
    (600, 100, 0.15),   # a tracking call: 12 objects x 50 candidates
    (3200, 50, 0.55),   # a request: 64 objects x 50 candidates
    (6400, 100, 0.55),  # the benchmark's cells: 128 objects x 50, 100 blocks of 64
    (6400, 500, 0.55),
    (4300, 20, 0.55),   # blocks of 48 rows (float32: 40)
    (8449, 10, 0.55),   # one row past 64 x 132: 64-row blocks in two rounds
    (6400, 500, 0.15),  # the cells' rows from a tracking call's T0
    (64 * 132, 20, 0.55),  # the most one round holds: 132 blocks of 64
])
def test_rk4_kernel_flagship_widths(card, dtype, mode, R, steps, T0):
    """The score net at its real widths (pose MLP 256/256, three 256-wide
    heads: H1 = 768, D = 9), at the row counts of the serving paths."""
    sde = init_sde(mode)
    net = _randomize(PoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T", 128), 12).to(card)
    g = torch.Generator().manual_seed(13)
    feat = torch.randn(R, 128, generator=g).to(card)
    x0 = (torch.randn(R, 9, generator=g) * T0).to(card)
    with torch.no_grad():
        w = fast_score_weights(net, feat)
        assert (w["W1_pose"].shape, w["W2bd"].shape) == ((256, 768), (768, 9))
        before = _cuda.launch_counts["fused_rk4"]
        got = fused_rk4_integrate(x0, w, sde, T0, steps, dtype)
        assert _cuda.launch_counts["fused_rk4"] == before + 1
        want = fused_rk4_plain(x0, w, sde, T0, steps, dtype)
    # chip_smoke.py's bounds: f32 the JAX package's for the fused kernel
    # against the scan; bf16 looser (t rows kept f32 where the scan rounds)
    atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rk4_kernel_one_launch_one_round(card, dtype):
    """At the benchmark's 6,400 rows one integration is one launch of
    rk4_kernel (what the rk4_roofline metrics read), in one round of blocks
    on the card (launch_counts' fused_rk4_rounds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sde = init_sde("ve")
    net = _randomize(PoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T", 128), 17).to(card)
    g = torch.Generator().manual_seed(18)
    feat = torch.randn(6400, 128, generator=g).to(card)
    x0 = (torch.randn(6400, 9, generator=g) * 0.55).to(card)
    with torch.no_grad():
        w = fast_score_weights(net, feat)
        fused_rk4_integrate(x0, w, sde, 0.55, 5, dtype)  # built and loaded
        torch.cuda.synchronize()
        before = _cuda.launch_counts["fused_rk4_rounds"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_rk4_integrate(x0, w, sde, 0.55, 5, dtype)
            torch.cuda.synchronize()
    assert _cuda.launch_counts["fused_rk4_rounds"] == before + 1
    rx = re.compile(r"\brk4_kernel\b")
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and rx.search(ev.key))
    assert launches == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [3200, 6400])
def test_rk4_kernel_unaligned_weights(card, dtype, R):
    """Weight matrices whose base is not 16-byte aligned (views one element
    into a buffer) cannot be copied by the TMA: the wrapper copies them to
    aligned storage, to the bounds of test_rk4_kernel_flagship_widths."""
    sde = init_sde("vp")
    net = _randomize(PoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T", 128), 19).to(card)
    g = torch.Generator().manual_seed(20)
    feat = torch.randn(R, 128, generator=g).to(card)
    x0 = (torch.randn(R, 9, generator=g) * 0.55).to(card)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def unaligned(w):
        buf = torch.empty(w.numel() + 1, dtype=dt, device=card)
        view = buf[1:].view(w.shape)
        view.copy_(w)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    with torch.no_grad():
        w = fast_score_weights(net, feat)
        pm = w["pose_mlp"]
        w = {**w, "W1_pose": unaligned(w["W1_pose"]), "W2bd": unaligned(w["W2bd"]),
             "pose_mlp": {"Dense_0": {**pm["Dense_0"], "kernel": unaligned(pm["Dense_0"]["kernel"])},
                          "Dense_1": {**pm["Dense_1"], "kernel": unaligned(pm["Dense_1"]["kernel"])}}}
        got = fused_rk4_integrate(x0, w, sde, 0.55, 20, dtype)
        want = fused_rk4_plain(x0, w, sde, 0.55, 20, dtype)
    atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,steps", [(600, 20), (6400, 100)])
def test_rk4_kernel_repeats_bit_for_bit(card, dtype, R, steps):
    """Two launches on the same operands give the same bits: the partial
    slopes are added in a fixed order on both routes (no atomics)."""
    sde = init_sde("ve")
    net = _randomize(PoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T", 128), 21).to(card)
    g = torch.Generator().manual_seed(22)
    feat = torch.randn(R, 128, generator=g).to(card)
    x0 = (torch.randn(R, 9, generator=g) * 0.55).to(card)
    with torch.no_grad():
        w = fast_score_weights(net, feat)
        first = fused_rk4_integrate(x0, w, sde, 0.55, steps, dtype)
        second = fused_rk4_integrate(x0, w, sde, 0.55, steps, dtype)
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


# the Fus encoder's stage 2 and stage 3 (config.py: PointNet2Config.mlps)
SA_WIDE = {"stage2": ((128, 196, 256), (128, 196, 256)),
           "stage3": ((256, 256, 512), (256, 384, 512))}


def _sa_wide_case(card, widths, bf16, seed):
    """Operands of one two-scale stage at the given widths: B=2 objects of
    400 points, M=37 centroids (not a multiple of the 16-centroid tile), the
    last one far from every point (no hit), radii (0.2, 0.3): the small
    scale mostly partial, the large one mostly full."""
    rng = np.random.default_rng(seed)
    B, N, M = 2, 400, 37
    dt = torch.bfloat16 if bf16 else torch.float32

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(card, dtype)

    xyz = rng.uniform(-0.5, 0.5, size=(B, N, 3))
    new_xyz = np.concatenate([xyz[:, : M - 1], np.full((B, 1, 3), 5.0)], axis=1)
    projs, centers, affines, weights = [], [], [], []
    for ws in widths:
        projs.append(t(rng.normal(size=(B, N, ws[0])), dt))
        centers.append(t(rng.normal(size=(B, M, ws[0]))))
        affines.append([(t(rng.uniform(0.5, 1.5, size=w)), t(rng.normal(size=w))) for w in ws])
        weights.append([t(rng.normal(size=(a, b)) / np.sqrt(a), dt)
                        for a, b in zip(ws[:-1], ws[1:])])
    return t(xyz), t(new_xyz), projs, centers, affines, weights, (0.2, 0.3), (16, 32)


def _assert_sa_edges(xyz, new_xyz, radius, nsample):
    """The case holds a centroid with no hit, one whose hits fill nsample,
    and, in a 16-centroid tile, a centroid whose rows cross a multiple of 64
    (a row-chunk boundary at 32 and at 64 rows)."""
    rows = ball_count_plain(xyz, new_xyz, radius).clamp(max=nsample).cpu()
    assert (rows == 0).any() and (rows == nsample).any()
    rows = rows.clamp(min=1)
    crossing = False
    for b in range(rows.shape[0]):
        for m0 in range(0, rows.shape[1], 16):
            end = torch.cumsum(rows[b, m0:m0 + 16], 0)
            start = end - rows[b, m0:m0 + 16]
            crossing |= bool(((start // 64) != ((end - 1) // 64)).any())
    assert crossing


def _assert_sa_close(got, want, bf16):
    # chip_smoke.py's bounds: of max|plain|, f32 1e-4 (sums in another
    # order, 3xTF32), bf16 2e-2 (the same bf16 operands, a rare flip of one
    # bf16 rounding)
    tol = 2e-2 if bf16 else 1e-4
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("stage", sorted(SA_WIDE))
def test_fused_sa_stage_wide(card, bf16, stage):
    xyz, nxs, projs, centers, affines, weights, radii, nsamples = _sa_wide_case(
        card, SA_WIDE[stage], bf16, 31)
    for r, ns in zip(radii, nsamples):
        _assert_sa_edges(xyz, nxs, r, ns)
    args = (xyz, nxs, projs, centers, affines, weights, radii, nsamples)
    before = _cuda.launch_counts["fused_sa_stage"]
    got = fused_sa_stage(*args)
    assert _cuda.launch_counts["fused_sa_stage"] == before + 1
    _assert_sa_close(got, fused_sa_stage_plain(*args), bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("stage", sorted(SA_WIDE))
def test_fused_sa_scale_wide(card, bf16, stage):
    xyz, nxs, projs, centers, affines, weights, radii, nsamples = _sa_wide_case(
        card, SA_WIDE[stage], bf16, 32)
    for s in range(2):
        _assert_sa_edges(xyz, nxs, radii[s], nsamples[s])
        args = (xyz, nxs, projs[s], centers[s], affines[s], weights[s], radii[s], nsamples[s])
        before = _cuda.launch_counts["fused_sa_scale"]
        got = fused_sa_scale(*args)
        assert _cuda.launch_counts["fused_sa_scale"] == before + 1
        _assert_sa_close(got, fused_sa_scale_plain(*args), bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("stage", sorted(SA_WIDE))
def test_fused_group_mlp_pool_wide(card, bf16, stage):
    xyz, nxs, projs, centers, affines, weights, radii, nsamples = _sa_wide_case(
        card, SA_WIDE[stage], bf16, 33)
    for s in range(2):
        idx = ball_query_plain(xyz, nxs, radii[s], nsamples[s])
        idx[:, :5, 3] = -1  # outside [0, N): a zero row
        idx[:, 5:10, 1:] = idx[:, 5:10, :1]  # one point in every slot
        before = _cuda.launch_counts["fused_group_mlp_pool"]
        got = fused_group_mlp_pool(projs[s], idx, centers[s], affines[s], weights[s])
        assert _cuda.launch_counts["fused_group_mlp_pool"] == before + 1
        _assert_sa_close(got, fused_group_mlp_pool_plain(projs[s], idx, centers[s], affines[s],
                                                         weights[s]), bf16)


def _normal(gen, shape, card, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(card, dtype)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [48, 96, 384, 1024])
def test_layernorm_kernels_match_plain(card, bf16, D):
    g = torch.Generator().manual_seed(14)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, h = _normal(g, (3, 37, D), card, dt), _normal(g, (3, 37, D), card, dt)
    gamma, scale, bias = (_normal(g, (D,), card) for _ in range(3))
    # the same float32 statistics in another summation order; bf16 outputs
    # are one rounding of the same float32 value
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(fast_residual_layernorm(x, h, scale, bias),
                               fast_residual_layernorm_plain(x, h, scale, bias),
                               rtol=tol, atol=tol)
    for got, want in zip(fast_add_layernorm(x, h, gamma, scale, bias),
                         fast_add_layernorm_plain(x, h, gamma, scale, bias)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert _cuda.launch_counts["add_layernorm"] >= 1


# (B, M, C, inputs): the Fus encoder's four stage shapes, M = 37 and a ragged
# M = 200 (a multiple of neither the 16-row query tile nor the 32-key chunk)
# at B = 2; stage 0 at a frame call's B = 12; q and k scaled by 8 (scores of
# large magnitude, whose running max moves across key chunks: the online
# softmax); coincident points (duplicated xyz rows, dist = 0 off the diagonal)
RELPE_CASES = [(2, 512, 96, "normal"), (2, 256, 256, "normal"), (2, 128, 512, "normal"),
               (2, 64, 1024, "normal"), (2, 37, 32, "normal"), (2, 200, 96, "normal"),
               (12, 512, 96, "normal"), (2, 256, 256, "large"), (2, 128, 512, "large"),
               (2, 200, 96, "coincident")]


@torch.no_grad()
def _relpe_float64(xyz, q, k, v, pe):
    """The attention of relpe_attention_plain evaluated in float64."""
    B, M, C = q.shape
    D = C // 8

    def heads(t):
        return t.double().reshape(B, M, 8, D).transpose(1, 2)

    bias = copy.deepcopy(pe).double()(xyz.double())
    scores = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(D) + bias
    return (torch.softmax(scores, -1) @ heads(v)).transpose(1, 2).reshape(B, M, C)


# the plain float32 version's largest distance from float64 on the output
# with q and k scaled by 8, above its measured 1.2-7.6e-5 (H100)
PLAIN_F32_ERR = 8e-5


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,M,C,inputs", RELPE_CASES)
def test_relpe_attention_kernel_matches_plain(card, compute_dtype, B, M, C, inputs):
    g = torch.Generator().manual_seed(15)
    pe = _randomize(EfficientRelativePositionalEncoding(8), 16).to(card)
    xyz = torch.rand(B, M, 3, generator=g) * 0.3
    if inputs == "coincident":
        xyz[:, 100:160] = xyz[:, 20:80]
        xyz[:, 1] = xyz[:, 0]
    xyz = xyz.to(card)
    q, k, v = (_normal(g, (B, M, C), card) for _ in range(3))
    if inputs == "large":
        q, k = q * 8, k * 8
    before = _cuda.launch_counts["relpe_attention"]
    with torch.no_grad():
        got = relpe_attention(xyz, q, k, v, pe, 8, compute_dtype)
        want = relpe_attention_plain(xyz, q, k, v, pe, 8, compute_dtype)
    assert _cuda.launch_counts["relpe_attention"] == before + 1
    # the JAX package's bounds for its kernel against the modules
    # (tests/test_ops.py:395, 405)
    tol = (2e-4, 2e-5) if compute_dtype == "float32" else (2e-2, 2e-2)
    if inputs == "large" and compute_dtype == "float32":
        # scores of a few hundred: float32 itself errs by 1.2-7.6e-5 on the
        # output here (the plain version against float64, H100), so a kernel
        # that rounds otherwise cannot hold 2e-5 to the plain version. The
        # kernel is held instead to the float64 result, within the bounds
        # plus a fixed PLAIN_F32_ERR; the plain version must stay within
        # that too, so a drifting reference fails and widens nothing.
        exact = _relpe_float64(xyz, q, k, v, pe)
        plain_err = float((want.double() - exact).abs().max())
        assert plain_err <= PLAIN_F32_ERR
        torch.testing.assert_close(got.double(), exact, rtol=tol[0],
                                   atol=tol[1] + PLAIN_F32_ERR)
    else:
        torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])


# (B, N, n_valid, C) with 6 heads: C = 384 is the flagship's head dim 64,
# C = 48 the tiny configs' head dim 8; B = 64 a request's objects, B = 12 a
# frame call's
VIT_PADDED = [(64, 272, 261, 384), (12, 272, 261, 384), (3, 264, 261, 384), (12, 272, 261, 48),
              (3, 32, 21, 48), (2, 1, 1, 48), (2, 1, 1, 384)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,N,n_valid,C", VIT_PADDED)
def test_vit_attention_kernel_matches_plain(card, bf16, B, N, n_valid, C):
    g = torch.Generator().manual_seed(17)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_normal(g, (B, N, C), card, dt) for _ in range(3))
    before = _cuda.launch_counts["vit_attention"]
    got = vit_attention_tm(q, k, v, 6, n_valid=n_valid)
    assert _cuda.launch_counts["vit_attention"] == before + 1
    want = vit_attention_tm_plain(q, k, v, 6, n_valid=n_valid)
    # the JAX package's bounds (tests/test_ops.py:546, 566), on the real rows
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got[:, :n_valid], want[:, :n_valid], rtol=tol, atol=tol)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [48, 384, 1024])
def test_fast_layernorm_kernel_matches_plain(card, bf16, D):
    g = torch.Generator().manual_seed(29)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = _normal(g, (3, 37, D), card, dt) * 3.0 + 1.0
    scale, bias = (_normal(g, (D,), card) for _ in range(2))
    before = _cuda.launch_counts["layernorm"]
    got = fast_layernorm(x, scale, bias)
    assert _cuda.launch_counts["layernorm"] == before + 1 and got.dtype == dt
    # as the other LayerNorm kernels: float32 statistics in another order
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got, fast_layernorm_plain(x, scale, bias), rtol=tol, atol=tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,N,n_valid,C", [(64, 261, 261, 384), (12, 261, 261, 384),
                                           (3, 261, 261, 384), (12, 261, 261, 48),
                                           (3, 40, 33, 48), (3, 5, 5, 48), (3, 1, 1, 48),
                                           (2, 1, 1, 384)])
def test_unpadded_vit_attention_kernel_matches_plain(card, bf16, B, N, n_valid, C):
    g = torch.Generator().manual_seed(30)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_normal(g, (B, N, C), card, dt) for _ in range(3))
    before = _cuda.launch_counts["vit_attention_unpadded"]
    got = vit_attention(q, k, v, 6, n_valid=n_valid)
    assert _cuda.launch_counts["vit_attention_unpadded"] == before + 1
    # the JAX package's bounds (tests/test_ops.py:546, 566); every row is real
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got, vit_attention_plain(q, k, v, 6, n_valid=n_valid), rtol=tol,
                               atol=tol)


def _rope_tables(N, n_valid, hd, card):
    """The DINOv3 tables of a square patch grid of n_valid - 5 tokens (identity
    rows for the 5 prefix tokens and the pad rows); for a token axis without
    such a grid, random angles."""
    grid = int(round((n_valid - 5) ** 0.5)) if n_valid > 5 else 0
    if grid * grid != n_valid - 5 or grid == 0:
        ang = torch.rand((N, hd), generator=torch.Generator().manual_seed(32)) * 6.3
        return ang.sin().to(card), ang.cos().to(card)
    periods = 100.0 ** (torch.arange(hd // 4, dtype=torch.float32) / (hd // 4))
    sin, cos = rope_tables(periods, grid, grid)
    sin = torch.cat([torch.zeros(5, hd), sin, torch.zeros(N - n_valid, hd)]).to(card)
    cos = torch.cat([torch.ones(5, hd), cos, torch.ones(N - n_valid, hd)]).to(card)
    return sin, cos


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,N,n_valid,C", VIT_PADDED)
def test_rope_vit_attention_kernel_matches_plain(card, bf16, B, N, n_valid, C):
    g = torch.Generator().manual_seed(31)
    dt = torch.bfloat16 if bf16 else torch.float32
    sin, cos = _rope_tables(N, n_valid, C // 6, card)
    q, k, v = (_normal(g, (B, N, C), card, dt) for _ in range(3))
    before = _cuda.launch_counts["vit_attention_rope"]
    got = vit_attention_tm(q, k, v, 6, n_valid=n_valid, sin=sin, cos=cos)
    assert _cuda.launch_counts["vit_attention_rope"] == before + 1
    want = vit_attention_tm_plain(q, k, v, 6, n_valid=n_valid, sin=sin, cos=cos)
    # the rope=False kernel's bounds: the rotation is the same float32
    # arithmetic (no FMA) on both sides and rounds to the input dtype once
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got[:, :n_valid], want[:, :n_valid], rtol=tol, atol=tol)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("entry", ["padded", "unpadded", "rope"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", [48, 384])
def test_vit_attention_token_limit(card, entry, bf16, C):
    """At the route switch (a head's K and V whole in shared memory), one
    token past it (key windows) and at crops of 512 and 640 px (1,029 and
    1,605 tokens) the kernel matches its plain version; a head dim past 128
    stays refused with a ValueError."""
    dt = torch.bfloat16 if bf16 else torch.float32
    limit = vit_attention_max_tokens(C // 6, dt)
    assert limit >= 416  # the flagship's 272 tokens, and room beyond them
    g = torch.Generator().manual_seed(33)
    kern, plain = ((vit_attention, vit_attention_plain) if entry == "unpadded"
                   else (vit_attention_tm, vit_attention_tm_plain))
    key = {"padded": "vit_attention", "unpadded": "vit_attention_unpadded",
           "rope": "vit_attention_rope"}[entry]
    for N in (limit, limit + 1, 1029, 1605):
        q, k, v = (_normal(g, (1, N, C), card, dt) for _ in range(3))
        tab = dict(zip(("sin", "cos"), _rope_tables(N, N, C // 6, card))) if entry == "rope" else {}

        def run(f):
            if entry == "unpadded":
                return f(q, k, v, 6, n_valid=N - 3)
            return f(q, k, v, 6, n_valid=N - 3, **tab)

        before = _cuda.launch_counts[key]
        got = run(kern)
        assert _cuda.launch_counts[key] == before + 1
        tol = 2e-2 if bf16 else 1e-5
        torch.testing.assert_close(got[:, :N - 3], run(plain)[:, :N - 3], rtol=tol, atol=tol)
        assert bool(torch.isfinite(got).all())
    q = _normal(g, (1, 40, 6 * 136), card, dt)
    with pytest.raises(ValueError, match="head dims up to 128"):
        kern(q, q, q, 6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,N,n_valid,C", [(12, 1029, 1029, 384), (12, 1605, 1605, 384),
                                           (2, 1605, 1600, 768), (2, 1040, 1029, 96)])
def test_vit_attention_long_axes(card, bf16, B, N, n_valid, C):
    """The three entries past the switch at a frame call's batch: crops of
    512 and 640 px (patch 16 + 5 tokens), head dim 128 and 16; to the rope
    =False kernel's bounds."""
    g = torch.Generator().manual_seed(34)
    dt = torch.bfloat16 if bf16 else torch.float32
    H = 6
    q, k, v = (_normal(g, (B, N, C), card, dt) for _ in range(3))
    sin, cos = _rope_tables(N, n_valid, C // H, card)
    tol = 2e-2 if bf16 else 1e-5
    for got, want in (
            (vit_attention_tm(q, k, v, H, n_valid), vit_attention_tm_plain(q, k, v, H, n_valid)),
            (vit_attention(q, k, v, H, n_valid), vit_attention_plain(q, k, v, H, n_valid)),
            (vit_attention_tm(q, k, v, H, n_valid, sin=sin, cos=cos),
             vit_attention_tm_plain(q, k, v, H, n_valid, sin=sin, cos=cos))):
        torch.testing.assert_close(got[:, :n_valid], want[:, :n_valid], rtol=tol, atol=tol)
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [96, 190, 384, 1024])  # 190: no multiple of 4, the scalar route
@pytest.mark.parametrize("rows", [1, 7, 1000, 17409])  # 17,409: the ViT's 64 x 272 rows + 1
def test_layernorm_rows(card, bf16, D, rows):
    """The three LayerNorm entries at ragged row counts, on the vector route
    (D a multiple of 4) and the scalar one; a width past 1,024 stays
    refused."""
    g = torch.Generator().manual_seed(D + rows)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, h = _normal(g, (rows, D), card, dt) * 2.0 + 0.5, _normal(g, (rows, D), card, dt)
    gamma, scale, bias = (_normal(g, (D,), card) for _ in range(3))
    tol = 2e-2 if bf16 else 1e-5  # as test_layernorm_kernels_match_plain
    counts = dict(_cuda.launch_counts)
    torch.testing.assert_close(fast_layernorm(x, scale, bias), fast_layernorm_plain(x, scale, bias),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(fast_residual_layernorm(x, h, scale, bias),
                               fast_residual_layernorm_plain(x, h, scale, bias), rtol=tol,
                               atol=tol)
    for got, want in zip(fast_add_layernorm(x, h, gamma, scale, bias),
                         fast_add_layernorm_plain(x, h, gamma, scale, bias)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for key in ("layernorm", "residual_layernorm", "add_layernorm"):
        assert _cuda.launch_counts[key] == counts.get(key, 0) + 1
    wide = _normal(g, (3, 8193), card, dt)
    with pytest.raises(ValueError, match="at most 8192"):
        fast_layernorm(wide, _normal(g, (8193,), card), _normal(g, (8193,), card))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [1280, 1030, 4096, 8192])  # 1,030: no multiple of 4, pieces of 1
@pytest.mark.parametrize("rows", [1, 7, 34817])  # 34,817: the 7B ViT's 128 x 272 rows + 1
def test_layernorm_wide_rows(card, bf16, D, rows):
    """The three LayerNorm entries past 1,024 (the wide route, a block a
    row) against the plain versions, aligned and one element off."""
    g = torch.Generator().manual_seed(D + rows)
    dt = torch.bfloat16 if bf16 else torch.float32
    x, h = _normal(g, (rows, D), card, dt) * 2.0 + 0.5, _normal(g, (rows, D), card, dt)
    gamma, scale, bias = (_normal(g, (D,), card) for _ in range(3))
    # as test_layernorm_kernels_match_plain: float32 statistics in another
    # order (over up to 8,192 terms), bf16 outputs one rounding of the value
    tol = 2e-2 if bf16 else 2e-5
    counts = dict(_cuda.launch_counts)
    for xs, hs in ((x, h), (_offset(g, (rows, D), card, dt), _offset(g, (rows, D), card, dt))):
        torch.testing.assert_close(fast_layernorm(xs, scale, bias),
                                   fast_layernorm_plain(xs, scale, bias), rtol=tol, atol=tol)
        torch.testing.assert_close(fast_residual_layernorm(xs, hs, scale, bias),
                                   fast_residual_layernorm_plain(xs, hs, scale, bias), rtol=tol,
                                   atol=tol)
        for got, want in zip(fast_add_layernorm(xs, hs, gamma, scale, bias),
                             fast_add_layernorm_plain(xs, hs, gamma, scale, bias)):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for key in ("layernorm", "residual_layernorm", "add_layernorm"):
        assert _cuda.launch_counts[key] == counts.get(key, 0) + 2


def test_vit7b_frame_on_card(card):
    """GenPose2 with the DINOv3 ViT-7B/16 backbone (published widths, four of
    its 40 blocks, bf16 held on the card) on one synthetic 640x480 frame:
    the request runs the backbone once through the kernels (the attention
    at head dim 128 and the wide add-LayerNorm a block each), and its
    candidates agree with the same request on the plain versions."""
    base = default_config()
    cfg = base.replace(model=dataclasses.replace(base.model, backbone="dinov3_vit7b16",
                                                 dino_dim=4096, backbone_depth=4,
                                                 dino_layer_ids=(0, 1, 3)))
    torch.manual_seed(36)
    eng = GenPose2(cfg, energy=True, scale=True, num_steps=8, device=card)
    assert eng.score_agent.provider.vit.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    gen = torch.Generator(card).manual_seed(39)  # output layers start at zero
    with torch.no_grad():
        for agent in (eng.score_agent, eng.energy_agent):
            for p in (*agent.model.parameters(), *agent.provider.vit.parameters()):
                p.add_((torch.randn(p.shape, generator=gen, device=card) * 0.02).to(p.dtype))
    rng = np.random.default_rng(37)
    objs = synthetic_frame.random_scene(rng, 3, 640, 480, 600.0, depth=(0.5, 0.8))
    raw = eng.front_end(synthetic_frame.render(rng, objs, 640, 480, 600.0))
    n, K = len(raw["mask_ids"]), cfg.eval.eval_repeat_num
    g = torch.Generator().manual_seed(38)
    prior = torch.randn(n * K, 9, generator=g) * 0.3
    t = torch.rand(n * K, 1, generator=g) * 9e-5 + 1e-5
    before = dict(_cuda.launch_counts)
    out = eng.serve_batch(raw, prior=prior, energy_t=t)
    assert _cuda.launch_counts["vit_attention"] == before.get("vit_attention", 0) + 4
    assert _cuda.launch_counts["add_layernorm"] == before.get("add_layernorm", 0) + 4
    with _cuda.plain_versions():
        plain = eng.serve_batch(raw, prior=prior, energy_t=t)
    assert out["candidates"].shape == (n, K, 9) and bool(torch.isfinite(out["candidates"]).all())
    # the kernels' and the plain versions' bf16 backbones differ by a bf16
    # step here and there (test_vit7b_backbone_on_card_matches_plain); eight
    # float32 RK4 steps carry that into the candidates (1.2e-3 on the H100)
    torch.testing.assert_close(out["candidates"], plain["candidates"], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bf16,B", [(True, 128), (False, 8)])
def test_vit_attention_head_dim_128(card, bf16, B):
    """The 7B ViT's attention: 32 heads of 128 over 272 tokens, 261 real
    (B = 128 crops in bf16, the cell's batch); float32 at 8 takes the key
    windows (a head's K and V past the shared memory)."""
    g = torch.Generator().manual_seed(32)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_normal(g, (B, 272, 4096), card, dt) for _ in range(3))
    before = _cuda.launch_counts["vit_attention"]
    got = vit_attention_tm(q, k, v, 32, n_valid=261)
    assert _cuda.launch_counts["vit_attention"] == before + 1
    want = vit_attention_tm_plain(q, k, v, 32, n_valid=261)
    # as test_vit_attention_kernel_matches_plain, on the real rows
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got[:, :261], want[:, :261], rtol=tol, atol=tol)
    assert bool(torch.isfinite(got).all())


def test_vit7b_backbone_on_card_matches_plain(card):
    """The DINOv3 ViT-7B/16 entry at its published widths (four of its 40
    blocks), built on the card with its matrices in bf16: the kernels
    (vit_attention_tm at head dim 128, the wide add-LayerNorm) against the
    plain versions on the card, on 8 crops of 256 px."""
    cfg = dataclasses.replace(tiny_flagship_config().model, backbone="dinov3_vit7b16",
                              dino_dim=4096, backbone_depth=4, backbone_dtype="bfloat16",
                              img_size=256, dino_layer_ids=(0, 1, 3))
    torch.manual_seed(33)
    prov = ImageFeatureProvider(cfg, device=card)
    assert prov.vit.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    gen = torch.Generator(card).manual_seed(34)
    with torch.no_grad():
        for p in prov.vit.parameters():
            p.add_((torch.randn(p.shape, generator=gen, device=card) * 0.02).to(p.dtype))
    rgb = torch.randn(8, 256, 256, 3, generator=gen, device=card)
    before = dict(_cuda.launch_counts)
    got = prov.patch_features(rgb)
    assert _cuda.launch_counts["vit_attention"] == before.get("vit_attention", 0) + 4
    assert _cuda.launch_counts["add_layernorm"] == before.get("add_layernorm", 0) + 4
    with _cuda.plain_versions():
        want = prov.patch_features(rgb)
    for a, b in zip(got, want):
        assert a.shape == (8, 256, 4096)
        # the bf16 stream of two routes: the attention's and the LayerNorm's
        # sums in another order, flipping a bf16 rounding (2^-8) here and
        # there through four blocks and the norm; relative to the tap's
        # largest value
        assert float((a - b).abs().max()) <= 3e-2 * float(b.abs().max())


def _offset(gen, shape, card, dtype=torch.float32):
    """A contiguous tensor one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return _normal(gen, (n + 1,), card, dtype)[1:].view(shape)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D", [96, 384, 1024])
def test_layernorm_misaligned_operands(card, bf16, D):
    """Operands off a 16-byte boundary (contiguous views one element into a
    buffer) take the scalar route of each entry, held to the plain version."""
    g = torch.Generator().manual_seed(D + 5)
    dt = torch.bfloat16 if bf16 else torch.float32
    rows = 1000
    x, h = _offset(g, (rows, D), card, dt), _offset(g, (rows, D), card, dt)
    gamma, scale, bias = (_offset(g, (D,), card) for _ in range(3))
    assert x.is_contiguous() and x.data_ptr() % 16 != 0 and scale.data_ptr() % 16 != 0
    tol = 2e-2 if bf16 else 1e-5  # as test_layernorm_kernels_match_plain
    counts = dict(_cuda.launch_counts)
    torch.testing.assert_close(fast_layernorm(x, scale, bias), fast_layernorm_plain(x, scale, bias),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(fast_residual_layernorm(x, h, scale, bias),
                               fast_residual_layernorm_plain(x, h, scale, bias), rtol=tol,
                               atol=tol)
    for got, want in zip(fast_add_layernorm(x, h, gamma, scale, bias),
                         fast_add_layernorm_plain(x, h, gamma, scale, bias)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for key in ("layernorm", "residual_layernorm", "add_layernorm"):
        assert _cuda.launch_counts[key] == counts.get(key, 0) + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switched_vit_on_card_matches_cpu(card, dtype, monkeypatch):
    """tiny_flagship_config's backbone with both switches on: the in-kernel
    RoPE attention, fast_layernorm and the deferred tails on the card against
    the plain versions on the CPU."""
    monkeypatch.setattr(port_vit, "_INKERNEL_ROPE", True)
    monkeypatch.setattr(port_vit, "_DEFER_TAIL", True)
    cfg = dataclasses.replace(tiny_flagship_config().model, backbone_dtype=dtype)
    torch.manual_seed(32)
    cpu = ImageFeatureProvider(cfg)
    _randomize(cpu.vit, 33)
    gpu = ImageFeatureProvider(cfg)
    gpu.vit.load_state_dict(cpu.vit.state_dict())
    gpu.vit.to(card)
    rgb = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(34))
    before = dict(_cuda.launch_counts)
    got = gpu.global_feature(rgb.to(card))
    want = cpu.global_feature(rgb)
    launched = {k: _cuda.launch_counts[k] - before.get(k, 0)
                for k in ("vit_attention_rope", "layernorm", "add_layernorm", "vit_attention")}
    bf16 = dtype == "bfloat16"
    assert launched == {"vit_attention_rope": 2, "layernorm": int(bf16),
                        "add_layernorm": 3 if bf16 else 0, "vit_attention": 0}
    # float32: summation order through two blocks; bf16: flipped roundings
    tol = 5e-2 if bf16 else 1e-4
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


def test_tiny_serving_path_on_card_matches_cpu(card):
    """Score agent at tiny_test_config: the kernels on the card against the
    plain versions on the CPU, with the same weights and the same prior."""
    cfg = tiny_test_config()
    cpu = PoseAgent(cfg, "score", device="cpu")
    _randomize(cpu.model, 12)
    gpu = PoseAgent(cfg, "score", device=card)
    gpu.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(13)
    pts = torch.rand(3, 128, 3, generator=g) - 0.5
    prior = torch.randn(3 * 4, 9, generator=g) * 0.5
    batch = {"pts": pts, "pts_center": pts.mean(1)}
    f_cpu, _ = cpu.extract_features(batch)
    f_gpu, _ = gpu.extract_features(batch)
    torch.testing.assert_close(f_gpu.cpu(), f_cpu, rtol=1e-4, atol=1e-4)
    p_cpu = cpu.sample_candidates(batch, repeat_num=4, T0=0.55, method="fixed", num_steps=8,
                                  prior=prior)
    p_gpu = gpu.sample_candidates(batch, repeat_num=4, T0=0.55, method="fixed", num_steps=8,
                                  prior=prior)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-4, atol=5e-4)


def test_tiny_rk45_sampling_on_card_matches_cpu(card):
    """sample_candidates' default method, the adaptive rk45 solver, at
    tiny_test_config: the encoder's kernels and the solver on the card
    against the plain versions on the CPU, same weights and prior. Bound: the
    candidates' 5e-4 plus sqrt(6 n) times the CPU result's spread when its
    prior moves by 1e-6 of itself (n the solver's iterations; see
    tests/test_torch_port_samplers.py:adaptive_bound); the card reads done
    at most every 8 steps."""
    cfg = tiny_test_config()
    cpu = PoseAgent(cfg, "score", device="cpu")
    _randomize(cpu.model, 14)
    gpu = PoseAgent(cfg, "score", device=card)
    gpu.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(15)
    pts = torch.rand(3, 128, 3, generator=g) - 0.5
    prior = torch.randn(3 * 4, 9, generator=g) * 0.5
    batch = {"pts": pts, "pts_center": pts.mean(1)}
    stats = {}
    p_cpu = cpu.sample_candidates(batch, repeat_num=4, T0=0.55, prior=prior, stats=stats)
    spread = max(float((cpu.sample_candidates(batch, repeat_num=4, T0=0.55,
                                              prior=prior * (1 + d)) - p_cpu).abs().max())
                 for d in (1e-6, -1e-6))
    gstats = {}
    p_gpu = gpu.sample_candidates(batch, repeat_num=4, T0=0.55, prior=prior, stats=gstats)
    n = len(stats["err_norm"])
    assert gstats["host_reads"] <= len(gstats["err_norm"]) // 8 + 1
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-4,
                               atol=5e-4 + (6 * n) ** 0.5 * spread)


def test_tiny_train_step_on_card_matches_cpu(card):
    """One score train step at tiny_test_config: the FPS and ball-query
    kernels and autograd on the card against the plain versions on the CPU,
    from the same weights, batch and explicit draws.

    The cloud is object-sized (a 30 cm cube), so that the 4 and 8 cm balls
    of stage 0 hold points: in a 1 m cube nearly every ball holds only its
    centroid, the first train-mode BatchNorm sees a batch variance near 0,
    and its gradient is float32 rounding amplified by 1/std (a relative
    perturbation of the cloud by 1e-7 moves it by up to 1.4e-3 of the
    largest gradient, against 7e-6 here)."""
    cfg = tiny_test_config()
    torch.manual_seed(19)  # the modules' own initialisation
    cpu = PoseAgent(cfg, "score", device="cpu")
    _randomize(cpu.model, 19)
    gpu = PoseAgent(cfg, "score", device=card)
    gpu.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(20)
    R = cfg.train.repeat_num
    batch = {"pts": (torch.rand(3, 128, 3, generator=g) - 0.5) * 0.3,
             "zero_mean_gt_pose": torch.randn(3, 9, generator=g) * 0.5}
    draws = {"t": torch.rand(R, 3, 1, generator=g) * 0.9 + 0.05,
             "z": torch.randn(R, 3, 9, generator=g)}
    l_cpu, _, g_cpu, _ = cpu.loss_and_grads(cpu.init_state(), batch, draws=draws)
    l_gpu, _, g_gpu, _ = gpu.loss_and_grads(gpu.init_state(),
                                            {k: v.to(card) for k, v in batch.items()}, draws=draws)
    # float32 summation order; gradients within the CPU tests' bound against
    # JAX, 5e-4 of the largest entry (tests/test_torch_port_train_step.py)
    assert abs(float(l_gpu.detach()) - float(l_cpu.detach())) <= 1e-4 * abs(float(l_cpu.detach()))
    gmax = max(float(v.abs().max()) for v in g_cpu.values() if v is not None)
    for k, v in g_cpu.items():
        if v is not None:
            assert float((g_gpu[k].cpu() - v).abs().max()) <= 5e-4 * gmax, k


def test_tiny_frame_on_card_matches_cpu(card):
    """GenPose2 at tiny_flagship_config on one synthetic frame, detection then
    tracking: the kernels on the card against the plain versions on the CPU,
    same weights, same front-end batch, same prior and energy times."""
    cfg = tiny_flagship_config()
    torch.manual_seed(23)
    cpu = GenPose2(cfg, energy=True, scale=True, num_steps=8, device="cpu")
    for agent in (cpu.score_agent, cpu.energy_agent):
        _randomize(agent.model, 24)
        _randomize(agent.provider.vit, 25)
    _randomize(cpu.scale_agent.model, 26)
    gpu = GenPose2(cfg, score=_weights(cpu.score_agent), energy=_weights(cpu.energy_agent),
                   scale=cpu.scale_agent.model.state_dict(), num_steps=8, device=card)
    rng = np.random.default_rng(27)
    objs = synthetic_frame.random_scene(rng, 3, 160, 120, 150.0, depth=(0.5, 0.8))
    raw = cpu.front_end(synthetic_frame.render(rng, objs, 160, 120, 150.0))
    n, K = len(raw["mask_ids"]), cfg.eval.eval_repeat_num
    g = torch.Generator().manual_seed(28)
    prev = None
    for tracking in (False, True):
        prior = torch.randn(n * K, 9, generator=g) * 0.3
        t = torch.rand(n * K, 1, generator=g) * 9e-5 + 1e-5
        a = cpu.serve_batch(raw, prev, tracking, prior=prior, energy_t=t)
        b = gpu.serve_batch(raw, None if prev is None else prev.to(card), tracking,
                            prior=prior, energy_t=t)
        # the slice's bounds: features 2e-4, candidates the fused RK4's 5e-4
        torch.testing.assert_close(b["features"].cpu(), a["features"], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(b["candidates"].cpu(), a["candidates"], rtol=1e-4, atol=5e-4)
        agg = a["aggregate"]
        prev = torch.cat([agg["rotation"][..., 0], agg["rotation"][..., 1], agg["translation"]],
                         dim=-1)


def test_plain_versions_scope_launches_no_kernel(card):
    """A whole serve_batch at tiny_flagship_config inside
    ``_cuda.plain_versions()`` adds 0 to every launch_counts entry; the same
    call outside it launches the kernels of every layer (backbone, encoders,
    RK4) and agrees with it as the card and the CPU do."""
    cfg = tiny_flagship_config()
    torch.manual_seed(46)
    eng = GenPose2(cfg, energy=True, scale=True, num_steps=8, device=card)
    for agent in (eng.score_agent, eng.energy_agent):
        for module, k in ((agent.model, 47), (agent.provider.vit, 48)):
            module.load_state_dict(_randomize(copy.deepcopy(module).cpu(), k).state_dict())
    rng = np.random.default_rng(49)
    objs = synthetic_frame.random_scene(rng, 3, 160, 120, 150.0, depth=(0.5, 0.8))
    raw = eng.front_end(synthetic_frame.render(rng, objs, 160, 120, 150.0))
    n, K = len(raw["mask_ids"]), cfg.eval.eval_repeat_num
    g = torch.Generator().manual_seed(50)
    prior = torch.randn(n * K, 9, generator=g) * 0.3
    t = torch.rand(n * K, 1, generator=g) * 9e-5 + 1e-5
    eng.serve_batch(raw, prior=prior, energy_t=t)  # every library built and loaded
    before = dict(_cuda.launch_counts)
    with _cuda.plain_versions():
        plain = eng.serve_batch(raw, prior=prior, energy_t=t)
    assert dict(_cuda.launch_counts) == before
    out = eng.serve_batch(raw, prior=prior, energy_t=t)
    launched = {k: v - before.get(k, 0) for k, v in _cuda.launch_counts.items()}
    assert launched["fused_rk4"] == 1, launched
    for k in ("fps", "relpe_attention", "residual_layernorm", "vit_attention"):
        assert launched.get(k, 0) > 0, (k, launched)
    assert launched.get("fused_sa_stage", 0) + launched.get("fused_sa_scale", 0) > 0, launched
    # test_tiny_frame_on_card_matches_cpu's bounds
    torch.testing.assert_close(out["features"], plain["features"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out["candidates"], plain["candidates"], rtol=1e-4, atol=5e-4)


def _weights(agent):
    sd = dict(agent.model.state_dict())
    sd.update({f"dino.{k}": v for k, v in agent.provider.vit.state_dict().items()})
    return sd


@pytest.mark.parametrize("backbone", ["dinov3_vits16plus", "dinov2_vits16"])
def test_tiny_global_frame_on_card_matches_cpu(card, backbone):
    """GenPose2 with dino='global' at tiny_flagship_config on one synthetic
    frame: the kernels on the card against the plain versions on the CPU."""
    base = tiny_flagship_config()
    cfg = base.replace(model=dataclasses.replace(base.model, dino="global", backbone=backbone))
    torch.manual_seed(35)
    cpu = GenPose2(cfg, energy=True, scale=True, num_steps=8, device="cpu")
    for agent in (cpu.score_agent, cpu.energy_agent):
        _randomize(agent.model, 36)
        _randomize(agent.provider.vit, 37)
    _randomize(cpu.scale_agent.model, 38)
    gpu = GenPose2(cfg, score=_weights(cpu.score_agent), energy=_weights(cpu.energy_agent),
                   scale=cpu.scale_agent.model.state_dict(), num_steps=8, device=card)
    rng = np.random.default_rng(39)
    objs = synthetic_frame.random_scene(rng, 3, 160, 120, 150.0, depth=(0.5, 0.8))
    raw = cpu.front_end(synthetic_frame.render(rng, objs, 160, 120, 150.0))
    n, K = len(raw["mask_ids"]), cfg.eval.eval_repeat_num
    g = torch.Generator().manual_seed(40)
    prior = torch.randn(n * K, 9, generator=g) * 0.3
    t = torch.rand(n * K, 1, generator=g) * 9e-5 + 1e-5
    a = cpu.serve_batch(raw, prior=prior, energy_t=t)
    b = gpu.serve_batch(raw, prior=prior, energy_t=t)
    # the slice's bounds: features 2e-4 (the class token 1e-4, the backbone's),
    # candidates the fused RK4's 5e-4
    torch.testing.assert_close(b["rgb_features"].cpu(), a["rgb_features"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(b["features"].cpu(), a["features"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(b["candidates"].cpu(), a["candidates"], rtol=1e-4, atol=5e-4)


def test_tiny_evaluator_streaming_on_card_kernels_match_plain(card, tmp_path):
    """SingleFrameEvaluator.run_streaming at tiny_flagship_config on the
    card, two labelled batches (boxes, cylinders): the kernels against the
    plain versions on the card, with the same weights, batches and priors."""
    from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
    from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator
    from genpose2_tpu_torch.training.agent import ScaleAgent

    cfg = tiny_flagship_config()
    torch.manual_seed(41)
    s, e = PoseAgent(cfg, "score", device=card), PoseAgent(cfg, "energy", device=card)
    for agent, seed in ((s, 42), (e, 43)):
        for module, k in ((agent.model, seed), (agent.provider.vit, seed + 10)):
            module.load_state_dict(_randomize(copy.deepcopy(module).cpu(), k).state_dict())
    g = torch.Generator(device=card).manual_seed(45)
    Bt, N, S, K = (cfg.eval.batch_size, cfg.model.num_points, cfg.model.img_size,
                   cfg.eval.eval_repeat_num)
    batches, priors = [], []
    for i, shape in enumerate(("box", "cylinder")):
        b = SyntheticPoseData(N, shape).batch(g, Bt)
        b.update(roi_rgb=torch.randn(Bt, S, S, 3, generator=g, device=card),
                 roi_xs=torch.randint(0, S, (Bt, N), generator=g, device=card),
                 roi_ys=torch.randint(0, S, (Bt, N), generator=g, device=card),
                 class_label=torch.full((Bt,), i, dtype=torch.int32, device=card))
        batches.append(b)
        priors.append(s.sde.prior_sample((Bt * K, 9), T=cfg.eval.T0, generator=g, device=card))
    sc = ScaleAgent(cfg, pts_dim=s.extract_features(batches[0])[0].shape[-1], device=card)
    sc.model.load_state_dict(_randomize(copy.deepcopy(sc.model).cpu(), 44).state_dict())

    def scale_fn(batch, R, t, pts_feat=None):
        if pts_feat is None:
            pts_feat, _ = s.extract_features(batch)
        return sc.predict(pts_feat, R)

    out = {}
    for plain in (False, True):
        _cuda.reset_launch_counts()
        ev = SingleFrameEvaluator(cfg, s, e, scale_fn, out_dir=str(tmp_path / str(plain)))
        with _cuda.plain_versions() if plain else contextlib.nullcontext():
            ev.run_streaming(batches, priors=priors)
        counts = dict(_cuda.launch_counts)
        out[plain] = [dict(np.load(tmp_path / str(plain) / f"batch_{i:06d}.npz"))
                      for i in range(2)]
        if plain:
            assert not any(counts.values()), counts
        else:  # per batch: RK4 once, FPS once in each of the two encoders
            assert counts["fused_rk4"] == 2 and counts["fps"] == 4, counts
            assert counts["relpe_attention"] > 0 and counts["vit_attention"] > 0, counts
    for got, want in zip(out[False], out[True]):
        # float32: the slice's candidate bound 5e-4 carried through the
        # average; ScaleNet of features within 2e-4 and axes within 5e-4 of
        # each other: 1e-3; the translation error is 1-Lipschitz in the
        # translation (5e-4 m moves it under 0.1 cm). The rotation error is
        # not held here: about a continuous axis an upside-down prediction's
        # error turns on float32 rounding (chip_smoke.py:criteria_off)
        for k in ("rotation", "translation"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-4, err_msg=k)
        np.testing.assert_allclose(got["lengths"], want["lengths"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got["sht"], want["sht"], rtol=0, atol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,head", [(7, "R_and_T"), (6, "RT")])
@pytest.mark.parametrize("R,steps,T0", [
    (600, 100, 0.15),   # a tracking call: 12 objects x 50 candidates
    (3200, 50, 0.55),   # a request: 64 objects x 50 candidates
    (6400, 100, 0.55),  # 128 objects x 50: blocks of 64 rows (float32: 56)
    (6400, 500, 0.55),  # the eval cells' steps
    (4300, 20, 0.55),   # float32 blocks of 40 rows
])
def test_rk4_kernel_pose_mode_widths(card, dtype, D, head, R, steps, T0):
    """The quaternion modes' score net (R_and_T: two 256-wide heads, D = 7)
    and euler_xyz's (RT: one 512-wide head, D = 6): H1 = 512."""
    sde = init_sde("ve")
    net = _randomize(PoseScoreNet(sde.marginal_std, D, head, 128), 15).to(card)
    g = torch.Generator().manual_seed(16)
    feat = torch.randn(R, 128, generator=g).to(card)
    x0 = (torch.randn(R, D, generator=g) * T0).to(card)
    with torch.no_grad():
        w = fast_score_weights(net, feat)
        assert (w["W1_pose"].shape, w["W2bd"].shape) == ((256, 512), (512, D))
        before = _cuda.launch_counts["fused_rk4"]
        got = fused_rk4_integrate(x0, w, sde, T0, steps, dtype)
        assert _cuda.launch_counts["fused_rk4"] == before + 1
        want = fused_rk4_plain(x0, w, sde, T0, steps, dtype)
    # the bounds of test_rk4_kernel_flagship_widths (chip_smoke.py's)
    atol, rtol = (2e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("train", [False, True])
def test_segmsg_kernels_match_plain(card, train, monkeypatch):
    """PointNet2SegMSG at the default config (four grouped stages, 1,024
    points): every FPS and ball query of its forward against the plain
    version on the same inputs, exact; the logits within 1e-4 of their
    largest (the same float32 work on the same indices)."""
    from genpose2_tpu_torch.config import PointNet2Config
    from genpose2_tpu_torch.models import pointnet2 as pn2
    from genpose2_tpu_torch.models.pointnet2 import PointNet2SegMSG

    torch.manual_seed(17)
    model = _randomize(PointNet2SegMSG(PointNet2Config()), 18).to(card)
    g = torch.Generator().manual_seed(19)
    pts = (torch.rand(8, 1024, 3, generator=g) * 0.3 - 0.15).to(card)
    calls = []

    def recording(kernel, plain):
        def run(*a):
            got, want = kernel(*a), plain(*a)
            calls.append(torch.equal(got, want))
            return got
        return run

    monkeypatch.setattr(pn2, "furthest_point_sample", recording(furthest_point_sample, fps_plain))
    monkeypatch.setattr(pn2, "ball_query", recording(ball_query, ball_query_plain))
    before = {k: _cuda.launch_counts[k] for k in ("fps", "ball_query")}
    with torch.no_grad():
        got = model(pts, train, torch.Generator(card).manual_seed(1))
    launched = {k: _cuda.launch_counts[k] - n for k, n in before.items()}
    assert launched == {"fps": 4, "ball_query": 8}
    assert len(calls) == 12 and all(calls)
    with torch.no_grad(), _cuda.plain_versions():
        want = model(pts, train, torch.Generator(card).manual_seed(1))
    assert got.shape == (8, 1024, 1) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_one_nccl_rank_steps_equal_the_mesh_less_steps(card, monkeypatch, tmp_path):
    """A one-rank NCCL group (initialize_multihost's torchrun path) under a
    Trainer with a mesh: two tiny_flagship_config score steps (dropout and
    input jitter on), the collectives run and change no bit of the kernels'
    mesh-less steps."""
    from genpose2_tpu_torch.parallel.distributed import initialize_multihost, shutdown
    from genpose2_tpu_torch.parallel.launch import free_port
    from genpose2_tpu_torch.parallel.mesh import make_mesh
    from genpose2_tpu_torch.training.trainer import Trainer

    cfg = tiny_flagship_config()
    g = torch.Generator().manual_seed(21)
    batches = [{"pts": ((torch.rand(4, 128, 3, generator=g) - 0.5) * 0.3).to(card),
                "zero_mean_gt_pose": (torch.randn(4, 9, generator=g) * 0.5).to(card),
                "roi_rgb": torch.randn(4, 64, 64, 3, generator=g).to(card),
                "roi_xs": torch.randint(0, 64, (4, 128), generator=g).to(card),
                "roi_ys": torch.randint(0, 64, (4, 128), generator=g).to(card)}
               for _ in range(2)]
    torch.manual_seed(22)
    ref = PoseAgent(cfg, "score", device=card)
    state = ref.init_state()
    gen = torch.Generator(card).manual_seed(23)
    losses = [float(ref.train_step(state, b, gen)[1]["loss"]) for b in batches]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                     RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    assert initialize_multihost()
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_mesh()
        torch.manual_seed(22)
        tr = Trainer(cfg, "score", 1000, log_dir=str(tmp_path), mesh=mesh)
        tr.init()
        gen = torch.Generator(card).manual_seed(23)
        got = [float(tr.train_epoch([b], gen)["loss"]) for b in batches]
    finally:
        shutdown()
    assert got == losses
    mine = [*tr.state.params.values(), *tr.state.buffers.values(), *tr.state.ema_params.values()]
    theirs = [*state.params.values(), *state.buffers.values(), *state.ema_params.values()]
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert mesh.stats["gradients"]["count"] == 2 and mesh.stats["batch_norm"]["count"] > 0
    assert mesh.stats["batch_norm_backward"]["count"] == mesh.stats["batch_norm"]["count"]
