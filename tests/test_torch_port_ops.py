"""The port's ops (genpose2_tpu_torch/ops) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function (Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU) and the port's plain PyTorch version. Discrete outputs (FPS indices,
ball counts, hit order) must match exactly; float outputs to the tolerance
stated at each assert. The CUDA kernels are held against the plain versions
in tests/test_torch_port_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.models.scorenet import PoseScoreNet as JaxPoseScoreNet
from genpose2_tpu.models.scorenet import fast_score_weights as jax_fast_score_weights
from genpose2_tpu.ops.ball_query import ball_query as jax_ball_query
from genpose2_tpu.ops.ball_query_pallas import ball_count as jax_ball_count
from genpose2_tpu.ops.fps import fps_pallas, fps_ref
from genpose2_tpu.ops.fused_sa import fused_sa_stage as jax_fused_sa_stage
from genpose2_tpu.ops.ode_rk4 import _time_tables as jax_time_tables
from genpose2_tpu.ops.ode_rk4 import fused_rk4_integrate as jax_fused_rk4
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain, ball_query
from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
from genpose2_tpu_torch.ops.ode_rk4 import (_time_tables, fused_rk4_integrate, fused_rk4_plain,
                                            rk4_operands)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return _t(tree)


# ------------------------------------------------------------------- FPS
@pytest.mark.parametrize("duplicates", [False, True])
def test_fps_matches_jax(duplicates):
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-0.5, 0.5, size=(3, 200, 3)).astype(np.float32)
    if duplicates:  # exact copies tie in the running distance; ties go to the lowest index
        xyz[:, 100:150] = xyz[:, 0:50]
        xyz[:, 180:] = xyz[:, 20:40]
    want_ref = np.asarray(fps_ref(jnp.asarray(xyz), 64))
    want_pallas = np.asarray(fps_pallas(jnp.asarray(xyz), 64, 8))
    got = fps_plain(_t(xyz), 64).numpy()
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(furthest_point_sample(_t(xyz), 64).numpy(), want_ref)


def test_fps_all_equal_points_pick_lowest_index():
    xyz = np.zeros((2, 16, 3), np.float32)
    got = fps_plain(_t(xyz), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(fps_ref(jnp.asarray(xyz), 5)))
    np.testing.assert_array_equal(got, np.zeros((2, 5), np.int32))


# ------------------------------------------------------------- ball query
@pytest.mark.parametrize("radius", [0.1, 0.25, 0.6])
def test_ball_count_matches_jax(radius):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-0.5, 0.5, size=(2, 300, 3)).astype(np.float32)
    new_xyz = np.concatenate([xyz[:, :40], np.full((2, 1, 3), 5.0, np.float32)], axis=1)
    want = np.asarray(jax_ball_count(jnp.asarray(xyz), jnp.asarray(new_xyz), radius))
    np.testing.assert_array_equal(ball_count_plain(_t(xyz), _t(new_xyz), radius).numpy(), want)
    np.testing.assert_array_equal(ball_count(_t(xyz), _t(new_xyz), radius).numpy(), want)


def test_ball_query_matches_jax():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-0.5, 0.5, size=(2, 150, 3)).astype(np.float32)
    new_xyz = np.concatenate([xyz[:, :20], np.full((2, 1, 3), 5.0, np.float32)], axis=1)
    want = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(new_xyz), 0.2, 12))
    np.testing.assert_array_equal(ball_query(_t(xyz), _t(new_xyz), 0.2, 12).numpy(), want)


# ---------------------------------------------------------- fused SA stage
def _sa_inputs(seed, bf16):
    rng = np.random.default_rng(seed)
    B, N, M = 2, 200, 16
    radii, nsamples = (0.15, 0.4), (4, 8)
    h1s, widths = (8, 16), ((8, 12), (16, 8))
    xyz = rng.uniform(-0.4, 0.4, size=(B, N, 3)).astype(np.float32)
    new_xyz = np.concatenate([xyz[:, : M - 1], np.full((B, 1, 3), 5.0, np.float32)], axis=1)
    dt_np = jnp.bfloat16 if bf16 else jnp.float32
    projs, centers, affines, weights = [], [], [], []
    for s in range(2):
        projs.append(rng.normal(size=(B, N, h1s[s])).astype(np.float32))
        centers.append(rng.normal(size=(B, M, h1s[s])).astype(np.float32))
        ws = (h1s[s],) + widths[s]
        affines.append([(rng.uniform(0.5, 1.5, size=(w,)).astype(np.float32),
                         rng.normal(size=(w,)).astype(np.float32)) for w in ws])
        weights.append([(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
                        for a, b in zip(ws[:-1], ws[1:])])
    jax_args = (
        jnp.asarray(xyz), jnp.asarray(new_xyz),
        [jnp.asarray(p).astype(dt_np) for p in projs], [jnp.asarray(c) for c in centers],
        [[(jnp.asarray(a), jnp.asarray(c)) for a, c in aff] for aff in affines],
        [[jnp.asarray(w).astype(dt_np) for w in ws] for ws in weights],
        radii, nsamples,
    )
    dt = torch.bfloat16 if bf16 else torch.float32
    torch_args = (
        _t(xyz), _t(new_xyz), [_t(p).to(dt) for p in projs], [_t(c) for c in centers],
        [[(_t(a), _t(c)) for a, c in aff] for aff in affines],
        [[_t(w).to(dt) for w in ws] for ws in weights],
        radii, nsamples,
    )
    return jax_args, torch_args


@pytest.mark.parametrize("dynamic_skip", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_sa_stage_matches_jax(dynamic_skip, bf16):
    jax_args, torch_args = _sa_inputs(3, bf16)
    want = np.asarray(jax_fused_sa_stage(*jax_args, row_tile=16, slot_chunk=4,
                                         dynamic_skip=dynamic_skip))
    got = fused_sa_stage_plain(*torch_args).numpy()
    # f32: the JAX package's own bound for this path (tests/test_models.py:384);
    # bf16: both sides round the same operands to bf16 and sum in f32, so only
    # the f32 summation order differs, plus a rare flip of one bf16 rounding
    tol = 2e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(fused_sa_stage(*torch_args).numpy(), want, rtol=tol, atol=tol)


# --------------------------------------------------------------------- RK4
def _score_weights(seed, R):
    """Randomised JAX score net folded by fast_score_weights, as numpy."""
    sde = jax_init_sde("ve")
    net = JaxPoseScoreNet(sde.marginal_std, 9, "Rx_Ry_and_T")
    rng = np.random.default_rng(seed)
    pts_feat = rng.normal(size=(R, 32)).astype(np.float32)
    vs = net.init(jax.random.PRNGKey(seed), jnp.asarray(pts_feat), None,
                  jnp.zeros((R, 9)), jnp.full((R, 1), 0.5))
    vs = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(size=p.shape, scale=0.05).astype(np.float32), vs)
    w = jax_fast_score_weights(vs["params"], vs["constants"], jnp.asarray(pts_feat))
    return jax.tree_util.tree_map(np.asarray, w)


@pytest.mark.parametrize("mode", ["ve", "vp", "subvp"])
def test_fused_rk4_matches_jax(mode):
    R, n, T0 = 12, 6, 0.8
    w = _score_weights(4, R)
    x0 = np.random.default_rng(5).normal(size=(R, 9)).astype(np.float32) * 0.7
    want = np.asarray(jax_fused_rk4(jnp.asarray(x0), w, jax_init_sde(mode), T0, n))
    got = fused_rk4_plain(_t(x0), _to_torch(w), init_sde(mode), T0, n).numpy()
    # the JAX package's own bound for fused vs scan (tests/test_ode_fused.py:91)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    got = fused_rk4_integrate(_t(x0), _to_torch(w), init_sde(mode), T0, n).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,P1,P2,refused", [
    ("float32", 256, 256, False), ("float32", 512, 256, True), ("float32", 256, 512, True),
    ("bfloat16", 512, 256, False), ("bfloat16", 256, 512, False),
])
def test_rk4_operands_widths(dtype, P1, P2, refused):
    """The kernel's float32 route (wgmma) holds a 256-wide pose MLP, the
    score net's; bf16 (mma.sync) takes any multiple of 256."""
    w = _to_torch(_score_weights(7, 8))
    g = torch.Generator().manual_seed(8)
    H1 = w["static"].shape[1]
    w["pose_mlp"] = {"Dense_0": {"kernel": torch.randn(9, P1, generator=g), "bias": torch.zeros(P1)},
                     "Dense_1": {"kernel": torch.randn(P1, P2, generator=g), "bias": torch.zeros(P2)}}
    w["W1_pose"] = torch.randn(P2, H1, generator=g)
    x0 = torch.randn(8, 9, generator=g)
    if refused:
        with pytest.raises(ValueError, match="pose MLP widths"):
            rk4_operands(x0, w, init_sde("ve"), 0.55, 3, dtype)
    else:
        _, ints = rk4_operands(x0, w, init_sde("ve"), 0.55, 3, dtype)
        assert ints == (8, 9, P1, P2, H1, 3, int(dtype == "bfloat16"))


@pytest.mark.parametrize("mode", ["ve", "vp"])
def test_time_tables_match_jax(mode):
    w = _score_weights(6, 4)
    n = 5
    want = np.asarray(jax_time_tables(w, jax_init_sde(mode), 0.55, jax_init_sde(mode).eps, n))
    want = want.reshape(n, 8, -1)
    trows, scal = _time_tables(_to_torch(w), init_sde(mode), 0.55, init_sde(mode).eps, n)
    # sin/cos of Fourier arguments up to ~200 rad turn one f32 ulp of the
    # argument into ~1e-5 of the embedding, which the two matmuls carry on
    np.testing.assert_allclose(trows.numpy(), want[:, :3], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(scal.numpy(), want[:, 3, :7], rtol=1e-5, atol=1e-6)


def test_kernel_argument_checks():
    with pytest.raises(ValueError, match="dtype"):
        _cuda.require(torch.zeros(2, 3, dtype=torch.float64), "x", torch.float32, (2, 3),
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="shape"):
        _cuda.require(torch.zeros(2, 3), "x", torch.float32, (3, 2), torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.require(torch.zeros(3, 2).t(), "x", torch.float32, (2, 3), torch.device("cpu"))
