"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips inside the test where there is no
card. The module imports neither JAX nor the JAX package, so it also runs on
a machine with the card and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_port_gpu.py

Discrete outputs (FPS indices, ball counts) must match exactly; float outputs
to the tolerance stated at each assert.
"""

import dataclasses

import numpy as np
import pytest
import torch

import genpose2_tpu_torch.models.vit as port_vit
from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
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


def test_fps_kernel_matches_plain(card):
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-0.5, 0.5, size=(4, 1024, 3)).astype(np.float32)
    xyz[:, 512:600] = xyz[:, :88]  # duplicates tie; ties go to the lowest index
    x = torch.from_numpy(xyz).to(card)
    torch.testing.assert_close(furthest_point_sample(x, 256), fps_plain(x, 256), rtol=0, atol=0)
    assert _cuda.launch_counts["fps"] >= 1


def test_ball_count_kernel_matches_plain(card):
    rng = np.random.default_rng(8)
    xyz = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(3, 1024, 3)).astype(np.float32)).to(card)
    new_xyz = xyz[:, :300].contiguous()
    torch.testing.assert_close(ball_count(xyz, new_xyz, 0.1), ball_count_plain(xyz, new_xyz, 0.1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("B,N,M,radius,nsample,far", [
    (4, 1024, 512, 0.1, 32, False),  # a dense stage
    (2, 1000, 300, 0.2, 32, False),  # N not a multiple of 32, past the 32-point window
    (2, 512, 256, 0.3, 64, False),   # nsample above 32, above many hit counts
    (3, 77, 20, 0.25, 16, False),    # M below one block's tile
    (2, 256, 40, 0.1, 8, True),      # no hit at all: every slot 0
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


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,C", [(512, 96), (256, 256), (128, 512), (64, 1024), (37, 32)])
def test_relpe_attention_kernel_matches_plain(card, compute_dtype, M, C):
    g = torch.Generator().manual_seed(15)
    pe = _randomize(EfficientRelativePositionalEncoding(8), 16).to(card)
    xyz = (torch.rand(2, M, 3, generator=g) * 0.3).to(card)
    q, k, v = (_normal(g, (2, M, C), card) for _ in range(3))
    with torch.no_grad():
        got = relpe_attention(xyz, q, k, v, pe, 8, compute_dtype)
        want = relpe_attention_plain(xyz, q, k, v, pe, 8, compute_dtype)
    # the JAX package's bounds for its kernel against the modules
    # (tests/test_ops.py:395, 405)
    tol = (2e-4, 2e-5) if compute_dtype == "float32" else (2e-2, 2e-2)
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
    """At the shared-memory limit the kernel matches its plain version; one
    token past it the wrapper raises a ValueError that names the limit."""
    dt = torch.bfloat16 if bf16 else torch.float32
    limit = vit_attention_max_tokens(C // 6, dt)
    assert limit >= 416  # the flagship's 272 tokens, and room beyond them
    g = torch.Generator().manual_seed(33)
    for N in (limit, limit + 1):
        q, k, v = (_normal(g, (1, N, C), card, dt) for _ in range(3))
        tab = dict(zip(("sin", "cos"), _rope_tables(N, N, C // 6, card))) if entry == "rope" else {}

        def run(f):
            if entry == "unpadded":
                return f(q, k, v, 6, n_valid=N - 3)
            return f(q, k, v, 6, n_valid=N - 3, **tab)

        kern, plain = ((vit_attention, vit_attention_plain) if entry == "unpadded"
                       else (vit_attention_tm, vit_attention_tm_plain))
        if N > limit:
            with pytest.raises(ValueError, match=f"at most {limit} tokens"):
                run(kern)
            continue
        tol = 2e-2 if bf16 else 1e-5
        torch.testing.assert_close(run(kern)[:, :N - 3], run(plain)[:, :N - 3], rtol=tol,
                                   atol=tol)


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
    p_cpu = cpu.sample_candidates(batch, repeat_num=4, T0=0.55, num_steps=8, prior=prior)
    p_gpu = gpu.sample_candidates(batch, repeat_num=4, T0=0.55, num_steps=8, prior=prior)
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-4, atol=5e-4)


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
