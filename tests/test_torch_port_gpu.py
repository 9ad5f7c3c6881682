"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips inside the test where there is no
card. The module imports neither JAX nor the JAX package, so it also runs on
a machine with the card and without JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_port_gpu.py

Discrete outputs (FPS indices, ball counts) must match exactly; float outputs
to the tolerance stated at each assert.
"""

import numpy as np
import pytest
import torch

from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.models.attention import EfficientRelativePositionalEncoding
from genpose2_tpu_torch.models.scorenet import PoseScoreNet, fast_score_weights
from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ball_query import (ball_count, ball_count_plain, ball_query,
                                               ball_query_plain)
from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
from genpose2_tpu_torch.ops.layernorm import (fast_add_layernorm, fast_add_layernorm_plain,
                                              fast_residual_layernorm,
                                              fast_residual_layernorm_plain)
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate, fused_rk4_plain
from genpose2_tpu_torch.ops.relpe_attention import relpe_attention, relpe_attention_plain
from genpose2_tpu_torch.ops.vit_attention import vit_attention_tm, vit_attention_tm_plain
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


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N,n_valid,H", [(272, 261, 6), (264, 261, 6), (32, 21, 6)])
def test_vit_attention_kernel_matches_plain(card, bf16, N, n_valid, H):
    g = torch.Generator().manual_seed(17)
    dt = torch.bfloat16 if bf16 else torch.float32
    C = 384 if N > 32 else 48
    q, k, v = (_normal(g, (3, N, C), card, dt) for _ in range(3))
    got = vit_attention_tm(q, k, v, H, n_valid=n_valid)
    want = vit_attention_tm_plain(q, k, v, H, n_valid=n_valid)
    # the JAX package's bounds (tests/test_ops.py:546, 566), on the real rows
    tol = 2e-2 if bf16 else 1e-5
    torch.testing.assert_close(got[:, :n_valid], want[:, :n_valid], rtol=tol, atol=tol)
    assert bool(torch.isfinite(got).all())


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
