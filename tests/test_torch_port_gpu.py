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
from genpose2_tpu_torch.models.scorenet import PoseScoreNet, fast_score_weights
from genpose2_tpu_torch.ops import _cuda
from genpose2_tpu_torch.ops.ball_query import ball_count, ball_count_plain
from genpose2_tpu_torch.ops.fps import fps_plain, furthest_point_sample
from genpose2_tpu_torch.ops.fused_sa import fused_sa_stage, fused_sa_stage_plain
from genpose2_tpu_torch.ops.ode_rk4 import fused_rk4_integrate, fused_rk4_plain
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
