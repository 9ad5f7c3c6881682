"""The backbone registry (models/backbones.py) and the DINOv3 ViT-7B/16 entry
at a small width on the CPU: dim 256, 2 heads of 128, SwiGLU 512, no q/k/v
bias, 4 storage tokens, depth 2, 64-px crops.

- the registry's entries, its checks, and the S+ and DINOv2 entries building
  exactly the modules, the parameters and the seed's draws they built before
  the registry (flagship's weights from a seed stay the same);
- the 7B entry: held in bf16 where the configuration says so, its forward
  against the plain DINOv3 written from the published description
  (bench_port/reference_vit7b/dinov3_plain.py) on seeded random weights;
- the flagship pipeline at that width (ImgEncoder, the gated fusions, the
  Fus encoder) against the JAX package's;
- the plain LayerNorms at 4,096 against float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_port.reference_vit7b import dinov3_plain
from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.models.img_encoder import ImgEncoder as JaxImgEncoder
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu_torch.config import default_config, tiny_flagship_config
from genpose2_tpu_torch.models import backbones
from genpose2_tpu_torch.models.img_encoder import ImgEncoder
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.models.vit import DinoV3ViT, ViT
from genpose2_tpu_torch.ops.layernorm import (fast_add_layernorm_plain, fast_layernorm_plain,
                                              fast_residual_layernorm_plain)
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.weights import StateDict, img_encoder, posenet_state_dict

DIM = 256  # 2 heads of 128 at the 7B's head dim


def _model(cfg=None, **kw):
    cfg = cfg or tiny_flagship_config()
    return dataclasses.replace(cfg.model, **kw)


def _vit7b_model(dtype="float32", **kw):
    return _model(backbone="dinov3_vit7b16", dino_dim=DIM, backbone_dtype=dtype, **kw)


def _randomized(vit, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in vit.parameters():
            p.add_((torch.randn(p.shape, generator=g) * 0.02).to(p.dtype))
    return vit


# ------------------------------------------------------------------ registry
def test_registry_holds_the_published_architectures():
    r = backbones.BACKBONES
    assert set(r) == {"dinov3_vits16plus", "dinov3_vit7b16", "dinov2_vits16"}
    b7 = r["dinov3_vit7b16"]
    assert (b7.dim, b7.depth, b7.num_heads, b7.ffn_hidden, b7.qkv_bias, b7.storage_tokens) == \
        (4096, 40, 32, 8192, False, 4)
    assert b7.at(4096, 40) == {"dim": 4096, "depth": 40, "num_heads": 32, "ffn_hidden": 8192}
    splus = r["dinov3_vits16plus"]
    assert splus.at(384, 12) == {"dim": 384, "depth": 12, "num_heads": 6, "ffn_hidden": 1536}
    # a narrower width for tests: the 7B keeps its head dim, S+ its head count
    assert b7.at(DIM, 2) == {"dim": DIM, "depth": 2, "num_heads": 2, "ffn_hidden": 512}
    assert splus.at(48, 2) == {"dim": 48, "depth": 2, "num_heads": 6, "ffn_hidden": 192}


@pytest.mark.parametrize("backbone,dim,depth,match", [
    ("dinov3_vit7b16", 4096, 41, "40 blocks"),
    ("dinov3_vit7b16", 8192, 40, "width is 4096"),
    ("dinov3_vit7b16", 200, 2, "does not split"),
    ("dinov3_vits16plus", 36, 2, "does not split"),
    ("dinov3_vits16plus", 768, 12, "width is 384"),
    ("vit_huge", 384, 12, "registry"),
])
def test_registry_refuses_what_the_entry_cannot_take(backbone, dim, depth, match):
    m = _model(backbone=backbone, dino_dim=dim, backbone_depth=depth)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        ImageFeatureProvider(m)


@pytest.mark.parametrize("cfg", ["tiny_flagship", "default"])
def test_splus_entry_builds_what_it_built_before(cfg):
    """The S+ entry constructs the modules of before the registry, in the
    same order from the same generator: the same state dict, bit for bit,
    and the generator left where it was left before."""
    m = (tiny_flagship_config() if cfg == "tiny_flagship" else default_config()).model
    dt = torch.bfloat16 if m.backbone_dtype == "bfloat16" else None
    torch.manual_seed(5)
    want = DinoV3ViT(patch_size=m.patch_size, dim=m.dino_dim, depth=m.backbone_depth,
                     num_heads=6, num_storage_tokens=4, ffn_hidden=m.dino_dim * 4, dtype=dt)
    after = torch.randn(4)
    torch.manual_seed(5)
    got = ImageFeatureProvider(m).vit
    assert torch.equal(torch.randn(4), after)
    sd, wd = got.state_dict(), want.state_dict()
    assert list(sd) == list(wd)
    assert all(sd[k].dtype == torch.float32 and torch.equal(sd[k], wd[k]) for k in wd)
    assert got.blocks[0].attn.qkv.bias is not None and got.num_heads == 6


def test_dinov2_entry_builds_what_it_built_before():
    m = _model(backbone="dinov2_vits16")
    torch.manual_seed(6)
    want = ViT((m.img_size // m.patch_size) ** 2, patch_size=m.patch_size, dim=m.dino_dim,
               depth=m.backbone_depth, num_heads=6, dtype=None)
    torch.manual_seed(6)
    got = ImageFeatureProvider(m).vit
    sd, wd = got.state_dict(), want.state_dict()
    assert list(sd) == list(wd) and all(torch.equal(sd[k], wd[k]) for k in wd)


def test_vit7b_entry_holds_matrices_in_the_compute_dtype():
    vit = ImageFeatureProvider(_vit7b_model("bfloat16"), device="cpu").vit
    blk = vit.blocks[0]
    assert blk.attn.qkv.bias is None and blk.attn.proj.bias is not None
    assert vit.storage_tokens.shape == (1, 4, DIM) and vit.num_heads == 2
    assert blk.mlp.w1.weight.shape == (512, DIM)
    for name, p in vit.named_parameters():
        matrix = p.dim() >= 2 and not name.endswith(("cls_token", "storage_tokens"))
        assert p.dtype == (torch.bfloat16 if matrix else torch.float32), name
    # float32 configuration: float32 throughout
    vit32 = ImageFeatureProvider(_vit7b_model("float32"), device="cpu").vit
    assert all(p.dtype == torch.float32 for p in vit32.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit7b_entry_matches_the_plain_dinov3(dtype):
    torch.manual_seed(7)
    vit = _randomized(ImageFeatureProvider(_vit7b_model(dtype), device="cpu").vit, 8)
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(9))
    got = vit(x, (0, 1))
    want = dinov3_plain.forward(vit.state_dict(), x, (0, 1), 2,
                                torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 16, DIM) and g.dtype == torch.float32
        gap = float((g - w).abs().max()) / float(w.abs().max())
        # float32: summation order (padded token axis, fused w1|w2, the
        # patch embedding as one product) through two blocks and the norm;
        # bf16: the two round at other points (the port's patch embedding,
        # SwiGLU gate and RoPE in bf16, the plain one's in float32), a few
        # bf16 steps (2^-8 = 0.4%) of a tap's largest value
        assert gap < (2e-6 if dtype == "float32" else 2e-2), gap


# ----------------------------------------------------- the pipeline at 256
def _randomize_jax(variables, seed, scale=0.1):
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key == "W":
            return x
        return (x + rng.normal(0.0, scale, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_img_encoder_at_the_7b_width_matches_jax(compute_dtype):
    rng = np.random.default_rng(12)
    layers = [rng.normal(size=(2, 16, DIM)).astype(np.float32) for _ in range(3)]
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if compute_dtype == "bfloat16" else (None, None))
    jenc = JaxImgEncoder(DIM, 16, dtype=jdt)
    vs = _randomize_jax(jenc.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in layers]), 13)
    want = np.asarray(jenc.apply(vs, [jnp.asarray(x) for x in layers]))
    d = StateDict()
    img_encoder(d, vs["params"], "m")
    enc = ImgEncoder(DIM, 16, dtype=pdt)
    enc.load_state_dict({k[2:]: v for k, v in d.sd.items()})
    got = enc([torch.from_numpy(x) for x in layers]).numpy()
    # as test_torch_port_flagship.py:test_img_encoder_matches_jax, over 256
    # channels (the conv and the dense layers sum 5x more terms than at 48)
    tol = 2e-5 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flagship_features_at_the_7b_width_match_jax():
    """The score agent's point feature from given ViT taps at width 256:
    ImgEncoder, the per-point gather, the gated fusions and the Fus encoder,
    in float32."""
    B, N = 2, 128
    jcfg = jax_flagship_config()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, dino_dim=DIM, backbone="none"))
    pcfg = tiny_flagship_config()
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, dino_dim=DIM, backbone="none"))
    rng = np.random.default_rng(14)
    pts = rng.uniform(-0.3, 0.3, size=(B, N, 3)).astype(np.float32)
    layers = [rng.normal(size=(B, 16, DIM)).astype(np.float32) for _ in range(3)]
    xs, ys = (rng.integers(0, 64, (B, N)).astype(np.int32) for _ in range(2))
    jbatch = {"pts": jnp.asarray(pts), "pts_center": jnp.asarray(pts.mean(1)),
              "zero_mean_gt_pose": jnp.zeros((B, 9)), "roi_xs": jnp.asarray(xs),
              "roi_ys": jnp.asarray(ys), "dino_layers": [jnp.asarray(x) for x in layers]}
    agent = JaxPoseAgent(jcfg, "score", steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(1), jbatch)
    vs = _randomize_jax({"params": state.params, "batch_stats": state.batch_stats,
                         "constants": state.constants}, 15)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    want = np.asarray(agent.extract_features(state, jbatch)[0])
    port = PoseAgent(pcfg, "score", device="cpu")
    assert port.provider is None
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model))
    pbatch = {"pts": torch.from_numpy(pts), "roi_xs": torch.from_numpy(xs),
              "roi_ys": torch.from_numpy(ys),
              "dino_layers": [torch.from_numpy(x) for x in layers]}
    got = port.extract_features(pbatch)[0].numpy()
    assert got.shape == want.shape == (B, 128)
    # the JAX package's bound for the fast path against the module
    # (tests/test_models.py:446), as test_fast_fus_forward_matches_jax
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# -------------------------------------------------------- LayerNorm at 4,096
@pytest.mark.parametrize("D", [1280, 4096, 4099])
def test_plain_layernorms_at_wide_rows_match_float64(D):
    g = torch.Generator().manual_seed(D)
    x, h = torch.randn(5, D, generator=g) * 3 + 1, torch.randn(5, D, generator=g)
    gamma, scale, bias = (torch.randn(D, generator=g) for _ in range(3))

    def ln64(s):
        s = s.double()
        mu = s.mean(-1, keepdim=True)
        return ((s - mu) / torch.sqrt(((s - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
                * scale.double() + bias.double())

    # float32 statistics of float32 sums against float64: a few ulps of the
    # normalised value over 4,096 terms
    tol = 2e-5
    torch.testing.assert_close(fast_layernorm_plain(x, scale, bias).double(), ln64(x),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(fast_residual_layernorm_plain(x, h, scale, bias).double(),
                               ln64(x.double() + h.double()), rtol=tol, atol=tol)
    x2, ln = fast_add_layernorm_plain(x, h, gamma, scale, bias)
    torch.testing.assert_close(x2, x + h * gamma, rtol=0, atol=0)
    torch.testing.assert_close(ln.double(), ln64(x2), rtol=tol, atol=tol)
