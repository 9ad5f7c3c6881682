"""The port's flagship path (dino='pointwise': DINOv3 ViT, ImgEncoder, Fus
PointNet++) against the JAX package's, at tiny_flagship_config (B=2, 128
points, 64-px crops, depth 2, dino_dim 48).

The same numpy inputs, made from a seed, and the same weights (JAX variables
randomised from a numpy seed, carried over by genpose2_tpu_torch/weights.py)
go through both packages; the JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them on the CPU. Each JAX side runs once per
module-scoped fixture. Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval.aggregate import aggregate_candidates as jax_aggregate
from genpose2_tpu.models.attention import EfficientRelativePositionalEncoding as JaxPE
from genpose2_tpu.models.attention import GatedAttentionFusion as JaxGAF
from genpose2_tpu.models.fast_encoder import _fast_gaf as jax_fast_gaf
from genpose2_tpu.models.fast_encoder import fast_fus_forward as jax_fast_fus_forward
from genpose2_tpu.models.img_encoder import ImgEncoder as JaxImgEncoder
from genpose2_tpu.models.layers import linear_resize_points as jax_resize
from genpose2_tpu.models.posenet import GFObjectPose as JaxGFObjectPose
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.models.provider import ImageFeatureProvider as JaxProvider
from genpose2_tpu.models.vit import load_dinov3_state_dict
from genpose2_tpu.ops.layernorm import fast_add_layernorm as jax_add_ln
from genpose2_tpu.ops.layernorm import fast_residual_layernorm as jax_residual_ln
from genpose2_tpu.ops.relpe_attention import relpe_attention as jax_relpe
from genpose2_tpu.ops.vit_attention import vit_attention_tm as jax_vit_attention_tm
from genpose2_tpu.training import torch_ingest
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu_torch.config import tiny_flagship_config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
from genpose2_tpu_torch.models.attention import (EfficientRelativePositionalEncoding,
                                                 GatedAttentionFusion)
from genpose2_tpu_torch.models.fast_encoder import _fast_gaf, fast_fus_forward
from genpose2_tpu_torch.models.img_encoder import ImgEncoder
from genpose2_tpu_torch.models.layers import linear_resize_points
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.ops.layernorm import fast_add_layernorm, fast_residual_layernorm
from genpose2_tpu_torch.ops.relpe_attention import relpe_attention
from genpose2_tpu_torch.ops.vit_attention import vit_attention_tm
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.weights import (StateDict, dinov3_state_dict, gated_fusion,
                                        img_encoder, posenet_state_dict, relative_pe,
                                        scalenet_state_dict)

B, N, S, K, STEPS, T0 = 2, 128, 64, 6, 8, 0.55


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(variables, seed, scale=0.1):
    """numpy copy of a variable tree with every leaf randomised (variances
    positive, Fourier weights and RoPE periods kept)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key in ("W", "rope_periods"):
            return x
        return (x + rng.normal(0.0, scale, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def _load(module, fill, *args):
    """A port module with the state dict that ``fill(StateDict, *args, key)`` writes."""
    d = StateDict()
    fill(d, *args, "m")
    module.load_state_dict({k[2:]: v for k, v in d.sd.items()})
    return module.eval()


def _model_cfg(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def _with_dtypes(cfg, compute_dtype, backbone_dtype=None):
    pn2 = dataclasses.replace(cfg.model.pointnet2, compute_dtype=compute_dtype)
    return _model_cfg(cfg, pointnet2=pn2, backbone_dtype=backbone_dtype or compute_dtype)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, size=(B, N, 3)).astype(np.float32)
    rgb = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    xs = rng.integers(0, S, (B, N)).astype(np.int32)
    ys = rng.integers(0, S, (B, N)).astype(np.int32)
    center = pts.mean(axis=1)
    jbatch = {"pts": jnp.asarray(pts), "pts_center": jnp.asarray(center),
              "zero_mean_gt_pose": jnp.zeros((B, 9)), "roi_rgb": jnp.asarray(rgb),
              "roi_xs": jnp.asarray(xs), "roi_ys": jnp.asarray(ys)}
    pbatch = {"pts": _t(pts), "pts_center": _t(center), "roi_rgb": _t(rgb),
              "roi_xs": torch.from_numpy(xs), "roi_ys": torch.from_numpy(ys)}
    return jbatch, pbatch


def _jax_agent(cfg, agent_type, batch, seed):
    agent = JaxPoseAgent(cfg, agent_type, steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), batch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    return agent, state, vs


def _port_agent(cfg, agent_type, vs):
    agent = PoseAgent(cfg, agent_type, device="cpu")
    agent.model.load_state_dict(posenet_state_dict(vs, cfg.model))
    agent.provider.vit.load_state_dict(dinov3_state_dict(vs["constants"][PROVIDER_KEY]))
    return agent


# ------------------------------------------------------------------ kernels' ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_ops_match_jax(dtype):
    rng = np.random.default_rng(1)
    x, h = (rng.normal(size=(3, 20, 48)).astype(np.float32) for _ in range(2))
    g, s, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(3))
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    jx, jh = jnp.asarray(x).astype(jdt), jnp.asarray(h).astype(jdt)
    px, ph = _t(x).to(pdt), _t(h).to(pdt)
    want = [jax_residual_ln(jx, jh, jnp.asarray(s), jnp.asarray(b)),
            *jax_add_ln(jx, jh, jnp.asarray(g), jnp.asarray(s), jnp.asarray(b))]
    got = [fast_residual_layernorm(px, ph, _t(s), _t(b)),
           *fast_add_layernorm(px, ph, _t(g), _t(s), _t(b))]
    for w, p in zip(want, got):
        assert p.dtype == pdt
        # float32: the JAX package's LayerNorm bound (tests/test_ops.py:599);
        # bf16: one rounding of the same float32 value, which may differ by
        # one bf16 step when the float32 values differ in the last bit
        tol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(p.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_relpe_attention_matches_jax(compute_dtype):
    rng = np.random.default_rng(2)
    Bq, M, C, H = 2, 72, 32, 8
    xyz = (rng.normal(size=(Bq, M, 3)) * 0.1).astype(np.float32)
    q, k, v = (rng.normal(size=(Bq, M, C)).astype(np.float32) for _ in range(3))
    pe_vars = randomize(JaxPE(H).init(jax.random.PRNGKey(0), jnp.asarray(xyz)), 3)
    want = jax_relpe(jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     pe_vars["params"], H, compute_dtype=compute_dtype)
    pe = _load(EfficientRelativePositionalEncoding(H), relative_pe, pe_vars["params"])
    with torch.no_grad():
        got = relpe_attention(_t(xyz), _t(q), _t(k), _t(v), pe, H, compute_dtype)
    assert got.dtype == torch.float32
    # the JAX package's bounds for its kernel (tests/test_ops.py:395, 405)
    tol = (2e-4, 2e-5) if compute_dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype,n_pad", [("float32", 24), ("bfloat16", 32)])
def test_vit_attention_matches_jax(dtype, n_pad):
    rng = np.random.default_rng(4)
    H, C, n_valid = 6, 48, 21
    q, k, v = (rng.normal(size=(2, n_pad, C)).astype(np.float32) for _ in range(3))
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = jax_vit_attention_tm(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), H,
                                n_valid=n_valid)
    got = vit_attention_tm(*(_t(a).to(pdt) for a in (q, k, v)), H, n_valid=n_valid)
    assert got.dtype == torch.float32
    # the JAX package's bounds (tests/test_ops.py:546, 566), on the real rows
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy()[:, :n_valid], np.asarray(want)[:, :n_valid],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("new_n", [64, 32, 48])
def test_linear_resize_points_matches_jax(new_n):
    x = np.random.default_rng(5).normal(size=(2, 128, 8)).astype(np.float32)
    # 2x is an average of pairs on both sides; other ratios interpolate
    np.testing.assert_allclose(linear_resize_points(_t(x), new_n).numpy(),
                               np.asarray(jax_resize(jnp.asarray(x), new_n)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fast_gaf_matches_jax(compute_dtype):
    rng = np.random.default_rng(6)
    C, M, C0 = 16, 24, 20
    cur = rng.normal(size=(2, M, C)).astype(np.float32)
    orig = rng.normal(size=(2, 48, C0)).astype(np.float32)
    vs = randomize(JaxGAF(C).init(jax.random.PRNGKey(0), jnp.asarray(cur), jnp.asarray(orig)), 7)
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if compute_dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    gaf_fn = jax.jit(jax_fast_gaf, static_argnums=4)
    want = gaf_fn(vs["params"], vs["batch_stats"], jnp.asarray(cur), jnp.asarray(orig), jdt)
    gaf = _load(GatedAttentionFusion(C, C0), gated_fusion, vs["params"], vs["batch_stats"])
    with torch.no_grad():
        got = _fast_gaf(gaf, _t(cur), _t(orig), pdt)
    # float32: the JAX package's bound for _fast_gaf (tests/test_models.py:424);
    # bf16: the port rounds each product's result to bf16 where JAX keeps float32
    tol = 2e-5 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_img_encoder_matches_jax(compute_dtype):
    rng = np.random.default_rng(8)
    layers = [rng.normal(size=(2, 16, 48)).astype(np.float32) for _ in range(3)]
    jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if compute_dtype == "bfloat16" else (None, None))
    jenc = JaxImgEncoder(48, 16, dtype=jdt)
    vs = randomize(jenc.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in layers]), 9)
    want = jenc.apply(vs, [jnp.asarray(x) for x in layers])
    enc = _load(ImgEncoder(48, 16, dtype=pdt), img_encoder, vs["params"])
    got = enc([_t(x) for x in layers])
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    # float32: summation order; bf16: the port rounds the dense layers' and
    # einsums' results alike, the conv accumulates in another order
    tol = 1e-5 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------- encoder and ViT
@pytest.fixture(scope="module")
def flagship():
    """JAX score and energy agents at tiny_flagship_config with random weights,
    one batch, and one request through both packages."""
    jcfg, pcfg = jax_flagship_config(), tiny_flagship_config()
    jbatch, pbatch = _batches()
    s_agent, s_state, s_vs = _jax_agent(jcfg, "score", jbatch, 1)
    e_agent, e_state, e_vs = _jax_agent(jcfg, "energy", jbatch, 2)
    scale_agent = JaxScaleAgent(jcfg)
    sc_state = scale_agent.init_state(jax.random.PRNGKey(3), pts_dim=128)
    sc_vs = randomize({"params": sc_state.params}, 3)
    sc_state = sc_state.replace(params=sc_vs["params"], ema_params=sc_vs["params"])

    key = jax.random.PRNGKey(4)
    prior = np.asarray(jax_init_sde(jcfg.sde).prior_sample(key, (B * K, 9), T=T0))
    jfeat_batch = s_agent.with_image_features(s_state, jbatch)
    feats = s_agent.extract_features(s_state, jfeat_batch)
    poses = s_agent.sample_candidates(s_state, jfeat_batch, key, repeat_num=K, T0=T0,
                                      method="fixed", num_steps=STEPS, features=feats)
    # the energy agent reuses the score agent's ViT layers, as bench.py does
    energy = e_agent.get_energy(e_state, jfeat_batch, poses, fixed_t=1e-5)
    ev = jcfg.eval
    agg = jax_aggregate(poses, energy, retain_ratio=ev.retain_ratio, clustering=True,
                        eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    lengths = scale_agent.predict(sc_state, feats[0], agg["rotation"])
    jv = {"params": s_vs["params"]}
    rgb = s_agent.model.apply(
        jv, s_agent.model.apply(jv, jfeat_batch["dino_layers"],
                                method=JaxGFObjectPose.fuse_dino_layers),
        jbatch["roi_xs"], jbatch["roi_ys"], method=JaxGFObjectPose.pointwise_rgb_feat)
    want = jax.tree_util.tree_map(np.asarray, {
        "encoder_input": jnp.concatenate([jbatch["pts"], rgb], axis=-1),
        "layers": list(jfeat_batch["dino_layers"]), "feat": feats[0], "poses": poses,
        "energy": energy, "agg": agg, "lengths": lengths})

    ps, pe = _port_agent(pcfg, "score", s_vs), _port_agent(pcfg, "energy", e_vs)
    psc = ScaleAgent(pcfg, pts_dim=128, device="cpu")
    psc.model.load_state_dict(scalenet_state_dict(sc_vs))
    pfeat_batch = ps.with_image_features(pbatch)
    feat, _ = ps.extract_features(pfeat_batch)
    p_poses = ps.sample_candidates(pfeat_batch, repeat_num=K, T0=T0, method="fixed",
                                   num_steps=STEPS, features=(feat, None), prior=_t(prior))
    # energies and aggregation take JAX's candidates, so that each stage is
    # compared on the same inputs
    p_energy = pe.get_energy(pfeat_batch, _t(want["poses"]))
    p_agg = aggregate_candidates(_t(want["poses"]), _t(want["energy"]),
                                 retain_ratio=ev.retain_ratio, clustering=True,
                                 eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    p_lengths = psc.predict(feat, _t(want["agg"]["rotation"]))
    got = {"layers": [t.numpy() for t in pfeat_batch["dino_layers"]], "feat": feat.numpy(),
           "poses": p_poses.numpy(), "energy": p_energy.numpy(),
           "agg": {k: v.numpy() for k, v in p_agg.items()}, "lengths": p_lengths.numpy()}
    return {"want": want, "got": got, "jcfg": jcfg, "pcfg": pcfg, "s_vs": s_vs, "e_vs": e_vs,
            "jbatch": jbatch, "pbatch": pbatch, "ps": ps, "s_model": s_agent.model}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fast_fus_forward_matches_jax(flagship, compute_dtype):
    pcfg = _with_dtypes(flagship["pcfg"], compute_dtype)
    vs = flagship["s_vs"]
    if compute_dtype == "float32":  # the encoder's input and output of the JAX request
        pc, want = flagship["want"]["encoder_input"], flagship["want"]["feat"]
    else:
        jcfg = _with_dtypes(flagship["jcfg"], compute_dtype)
        rng = np.random.default_rng(10)  # one object: interpret mode costs per grid step
        pc = np.concatenate([rng.uniform(-0.3, 0.3, size=(1, N, 3)),
                             rng.normal(size=(1, N, 48))], axis=-1).astype(np.float32)
        enc = {"params": vs["params"]["pts_encoder"],
               "batch_stats": vs["batch_stats"]["pts_encoder"]}
        want = np.asarray(jax_fast_fus_forward(enc, jnp.asarray(pc), jcfg.model.pointnet2))
    model = GFObjectPose(pcfg.model, lambda t: t, "score")
    model.load_state_dict(posenet_state_dict(vs, pcfg.model))
    got = fast_fus_forward(model.pts_encoder, _t(pc), pcfg.model.pointnet2).numpy()
    assert got.shape == want.shape == (pc.shape[0], 128)
    # float32: the JAX package's bound for the fast path against the module
    # (tests/test_models.py:446); bf16: its bf16 bound (:498)
    tol = 2e-4 if compute_dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("backbone_dtype", ["float32", "bfloat16"])
def test_dinov3_taps_match_jax(flagship, backbone_dtype):
    jcfg = _model_cfg(flagship["jcfg"], backbone_dtype=backbone_dtype)
    pcfg = _model_cfg(flagship["pcfg"], backbone_dtype=backbone_dtype)
    pvars = flagship["s_vs"]["constants"][PROVIDER_KEY]
    rgb = np.asarray(flagship["jbatch"]["roi_rgb"])
    want = JaxProvider(jcfg.model).patch_features(pvars, jnp.asarray(rgb))
    prov = ImageFeatureProvider(pcfg.model)
    prov.vit.load_state_dict(dinov3_state_dict(pvars))
    got = prov.patch_features(_t(rgb))
    # dino_layer_ids (0, 1, 1) at depth 2: block 1 is tapped once
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert g.shape == w.shape == (B, 16, 48)
        # float32: summation order through two blocks and the final norm;
        # bf16: the same bf16 residual stream, where a flipped rounding moves
        # a normalised tap by a bf16 step or two
        tol = 1e-4 if backbone_dtype == "float32" else 5e-2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_pointwise_rgb_feat_matches_jax(flagship):
    rng = np.random.default_rng(11)
    fused = rng.normal(size=(B, 16, 48)).astype(np.float32)
    xs = rng.integers(0, S + 20, (B, N)).astype(np.int32)  # some past the grid: clipped
    ys = rng.integers(0, S, (B, N)).astype(np.int32)
    want = flagship["s_model"].apply(
        {"params": flagship["s_vs"]["params"]}, jnp.asarray(fused), jnp.asarray(xs),
        jnp.asarray(ys), method=JaxGFObjectPose.pointwise_rgb_feat)
    got = flagship["ps"].model.pointwise_rgb_feat(_t(fused), torch.from_numpy(xs),
                                                  torch.from_numpy(ys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # a gather: exact


# ------------------------------------------------------------------- the slice
def test_slice_dino_layers_match(flagship):
    for g, w in zip(flagship["got"]["layers"], flagship["want"]["layers"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)  # as test_dinov3_taps


def test_slice_features_match(flagship):
    # the Fus encoder's float32 bound against the module (tests/test_models.py:446)
    np.testing.assert_allclose(flagship["got"]["feat"], flagship["want"]["feat"],
                               rtol=2e-4, atol=2e-4)


def test_slice_candidates_match(flagship):
    # the JAX package's bound for its fused RK4 against the scan
    # (tests/test_ode_fused.py:112)
    np.testing.assert_allclose(flagship["got"]["poses"], flagship["want"]["poses"],
                               rtol=1e-4, atol=5e-4)


def test_slice_energies_match(flagship):
    got, want = flagship["got"]["energy"], flagship["want"]["energy"]
    # s_theta divides by std(1e-5) ~ 0.01, so float32 differences of the
    # heads grow a hundredfold; relative agreement stays at the f32 level
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


def test_slice_aggregation_and_box_sizes_match(flagship):
    got, want = flagship["got"], flagship["want"]
    # aggregation takes the same candidates and energies on both sides
    np.testing.assert_array_equal(got["agg"]["retained"], want["agg"]["retained"])
    np.testing.assert_allclose(got["agg"]["rotation"], want["agg"]["rotation"], atol=1e-5)
    np.testing.assert_allclose(got["agg"]["translation"], want["agg"]["translation"],
                               atol=1e-6)
    # ScaleNet's float32 bound on the same features (test_torch_port_slice.py)
    np.testing.assert_allclose(got["lengths"], want["lengths"], rtol=2e-4, atol=2e-4)
    assert got["lengths"].shape == (B, 3)


def test_backbone_skipped_when_batch_carries_layers(flagship, monkeypatch):
    ps = flagship["ps"]
    batch = ps.with_image_features(flagship["pbatch"])
    calls = []
    monkeypatch.setattr(ps.provider, "patch_features", lambda *a, **k: calls.append(1))
    assert ps.with_image_features(batch) is batch
    ps.extract_features(batch)
    assert calls == []


@pytest.mark.parametrize("lacks", ["global_train_step", "pointnet_encoder"])
def test_port_refuses_what_it_lacks(lacks):
    """What the port once refused runs now (held against the JAX package in
    tests/test_torch_port_train_rest.py and test_torch_port_modes.py): a
    dino='global' train step moves the parameters, among them the heads';
    the PointNet encoder serves dino='global' and refuses dino='pointwise',
    where the JAX package fails."""
    _, pbatch = _batches()
    if lacks == "pointnet_encoder":
        with pytest.raises(ValueError, match="pointwise"):
            PoseAgent(_model_cfg(tiny_flagship_config(), pts_encoder="pointnet"), "score",
                      device="cpu")
        agent = PoseAgent(_model_cfg(tiny_flagship_config(), pts_encoder="pointnet",
                                     dino="global"), "score", device="cpu")
        feat, rgb = agent.extract_features(dict(pbatch, roi_center_dir=torch.ones(B, 3)))
        assert feat.shape == (B, 1024) and rgb.shape[0] == B
        assert bool(torch.isfinite(feat).all())
        return
    agent = PoseAgent(_model_cfg(tiny_flagship_config(), dino="global"), "score", device="cpu")
    batch = dict(pbatch, zero_mean_gt_pose=torch.zeros(B, 9), roi_center_dir=torch.ones(B, 3))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # output layers start at zero: no gradient would reach the encoder
        for p in agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    state = agent.init_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, metrics = agent.train_step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    moved = [k for k, p in state.params.items() if not torch.equal(p, before[k])]
    assert any(k.startswith("pts_encoder.") for k in moved)
    assert any(k.startswith("pose_score_net.fusion_tail") for k in moved)


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("agent_type", ["score", "energy"])
def test_posenet_weights_round_trip_exactly(flagship, agent_type):
    vs = flagship["s_vs" if agent_type == "score" else "e_vs"]
    jcfg, pcfg = flagship["jcfg"], flagship["pcfg"]
    back, dino = torch_ingest.convert_posenet_state_dict(posenet_state_dict(vs, pcfg.model),
                                                         jcfg.model)
    assert dino is None
    model_vars = {"params": vs["params"], "batch_stats": vs["batch_stats"],
                  "constants": {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}}
    want, got = flatten_dict(model_vars), flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))
    # and the port's modules take the state dict as it is
    PoseAgent(pcfg, agent_type, device="cpu").model.load_state_dict(
        posenet_state_dict(vs, pcfg.model))


def test_dinov3_weights_round_trip_exactly(flagship):
    pvars = flagship["s_vs"]["constants"][PROVIDER_KEY]
    # zeros of the same structure: a key the loader misses stays zero and fails
    init = jax.tree_util.tree_map(np.zeros_like, pvars)
    back = load_dinov3_state_dict(init, dinov3_state_dict(pvars))
    want, got = flatten_dict(pvars), flatten_dict(back)
    assert ("constants", "rope_periods") in want
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))
