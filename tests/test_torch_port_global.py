"""The port's dino='global' serving path against the JAX package's, on the CPU,
at tiny_flagship_config with dino='global' (B=2, 128 points, 64-px crops,
backbone depth 2, dino_dim 48, a 60-wide view-direction embedding), with the
DINOv3 backbone and with the DINOv2-style one.

The same numpy inputs, made from a seed, and the same weights (JAX variables
randomised from a numpy seed, carried over by genpose2_tpu_torch/weights.py)
go through both packages; the JAX Pallas kernels run in interpret mode. The
randomness is JAX's: the prior and the detection-mode energy times are drawn
from JAX's keys and handed to the port. Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from genpose2_tpu.api import GenPose2TPU
from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval.aggregate import aggregate_candidates as jax_aggregate
from genpose2_tpu.models.posenet import GFObjectPose as JaxGFObjectPose
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.models.provider import ImageFeatureProvider as JaxProvider
from genpose2_tpu.models.scorenet import fast_score_weights as jax_fast_score_weights
from genpose2_tpu.models.vit import load_torch_state_dict
from genpose2_tpu.training import torch_ingest
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu_torch.api import GenPose2
from genpose2_tpu_torch.config import tiny_flagship_config
from genpose2_tpu_torch.data import synthetic_frame
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.models.scorenet import fast_score_weights
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.weights import (dinov2_state_dict, dinov3_state_dict, posenet_state_dict,
                                        scalenet_state_dict)

B, N, S, K, STEPS, T0 = 2, 128, 64, 6, 8, 0.55
BACKBONES = ("dinov3_vits16plus", "dinov2_vits16")
RGB_DIM = 48 + 60


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


def _global(cfg, backbone="dinov3_vits16plus", **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, dino="global", backbone=backbone,
                                                 **kw))


def _backbone_sd(backbone, pvars):
    return (dinov3_state_dict if backbone == "dinov3_vits16plus" else dinov2_state_dict)(pvars)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, size=(B, N, 3)).astype(np.float32)
    rgb = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    cdir = rng.normal(size=(B, 3)).astype(np.float32)
    cdir /= np.linalg.norm(cdir, axis=-1, keepdims=True)
    center = pts.mean(axis=1)
    jbatch = {"pts": jnp.asarray(pts), "pts_center": jnp.asarray(center),
              "zero_mean_gt_pose": jnp.zeros((B, 9)), "roi_rgb": jnp.asarray(rgb),
              "roi_center_dir": jnp.asarray(cdir)}
    pbatch = {"pts": _t(pts), "pts_center": _t(center), "roi_rgb": _t(rgb),
              "roi_center_dir": _t(cdir)}
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
    agent.provider.vit.load_state_dict(_backbone_sd(cfg.model.backbone,
                                                    vs["constants"][PROVIDER_KEY]))
    return agent


@pytest.fixture(scope="module", params=BACKBONES)
def global_run(request):
    """JAX score, energy and scale agents at the global config with random
    weights, one request through both packages."""
    backbone = request.param
    jcfg = _global(jax_flagship_config(), backbone)
    pcfg = _global(tiny_flagship_config(), backbone)
    jbatch, pbatch = _batches()
    s_agent, s_state, s_vs = _jax_agent(jcfg, "score", jbatch, 1)
    e_agent, e_state, e_vs = _jax_agent(jcfg, "energy", jbatch, 2)
    scale_agent = JaxScaleAgent(jcfg)
    sc_state = scale_agent.init_state(jax.random.PRNGKey(3), pts_dim=128)
    sc_vs = randomize({"params": sc_state.params}, 3)
    sc_state = sc_state.replace(params=sc_vs["params"], ema_params=sc_vs["params"])

    key, dkey = jax.random.PRNGKey(4), jax.random.PRNGKey(5)
    prior = np.asarray(jax_init_sde(jcfg.sde).prior_sample(key, (B * K, 9), T=T0))
    det_t = np.asarray(jax.random.uniform(dkey, (B * K, 1), jnp.float32, 1e-5, 1e-4))
    jfeat_batch = s_agent.with_image_features(s_state, jbatch)
    feats = s_agent.extract_features(s_state, jfeat_batch)
    poses = s_agent.sample_candidates(s_state, jfeat_batch, key, repeat_num=K, T0=T0,
                                      method="fixed", num_steps=STEPS, features=feats)
    # the energy agent reuses the score agent's backbone feature
    energy = e_agent.get_energy(e_state, jfeat_batch, poses, fixed_t=1e-5)
    det_energy = e_agent.get_energy(e_state, jfeat_batch, poses, fixed_t=None, key=dkey)
    ev = jcfg.eval
    agg = jax_aggregate(poses, energy, retain_ratio=ev.retain_ratio, clustering=True,
                        eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    lengths = scale_agent.predict(sc_state, feats[0], agg["rotation"])
    want = jax.tree_util.tree_map(np.asarray, {
        "dino_global": jfeat_batch["dino_global"], "feat": feats[0], "rgb": feats[1],
        "poses": poses, "energy": energy, "det_energy": det_energy, "agg": agg,
        "lengths": lengths})

    ps, pe = _port_agent(pcfg, "score", s_vs), _port_agent(pcfg, "energy", e_vs)
    psc = ScaleAgent(pcfg, pts_dim=128, device="cpu")
    psc.model.load_state_dict(scalenet_state_dict(sc_vs))
    pfeat_batch = ps.with_image_features(pbatch)
    feat, rgb = ps.extract_features(pfeat_batch)
    p_poses = ps.sample_candidates(pfeat_batch, repeat_num=K, T0=T0, method="fixed",
                                   num_steps=STEPS, features=(feat, rgb), prior=_t(prior))
    # energies and aggregation take JAX's candidates, so that each stage is
    # compared on the same inputs
    p_energy = pe.get_energy(pfeat_batch, _t(want["poses"]))
    p_det = pe.get_energy(pfeat_batch, _t(want["poses"]), fixed_t=None, t=_t(det_t))
    p_agg = aggregate_candidates(_t(want["poses"]), _t(want["energy"]),
                                 retain_ratio=ev.retain_ratio, clustering=True,
                                 eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    p_lengths = psc.predict(feat, _t(want["agg"]["rotation"]))
    got = {"dino_global": pfeat_batch["dino_global"].numpy(), "feat": feat.numpy(),
           "rgb": rgb.numpy(), "poses": p_poses.numpy(), "energy": p_energy.numpy(),
           "det_energy": p_det.numpy(), "agg": {k: v.numpy() for k, v in p_agg.items()},
           "lengths": p_lengths.numpy()}
    return {"want": want, "got": got, "jcfg": jcfg, "pcfg": pcfg, "s_vs": s_vs, "e_vs": e_vs,
            "ps": ps, "pe": pe, "s_agent": s_agent, "e_agent": e_agent, "backbone": backbone}


# ------------------------------------------------------------------- backbone
@pytest.mark.parametrize("backbone", BACKBONES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_taps_and_global_feature_match_jax(backbone, dtype):
    jcfg = _global(jax_flagship_config(), backbone, backbone_dtype=dtype).model
    pcfg = _global(tiny_flagship_config(), backbone, backbone_dtype=dtype).model
    jprov = JaxProvider(jcfg)
    pvars = randomize(jprov.init(jax.random.PRNGKey(0)), 5)
    rgb = np.random.default_rng(6).normal(size=(B, S, S, 3)).astype(np.float32)
    want_taps = jprov.patch_features(pvars, jnp.asarray(rgb))
    want_cls = jprov.global_feature(pvars, jnp.asarray(rgb))
    prov = ImageFeatureProvider(pcfg)
    prov.vit.load_state_dict(_backbone_sd(backbone, pvars))
    got_taps = prov.patch_features(_t(rgb))
    got_cls = prov.global_feature(_t(rgb))
    assert len(got_taps) == len(want_taps) == 2  # layer ids (0, 1, 1) at depth 2
    assert got_cls.dtype == torch.float32 and got_cls.shape == want_cls.shape == (B, 48)
    # as test_dinov3_taps_match_jax: float32, summation order through two
    # blocks and the final norm; bf16, the bf16 products, softmax and GELU
    # (DINOv2: flax attention in bf16), where a flipped rounding moves a
    # normalised value by a bf16 step or two
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got_taps, want_taps):
        assert g.shape == w.shape == (B, 16, 48)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=tol, atol=tol)


def test_dinov2_bf16_differs_from_float32():
    """The DINOv2 block's bf16 setting does round: its class token moves off
    the float32 one by more than the float32 noise."""
    cfg = _global(tiny_flagship_config(), "dinov2_vits16").model
    rgb = _t(np.random.default_rng(8).normal(size=(B, S, S, 3)))
    out = {}
    for dtype in ("float32", "bfloat16"):
        prov = ImageFeatureProvider(dataclasses.replace(cfg, backbone_dtype=dtype))
        if out:
            prov.vit.load_state_dict(state)
        else:
            torch.manual_seed(0)
            with torch.no_grad():
                for p in prov.vit.parameters():
                    p.add_(torch.randn(p.shape) * 0.1)
            state = prov.vit.state_dict()
        out[dtype] = prov.global_feature(rgb)
    assert float((out["bfloat16"] - out["float32"]).abs().max()) > 1e-3


# --------------------------------------------------------------- model parts
def test_global_rgb_feature_matches_jax(global_run):
    rng = np.random.default_rng(9)
    dino = rng.normal(size=(B, 48)).astype(np.float32)
    cdir = rng.normal(size=(B, 3)).astype(np.float32)
    want = global_run["s_agent"].model.apply(
        {"params": global_run["s_vs"]["params"]},
        {"dino_global": jnp.asarray(dino), "roi_center_dir": jnp.asarray(cdir)},
        method=JaxGFObjectPose.extract_global_rgb_feature)
    got = global_run["ps"].model.extract_global_rgb_feature(_t(dino), _t(cdir))
    assert got.shape == want.shape == (B, RGB_DIM)
    # sin/cos of 2^k * direction for k < 10: float32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agent_type", ["score", "energy"])
def test_heads_with_rgb_match_jax(global_run, agent_type):
    rng = np.random.default_rng(10)
    R = 12
    pts_feat = rng.normal(size=(R, 128)).astype(np.float32)
    rgb = rng.normal(size=(R, RGB_DIM)).astype(np.float32)
    x = rng.normal(size=(R, 9)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=(R, 1)).astype(np.float32)
    vs = global_run["s_vs" if agent_type == "score" else "e_vs"]
    jmodel = global_run["s_agent" if agent_type == "score" else "e_agent"].model
    v = {"params": vs["params"], "constants": {"pose_net": vs["constants"]["pose_net"]}}
    args = [jnp.asarray(a) for a in (pts_feat, rgb, x, t)]
    model = global_run["ps" if agent_type == "score" else "pe"].model
    with torch.no_grad():
        if agent_type == "score":
            want = jmodel.apply(v, *args, method=JaxGFObjectPose.score)
            got = model.score(_t(pts_feat), _t(x), _t(t), _t(rgb))
        else:
            want = jmodel.apply(v, *args, True, method=JaxGFObjectPose.energy)
            got = model.energy(_t(pts_feat), _t(x), _t(t), True, _t(rgb))
    assert got.shape == want.shape
    # float32 heads over 620 inputs, another summation order; dividing by
    # std(t) >= ~0.1 puts values at up to ~10^3: the slice's relative bound
    # for energies (test_slice_energies_match)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-4)
    # the rgb rows are live: another rgb feature moves the output
    with torch.no_grad():
        other = (model.score(_t(pts_feat), _t(x), _t(t), _t(rgb) + 1.0) if agent_type == "score"
                 else model.energy(_t(pts_feat), _t(x), _t(t), True, _t(rgb) + 1.0))
    assert float((other - got).abs().max()) > 1e-3


def test_fast_score_weights_with_rgb_match_jax(global_run):
    rng = np.random.default_rng(11)
    pts_feat = rng.normal(size=(12, 128)).astype(np.float32)
    rgb = rng.normal(size=(12, RGB_DIM)).astype(np.float32)
    vs = global_run["s_vs"]
    want = jax_fast_score_weights(vs["params"]["pose_net"], vs["constants"]["pose_net"],
                                  jnp.asarray(pts_feat), jnp.asarray(rgb))
    with torch.no_grad():
        got = fast_score_weights(global_run["ps"].model.pose_score_net, _t(pts_feat), _t(rgb))
    for name in ("static", "W1_dyn", "W2bd", "b2cat"):
        assert tuple(got[name].shape) == want[name].shape, name
        # float32 products over 128 + 108 rows
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ------------------------------------------------------------------- the slice
def test_global_slice_features_match(global_run):
    got, want = global_run["got"], global_run["want"]
    # the class token: the backbone's float32 bound (test_dinov3_taps_match_jax)
    np.testing.assert_allclose(got["dino_global"], want["dino_global"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["rgb"], want["rgb"], rtol=1e-4, atol=1e-4)
    assert got["rgb"].shape == (B, RGB_DIM)
    # the module encoder's float32 bound against JAX (tests/test_torch_port_training.py)
    np.testing.assert_allclose(got["feat"], want["feat"], rtol=2e-4, atol=2e-4)


def test_global_slice_candidates_match(global_run):
    # the JAX package's bound for its fused RK4 against the scan
    # (tests/test_ode_fused.py:112)
    np.testing.assert_allclose(global_run["got"]["poses"], global_run["want"]["poses"],
                               rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("mode", ["energy", "det_energy"])
def test_global_slice_energies_match(global_run, mode):
    # as test_slice_energies_match: s_theta divides by std(t) ~ 0.01, so the
    # heads' float32 differences grow a hundredfold
    np.testing.assert_allclose(global_run["got"][mode], global_run["want"][mode],
                               rtol=2e-4, atol=1e-3)


def test_global_slice_aggregation_and_box_sizes_match(global_run):
    got, want = global_run["got"], global_run["want"]
    np.testing.assert_array_equal(got["agg"]["retained"], want["agg"]["retained"])
    np.testing.assert_allclose(got["agg"]["rotation"], want["agg"]["rotation"], atol=1e-5)
    np.testing.assert_allclose(got["agg"]["translation"], want["agg"]["translation"],
                               atol=1e-6)
    # ScaleNet's float32 bound on the same features (test_torch_port_slice.py)
    np.testing.assert_allclose(got["lengths"], want["lengths"], rtol=2e-4, atol=2e-4)


def test_backbone_skipped_when_batch_carries_global_feature(global_run, monkeypatch):
    ps = global_run["ps"]
    _, pbatch = _batches()
    batch = ps.with_image_features(pbatch)
    calls = []
    monkeypatch.setattr(ps.provider, "global_feature", lambda *a, **k: calls.append(1))
    assert ps.with_image_features(batch) is batch
    ps.extract_features(batch)
    assert calls == []


# -------------------------------------------------------------------- weights
@pytest.mark.parametrize("agent_type", ["score", "energy"])
def test_global_posenet_weights_round_trip_exactly(global_run, agent_type):
    vs = global_run["s_vs" if agent_type == "score" else "e_vs"]
    jcfg, pcfg = global_run["jcfg"], global_run["pcfg"]
    assert "img_encoder" not in vs["params"]  # created only where the module runs
    back, dino = torch_ingest.convert_posenet_state_dict(posenet_state_dict(vs, pcfg.model),
                                                         jcfg.model)
    assert dino is None
    model_vars = {"params": vs["params"], "batch_stats": vs["batch_stats"],
                  "constants": {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}}
    want, got = flatten_dict(model_vars), flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def test_dinov2_weights_round_trip_exactly():
    cfg = _global(jax_flagship_config(), "dinov2_vits16").model
    pvars = randomize(JaxProvider(cfg).init(jax.random.PRNGKey(1)), 12)
    # zeros of the same structure: a key the loader misses stays zero and fails
    init = jax.tree_util.tree_map(np.zeros_like, pvars)
    sd = dinov2_state_dict(pvars)
    back = load_torch_state_dict(init, sd)
    want, got = flatten_dict(pvars), flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))
    # and the port's ViT takes the state dict as it is
    ImageFeatureProvider(_global(tiny_flagship_config(), "dinov2_vits16").model) \
        .vit.load_state_dict(sd)


# ------------------------------------------------------------------------ API
def test_genpose2_global_matches_jax():
    """GenPose2TPU and GenPose2 with dino='global' (DINOv3) on the same weights
    and the small synthetic frame of tests/test_torch_port_frame.py:
    detection, then one tracking call from each side's own prev_pose."""
    jcfg = _global(jax_flagship_config())
    pcfg = _global(tiny_flagship_config())
    rng = np.random.default_rng(0)
    objs = synthetic_frame.random_scene(rng, 3, 160, 120, 150.0, depth=(0.5, 0.8))
    frames = [synthetic_frame.render(rng, objs, 160, 120, 150.0)]
    frames.append(synthetic_frame.render(rng, synthetic_frame.moved(rng, objs), 160, 120, 150.0))
    # the attributes GenPose2TPU's constructor would set, from jitted
    # initialisations (as tests/test_torch_port_frame.py builds them)
    engine = GenPose2TPU.__new__(GenPose2TPU)
    engine.cfg, engine.single_T0, engine.tracking_T0, engine.num_steps = jcfg, 0.55, 0.15, 12
    dummy = {"pts": jnp.zeros((1, N, 3)), "zero_mean_gt_pose": jnp.zeros((1, 9)),
             "pts_center": jnp.zeros((1, 3)), "roi_rgb": jnp.zeros((1, S, S, 3)),
             "roi_center_dir": jnp.zeros((1, 3))}
    sds = {}
    for name, seed in (("score", 1), ("energy", 2)):
        agent = JaxPoseAgent(jcfg, name)
        state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), dummy)
        vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                        "constants": state.constants}, seed)
        setattr(engine, f"{name}_agent", agent)
        setattr(engine, f"{name}_state", state.replace(
            params=vs["params"], ema_params=vs["params"], batch_stats=vs["batch_stats"],
            constants=vs["constants"]))
        sd = posenet_state_dict(vs, pcfg.model)
        sd.update({f"dino.{k}": v for k, v in
                   dinov3_state_dict(vs["constants"][PROVIDER_KEY]).items()})
        sds[name] = sd
    engine.scale_agent = JaxScaleAgent(jcfg)
    sc_state = engine.scale_agent.init_state(jax.random.PRNGKey(3), pts_dim=128)
    sc_vs = randomize({"params": sc_state.params}, 3)
    engine.scale_state = sc_state.replace(params=sc_vs["params"], ema_params=sc_vs["params"])
    port = GenPose2(pcfg, score=sds["score"], energy=sds["energy"],
                    scale=scalenet_state_dict(sc_vs), num_steps=12, device="cpu")
    jprev = pprev = None
    for i, frame in enumerate(frames):
        key = jax.random.PRNGKey(10 + i)
        tracking = i > 0
        want = engine.inference(frame, prev_pose=jprev, tracking=tracking, key=key)
        n, Kf = len(want["mask_ids"]), jcfg.eval.eval_repeat_num
        T0f = engine.tracking_T0 if tracking else engine.single_T0
        prior = jax_init_sde(jcfg.sde).prior_sample(key, (n * Kf, 9), T=T0f)
        t = jax.random.uniform(key, (n * Kf, 1), jnp.float32, 1e-5, 1e-4)
        got = port.inference(frame, prev_pose=pprev, tracking=tracking, prior=_t(prior),
                             energy_t=_t(t))
        jprev, pprev = want["prev_pose"], got["prev_pose"]
        what = f"call {i}"
        np.testing.assert_array_equal(got["mask_ids"], want["mask_ids"], err_msg=what)
        assert got["pose"].shape == want["pose"].shape == (3, 4, 4)
        # the bounds of tests/test_torch_port_frame.py::test_api_matches_jax
        np.testing.assert_allclose(got["pose"], np.asarray(want["pose"]), rtol=0, atol=2e-3,
                                   err_msg=what)
        np.testing.assert_allclose(np.asarray(got["prev_pose"]), np.asarray(want["prev_pose"]),
                                   rtol=0, atol=2e-3, err_msg=what)
        np.testing.assert_allclose(got["lengths"], np.asarray(want["lengths"]), rtol=2e-3,
                                   atol=2e-3, err_msg=what)
