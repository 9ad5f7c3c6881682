"""The port's models (genpose2_tpu_torch/models) against the JAX package's.

JAX modules are initialised, every parameter and BatchNorm statistic is
randomised from a numpy seed (the output layers start at zero, and an
all-zero head would make any comparison pass), and the variables go to the
port through genpose2_tpu_torch/weights.py. Tolerances are stated at each
assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from genpose2_tpu.config import PointNet2Config as JaxPointNet2Config
from genpose2_tpu.config import default_config as jax_default_config
from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.models.fast_encoder import fast_cls_forward as jax_fast_cls_forward
from genpose2_tpu.models.posenet import GFObjectPose as JaxGFObjectPose
from genpose2_tpu.models.scalenet import ScaleNet as JaxScaleNet
from genpose2_tpu.models.scorenet import fast_score_weights as jax_fast_score_weights
from genpose2_tpu.models.scorenet import make_fast_score_fn as jax_make_fast_score_fn
from genpose2_tpu.training import torch_ingest
from genpose2_tpu_torch.config import PointNet2Config, tiny_test_config
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.models.fast_encoder import fast_cls_forward
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.models.scalenet import ScaleNet
from genpose2_tpu_torch.models.scorenet import fast_score_weights
from genpose2_tpu_torch.ops.ode_rk4 import fast_score
from genpose2_tpu_torch.weights import posenet_state_dict, scalenet_state_dict


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(variables, seed, scale=0.1):
    """numpy copy of a variable tree with every leaf randomised (variances
    positive, Fourier weights kept)."""
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


def jax_posenet(cfg, agent_type, seed):
    sde = jax_init_sde(cfg.sde)
    model = JaxGFObjectPose(cfg.model, sde.marginal_std, agent_type)
    N = cfg.model.num_points
    batch = {"pts": jnp.zeros((1, N, 3)), "sampled_pose": jnp.zeros((1, 9)),
             "t": jnp.full((1, 1), 0.5)}
    key = jax.random.PRNGKey(seed)
    vs = model.init({"params": key, "aug": key, "dropout": key}, batch, False)
    return model, randomize(vs, seed)


def port_posenet(cfg, agent_type, variables):
    model = GFObjectPose(cfg.model, init_sde(cfg.sde).marginal_std, agent_type)
    model.load_state_dict(posenet_state_dict(variables, cfg.model))
    return model.eval()


def _cfg(jax_cfg, port_cfg, **model_kw):
    return (jax_cfg.replace(model=dataclasses.replace(jax_cfg.model, **model_kw)),
            port_cfg.replace(model=dataclasses.replace(port_cfg.model, **model_kw)))


# ------------------------------------------------------------ weight bridge
@pytest.mark.parametrize("agent_type", ["score", "energy"])
def test_weight_bridge_round_trips_through_torch_ingest(agent_type):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    _, vs = jax_posenet(jcfg, agent_type, 0)
    model = port_posenet(pcfg, agent_type, vs)
    back, dino = torch_ingest.convert_posenet_state_dict(model.state_dict(), jcfg.model)
    assert dino is None
    want = flatten_dict(vs)
    got = flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def test_scalenet_bridge_round_trips():
    net = JaxScaleNet(36)
    vs = randomize(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)), jnp.zeros((1, 3, 3))), 1)
    port = ScaleNet(36, pts_dim=64)
    port.load_state_dict(scalenet_state_dict(vs))
    back = torch_ingest.convert_scalenet_state_dict(port.state_dict())
    want, got = flatten_dict(vs), flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


# ----------------------------------------------------------------- encoder
DENSE = dict(
    npoints=(64, 32, None),
    radii=((0.08, 0.16), (0.16, 0.32), (None, None)),
    nsamples=((8, 16), (8, 16), (None, None)),
    mlps=(((8, 8, 16), (8, 16, 16)), ((16, 16, 32), (16, 32, 32)), ((32, 64), (32, 64))),
)


def _encoder_case(name, compute_dtype):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    if name == "dense":  # N = 1024 reaches ball_count and the density order
        jcfg, pcfg = _cfg(jcfg, pcfg, num_points=1024,
                          pointnet2=JaxPointNet2Config(**DENSE, compute_dtype=compute_dtype))
        pcfg = pcfg.replace(model=dataclasses.replace(
            pcfg.model, pointnet2=PointNet2Config(**DENSE, compute_dtype=compute_dtype)))
    elif compute_dtype != "float32":
        jcfg, pcfg = _cfg(jcfg, pcfg, pointnet2=dataclasses.replace(
            jcfg.model.pointnet2, compute_dtype=compute_dtype))
        pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model, pointnet2=dataclasses.replace(
            pcfg.model.pointnet2, compute_dtype=compute_dtype)))
    return jcfg, pcfg


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny", "dense"])
def test_fast_cls_forward_matches_jax(name, compute_dtype):
    jcfg, pcfg = _encoder_case(name, compute_dtype)
    _, vs = jax_posenet(jcfg, "score", 2)
    model = port_posenet(pcfg, "score", vs)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, size=(2, jcfg.model.num_points, 3)).astype(np.float32)
    enc = {"params": vs["params"]["pts_encoder"], "batch_stats": vs["batch_stats"]["pts_encoder"]}
    want = np.asarray(jax_fast_cls_forward(enc, jnp.asarray(pts), jcfg.model.pointnet2))
    got = fast_cls_forward(model.pts_encoder, _t(pts), pcfg.model.pointnet2).numpy()
    assert got.shape == want.shape
    if compute_dtype == "float32":
        # the JAX package's own bound for the fast path (tests/test_models.py:384)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        # both sides round the same operands to bf16; f32 differences of the
        # projections can flip a bf16 rounding, which later layers carry on
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------------- heads
@pytest.mark.parametrize("head", ["RT", "R_and_T", "Rx_Ry_and_T"])
def test_score_net_matches_jax(head):
    jcfg, pcfg = _cfg(jax_tiny_config(), tiny_test_config(), regression_head=head)
    jmodel, vs = jax_posenet(jcfg, "score", 4)
    model = port_posenet(pcfg, "score", vs)
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(6, 128)).astype(np.float32)
    pose = rng.normal(size=(6, 9)).astype(np.float32)
    t = rng.uniform(0.05, 0.9, size=(6, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(feat), None, jnp.asarray(pose),
                                   jnp.asarray(t), method=JaxGFObjectPose.score))
    with torch.no_grad():
        got = model.score(_t(feat), _t(pose), _t(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("decoupled", [True, False])
def test_energy_net_matches_jax(decoupled):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jmodel, vs = jax_posenet(jcfg, "energy", 6)
    model = port_posenet(pcfg, "energy", vs)
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(6, 128)).astype(np.float32)
    pose = rng.normal(size=(6, 9)).astype(np.float32)
    t = rng.uniform(0.05, 0.9, size=(6, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(vs, jnp.asarray(feat), None, jnp.asarray(pose),
                                   jnp.asarray(t), decoupled, method=JaxGFObjectPose.energy))
    with torch.no_grad():
        got = model.energy(_t(feat), _t(pose), _t(t), decoupled).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_scale_net_matches_jax():
    net = JaxScaleNet(jax_default_config().model.scale_embedding)
    vs = randomize(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024)), jnp.zeros((1, 3, 3))), 8)
    port = ScaleNet(180, pts_dim=1024)
    port.load_state_dict(scalenet_state_dict(vs))
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(5, 1024)).astype(np.float32)
    axes = rng.normal(size=(5, 3, 3)).astype(np.float32)
    want = np.asarray(net.apply(vs, jnp.asarray(feat), jnp.asarray(axes)))
    with torch.no_grad():
        got = port(_t(feat), _t(axes)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fast_score_weights_and_fn_match_jax(compute_dtype):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jmodel, vs = jax_posenet(jcfg, "score", 10)
    model = port_posenet(pcfg, "score", vs)
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(6, 128)).astype(np.float32)
    want_w = jax_fast_score_weights(vs["params"]["pose_net"], vs["constants"]["pose_net"],
                                    jnp.asarray(feat))
    with torch.no_grad():
        got_w = fast_score_weights(model.pose_score_net, _t(feat))
    want_flat, got_flat = flatten_dict(want_w), flatten_dict(got_w)
    assert set(got_flat) == set(want_flat)
    for k in want_flat:  # static is a product; the rest are copies
        np.testing.assert_allclose(got_flat[k].detach().numpy(), np.asarray(want_flat[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=str(k))

    pose = rng.normal(size=(6, 9)).astype(np.float32)
    t = rng.uniform(0.05, 0.9, size=(6, 1)).astype(np.float32)
    jfn = jax_make_fast_score_fn(vs["params"]["pose_net"], vs["constants"]["pose_net"],
                                 jax_init_sde(jcfg.sde).marginal_std, jnp.asarray(feat),
                                 compute_dtype=compute_dtype)
    want = np.asarray(jfn(jnp.asarray(pose), jnp.asarray(t)))
    with torch.no_grad():
        got = fast_score(got_w, _t(pose), _t(t), model.pose_score_net.marginal_std_fn,
                         compute_dtype).numpy()
    # f32: summation order only; bf16: the same operands rounded on both sides
    tol = 2e-2 if compute_dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 0.1)
