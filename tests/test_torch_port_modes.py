"""The rest of the port's model surface against the JAX package on the CPU:
every pose mode (so3/rotations.py and the predictor-corrector sampler's
renormalisation), three_nn / three_interpolate, FeaturePropagation,
PointNet2SegMSG, the per-point heads, PointNetFeat and the two PointNet
encoder compositions of GFObjectPose (with the weights' round trip through
the JAX package's torch_ingest), then one-epoch ``cli train`` + ``eval``
runs with --pose_mode quat_wxyz and with --pts_encoder
pointnet_and_pointnet2.

Both packages take the same numpy inputs and the same weights (JAX variables
randomised from a numpy seed, carried over by genpose2_tpu_torch/weights.py).
Discrete outputs (three_nn indices) must be equal; float tolerances are
stated at each assert.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.diffusion import pc_sampler as jax_pc_sampler
from genpose2_tpu.models.heads import RotHead as JaxRotHead
from genpose2_tpu.models.heads import TransHead as JaxTransHead
from genpose2_tpu.models.pointnet import PointNetFeat as JaxPointNetFeat
from genpose2_tpu.models.pointnet2 import FeaturePropagation as JaxFeaturePropagation
from genpose2_tpu.models.pointnet2 import PointNet2SegMSG as JaxSegMSG
from genpose2_tpu.models.posenet import GFObjectPose as JaxGFObjectPose
from genpose2_tpu.ops.interpolate import three_interpolate as jax_three_interpolate
from genpose2_tpu.ops.interpolate import three_nn as jax_three_nn
from genpose2_tpu.so3 import rotations as jrot
from genpose2_tpu.training.torch_ingest import convert_posenet_state_dict
from genpose2_tpu_torch import cli
from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.diffusion import init_sde, pc_sampler
from genpose2_tpu_torch.diffusion.samplers import _mid_normalize
from genpose2_tpu_torch.models.heads import RotHead, TransHead
from genpose2_tpu_torch.models.pointnet import PointNetFeat
from genpose2_tpu_torch.models.pointnet2 import FeaturePropagation, PointNet2SegMSG
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.ops.interpolate import three_interpolate, three_nn
from genpose2_tpu_torch.so3 import rotations as rot
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.weights import (StateDict, head_state_dict, pointnet_feat,
                                        posenet_state_dict, segmsg_state_dict, shared_mlp)

MODES = ["rot_matrix", "quat_wxyz", "quat_xyzw", "euler_xyz", "euler_xyz_sx_cx"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many torch ops on tiny tensors: beside other test processes the
    default thread pool's spinning threads slow them several times
    (tests/test_torch_port_samplers.py), so one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(a, dtype=np.float32)


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


# ------------------------------------------------------------------ so3
def _rotations():
    """Random rotations, every 180-degree rotation about a coordinate or a
    diagonal axis (quaternion candidates tie), and R[2, 0] = -1 and +1
    (gimbal lock: y = +-90 degrees)."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(32, 3, 3)))
    q = q * np.sign(np.linalg.det(q))[:, None, None]
    axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1)]
    flips = []
    for a in axes:
        a = np.asarray(a, np.float64) / np.linalg.norm(a)
        flips.append(2.0 * np.outer(a, a) - np.eye(3))  # 180 degrees about a
    locks = []
    for s in (1.0, -1.0):
        for z in (0.0, 0.7):
            cz, sz = np.cos(z), np.sin(z)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            Ry = np.array([[0, 0, s], [0, 1, 0], [-s, 0, 0]])  # cos 90 = 0 exactly
            locks.append(Rz @ Ry)
    return np.concatenate([q, np.stack(flips), np.stack(locks),
                           np.eye(3)[None]]).astype(np.float32)


def test_get_pose_dim():
    for mode in MODES:
        assert rot.get_pose_dim(mode) == jrot.get_pose_dim(mode)


@pytest.mark.parametrize("mode", MODES)
def test_pose_mode_functions_match_jax(mode):
    R = _rotations()
    n = R.shape[0]
    # representation: the same float32 operations (quaternions: the same
    # candidate picked, also on ties); 2e-6 for the arctan2 / arcsin of the
    # Euler modes and the quaternion's sqrt
    rep = rot.get_pose_representation(_t(R), mode).numpy()
    jrep = _np(jrot.get_pose_representation(jnp.asarray(R), mode))
    assert rep.shape == (n, rot.get_pose_dim(mode) - 3)
    np.testing.assert_allclose(rep, jrep, rtol=0, atol=2e-6)
    # back to a matrix, and it is the rotation again
    back = rot.get_rot_matrix(_t(jrep), mode).numpy()
    np.testing.assert_allclose(back, _np(jrot.get_rot_matrix(jnp.asarray(jrep), mode)),
                               rtol=0, atol=2e-6)
    if mode != "euler_xyz_sx_cx" and mode != "euler_xyz":
        np.testing.assert_allclose(back, R, rtol=0, atol=2e-5)
    # the manifold projection of off-manifold rotations, and normalize_pose
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(n, rot.get_pose_dim(mode))).astype(np.float32)
    np.testing.assert_allclose(rot.normalize_rotation(_t(raw[:, :-3]), mode).numpy(),
                               _np(jrot.normalize_rotation(jnp.asarray(raw[:, :-3]), mode)),
                               rtol=0, atol=2e-6)
    got = rot.normalize_pose(_t(raw), mode).numpy()
    np.testing.assert_allclose(got, _np(jrot.normalize_pose(jnp.asarray(raw), mode)), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(got[:, -3:], raw[:, -3:])
    # transform_batch_pts: the mode's rotation and translation, both ways
    pose = np.concatenate([jrep, rng.normal(size=(n, 3)).astype(np.float32)], -1)
    pts = rng.normal(size=(n, 20, 5)).astype(np.float32)
    for inverse in (False, True):
        np.testing.assert_allclose(
            rot.transform_batch_pts(_t(pts), _t(pose), mode, inverse).numpy(),
            _np(jrot.transform_batch_pts(jnp.asarray(pts), jnp.asarray(pose), mode, inverse)),
            rtol=0, atol=1e-5)
    if mode == "quat_wxyz":
        # unit quaternions that round-trip, as in the JAX package (its
        # reference does not: tests/test_reference_parity.py)
        np.testing.assert_allclose(np.linalg.norm(rep, axis=-1), 1.0, atol=1e-6)


def test_euler_at_gimbal_lock_matches_jax():
    R = _rotations()[-5:-1]  # R[2, 0] = -1, -1, +1, +1
    got = rot.matrix_to_euler_zyx(_t(R)).numpy()
    want = _np(jrot.matrix_to_euler_zyx(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.abs(got[:, 1]), np.pi / 2, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_pc_sampler_renormalisation_matches_jax(mode):
    """pc_sampler's per-step renormalisation (``_mid_normalize`` after the
    corrector, ``normalize_rotation`` after the predictor) in every mode,
    with a linear score and the JAX sampler's own draws."""
    D, Bs, n = rot.get_pose_dim(mode), 6, 8
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jsde, psde = jax_init_sde(jcfg.sde), init_sde(pcfg.sde)
    key = jax.random.PRNGKey(3)
    kp, kloop = jax.random.split(key)
    noise = [jnp.stack([jax.random.normal(k, (Bs, D)) for k in jax.random.split(step)])
             for step in jax.random.split(kloop, n)]
    want = jax_pc_sampler(key, lambda x, t: -0.5 * x / (t + 0.1), jsde, Bs, D, num_steps=n,
                          pose_mode=mode)
    got = pc_sampler(lambda x, t: -0.5 * x / (t + 0.1), psde, Bs, D, num_steps=n,
                     pose_mode=mode, prior=_t(jsde.prior_sample(kp, (Bs, D))),
                     noise=_t(jnp.stack(noise)))
    # the sampler's bound (tests/test_torch_port_samplers.py:test_pc_sampler_matches_jax)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=5e-4)
    x = np.random.default_rng(2).normal(size=(Bs, D)).astype(np.float32)
    mid = _mid_normalize(_t(x), mode).numpy()
    if mode.startswith("quat"):
        np.testing.assert_allclose(np.linalg.norm(mid[:, :4], axis=-1), 1.0, atol=1e-6)
    elif mode == "euler_xyz":
        np.testing.assert_array_equal(mid, x)
    else:
        np.testing.assert_allclose(np.linalg.norm(mid[:, 3:6], axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", ["quat_wxyz", "euler_xyz"])
def test_aggregation_in_the_pose_mode_matches_jax(mode):
    """aggregate_candidates on 7- and 6-wide candidates: the rotations read
    in the mode, energy-sorted, retained, clustered and averaged."""
    from genpose2_tpu.eval.aggregate import aggregate_candidates as jax_aggregate
    from genpose2_tpu_torch.eval.aggregate import aggregate_candidates

    rng = np.random.default_rng(20)
    Bo, Kc = 3, 12
    # candidates around one rotation per object, so that clusters form
    base = _rotations()[:Bo]
    noise = rng.normal(size=(Bo, Kc, 3)) * 0.05
    R = np.stack([[b @ _axis_angle(n) for n in ns] for b, ns in zip(base, noise)]).astype(np.float32)
    rep = _np(jrot.get_pose_representation(jnp.asarray(R), mode))
    poses = np.concatenate([rep, rng.normal(size=(Bo, Kc, 3)).astype(np.float32) * 0.01], -1)
    energy = rng.normal(size=(Bo, Kc, 2)).astype(np.float32)
    want = jax_aggregate(jnp.asarray(poses), jnp.asarray(energy), retain_ratio=0.5,
                         pose_mode=mode)
    got = aggregate_candidates(_t(poses), _t(energy), retain_ratio=0.5, pose_mode=mode)
    np.testing.assert_array_equal(got["retained"].numpy(), _np(want["retained"]))
    # the clustered quaternion mean: float32 power iterations (as
    # tests/test_torch_port_slice.py holds it)
    np.testing.assert_allclose(got["rotation"].numpy(), _np(want["rotation"]), atol=1e-5)
    np.testing.assert_allclose(got["translation"].numpy(), _np(want["translation"]), atol=1e-6)


def _axis_angle(v):
    """Rodrigues of a rotation vector (float64)."""
    th = np.linalg.norm(v)
    k = v / th
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_


# --------------------------------------------------------------- interpolate
@pytest.mark.parametrize("cloud", ["uniform", "duplicates", "three_known"])
def test_three_nn_matches_jax(cloud):
    rng = np.random.default_rng(4)
    B, Nq = 3, 50
    M = 3 if cloud == "three_known" else 40
    known = rng.uniform(-1, 1, size=(B, M, 3)).astype(np.float32)
    unknown = rng.uniform(-1, 1, size=(B, Nq, 3)).astype(np.float32)
    if cloud == "duplicates":
        # equal distances everywhere: repeated known points, and queries on
        # known points
        known[:, 20:] = known[:, :20]
        known[:, 5] = known[:, 4]
        unknown[:, :10] = known[:, :10]
    d, idx = three_nn(_t(unknown), _t(known))
    jd, jidx = jax_three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32
    # the same float32 squared distances, then sqrt
    np.testing.assert_allclose(d.numpy(), _np(jd), rtol=1e-6, atol=1e-7)


def test_three_interpolate_and_its_gradient_match_jax():
    rng = np.random.default_rng(5)
    B, M, Nq, C = 2, 12, 30, 7
    feats = rng.normal(size=(B, M, C)).astype(np.float32)
    idx = rng.integers(0, M, size=(B, Nq, 3)).astype(np.int32)
    idx[:, :5] = 3  # rows gathered many times: the scatter-add's sums
    w = rng.uniform(size=(B, Nq, 3)).astype(np.float32)
    cot = rng.normal(size=(B, Nq, C)).astype(np.float32)

    def jf(f, ww):
        return jnp.sum(jax_three_interpolate(f, jnp.asarray(idx), ww) * cot)

    jout = jax_three_interpolate(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w))
    jgf, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    f_t, w_t = _t(feats).requires_grad_(True), _t(w).requires_grad_(True)
    out = three_interpolate(f_t, torch.from_numpy(idx), w_t)
    (out * _t(cot)).sum().backward()
    # three products summed: float32 rounding
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f_t.grad.numpy(), _np(jgf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w_t.grad.numpy(), _np(jgw), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------- FP, SegMSG, heads
def _shared_sd(p, s, key):
    d = StateDict()
    shared_mlp(d, p, s, key)
    return d.sd


@pytest.mark.parametrize("known", ["points", "none"])
@pytest.mark.parametrize("train", [False, True])
def test_feature_propagation_matches_jax(known, train):
    rng = np.random.default_rng(6)
    B, n, m, C1, C2, mlp = 2, 40, 10, 5, 6, (8, 12)
    unknown = rng.normal(size=(B, n, 3)).astype(np.float32)
    known_xyz = rng.normal(size=(B, m, 3)).astype(np.float32) if known == "points" else None
    uf = rng.normal(size=(B, n, C1)).astype(np.float32)
    kf = rng.normal(size=(B, m if known == "points" else 1, C2)).astype(np.float32)
    jm = JaxFeaturePropagation(mlp)
    args = (jnp.asarray(unknown), None if known_xyz is None else jnp.asarray(known_xyz),
            jnp.asarray(uf), jnp.asarray(kf))
    vs = randomize(jm.init(jax.random.PRNGKey(0), *args), 7)
    if train:
        jout, mut = jm.apply(vs, *args, train=True, mutable=["batch_stats"])
    else:
        jout = jm.apply(vs, *args)
    port = FeaturePropagation(C2 + C1, mlp)
    port.load_state_dict(_shared_sd(vs["params"]["SharedMLP_0"],
                                    vs["batch_stats"]["SharedMLP_0"], "mlp"))
    with torch.no_grad():
        got = port(_t(unknown), None if known_xyz is None else _t(known_xyz), _t(uf), _t(kf),
                   train)
    # float32 layers (train mode: batch statistics summed in another order)
    np.testing.assert_allclose(got.numpy(), _np(jout), rtol=1e-5, atol=1e-5)


def _seg_cfg():
    return jax_tiny_config().model.pointnet2, tiny_test_config().model.pointnet2


FP_MLPS, CLS_FC = ((16, 16), (24, 24)), (16,)


@pytest.fixture(scope="module")
def segmsg():
    jcfg, pcfg = _seg_cfg()
    rng = np.random.default_rng(8)
    pts = (rng.uniform(-0.15, 0.15, size=(2, 128, 3))).astype(np.float32)
    jm = JaxSegMSG(jcfg, fp_mlps=FP_MLPS, cls_fc=CLS_FC, dropout=0.5)
    vs = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(pts)), 9)
    port = PointNet2SegMSG(pcfg, fp_mlps=FP_MLPS, cls_fc=CLS_FC, dropout=0.5)
    port.load_state_dict(segmsg_state_dict(vs, pcfg, len(FP_MLPS)))
    return {"jm": jm, "vs": vs, "port": port, "pts": pts}


def test_segmsg_eval_matches_jax(segmsg):
    want = segmsg["jm"].apply(segmsg["vs"], jnp.asarray(segmsg["pts"]))
    with torch.no_grad():
        got = segmsg["port"](_t(segmsg["pts"]), False)
    assert got.shape == (2, 128, 1)
    # float32 SA stages on the same FPS and ball-query indices, then 3-NN
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


def test_segmsg_train_forward_and_gradients_match_jax(segmsg):
    """Train mode with dropout 0 (its masks are the generator's, see
    test_segmsg_dropout_draws_from_the_generator): batch statistics, the
    logits, and the gradient of their sum against a cotangent."""
    jcfg, pcfg = _seg_cfg()
    vs, pts = segmsg["vs"], segmsg["pts"]
    jm = JaxSegMSG(jcfg, fp_mlps=FP_MLPS, cls_fc=CLS_FC, dropout=0.0)
    cot = np.random.default_rng(10).normal(size=(2, 128, 1)).astype(np.float32)

    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": vs["batch_stats"]},
                            jnp.asarray(pts), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (jout, mut)), jg = jax.value_and_grad(loss, has_aux=True)(vs["params"])
    port = PointNet2SegMSG(pcfg, fp_mlps=FP_MLPS, cls_fc=CLS_FC, dropout=0.0)
    port.load_state_dict(segmsg["port"].state_dict())
    out = port(_t(pts), True)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), rtol=1e-4, atol=1e-5)
    want_g = segmsg_state_dict({"params": jax.device_get(jg), "batch_stats": vs["batch_stats"]},
                               pcfg, len(FP_MLPS))
    gmax = max(float(np.abs(v.numpy()).max()) for k, v in want_g.items() if "bn.bn.running"
               not in k and not k.endswith("num_batches_tracked"))
    for k, p in port.named_parameters():
        # train-mode BatchNorm gradients in another summation order: 5e-4
        # of the largest gradient entry (tests/test_torch_port_train_step.py)
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=0,
                                   atol=5e-4 * gmax, err_msg=k)


def test_segmsg_dropout_draws_from_the_generator(segmsg):
    port, pts = segmsg["port"], _t(segmsg["pts"])
    with torch.no_grad():
        a = port(pts, True, torch.Generator().manual_seed(1))
        b = port(pts, True, torch.Generator().manual_seed(1))
        c = port(pts, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("head", ["rot", "trans"])
def test_heads_match_jax(head):
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(3, 20, 33)).astype(np.float32)
    jm = (JaxRotHead if head == "rot" else JaxTransHead)(out_dim=4)
    vs = randomize(jm.init(jax.random.PRNGKey(2), jnp.asarray(feat)), 12)
    port = (RotHead if head == "rot" else TransHead)(33, 4)
    port.load_state_dict(head_state_dict(vs))
    with torch.no_grad():
        got = port(_t(feat))
    np.testing.assert_allclose(got.numpy(), _np(jm.apply(vs, jnp.asarray(feat))), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("feature_transform,global_feat", [(False, True), (True, False)])
def test_pointnet_feat_matches_jax(feature_transform, global_feat):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 60, 3)).astype(np.float32)
    jm = JaxPointNetFeat(out_dim=96, in_dim=3, feature_transform=feature_transform,
                         global_feat=global_feat)
    vs = randomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 14, scale=0.05)
    port = PointNetFeat(96, 3, feature_transform, global_feat)
    d = StateDict()
    pointnet_feat(d, vs["params"], "")
    port.load_state_dict(d.sd)
    with torch.no_grad():
        got = port(_t(x))
    want = _np(jm.apply(vs, jnp.asarray(x)))
    assert got.shape == want.shape
    # the T-Net's 1024-wide max-pool and transforms: float32 products
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------- encoder compositions
ENCODERS = [("pointnet", "none"), ("pointnet_and_pointnet2", "none"),
            ("pointnet_and_pointnet2", "global")]


def _model_cfgs(enc, dino):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    kw = dict(pts_encoder=enc, dino=dino, dino_dim=24)
    return (dataclasses.replace(jcfg.model, **kw), dataclasses.replace(pcfg.model, **kw),
            jcfg, pcfg)


@pytest.mark.parametrize("enc,dino", ENCODERS)
def test_encoder_composition_matches_jax(enc, dino):
    """GFObjectPose's features (eval: the module forms, as the JAX agent
    routes these encoders; train: BatchNorm on the batch) and its score, and
    the state dict through torch_ingest back to the JAX variables."""
    jm_cfg, pm_cfg, jcfg, pcfg = _model_cfgs(enc, dino)
    jsde = jax_init_sde(jcfg.sde)
    rng = np.random.default_rng(15)
    B, N = 2, jm_cfg.num_points
    pts = (rng.uniform(-0.15, 0.15, size=(B, N, 3)) + [0, 0, 0.7]).astype(np.float32)
    data = {"pts": jnp.asarray(pts), "sampled_pose": jnp.asarray(rng.normal(size=(B, 9)),
                                                                 jnp.float32),
            "t": jnp.full((B, 1), 0.3)}
    if dino == "global":
        data["dino_global"] = jnp.asarray(rng.normal(size=(B, 24)), jnp.float32)
        data["roi_center_dir"] = jnp.asarray(rng.normal(size=(B, 3)), jnp.float32)
    jm = JaxGFObjectPose(jm_cfg, lambda t: jsde.marginal_prob(None, t)[1], "score")
    vs = randomize(jm.init(jax.random.PRNGKey(4), data), 16, scale=0.05)
    port = GFObjectPose(pm_cfg, init_sde(pcfg.sde).marginal_std, "score")
    sd = posenet_state_dict(vs, pm_cfg)
    port.load_state_dict(sd)
    prefixes = {k.split(".")[0] for k in sd}
    assert prefixes == ({"pts_encoder", "pose_score_net"} if enc == "pointnet" else
                        {"pts_pointnet_encoder", "pts_pointnet2_encoder", "fusion_layer",
                         "pose_score_net"})
    # the round trip: the JAX package's reader gives the variables back
    back, _ = convert_posenet_state_dict({k: v.numpy() for k, v in sd.items()}, jm_cfg)
    for col in ("params", "batch_stats"):
        flat_w = jax.tree_util.tree_leaves_with_path(vs.get(col, {}))
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back.get(col, {})))
        assert len(flat_w) == len(flat_b)
        for path, w in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), w, err_msg=str(path))

    jfeat = jm.apply(vs, data, False, method=JaxGFObjectPose.extract_pts_feature)
    feat = port.extract_pts_feature(_t(pts))
    # float32 encoders: the PointNet's 1024-wide products and max-pools
    np.testing.assert_allclose(feat.numpy(), _np(jfeat), rtol=1e-4,
                               atol=1e-4 * float(np.abs(_np(jfeat)).max()))
    jtrain, _ = jm.apply(vs, data, True, method=JaxGFObjectPose.extract_pts_feature,
                         mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        tfeat = port.extract_pts_feature(_t(pts), train=True)
    port.eval()
    np.testing.assert_allclose(tfeat.numpy(), _np(jtrain), rtol=1e-4,
                               atol=1e-4 * float(np.abs(_np(jtrain)).max()))
    rgb = None
    jrgb = None
    if dino == "global":
        jrgb = jm.apply(vs, data, method=JaxGFObjectPose.extract_global_rgb_feature)
        rgb = port.extract_global_rgb_feature(_t(data["dino_global"]), _t(data["roi_center_dir"]))
        np.testing.assert_allclose(rgb.numpy(), _np(jrgb), rtol=1e-6, atol=1e-6)
    js = jm.apply(vs, jfeat, jrgb, data["sampled_pose"], data["t"], method=JaxGFObjectPose.score)
    with torch.no_grad():
        s = port.score(_t(jfeat), _t(data["sampled_pose"]), _t(data["t"]), rgb)
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-5)


def test_pointwise_dino_takes_only_pointnet2():
    """The JAX package fails on dino='pointwise' with the PointNet encoders
    (a 3 + dino_dim wide input to the 3-channel T-Net; no pts_encoder): the
    port refuses them."""
    for enc in ("pointnet", "pointnet_and_pointnet2"):
        cfg = tiny_test_config()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, pts_encoder=enc, dino="pointwise"))
        with pytest.raises(ValueError, match="pointwise"):
            PoseAgent(cfg, "score", device="cpu")


# ------------------------------------------------------------------ the cli
BASE_FLAGS = ["--batch_size", "4", "--seed", "0", "--sampling_steps", "5", "--n_epochs", "1",
              "--repeat_num", "2", "--eval_repeat_num", "4", "--retain_ratio", "0.5",
              "--steps_per_epoch", "2", "--warmup", "5", "--device", "cpu", "--source",
              "synthetic", "--data_path", ""]


@pytest.fixture()
def tiny_build_config(monkeypatch):
    """build_config at tiny_test_config, with the flags the commands read
    applied as the real build_config applies them, the model's too."""
    real = cli.build_config

    def fake_build_config(args):
        full = real(args)
        cfg = tiny_test_config()
        m = full.model
        model = dataclasses.replace(cfg.model, pose_mode=m.pose_mode,
                                    regression_head=m.regression_head,
                                    pts_encoder=m.pts_encoder)
        train = dataclasses.replace(full.train, batch_size=args.batch_size,
                                    repeat_num=args.repeat_num,
                                    ranking_num=cfg.train.ranking_num)
        data = dataclasses.replace(full.data, num_points=cfg.model.num_points)
        return cfg.replace(model=model, train=train, eval=full.eval, sampler=full.sampler,
                           data=data, log_dir=args.log_dir)

    monkeypatch.setattr(cli, "build_config", fake_build_config)


@pytest.mark.parametrize("flags,width", [
    (["--pose_mode", "quat_wxyz", "--regression_head", "R_and_T"], 7),
    (["--pts_encoder", "pointnet_and_pointnet2"], 9),
])
def test_cli_train_and_eval_other_modes(tiny_build_config, tmp_path, flags, width):
    """One epoch of ``cli train`` on synthetic batches (their poses in the
    pose mode), then ``cli eval`` from its checkpoint."""
    d = str(tmp_path)
    trainer = cli.main(["train", "--agent_type", "score", "--log_dir", f"{d}/score", *flags,
                        *BASE_FLAGS, "--eval_freq", "1"])
    assert trainer.agent.model.pose_score_net.pose_encoder[0].in_features == width
    assert trainer.state.step == 2
    with open(f"{d}/score/score_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert any(np.isfinite(r.get("eval_deg_mean", np.nan)) for r in recs)
    metrics = cli.main(["eval", "--log_dir", f"{d}/eval", "--score_ckpt",
                        f"{d}/score/ckpt/final", *flags, *BASE_FLAGS])
    assert np.isfinite(metrics.deg_mean) and np.isfinite(metrics.sht_mean)
    with np.load(os.path.join(d, "eval", "eval", "batch_000000.npz")) as z:
        R = z["rotation"]
    # the aggregated rotations, read from the mode's candidates
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", R, R), np.broadcast_to(np.eye(3),
                                                                                R.shape),
                               atol=1e-5)
