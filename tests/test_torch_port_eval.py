"""The port's evaluation slice against the JAX package's, on the CPU: the so3
additions, the symmetry-aware metrics, SyntheticPoseData and the staged
SingleFrameEvaluator (tiny_test_config and tiny_flagship_config); the
multiplexed tracker and the trainer's ranking candidates are in
tests/test_torch_port_eval_tracking.py, which uses this file's helpers.

The same numpy inputs and the same weights (JAX variables randomised from a
numpy seed, carried over by genpose2_tpu_torch/weights.py) go through both
packages; JAX's draws (prior noise, first-frame jitter) are rebuilt from its
keys and handed to the port, since the two frameworks' random numbers never
match. Tolerances are stated at each assert.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.data.synthetic import SyntheticPoseData as JaxSyntheticPoseData
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval import metrics as jax_metrics
from genpose2_tpu.eval.pipeline import SingleFrameEvaluator as JaxEvaluator
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.so3 import rotations as jax_so3
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
from genpose2_tpu_torch.eval import metrics
from genpose2_tpu_torch.eval import pipeline as port_pipeline
from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator
from genpose2_tpu_torch.so3 import rotations as so3
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict, scalenet_state_dict


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(variables, seed, scale=0.1):
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


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jax_so3.quaternion_to_matrix(jnp.asarray(q)))


def _small_rotations(rng, n, max_deg):
    axis = rng.normal(size=(n, 3))
    angle = np.radians(rng.uniform(0.0, max_deg, n))
    return np.asarray(jax_so3.axis_angle_to_matrix(jnp.asarray(axis, jnp.float32),
                                                   jnp.asarray(angle, jnp.float32)))


def _deg_close(got, want, err_msg=""):
    """Angles in degrees: atol 1e-3, and 0.05 within 1 degree of 0 or 180,
    where arccos turns a float32 rounding of the cosine into up to ~0.03."""
    want = np.asarray(want, np.float64)
    near = (want < 1.0) | (want > 179.0)
    tol = np.where(near, 0.05, 1e-3)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= tol).all(), f"{err_msg}: {err.max()} (at {want[np.argmax(err - tol)]} deg)"


# --------------------------------------------------------------------- so3
def test_so3_additions_match_jax():
    rng = np.random.default_rng(0)
    R1, R2 = _rotations(rng, 64), _rotations(rng, 64)
    q1, q2 = rng.normal(size=(2, 64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    # products and sums of float32 values in the same order: 1e-6
    np.testing.assert_allclose(so3.quaternion_multiply(_t(q1), _t(q2)).numpy(),
                               np.asarray(jax_so3.quaternion_multiply(q1, q2)), rtol=0, atol=1e-6)
    Ri, ti = so3.inverse_RT(_t(R1), _t(t))
    jRi, jti = jax_so3.inverse_RT(jnp.asarray(R1), jnp.asarray(t))
    np.testing.assert_array_equal(Ri.numpy(), np.asarray(jRi))
    np.testing.assert_allclose(ti.numpy(), np.asarray(jti), rtol=0, atol=1e-6)
    pts = rng.normal(size=(64, 50, 5)).astype(np.float32)
    pose = np.concatenate([R1[:, :, 0], R1[:, :, 1], t], -1)
    for inverse in (False, True):
        np.testing.assert_allclose(
            so3.transform_batch_pts(_t(pts), _t(pose), inverse_pose=inverse).numpy(),
            np.asarray(jax_so3.transform_batch_pts(jnp.asarray(pts), jnp.asarray(pose),
                                                   inverse_pose=inverse)), rtol=0, atol=1e-6)
    # the quaternion mode (every mode: tests/test_torch_port_modes.py)
    q = np.concatenate([np.asarray(jax_so3.matrix_to_quaternion(jnp.asarray(R1))), t], -1)
    np.testing.assert_allclose(
        so3.transform_batch_pts(_t(pts), _t(q), pose_mode="quat_wxyz").numpy(),
        np.asarray(jax_so3.transform_batch_pts(jnp.asarray(pts), jnp.asarray(q),
                                               pose_mode="quat_wxyz")), rtol=0, atol=1e-5)
    # the angle: its cosine (the float32 trace) within 1e-6; the degrees as
    # _deg_close (arccos amplifies the cosine's rounding near 0 and 180)
    got = so3.rotation_angle_deg(_t(R1), _t(R2)).numpy()
    want = np.asarray(jax_so3.rotation_angle_deg(jnp.asarray(R1), jnp.asarray(R2)))
    np.testing.assert_allclose(np.cos(np.radians(got.astype(np.float64))),
                               np.cos(np.radians(want.astype(np.float64))), rtol=0, atol=1e-6)
    _deg_close(got, want, "rotation_angle_deg")


@pytest.mark.parametrize("case", ["uniform", "weighted", "w_near_zero"])
def test_average_quaternion_batch_matches_jax(case):
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(8, 20, 4)).astype(np.float32)
    w = None
    if case == "weighted":
        w = rng.uniform(size=(8, 20)).astype(np.float32)
    if case == "w_near_zero":
        # clusters about quaternions whose w is +-1e-3: the mean's sign is
        # fixed by a w that small (eigh's own sign is arbitrary)
        mean = rng.normal(size=(8, 1, 4))
        mean[..., 0] = rng.choice([-1e-3, 1e-3], size=(8, 1)) * np.linalg.norm(mean, axis=-1)
        Q = (mean / np.linalg.norm(mean, axis=-1, keepdims=True)
             + rng.normal(0, 1e-4, size=(8, 20, 4))).astype(np.float32)
        Q[..., 0] = np.where(rng.uniform(size=(8, 20)) < 0.5, 1, -1) * Q[..., 0]
    Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
    got = so3.average_quaternion_batch(_t(Q), None if w is None else _t(w)).numpy()
    want = np.asarray(jax_so3.average_quaternion_batch(
        jnp.asarray(Q), None if w is None else jnp.asarray(w)))
    if case == "w_near_zero":
        assert (np.abs(want[:, 0]) < 2e-3).all() and (want[:, 0] > 0).all()
    # eigh of a 4 x 4 float32 matrix: 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------- calibration
SYMS = {
    "none": dict(),
    "half_x": dict(x="half"),
    "half_y": dict(y="half"),
    "half_z": dict(z="half"),
    "quarter": dict(z="quarter"),
    "any_y": dict(x="half", y="any"),
    "global_any": dict(any_sym=True),
}


@pytest.mark.parametrize("name", list(SYMS))
def test_calibrate_rotation_matches_jax(name):
    rng = np.random.default_rng(2)
    R_gt = _rotations(rng, 32)
    R_pred = _rotations(rng, 32)
    sym = np.tile(np.asarray(jax_metrics.sym_label(**SYMS[name]))[None], (32, 1))
    np.testing.assert_array_equal(metrics.sym_label(**SYMS[name]).numpy(), sym[0])
    got = metrics.calibrate_rotation(_t(R_pred), _t(R_gt), torch.from_numpy(sym)).numpy()
    want = np.asarray(jax_metrics.calibrate_rotation(jnp.asarray(R_pred), jnp.asarray(R_gt),
                                                     jnp.asarray(sym)))
    # the same candidates and argmin; float32 products: 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if name in ("none", "global_any"):
        np.testing.assert_array_equal(got, R_pred if name == "none" else R_gt)


def _criterion_inputs(seed, n=48):
    """Predictions of three kinds: within 1 degree and 1 cm of the ground
    truth, within 20 degrees and 5 cm, and random; random symmetry labels."""
    rng = np.random.default_rng(seed)
    R_gt = _rotations(rng, n)
    third = n // 3
    delta = np.concatenate([_small_rotations(rng, third, 1.0), _small_rotations(rng, third, 20.0),
                            _rotations(rng, n - 2 * third)])
    R_pred = np.einsum("bij,bjk->bik", R_gt, delta).astype(np.float32)
    t_gt = rng.uniform([-0.2, -0.2, 0.5], [0.2, 0.2, 1.0], (n, 3)).astype(np.float32)
    scale = np.repeat([0.01, 0.05, 0.3], [third, third, n - 2 * third])[:, None]
    t_pred = (t_gt + rng.normal(size=(n, 3)) * scale / np.sqrt(3)).astype(np.float32)
    s_gt = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    s_pred = (s_gt * rng.uniform(0.8, 1.2, (n, 3))).astype(np.float32)
    labels = [jax_metrics.sym_label(**SYMS[k]) for k in SYMS]
    sym = np.stack([np.asarray(labels[i]) for i in rng.integers(0, len(labels), n)])
    return R_pred, t_pred, s_pred, R_gt, t_gt, s_gt, sym


def test_iou_and_criteria_match_jax():
    args = _criterion_inputs(3)
    R_pred, t_pred, s_pred, R_gt, t_gt, s_gt, sym = args
    jargs = [jnp.asarray(a) for a in args]
    pargs = [torch.from_numpy(np.array(a)) for a in args]
    # the AABBs' float32 products and one division: 1e-5
    np.testing.assert_allclose(
        metrics.iou_3d(*pargs[:6]).numpy(), np.asarray(jax_metrics.iou_3d(*jargs[:6])),
        rtol=0, atol=1e-5)
    iou, deg, sht = (x.numpy() for x in metrics.batch_criterion(*pargs))
    jiou, jdeg, jsht = (np.asarray(x) for x in jax_metrics.batch_criterion(*jargs))
    assert (jiou > 0.1).sum() >= 10 and (jdeg < 1.0).sum() >= 8  # every regime is present
    np.testing.assert_allclose(iou, jiou, rtol=0, atol=1e-5)
    _deg_close(deg, jdeg, "batch_criterion deg")
    np.testing.assert_allclose(sht, jsht, rtol=1e-6, atol=1e-5)  # cm
    _deg_close(metrics.rot_error_deg(pargs[0], pargs[3], pargs[6]).numpy(),
               np.asarray(jax_metrics.rot_error_deg(jargs[0], jargs[3], jargs[6])),
               "rot_error_deg")


@pytest.mark.parametrize("with_classes", [False, True])
def test_compute_metrics_matches_jax(with_classes):
    rng = np.random.default_rng(4)
    n = 200
    iou = rng.uniform(0, 1, n).astype(np.float32)
    deg = rng.uniform(0, 15, n).astype(np.float32)
    sht = rng.uniform(0, 7, n).astype(np.float32)
    cls = rng.integers(0, 4, n) if with_classes else None
    got = metrics.compute_metrics(iou, deg, sht, cls).to_dict()
    want = jax_metrics.compute_metrics(iou, deg, sht, cls).to_dict()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert bool(got["per_class"]) == with_classes


# --------------------------------------------------------------- synthetic
@pytest.mark.parametrize("shape", ["box", "cylinder"])
@pytest.mark.parametrize("fixed_pose", [False, True])
def test_synthetic_pose_data_like_jax(shape, fixed_pose):
    want = JaxSyntheticPoseData(num_points=256, shape=shape).batch(
        jax.random.PRNGKey(0), 6, fixed_pose=fixed_pose)
    data = SyntheticPoseData(num_points=256, shape=shape, noise=0.002)
    got = data.batch(torch.Generator().manual_seed(0), 6, fixed_pose=fixed_pose)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("sym_info", "class_label", "bbox_side_len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    R, t, cam = got["gt_rotation"].numpy(), got["gt_translation"].numpy(), got["cam_pts"].numpy()
    np.testing.assert_allclose(np.einsum("bij,bik->bjk", R, R), np.tile(np.eye(3), (6, 1, 1)),
                               atol=1e-6)
    center = got["pts_center"].numpy()
    np.testing.assert_allclose(got["pts"].numpy() + center[:, None], cam, atol=1e-6)
    np.testing.assert_allclose(got["zero_mean_gt_pose"].numpy()[:, 6:], t - center, atol=1e-6)
    # R cloud + t = cam_pts within the noise (2 mm, so 5 sigma = 1 cm): the
    # object-frame points lie on the shape's surface
    local = np.einsum("bji,bnj->bni", R, cam - t[:, None])
    half = got["bbox_side_len"].numpy()[:, None] / 2
    tol = 5 * data.noise
    if shape == "box":
        assert (np.abs(local) <= half + tol).all()
        assert (np.abs(np.abs(local) - half).min(-1) <= tol).all()
    else:
        r = np.linalg.norm(local[..., [0, 2]], axis=-1)
        assert (np.abs(r - half[..., 0]) <= tol).all()
        assert (np.abs(local[..., 1]) <= half[..., 1] + tol).all()
    if fixed_pose:
        again = data.batch(torch.Generator().manual_seed(5), 6, fixed_pose=True)
        np.testing.assert_array_equal(again["gt_rotation"].numpy(), R)
        assert np.ptp(R, axis=0).max() == 0 and np.ptp(t, axis=0).max() == 0
    else:
        assert np.ptp(t, axis=0).min() > 0


# --------------------------------------------------------------- evaluator
def _jax_pose_agent(cfg, agent_type, batch, seed):
    agent = JaxPoseAgent(cfg, agent_type, steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), batch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    return agent, state, vs


def _port_pose_agent(cfg, agent_type, vs):
    agent = PoseAgent(cfg, agent_type, device="cpu")
    agent.model.load_state_dict(posenet_state_dict(vs, cfg.model))
    if agent.provider is not None:
        agent.provider.vit.load_state_dict(dinov3_state_dict(vs["constants"][PROVIDER_KEY]))
    return agent


def _eval_batches(cfg, count, seed):
    """``count`` labelled batches of cfg.eval.batch_size synthetic objects,
    boxes (class 0) and cylinders (class 1) in turn, with N(0, 1) crops and
    random pixels under dino='pointwise': (JAX batches, port batches)."""
    rng = np.random.default_rng(seed)
    B, N = cfg.eval.batch_size, cfg.model.num_points
    jb, pb = [], []
    for i in range(count):
        shape = ("box", "cylinder")[i % 2]
        b = dict(JaxSyntheticPoseData(num_points=N, shape=shape).batch(
            jax.random.PRNGKey(seed + i), B))
        b["class_label"] = jnp.full((B,), i % 2, jnp.int32)
        if cfg.model.dino == "pointwise":
            S = cfg.model.img_size
            b["roi_rgb"] = jnp.asarray(rng.normal(size=(B, S, S, 3)), jnp.float32)
            b["roi_xs"] = jnp.asarray(rng.integers(0, S, (B, N)), jnp.int32)
            b["roi_ys"] = jnp.asarray(rng.integers(0, S, (B, N)), jnp.int32)
        jb.append(b)
        pb.append({k: torch.from_numpy(np.array(v)) for k, v in b.items()})
    return jb, pb


CONFIGS = {"tiny": (jax_tiny_config, tiny_test_config),
           "flagship": (jax_flagship_config, tiny_flagship_config)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def evaluators(request):
    """Both packages' score, energy and scale agents from the same weights,
    their scale functions, two labelled batches and JAX's per-batch priors."""
    jcfg, pcfg = (f() for f in CONFIGS[request.param])
    jb, pb = _eval_batches(pcfg, 2, 10)
    sa, ss, svs = _jax_pose_agent(jcfg, "score", jb[0], 11)
    ea, es, evs = _jax_pose_agent(jcfg, "energy", jb[0], 12)
    feat_dim = int(sa.extract_features(ss, jb[0])[0].shape[-1])
    sc = JaxScaleAgent(jcfg)
    scs = sc.init_state(jax.random.PRNGKey(13), pts_dim=feat_dim)
    scvs = randomize({"params": scs.params}, 13)
    scs = scs.replace(params=scvs["params"], ema_params=scvs["params"])
    ps, pe = _port_pose_agent(pcfg, "score", svs), _port_pose_agent(pcfg, "energy", evs)
    psc = ScaleAgent(pcfg, pts_dim=feat_dim, device="cpu")
    psc.model.load_state_dict(scalenet_state_dict(scvs))

    def jax_scale(batch, R, t, pts_feat=None):
        if pts_feat is None:
            pts_feat, _ = sa.extract_features(ss, batch)
        return sc.predict(scs, pts_feat, R)

    calls = {"encoder": 0}

    def port_scale(batch, R, t, pts_feat=None):
        if pts_feat is None:
            calls["encoder"] += 1
            pts_feat, _ = ps.extract_features(batch)
        return psc.predict(pts_feat, R)

    key = jax.random.PRNGKey(14)
    K = jcfg.eval.eval_repeat_num
    priors = [_t(jax_init_sde(jcfg.sde).prior_sample(jax.random.fold_in(key, i),
                                                     (pcfg.eval.batch_size * K, 9),
                                                     T=jcfg.eval.T0)) for i in range(len(jb))]
    return {"name": request.param, "cfgs": (jcfg, pcfg), "batches": (jb, pb), "key": key,
            "priors": priors, "jax": (sa, ss, ea, es, jax_scale), "port": (ps, pe, port_scale),
            "scale_calls": calls}


def _thresholds():
    """Every threshold of the metric family: (iou thresholds, deg, cm)."""
    iou = [0.25, 0.5, 0.75] + [t for lo, hi, s in jax_metrics._IOU_AUC_RANGES
                               for t in np.arange(lo, hi, s)]
    deg, cm = [5, 10], [2, 5]
    for (dlo, dhi, ds), (slo, shi, ss) in jax_metrics._POSE_AUC_RANGES:
        deg += list(np.arange(dlo, dhi, ds) + ds)
        cm += list(np.arange(slo, shi, ss) + ss)
    return np.asarray(iou), np.asarray(deg), np.asarray(cm)


CRITERIA = ("iou", "deg", "sht")


def _assert_metrics_match(got, want, crit_got, crit_want, err_msg):
    """The two packages' metrics from per-object criteria (dicts of iou, deg,
    sht arrays) that differ by d: every accuracy and AUC equal where each of
    JAX's criteria lies farther than d from every threshold (checked first:
    otherwise the two could fall on either side), the means within d."""
    diffs = {}
    for k, th in zip(CRITERIA, _thresholds()):
        a, b = (np.concatenate(c[k]).astype(np.float64) for c in (crit_got, crit_want))
        diffs[k] = np.abs(a - b).max() + 1e-6
        gap = np.abs(b[:, None] - th[None]).min()
        assert gap > diffs[k], f"{err_msg}: a criterion lies {gap} from a threshold"
    tol = {"iou_mean": diffs["iou"], "deg_mean": diffs["deg"], "sht_mean": diffs["sht"]}

    def walk(a, b, path):
        assert sorted(a) == sorted(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            elif k in tol:
                assert abs(a[k] - b[k]) <= tol[k], f"{err_msg} {path}.{k}: {a[k]} vs {b[k]}"
            else:
                assert a[k] == b[k], f"{err_msg} {path}.{k}: {a[k]} vs {b[k]}"

    walk(got.to_dict(), want.to_dict(), "metrics")


def _check_decisions(poses, energy, cfg, err_msg):
    """The energy order and DBSCAN's neighbourhoods must be clear of float32
    noise, or the two packages could retain or cluster other candidates."""
    gaps = np.diff(np.sort(energy, axis=1), axis=1)
    assert gaps.min() > 1e-2, f"{err_msg}: energies too close to rank alike"
    order = np.argsort(-energy, axis=1, kind="stable")
    retain = max(int(poses.shape[1] * cfg.eval.retain_ratio), 1)
    kept = np.take_along_axis(poses[..., :6], order[:, :retain, 0:1], axis=1)
    quat = so3.matrix_to_quaternion(so3.rot6d_cols_to_matrix(_t(kept))).numpy()
    qd = 1.0 - np.einsum("bki,bji->bkj", quat, quat) ** 2
    row = np.linalg.norm(qd[:, :, None, :] - qd[:, None, :, :], axis=-1)
    assert np.abs(row - cfg.eval.clustering_eps).min() > 1e-3, f"{err_msg}: DBSCAN eps"


# the bounds of tests/test_torch_port_slice.py: candidates the fused RK4's
# 5e-4, energies 2e-4 / 1e-3; on the same inputs the aggregated rotation
# 1e-5 and translation 1e-6, ScaleNet's box sizes 2e-4
POSE_TOL, E_RTOL, E_ATOL, LEN_TOL = 5e-4, 2e-4, 1e-3, 2e-4


def _criteria(R, t, L, batch):
    """JAX's per-object criteria of poses (R, t, L)."""
    out = jax_metrics.batch_criterion(jnp.asarray(R), jnp.asarray(t), jnp.asarray(L),
                                      batch["gt_rotation"], batch["gt_translation"],
                                      batch["bbox_side_len"], batch["sym_info"])
    return dict(zip(CRITERIA, (np.asarray(x) for x in out)))


def _port_criteria(R, t, L, batch):
    out = metrics.batch_criterion(_t(R), _t(t), _t(L), batch["gt_rotation"],
                                  batch["gt_translation"], batch["bbox_side_len"],
                                  batch["sym_info"])
    return dict(zip(CRITERIA, (x.numpy() for x in out)))


def _compare_criteria(got, want, tag):
    """Criteria of the same poses: IoU 1e-5 (the AABBs' float32 products),
    deg as _deg_close, cm 1e-5 x |cm| + 1e-5."""
    np.testing.assert_allclose(got["iou"], want["iou"], rtol=0, atol=1e-5, err_msg=f"{tag} iou")
    _deg_close(got["deg"], want["deg"], f"{tag} deg")
    np.testing.assert_allclose(got["sht"], want["sht"], rtol=1e-5, atol=1e-5, err_msg=f"{tag} cm")


def _load_stage(path):
    d = np.load(path)
    return [d[f"b{i}"] for i in range(len(d.files))]


STAGES = (("poses", "pred_pose.npz"), ("energy", "pred_energy.npz"),
          ("rotation", "aggregated_rot.npz"), ("translation", "aggregated_trans.npz"),
          ("lengths", "lengths.npz"))


def test_evaluator_run_matches_jax(evaluators, tmp_path, monkeypatch):
    """End to end, then stage by stage: the port's aggregation and box sizes
    again from JAX's cached candidates and energies, so that each stage is
    held to its own bound on the same inputs."""
    ev = evaluators
    jcfg, pcfg = ev["cfgs"]
    jb, pb = ev["batches"]
    sa, ss, ea, es, jax_scale = ev["jax"]
    ps, pe, port_scale = ev["port"]
    want_m = JaxEvaluator(jcfg, sa, ss, ea, es, scale_fn=jax_scale,
                          out_dir=str(tmp_path / "jax")).run(jb, ev["key"])
    ev["scale_calls"]["encoder"] = 0
    got_m = SingleFrameEvaluator(pcfg, ps, pe, scale_fn=port_scale,
                                 out_dir=str(tmp_path / "port")).run(pb, priors=ev["priors"])
    # the scale stage gets no feature: it runs the score encoder once a batch
    assert ev["scale_calls"]["encoder"] == len(pb)
    with open(tmp_path / "port" / "metrics.json") as f:
        assert json.load(f) == json.loads(json.dumps(got_m.to_dict(), default=str))
    want = {n: _load_stage(tmp_path / "jax" / f) for n, f in STAGES}
    got = {n: _load_stage(tmp_path / "port" / f) for n, f in STAGES}
    crit_got, crit_want = {k: [] for k in CRITERIA}, {k: [] for k in CRITERIA}
    for i in range(len(pb)):
        tag = f"{ev['name']} batch {i}"
        np.testing.assert_allclose(got["poses"][i], want["poses"][i], rtol=1e-4, atol=POSE_TOL,
                                   err_msg=tag)
        np.testing.assert_allclose(got["energy"][i], want["energy"][i], rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=tag)
        _check_decisions(want["poses"][i], want["energy"][i], pcfg, tag)
        for crit, side in ((crit_got, got), (crit_want, want)):
            c = _criteria(side["rotation"][i], side["translation"][i], side["lengths"][i], jb[i])
            for k in CRITERIA:
                crit[k].append(c[k])
        c = _port_criteria(got["rotation"][i], got["translation"][i], got["lengths"][i], pb[i])
        _compare_criteria(c, {k: crit_got[k][i] for k in CRITERIA}, tag)
    _assert_metrics_match(got_m, want_m, crit_got, crit_want, ev["name"])

    # stage by stage: JAX's candidates and energies in the port's cache
    staged = tmp_path / "staged"
    staged.mkdir()
    for _, f in STAGES[:2]:
        (staged / f).write_bytes((tmp_path / "jax" / f).read_bytes())
    SingleFrameEvaluator(pcfg, ps, pe, scale_fn=port_scale, out_dir=str(staged)).run(pb)
    for i in range(len(pb)):
        tag = f"{ev['name']} staged batch {i}"
        np.testing.assert_allclose(_load_stage(staged / "aggregated_rot.npz")[i],
                                   want["rotation"][i], rtol=0, atol=1e-5, err_msg=tag)
        np.testing.assert_allclose(_load_stage(staged / "aggregated_trans.npz")[i],
                                   want["translation"][i], rtol=0, atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(_load_stage(staged / "lengths.npz")[i], want["lengths"][i],
                                   rtol=LEN_TOL, atol=LEN_TOL, err_msg=tag)

    # the second run loads every stage from its cache: nothing is sampled,
    # scored, aggregated or sized again
    def boom(*a, **k):
        raise AssertionError("a cached stage ran again")

    monkeypatch.setattr(ps, "sample_candidates", boom)
    monkeypatch.setattr(pe, "get_energy", boom)
    monkeypatch.setattr(port_pipeline, "aggregate_candidates", boom)
    again = SingleFrameEvaluator(pcfg, ps, pe, scale_fn=boom,
                                 out_dir=str(tmp_path / "port")).run(pb)
    assert again.to_dict() == got_m.to_dict()


def test_evaluator_run_streaming_matches_jax(evaluators, tmp_path):
    """End to end per batch: the aggregated pose within the candidates'
    bound (the energy order and the clusters are the same, _check_decisions
    in the run test), the box sizes within ScaleNet's bound plus what the
    port's own ScaleNet moves between the two rotations, the criteria those
    of the port's poses."""
    ev = evaluators
    jcfg, pcfg = ev["cfgs"]
    jb, pb = ev["batches"]
    sa, ss, ea, es, jax_scale = ev["jax"]
    ps, pe, port_scale = ev["port"]
    want_m = JaxEvaluator(jcfg, sa, ss, ea, es, scale_fn=jax_scale,
                          out_dir=str(tmp_path / "jax")).run_streaming(iter(jb), ev["key"])
    ev["scale_calls"]["encoder"] = 0
    got_m = SingleFrameEvaluator(pcfg, ps, pe, scale_fn=port_scale,
                                 out_dir=str(tmp_path / "port")).run_streaming(
        iter(pb), priors=ev["priors"])
    assert ev["scale_calls"]["encoder"] == 0  # the sampler's feature feeds ScaleNet
    crit_got, crit_want = {k: [] for k in CRITERIA}, {k: [] for k in CRITERIA}
    for i in range(len(pb)):
        tag = f"{ev['name']} streaming batch {i}"
        name = f"batch_{i:06d}.npz"
        got, want = dict(np.load(tmp_path / "port" / name)), dict(np.load(tmp_path / "jax" / name))
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["class_label"], want["class_label"])
        for k in ("rotation", "translation"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=POSE_TOL, err_msg=tag)
        moved = np.abs(port_scale(pb[i], _t(want["rotation"]), None).numpy().clip(1e-3)
                       - got["lengths"])
        assert (np.abs(got["lengths"] - want["lengths"])
                <= moved + LEN_TOL * (1 + np.abs(want["lengths"]))).all(), tag
        _compare_criteria({k: got[k] for k in CRITERIA},
                          _criteria(got["rotation"], got["translation"], got["lengths"], jb[i]),
                          tag)
        for k in CRITERIA:
            crit_got[k].append(got[k])
            crit_want[k].append(want[k])
    _assert_metrics_match(got_m, want_m, crit_got, crit_want, f"{ev['name']} streaming")
    # a second pass reads the per-batch caches
    again = SingleFrameEvaluator(pcfg, ps, pe, out_dir=str(tmp_path / "port")).run_streaming(
        iter([{}, {}]))
    assert again.to_dict() == got_m.to_dict()


def test_evaluator_refuses_unported_samplers():
    """Every mode of the JAX evaluator runs: 'ode' as the fixed grid, the
    others ('rk45', 'euler', 'pc') passed through as sample_candidates'
    method, as genpose2_tpu/eval/pipeline.py does; a mode no sampler has is
    refused by the sampler."""
    cfg = tiny_test_config()
    agent = PoseAgent(cfg, "score", device="cpu")
    pts = torch.rand(2, cfg.model.num_points, 3)
    batch = {"pts": pts, "pts_center": pts.mean(1)}
    K = cfg.eval.eval_repeat_num
    prior = torch.randn(2 * K, 9, generator=torch.Generator().manual_seed(0))
    for mode, method in (("ode", "fixed"), ("rk45", "rk45"), ("euler", "euler"), ("pc", "pc")):
        mcfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, mode=mode, sampling_steps=4))
        evaluator = SingleFrameEvaluator(mcfg, agent)
        assert evaluator.method == method
        poses = evaluator.inference_score([batch], priors=[prior])[0]
        assert poses.shape == (2, K, 9) and np.isfinite(poses).all(), mode
    mcfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, mode="ode_fixed"))
    with pytest.raises(NotImplementedError, match="ode_fixed"):
        SingleFrameEvaluator(mcfg, agent).inference_score([batch], priors=[prior])
