"""The port's serving slice (score agent + energy agent + ScaleNet, dino='none')
against the JAX package's, at tiny_test_config, with the same weights and the
same prior noise.

JAX's prior draw (``sde.prior_sample`` with the key ``sample_candidates``
gets) is handed to the port's ``prior`` argument: the two frameworks' random
numbers never match. Tolerances are stated at each assert.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval.aggregate import aggregate_candidates as jax_aggregate
from genpose2_tpu.eval.aggregate import analytic_bbox_lengths as jax_bbox_lengths
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu.training.ranking import sort_poses_by_energy as jax_sort
from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.device import resolve_device
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates, analytic_bbox_lengths
from genpose2_tpu_torch.so3.rotations import (matrix_to_quaternion, quaternion_to_matrix,
                                              rot6d_cols_to_matrix)
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.training.ranking import sort_poses_by_energy
from genpose2_tpu_torch.weights import posenet_state_dict, scalenet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, STEPS, T0 = 3, 20, 12, 0.55


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(variables, seed, scale=0.1):
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


def _jax_agent(cfg, agent_type, batch, seed):
    agent = JaxPoseAgent(cfg, agent_type, steps_per_epoch=4)
    state = agent.init_state(jax.random.PRNGKey(seed), batch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    return agent, state, vs


@pytest.fixture(scope="module")
def slice_run():
    """One request through both packages: features, candidates, energies,
    aggregation and box sizes."""
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.3, 0.3, size=(B, jcfg.model.num_points, 3)).astype(np.float32)
    center = pts.mean(axis=1)
    jbatch = {"pts": jnp.asarray(pts), "pts_center": jnp.asarray(center),
              "zero_mean_gt_pose": jnp.zeros((B, 9))}
    pbatch = {"pts": _t(pts), "pts_center": _t(center)}

    s_agent, s_state, s_vs = _jax_agent(jcfg, "score", jbatch, 1)
    e_agent, e_state, e_vs = _jax_agent(jcfg, "energy", jbatch, 2)
    scale_agent = JaxScaleAgent(jcfg)
    sc_state = scale_agent.init_state(jax.random.PRNGKey(3), pts_dim=128)
    sc_vs = randomize({"params": sc_state.params}, 3)
    sc_state = sc_state.replace(params=sc_vs["params"], ema_params=sc_vs["params"])

    key = jax.random.PRNGKey(4)
    prior = np.asarray(jax_init_sde(jcfg.sde).prior_sample(key, (B * K, 9), T=T0))
    feats = s_agent.extract_features(s_state, jbatch)
    poses = s_agent.sample_candidates(s_state, jbatch, key, repeat_num=K, T0=T0,
                                      method="fixed", num_steps=STEPS, features=feats)
    energy = e_agent.get_energy(e_state, jbatch, poses, fixed_t=1e-5)
    ev = jcfg.eval
    agg = jax_aggregate(poses, energy, retain_ratio=ev.retain_ratio, clustering=True,
                        eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    lengths = scale_agent.predict(sc_state, feats[0], agg["rotation"])
    want = jax.tree_util.tree_map(np.asarray, {
        "feat": feats[0], "poses": poses, "energy": energy, "agg": agg, "lengths": lengths})

    ps = PoseAgent(pcfg, "score", device="cpu")
    ps.model.load_state_dict(posenet_state_dict(s_vs, pcfg.model))
    pe = PoseAgent(pcfg, "energy", device="cpu")
    pe.model.load_state_dict(posenet_state_dict(e_vs, pcfg.model))
    psc = ScaleAgent(pcfg, pts_dim=128, device="cpu")
    psc.model.load_state_dict(scalenet_state_dict(sc_vs))
    feat, _ = ps.extract_features(pbatch)
    p_poses = ps.sample_candidates(pbatch, repeat_num=K, T0=T0, method="fixed",
                                   num_steps=STEPS, features=(feat, None), prior=_t(prior))
    # energies and aggregation take JAX's candidates, so that each stage is
    # compared on the same inputs
    p_energy = pe.get_energy(pbatch, _t(want["poses"]))
    p_agg = aggregate_candidates(_t(want["poses"]), _t(want["energy"]),
                                 retain_ratio=ev.retain_ratio, clustering=True,
                                 eps=ev.clustering_eps, minpts_ratio=ev.clustering_minpts_ratio)
    p_lengths = psc.predict(feat, _t(want["agg"]["rotation"]))
    got = {"feat": feat.numpy(), "poses": p_poses.numpy(), "energy": p_energy.numpy(),
           "agg": {k: v.numpy() for k, v in p_agg.items()}, "lengths": p_lengths.numpy()}
    return want, got, jcfg


def test_features_match(slice_run):
    want, got, _ = slice_run
    np.testing.assert_allclose(got["feat"], want["feat"], rtol=1e-4, atol=1e-4)


def test_candidates_match(slice_run):
    want, got, _ = slice_run
    # the JAX package's bound for the fused kernel against the scan path with
    # denoise, renormalisation and center re-add (tests/test_ode_fused.py:112)
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=1e-4, atol=5e-4)


def test_energies_match_and_rank_alike(slice_run):
    want, got, _ = slice_run
    # s_theta divides by std(1e-5) ~ 0.01, so f32 differences of the heads
    # grow a hundredfold; relative agreement stays at the f32 matmul level
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=2e-4, atol=1e-3)
    gaps = np.diff(np.sort(want["energy"], axis=1), axis=1)
    assert gaps.min() > 1e-2, "energies too close to rank the same under f32 noise"
    np.testing.assert_array_equal(np.argsort(-got["energy"], axis=1, kind="stable"),
                                  np.argsort(-want["energy"], axis=1, kind="stable"))


def test_aggregation_matches(slice_run):
    want, got, jcfg = slice_run
    # DBSCAN compares row distances with <= eps; the test data must keep every
    # distance clear of eps, or rounding alone could flip a neighbourhood
    retained = want["agg"]["retained"]
    quat = matrix_to_quaternion(rot6d_cols_to_matrix(_t(retained[..., :6]))).numpy()
    qd = 1.0 - np.einsum("bki,bji->bkj", quat, quat) ** 2
    row_dist = np.linalg.norm(qd[:, :, None, :] - qd[:, None, :, :], axis=-1)
    assert np.abs(row_dist - jcfg.eval.clustering_eps).min() > 1e-4
    np.testing.assert_array_equal(got["agg"]["retained"], want["agg"]["retained"])
    np.testing.assert_allclose(got["agg"]["rotation"], want["agg"]["rotation"], atol=1e-5)
    np.testing.assert_allclose(got["agg"]["translation"], want["agg"]["translation"], atol=1e-6)


def test_scale_lengths_match(slice_run):
    want, got, _ = slice_run
    np.testing.assert_allclose(got["lengths"], want["lengths"], rtol=2e-4, atol=2e-4)


def test_sort_by_energy_is_stable_like_jax():
    rng = np.random.default_rng(5)
    poses = rng.normal(size=(2, 10, 9)).astype(np.float32)
    energy = rng.integers(0, 3, size=(2, 10, 2)).astype(np.float32)  # many ties
    want = jax_sort(jnp.asarray(poses), jnp.asarray(energy))
    got = sort_poses_by_energy(_t(poses), _t(energy))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_score_only_aggregation_keeps_input_order():
    rng = np.random.default_rng(6)
    poses = rng.normal(size=(2, 10, 9)).astype(np.float32)
    want = jax_aggregate(jnp.asarray(poses), None, clustering=False)
    got = aggregate_candidates(_t(poses), None, clustering=False)
    np.testing.assert_array_equal(got["retained"].numpy(), np.asarray(want["retained"]))
    np.testing.assert_allclose(got["rotation"].numpy(), np.asarray(want["rotation"]), atol=1e-5)


def test_analytic_bbox_lengths_match_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    R = quaternion_to_matrix(_t(rng.normal(size=(3, 4))))
    t = rng.normal(size=(3, 3)).astype(np.float32)
    want = np.asarray(jax_bbox_lengths(jnp.asarray(pts), jnp.asarray(R.numpy()), jnp.asarray(t)))
    got = analytic_bbox_lengths(_t(pts), R, _t(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither JAX nor the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import genpose2_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(genpose2_tpu_torch.__path__,
                                                        "genpose2_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "genpose2_tpu")]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseAgent(cfg, "score")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScaleAgent(cfg)
    assert PoseAgent(cfg, "score", device="cpu").device.type == "cpu"
