"""The port's multiplexed video tracker and the trainer's ranking candidates
against the JAX package's, on the CPU, at tiny_test_config (the helpers and
bounds of tests/test_torch_port_eval.py).

The same weights (JAX variables randomised from a numpy seed) and inputs go
through both packages; JAX's draws (prior noise, first-frame jitter) are
rebuilt from its keys and handed to the port. Tolerances are stated at each
assert.
"""

import jax
import numpy as np
import pytest
import torch

from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.data.loader import process_batch as jax_process_batch
from genpose2_tpu.data.synthetic import SyntheticPoseData as JaxSyntheticPoseData
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval import metrics as jax_metrics
from genpose2_tpu.eval.tracking import PoseTracker as JaxPoseTracker
from genpose2_tpu.eval.tracking_multiplex import track_videos_multiplexed as jax_multiplexed
from genpose2_tpu.eval.tracking_multiplex import tracking_metrics as jax_tracking_metrics
from genpose2_tpu.training.trainer import (
    candidate_metrics_for_ranking as jax_candidate_metrics)
from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.eval.tracking import PoseTracker
from genpose2_tpu_torch.eval.tracking_multiplex import (track_videos_multiplexed,
                                                        tracking_metrics)
from genpose2_tpu_torch.so3 import rotations as so3
from genpose2_tpu_torch.training.trainer import candidate_metrics_for_ranking
from tests.test_torch_port_eval import (CRITERIA, POSE_TOL, SYMS, _assert_metrics_match,
                                        _criteria, _jax_pose_agent, _port_pose_agent, _t)

# ------------------------------------------------------------ multiplexer
OBJECTS, FRAMES = (3, 5, 10, 2), (3, 2, 2, 3)
TRACK_T0, TRACK_STEPS = 0.25, 6


def _raw_video(rng, n, frames, N):
    """Collated raw frames of n ellipsoid-surface objects moving 3 mm and
    1 degree a frame, with symmetry labels, sizes and classes."""
    d = rng.normal(size=(n, N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    semi = rng.uniform(0.04, 0.15, size=(n, 1, 3))
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = rng.uniform([-0.2, -0.2, 0.5], [0.2, 0.2, 1.0], size=(n, 3))
    labels = [np.asarray(jax_metrics.sym_label(**SYMS[k])) for k in SYMS]
    sym = np.stack([labels[i] for i in rng.integers(0, len(labels), n)]).astype(np.int32)
    cls = rng.integers(0, 2, n).astype(np.int32)
    out = []
    for _ in range(frames):
        out.append({"pcl_in": (np.einsum("bij,bnj->bni", R, d * semi) + t[:, None]).astype(
                        np.float32),
                    "rotation": R.astype(np.float32), "translation": t.astype(np.float32),
                    "sym_info": sym, "bbox_side_len": (2 * semi[:, 0]).astype(np.float32),
                    "class_label": cls})
        a = np.radians(1.0)
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        R, t = Rz @ R, t + rng.normal(0, 0.003 / np.sqrt(3), size=(n, 3))
    return out


def _jitter_draws(key, n):
    """add_noise_to_RT's draws from its key: axis, angle and translation."""
    kr, kt = jax.random.split(key)
    kaxis, kangle = jax.random.split(kr)
    return {"axis": _t(jax.random.normal(kaxis, (n, 3))),
            "angle_z": _t(jax.random.truncated_normal(kangle, -2.0, 2.0, (n,))),
            "t_z": _t(jax.random.truncated_normal(kt, -2.0, 2.0, (n, 3)))}


@pytest.fixture(scope="module")
def agents():
    """JAX score and energy agents at tiny_test_config with randomised
    weights, and their variables for the port."""
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    rng = np.random.default_rng(19)
    probe = jax_process_batch(_raw_video(rng, 2, 1, pcfg.model.num_points)[0])
    return {"cfgs": (jcfg, pcfg), "score": _jax_pose_agent(jcfg, "score", probe, 21),
            "energy": _jax_pose_agent(jcfg, "energy", probe, 22)}


@pytest.mark.parametrize("budget", [8, 16])
def test_multiplexed_tracking_matches_jax(agents, budget):
    """4 videos (3, 5, 10 and 2 objects), 3 streams open at a time, so that
    a finished stream is replaced: at a budget of 8 every step takes one
    frame and the 10-object frames run in two slices; at 16 the first two
    streams share steps and the third one's frame is put back until it
    fits."""
    jcfg, pcfg = agents["cfgs"]
    rng = np.random.default_rng(20)
    videos = [_raw_video(rng, n, f, pcfg.model.num_points) for n, f in zip(OBJECTS, FRAMES)]
    (sa, ss, svs), (ea, es, evs) = agents["score"], agents["energy"]
    events = []

    class Recording(JaxPoseTracker):
        def init_from_gt(self, key, gt_rotation, gt_translation, *a, **kw):
            events.append(("init", key, gt_rotation.shape[0]))
            return super().init_from_gt(key, gt_rotation, gt_translation, *a, **kw)

        def step(self, batch, prev_pose, key):
            events.append(("step", key))
            return super().step(batch, prev_pose, key)

    key = jax.random.PRNGKey(23)
    want = jax_multiplexed(Recording(jcfg, sa, ss, ea, es, T0=TRACK_T0, num_steps=TRACK_STEPS),
                           videos, key, max_streams=3, object_budget=budget,
                           progress=lambda n: events.append(("done", n)))
    # JAX's draws, step by step: a step's slice keys, then its chunks' sizes
    K, sde = jcfg.eval.eval_repeat_num, jax_init_sde(jcfg.sde)
    init_noise = [_jitter_draws(e[1], e[2]) for e in events if e[0] == "init"]
    steps = []  # (slice keys, chunk sizes) per step
    for e in events:
        if e[0] == "step":
            if not steps or steps[-1][1]:
                steps.append(([], []))
            steps[-1][0].append(e[1])
        elif e[0] == "done":
            steps[-1][1].append(e[1])
    priors = []
    for keys, sizes in steps:
        total = sum(sizes)
        priors.append(_t(np.concatenate([
            np.asarray(sde.prior_sample(k, (budget * K, 9), T=TRACK_T0))[
                :min(budget, total - off) * K] for k, off in zip(keys, range(0, total, budget))])))
    got_steps = []
    tracker = PoseTracker(pcfg, _port_pose_agent(pcfg, "score", svs),
                          _port_pose_agent(pcfg, "energy", evs), T0=TRACK_T0,
                          num_steps=TRACK_STEPS)
    got = track_videos_multiplexed(tracker, videos, max_streams=3, object_budget=budget,
                                   init_noise=init_noise, priors=priors,
                                   progress=lambda n: got_steps.append(n))
    sizes = [s for _, s in steps]
    assert got_steps == [n for s in sizes for n in s]
    if budget == 8:  # one frame a step; the 10-object frames in two slices
        assert sizes == [[3], [3], [3], [5], [5], [10], [10], [2], [2], [2]]
        assert [len(k) for k, _ in steps] == [1] * 5 + [2, 2] + [1] * 3
    else:  # video 2's first frame put back twice; video 3 opened after video 1 ends
        assert sizes == [[3, 5], [3, 5], [3, 10], [10], [2], [2], [2]]
    for v, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == FRAMES[v]
        for f, (gf, wf) in enumerate(zip(g, w)):
            assert sorted(gf) == sorted(wf)
            for k in ("gt_rotation", "gt_translation", "gt_lengths", "sym_info", "class_label"):
                np.testing.assert_array_equal(gf[k], wf[k])
            # the tracking bound (tests/test_torch_port_tracking.py)
            for k in ("rotation", "translation", "lengths"):
                np.testing.assert_allclose(gf[k], wf[k], rtol=0, atol=2e-3,
                                           err_msg=f"video {v} frame {f} {k}")
    crit_got, crit_want = {k: [] for k in CRITERIA}, {k: [] for k in CRITERIA}
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            batch = {"gt_rotation": wf["gt_rotation"], "gt_translation": wf["gt_translation"],
                     "bbox_side_len": wf["gt_lengths"], "sym_info": wf["sym_info"]}
            for crit, r in ((crit_got, gf), (crit_want, wf)):
                c = _criteria(r["rotation"], r["translation"], r["lengths"], batch)
                for k in CRITERIA:
                    crit[k].append(c[k])
    _assert_metrics_match(tracking_metrics(got), jax_tracking_metrics(want), crit_got,
                          crit_want, f"budget {budget}")


# ------------------------------------------------------------------ ranking
def test_candidate_metrics_for_ranking_matches_jax(agents):
    jcfg, pcfg = agents["cfgs"]
    data = JaxSyntheticPoseData(num_points=pcfg.model.num_points, shape="cylinder")
    jbatch = data.batch(jax.random.PRNGKey(30), 3)
    sa, ss, svs = agents["score"]
    num = jcfg.train.ranking_num
    key = jax.random.PRNGKey(32)
    want_c, want_m = (np.asarray(x) for x in jax_candidate_metrics(sa, ss, jbatch, key, num))
    prior = _t(jax_init_sde(jcfg.sde).prior_sample(key, (3 * num, 9), T=1.0))
    pbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    got_c, got_m = candidate_metrics_for_ranking(_port_pose_agent(pcfg, "score", svs), pbatch,
                                                 num, prior=prior)
    got_c, got_m = got_c.numpy(), got_m.numpy()
    assert got_c.shape == want_c.shape == (3, num, 9) and got_m.shape == (3, num, 2)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=POSE_TOL)  # the fused RK4's bound
    # each error is 1-Lipschitz in its candidate: the rotation error moves by
    # at most the angle between the two candidates' rotations (float64, from
    # the chord), the translation error by the distance between translations
    Rg = so3.rot6d_cols_to_matrix(_t(got_c[..., :6]).double())
    Rw = so3.rot6d_cols_to_matrix(torch.from_numpy(want_c[..., :6]).double())
    chord = torch.linalg.norm((Rg - Rw).flatten(-2), dim=-1).numpy()
    apart = np.degrees(2 * np.arcsin(np.minimum(chord / (2 * np.sqrt(2)), 1.0)))
    assert (np.abs(got_m[..., 0] - want_m[..., 0]) <= apart + 1e-3).all()
    dt = np.linalg.norm(got_c[..., 6:] - want_c[..., 6:], axis=-1)
    # (plus the float32 rounding of norms up to ~60 m: 1e-6 relative)
    assert (np.abs(got_m[..., 1] - want_m[..., 1]) <= dt + 1e-6 * (1 + want_m[..., 1])).all()
    assert want_m[..., 0].min() > 1.0  # away from 0, where arccos would amplify rounding
