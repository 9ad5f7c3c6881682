"""The port's video entry point and its pieces against the JAX package's, at
tiny_test_config: the warm-started sampler (``init_x``, T0 = 0.15 and 0.25,
fused RK4 and the plain loop), detection-mode energies (t drawn per row),
the first-frame pose jitter, ``PoseTracker`` / ``track_video`` over three
frames, and one tracker step through score and energy states trained on
both sides (EMA).

JAX's draws (prior noise, energy times, jitter) are rebuilt from its keys and
handed to the port: the two frameworks' random numbers never match.
Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.data.loader import process_batch as jax_process_batch
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.eval.tracking import PoseTracker as JaxPoseTracker
from genpose2_tpu.eval.tracking import track_video as jax_track_video
from genpose2_tpu.so3.noise import add_noise_to_RT as jax_add_noise_to_RT
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu_torch.config import tiny_test_config
from genpose2_tpu_torch.data.loader import process_batch
from genpose2_tpu_torch.eval.tracking import PoseTracker, track_video
from genpose2_tpu_torch.so3.noise import add_noise_to_RT, truncated_normal
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.weights import posenet_state_dict

B, STEPS = 3, 10


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


def _cfgs(fused):
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    if not fused:
        jcfg = jcfg.replace(sampler=dataclasses.replace(jcfg.sampler, fused_fixed=False))
        pcfg = pcfg.replace(sampler=dataclasses.replace(pcfg.sampler, fused_fixed=False))
    return jcfg, pcfg


def _raw_frames(count=3, seed=0):
    """Collated numpy batches of B ellipsoid-surface clouds with their poses,
    each frame moving the objects a few mm and about 1 degree."""
    rng = np.random.default_rng(seed)
    N = tiny_test_config().model.num_points
    d = rng.normal(size=(B, N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    local = d * rng.uniform(0.04, 0.15, size=(B, 1, 3))
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(B)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = rng.uniform([-0.2, -0.2, 0.5], [0.2, 0.2, 1.0], size=(B, 3))
    frames = []
    for _ in range(count):
        pts = np.einsum("bij,bnj->bni", R, local) + t[:, None]
        frames.append({"pcl_in": pts.astype(np.float32), "rotation": R.astype(np.float32),
                       "translation": t.astype(np.float32)})
        a = np.radians(1.0)
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ R
        t = t + rng.normal(0, 0.003, size=(B, 3))
    return frames


def _agents(jcfg, pcfg, agent_type, seed, batch):
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), batch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    port = PoseAgent(pcfg, agent_type, device="cpu")
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model))
    return agent, state, port


@pytest.fixture(scope="module")
def setup():
    raws = _raw_frames()
    jb = [jax_process_batch(r) for r in raws]
    pb = [process_batch(r, device="cpu") for r in raws]
    out = {"raws": raws, "jb": jb, "pb": pb}
    for fused in (True, False):
        jcfg, pcfg = _cfgs(fused)
        out[fused] = {"cfgs": (jcfg, pcfg), "score": _agents(jcfg, pcfg, "score", 1, jb[0]),
                      "energy": _agents(jcfg, pcfg, "energy", 2, jb[0])}
    return out


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("T0", [0.15, 0.25])
def test_warm_start_candidates_match_jax(setup, T0, fused):
    jcfg, _ = setup[fused]["cfgs"]
    agent, state, port = setup[fused]["score"]
    K = jcfg.eval.eval_repeat_num
    rng = np.random.default_rng(3)
    init_x = np.concatenate([setup["raws"][0]["rotation"][:, :, 0],
                             setup["raws"][0]["rotation"][:, :, 1],
                             rng.normal(0, 0.02, (B, 3))], axis=-1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    prior = jax_init_sde(jcfg.sde).prior_sample(key, (B * K, 9), T=T0)
    want = agent.sample_candidates(state, setup["jb"][0], key, repeat_num=K, T0=T0,
                                   init_x=jnp.asarray(init_x), method="fixed", num_steps=STEPS)
    got = port.sample_candidates(setup["pb"][0], repeat_num=K, T0=T0, init_x=_t(init_x),
                                 method="fixed", num_steps=STEPS, prior=_t(prior))
    # the JAX package's bound for its fused RK4 against the scan after denoise,
    # renormalisation and the center re-add (tests/test_ode_fused.py:112)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-4)
    # a warm start stays near its start: the candidates are not the cold ones
    cold = port.sample_candidates(setup["pb"][0], repeat_num=K, T0=T0, method="fixed",
                                  num_steps=STEPS, prior=_t(prior))
    assert np.abs(cold.numpy() - got.numpy()).max() > 1e-2


def test_detection_energy_time_draw_matches_jax(setup):
    jcfg, _ = setup[True]["cfgs"]
    agent, state, port = setup[True]["energy"]
    K = jcfg.eval.eval_repeat_num
    poses = np.random.default_rng(4).normal(0, 0.3, (B, K, 9)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(agent.get_energy(state, setup["jb"][0], jnp.asarray(poses), fixed_t=None,
                                       key=key))
    t = jax.random.uniform(key, (B * K, 1), jnp.float32, 1e-5, 1e-4)
    got = port.get_energy(setup["pb"][0], _t(poses), fixed_t=None, t=_t(t)).numpy()
    # the slice's energy bound (tests/test_torch_port_slice.py): s_theta
    # divides by std(t) ~ 0.01, so f32 differences grow a hundredfold
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
    fixed = port.get_energy(setup["pb"][0], _t(poses), fixed_t=1e-5).numpy()
    assert np.abs(fixed - got).max() > 1e-3  # the drawn times matter
    # the port's own draw: U[1e-5, 1e-4) per row from the generator, repeatable
    g = [port.get_energy(setup["pb"][0], _t(poses), fixed_t=None,
                         generator=torch.Generator().manual_seed(9)).numpy() for _ in range(2)]
    np.testing.assert_array_equal(g[0], g[1])
    assert np.abs(g[0] - got).max() > 0


def test_first_frame_jitter_matches_jax():
    key = jax.random.PRNGKey(7)
    raw = _raw_frames(1)[0]
    R, t = jnp.asarray(raw["rotation"]), jnp.asarray(raw["translation"])
    want_R, want_t = jax_add_noise_to_RT(key, R, t, 5.0, 0.03)
    draws = _jitter_draws(key, B)
    got_R, got_t = add_noise_to_RT(_t(raw["rotation"]), _t(raw["translation"]), 5.0, 0.03,
                                   **draws)
    np.testing.assert_allclose(got_R.numpy(), np.asarray(want_R), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-7)
    # the port's own draws: truncated at 2 sigma, about unit spread
    z = truncated_normal((20000,), torch.Generator().manual_seed(0))
    assert float(z.abs().max()) <= 2.0 and 0.85 < float(z.std()) < 0.9


def _jitter_draws(key, n):
    """add_noise_to_RT's draws from its key: axis, angle and translation."""
    kr, kt = jax.random.split(key)
    kaxis, kangle = jax.random.split(kr)
    return {"axis": _t(jax.random.normal(kaxis, (n, 3))),
            "angle_z": _t(jax.random.truncated_normal(kangle, -2.0, 2.0, (n,))),
            "t_z": _t(jax.random.truncated_normal(kt, -2.0, 2.0, (n, 3)))}


@pytest.mark.parametrize("T0,fused", [(0.25, True), (0.15, True), (0.25, False)])
def test_track_video_matches_jax(setup, T0, fused):
    jcfg, _ = setup[fused]["cfgs"]
    (sa, ss, sp), (ea, es, ep) = setup[fused]["score"], setup[fused]["energy"]
    key = jax.random.PRNGKey(8)
    want = jax_track_video(JaxPoseTracker(jcfg, sa, ss, ea, es, T0=T0, num_steps=STEPS),
                           setup["jb"], key)
    K = jcfg.eval.eval_repeat_num
    keys = [jax.random.fold_in(key, i) for i in range(len(setup["jb"]))]
    priors = [_t(jax_init_sde(jcfg.sde).prior_sample(k, (B * K, 9), T=T0)) for k in keys]
    tracker = PoseTracker(setup[fused]["cfgs"][1], sp, ep, T0=T0, num_steps=STEPS)
    got = track_video(tracker, setup["pb"], init_noise=_jitter_draws(keys[0], B), priors=priors)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        # each frame starts from the previous frame's own pose on each side;
        # candidates agree to the fused RK4's 5e-4 (tests/test_ode_fused.py:112)
        for k in ("rotation", "translation", "lengths"):
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=0, atol=2e-3,
                                       err_msg=f"frame {i} {k}")


def _capture_grads():
    """An optax transform that passes the updates on and keeps them as its
    state: chained first, its state after a step is the step's gradients."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _dsm_draws(jcfg, key):
    """The JAX step's DSM draws from its key (genpose2_tpu/training/agent.py:
    407, diffusion/losses.py:39-44), for the port's ``draws=``."""
    _, _, k_loss, _ = jax.random.split(key, 4)
    R, eps = jcfg.train.repeat_num, 1e-5  # VE
    keys = jax.random.split(k_loss, R) if R > 1 else [k_loss]
    ts, zs = [], []
    for k in keys:
        kt, kz = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(kt, (B, 1), jnp.float32, eps, 1.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, 9), jnp.float32)))
    return {"t": _t(np.stack(ts)), "z": _t(np.stack(zs))}


def _trained(jcfg, pcfg, agent_type, seed, jbatch, pbatch, steps=3):
    """_agents after ``steps`` train steps on both sides from the same weights
    and batch, at lr 1e-2 without warmup (the EMA then lags the parameters).
    The port takes its own steps (forward, BatchNorm statistics, clip, Adam,
    EMA) on the JAX step's draws, fed the JAX step's gradients: Adam's first
    updates are about lr * sign(g), which flips on gradients near zero
    (tests/test_torch_port_train_step.py holds the gradients themselves)."""
    def lr(cfg):
        return cfg.replace(train=dataclasses.replace(cfg.train, lr=1e-2, warmup=1))

    jcfg, pcfg = lr(jcfg), lr(pcfg)
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=4)
    agent.tx = optax.chain(_capture_grads(), agent.tx)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"],
                          opt_state=agent.tx.init(vs["params"]))
    port = PoseAgent(pcfg, agent_type, device="cpu", steps_per_epoch=4)
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model))
    pstate = port.init_state()
    for i in range(steps):
        key = jax.random.PRNGKey(400 + seed + i)
        state, _ = agent.train_step(state, jbatch, key)
        grads = posenet_state_dict({"params": jax.device_get(state.opt_state[0]),
                                    "batch_stats": jax.device_get(state.batch_stats),
                                    "constants": vs["constants"]}, pcfg.model)
        loss, _, _, bn_stats = port.loss_and_grads(pstate, pbatch,
                                                   draws=_dsm_draws(jcfg, key))
        port.apply_gradients(pstate, loss, [grads[k] for k in pstate.params], bn_stats)
    return agent, jax.device_get(state), port, pstate


def test_tracker_step_runs_the_train_states_like_jax(setup):
    jcfg, pcfg = setup[True]["cfgs"]
    jb, pb = setup["jb"], setup["pb"]
    sa, ss, sp, sps = _trained(jcfg, pcfg, "score", 13, jb[0], pb[0])
    ea, es, ep, eps = _trained(jcfg, pcfg, "energy", 14, jb[0], pb[0])
    raw = setup["raws"][0]
    prev = np.concatenate([raw["rotation"][:, :, 0], raw["rotation"][:, :, 1],
                           raw["translation"]], axis=-1).astype(np.float32)
    key = jax.random.PRNGKey(15)
    want = JaxPoseTracker(jcfg, sa, ss, ea, es, T0=0.25, num_steps=STEPS).step(
        jb[1], jnp.asarray(prev), key)
    K = jcfg.eval.eval_repeat_num
    prior = _t(jax_init_sde(jcfg.sde).prior_sample(key, (B * K, 9), T=0.25))
    tracker = PoseTracker(pcfg, sp, ep, T0=0.25, num_steps=STEPS, score_state=sps,
                          energy_state=eps)
    got = tracker.step(pb[1], _t(prev), prior=prior)
    # the tracking test's bound (test_track_video_matches_jax)
    for k in ("rotation", "translation", "lengths", "prev_pose"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-3,
                                   err_msg=k)
    # the agents' live weights track elsewhere (0.076 apart on this draw):
    # the states are read
    live = PoseTracker(pcfg, sp, ep, T0=0.25, num_steps=STEPS).step(pb[1], _t(prev),
                                                                    prior=prior)
    assert float((live["prev_pose"] - got["prev_pose"]).abs().max()) > 1e-2

