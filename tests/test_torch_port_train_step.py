"""The port's training steps against the JAX package's ``train_step`` on the
CPU: the score agent at tiny_test_config (dino='none') and at
tiny_flagship_config (ViT, ImgEncoder, Fus PointNet++), the energy agent with
ranking candidates, and the ScaleAgent; then the NaN guard, replay from a
seed and the Trainer; then inference through the EMA weights after JAX train
steps (``use_ema``).

Both packages start from the same weights (JAX variables randomised from a
numpy seed, carried over by genpose2_tpu_torch/weights.py) and see the same
batch; dropout and input jitter are 0; the DSM draws and the ranking times
are the JAX step's own, reproduced from its key split
(genpose2_tpu/training/agent.py:407,485, diffusion/losses.py:39-44) and given
to the port as explicit arrays. The JAX gradients are read out of the step
through an identity transform chained in front of its optimizer. Parameters
and EMA are compared after feeding the port's update JAX's gradients: Adam's
first step is about lr * sign(g), which flips on gradients near zero.
Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import ScaleAgent as JaxScaleAgent
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
from genpose2_tpu_torch.training.optim import global_norm
from genpose2_tpu_torch.training.trainer import Trainer, zero_init_energy_heads
from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict, scalenet_state_dict

B, N, K, SPE = 2, 128, 3, 4


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


def _no_dropout(cfg):
    pn2 = dataclasses.replace(cfg.model.pointnet2, dropout=0.0, input_jitter=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, pointnet2=pn2))


def _batch(cfg, seed, ranking=False):
    """numpy batch: camera-frame clouds, gt poses, pixels with dino='pointwise',
    candidates and their errors with ``ranking``."""
    rng = np.random.default_rng(seed)
    b = {"pts": rng.uniform(-0.3, 0.3, size=(B, N, 3)) + [0.0, 0.0, 0.8],
         "zero_mean_gt_pose": rng.normal(size=(B, 9)) * 0.5}
    if cfg.model.dino == "pointwise":
        S = cfg.model.img_size
        b["roi_rgb"] = rng.normal(size=(B, S, S, 3))
        b["roi_xs"] = rng.integers(0, S, (B, N)).astype(np.int32)
        b["roi_ys"] = rng.integers(0, S, (B, N)).astype(np.int32)
    if ranking:
        b["candidate_poses"] = rng.normal(size=(B, K, 9)) * 0.5
        b["candidate_metrics"] = rng.uniform(size=(B, K, 2))
    return {k: v if v.dtype == np.int32 else v.astype(np.float32) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _capture_grads():
    """An optax transform that passes the updates on and keeps them as its
    state: chained first, its state after a step is the step's gradients."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _draws(cfg, key, ranking):
    """The JAX step's DSM draws and ranking times, from its key."""
    _, _, k_loss, k_rank = jax.random.split(key, 4)
    R, eps = cfg.train.repeat_num, 1e-5  # VE
    keys = jax.random.split(k_loss, R) if R > 1 else [k_loss]
    ts, zs = [], []
    for k in keys:
        kt, kz = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(kt, (B, 1), jnp.float32, eps, 1.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, 9), jnp.float32)))
    d = {"t": _t(np.stack(ts)), "z": _t(np.stack(zs))}
    if ranking:
        d["rank_t"] = _t(jax.random.uniform(k_rank, (B * K, 1), jnp.float32, 1e-5, 1e-4))
    return d


def _sd_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _pose_step(jcfg, pcfg, agent_type, seed, ranking=False):
    """One JAX train_step and the port's loss, gradients and update from the
    same weights, batch and draws."""
    batch = _batch(pcfg, seed, ranking)
    jbatch = jax.tree.map(jnp.asarray, batch)
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=SPE)
    agent.tx = optax.chain(_capture_grads(), agent.tx)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"],
                          opt_state=agent.tx.init(vs["params"]))
    key = jax.random.PRNGKey(100 + seed)
    new, metrics = agent.train_step(state, jbatch, key)
    new, metrics = jax.device_get((new, metrics))
    consts = {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}

    def sd(params, stats):
        return _sd_numpy(posenet_state_dict({"params": params, "batch_stats": stats,
                                             "constants": consts}, pcfg.model))

    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]), "grads": sd(new.opt_state[0], new.batch_stats),
            "params": sd(new.params, new.batch_stats), "ema": sd(new.ema_params, new.batch_stats)}
    if ranking:
        want["ranking_loss"] = float(metrics["ranking_loss"])

    port = PoseAgent(pcfg, agent_type, device="cpu", steps_per_epoch=SPE)
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model))
    if port.provider is not None:
        port.provider.vit.load_state_dict(dinov3_state_dict(vs["constants"][PROVIDER_KEY]))
    pstate = port.init_state()
    buffers0 = {k: v.clone() for k, v in pstate.buffers.items()}
    loss, m, grads, bn_stats = port.loss_and_grads(pstate, _port_batch(batch),
                                                   draws=_draws(jcfg, key, ranking))
    got = {"loss": float(loss.detach()), "metrics": m, "grads": {k: g for k, g in grads.items()},
           "grad_norm": float(global_norm([torch.zeros_like(pstate.params[k]) if g is None else g
                                           for k, g in grads.items()]))}
    # the update, fed JAX's gradients
    untouched = all(torch.equal(v, buffers0[k]) for k, v in pstate.buffers.items())
    norm = port.apply_gradients(pstate, loss, [_t(want["grads"][k]) for k in pstate.params],
                                bn_stats)
    got.update(fed_norm=float(norm), state=pstate, buffers_untouched_by_loss=untouched,
               buffers={k: v.numpy() for k, v in pstate.buffers.items()},
               params={k: v.detach().numpy() for k, v in pstate.params.items()},
               ema={k: v.numpy() for k, v in pstate.ema_params.items()})
    return want, got


@pytest.fixture(scope="module")
def steps():
    """The three PoseAgent steps, each through both packages once."""
    return {
        "score_none": _pose_step(jax_tiny_config(), tiny_test_config(), "score", 1),
        "score_flagship": _pose_step(_no_dropout(jax_flagship_config()),
                                     _no_dropout(tiny_flagship_config()), "score", 2),
        "energy_ranking": _pose_step(jax_tiny_config(), tiny_test_config(), "energy", 3,
                                     ranking=True),
    }


STEPS = ["score_none", "score_flagship", "energy_ranking"]


def _rel(got, want):
    """max |got - want| over max |want| (at least 1e-30), over a dict."""
    diff = max(float(np.abs(np.asarray(got[k]) - want[k]).max()) for k in want)
    return diff / max(max(float(np.abs(w).max()) for w in want.values()), 1e-30)


@pytest.mark.parametrize("name", STEPS)
def test_train_step_loss_and_grad_norm_match_jax(steps, name):
    want, got = steps[name]
    # float32: the encoder's module forward and the DSM loss in another
    # summation order; the energy score is a second derivative
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    # the update fed JAX's gradients reports their norm
    assert abs(got["fed_norm"] - want["grad_norm"]) <= 1e-6 * want["grad_norm"]
    if name == "energy_ranking":
        assert abs(float(got["metrics"]["ranking_loss"]) - want["ranking_loss"]) <= 1e-5


@pytest.mark.parametrize("name", STEPS)
def test_train_step_grads_match_jax(steps, name):
    want, got = steps[name]
    grads = {k: (np.zeros_like(want["grads"][k]) if g is None else g.numpy())
             for k, g in got["grads"].items()}
    # every trainable parameter of the port has a JAX gradient, and only the
    # ImgEncoder's (behind the stop-gradient) is zero
    assert set(grads) <= set(want["grads"])
    for k, g in got["grads"].items():
        assert (g is None) == k.startswith("img_encoder."), k
    # float32, within 5e-4 of the largest gradient entry: train-mode
    # BatchNorm gradients summed in another order, as in the module tests
    # (tests/test_torch_port_training.py)
    assert _rel(grads, {k: want["grads"][k] for k in grads}) <= 5e-4


@pytest.mark.parametrize("name", STEPS)
def test_train_step_state_matches_jax(steps, name):
    want, got = steps[name]
    # loss_and_grads hands the batch's BatchNorm statistics to the update
    # and leaves the running ones as they were
    assert got["buffers_untouched_by_loss"]
    # BatchNorm statistics of the batch, moved 0.9 / 0.1 with the biased
    # variance: float32 summation order
    for k, v in got["buffers"].items():
        np.testing.assert_allclose(v, want["params"][k], rtol=1e-5, atol=1e-6, err_msg=k)
    # parameters and EMA after the same gradients: the same float32 clip,
    # Adam and EMA operations, up to the global norm's summation order
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want["params"][k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["ema"][k], want["ema"][k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["state"].step == 1 and got["state"].opt_state["count"] == 1


def test_scale_train_step_matches_jax():
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    rng = np.random.default_rng(20)
    S_AX, F = 4, 64
    batch = {"pts_feat": rng.normal(size=(B, F)).astype(np.float32),
             "axes_training": rng.normal(size=(B, S_AX, 3, 3)).astype(np.float32),
             "gt_length": rng.uniform(0.05, 0.3, size=(B, 3)).astype(np.float32)}
    agent = JaxScaleAgent(jcfg, steps_per_epoch=SPE)
    agent.tx = optax.chain(_capture_grads(), agent.tx)
    state = agent.init_state(jax.random.PRNGKey(0), pts_dim=F)
    vs = randomize({"params": state.params}, 21)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          opt_state=agent.tx.init(vs["params"]))
    new, metrics = jax.device_get(agent.train_step(state, jax.tree.map(jnp.asarray, batch),
                                                   jax.random.PRNGKey(1)))
    port = ScaleAgent(pcfg, pts_dim=F, device="cpu", steps_per_epoch=SPE)
    port.model.load_state_dict(scalenet_state_dict(vs))
    pstate = port.init_state()
    loss, grads = port.loss_and_grads(pstate, {k: _t(v) for k, v in batch.items()})
    want_g = _sd_numpy(scalenet_state_dict({"params": new.opt_state[0]}))
    want_loss = float(metrics["loss"])
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    # a few float32 dense layers: 1e-5 of the largest gradient entry
    assert _rel({k: g.numpy() for k, g in grads.items()}, want_g) <= 1e-5
    port.apply_gradients(pstate, loss, [_t(want_g[k]) for k in pstate.params], {})
    want_p = _sd_numpy(scalenet_state_dict({"params": new.params}))
    want_e = _sd_numpy(scalenet_state_dict({"params": new.ema_params}))
    for k, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(pstate.ema_params[k].numpy(), want_e[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- port only
def _randomized_agent(cfg, agent_type="score", seed=0):
    torch.manual_seed(seed)  # the modules' own initialisation
    agent = PoseAgent(cfg, agent_type, device="cpu", steps_per_epoch=SPE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return agent


def _snapshot(state):
    opt = state.opt_state
    return [t.clone() for t in (*state.params.values(), *state.buffers.values(),
                                *state.ema_params.values(), *opt["mu"], *opt["nu"])]


def test_nan_guard_leaves_state_untouched():
    cfg = tiny_test_config()
    agent = _randomized_agent(cfg)
    state = agent.init_state()
    ok = _port_batch(_batch(cfg, 30))
    state, _ = agent.train_step(state, ok, torch.Generator().manual_seed(1))
    before = _snapshot(state)
    bad = dict(ok, zero_mean_gt_pose=ok["zero_mean_gt_pose"].clone())
    bad["zero_mean_gt_pose"][0, 0] = float("nan")
    state, metrics = agent.train_step(state, bad, torch.Generator().manual_seed(2))
    assert not bool(torch.isfinite(metrics["loss"]))
    assert state.step == 2 and state.opt_state["count"] == 1 and state.ema_updates == 1.0
    for a, b in zip(before, _snapshot(state)):
        assert torch.equal(a, b)
    # and the next finite step goes on from there
    state, metrics = agent.train_step(state, ok, torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(metrics["loss"])) and state.opt_state["count"] == 2


def test_same_seed_replays_the_step_and_another_seed_differs():
    """tiny_flagship_config keeps dropout 0.1 and input jitter 1e-3."""
    cfg = tiny_flagship_config()
    batch = _port_batch(_batch(cfg, 31))
    runs = []
    for seed in (5, 5, 6):
        agent = _randomized_agent(cfg, seed=0)
        state = agent.init_state()
        state, m = agent.train_step(state, batch, torch.Generator().manual_seed(seed))
        runs.append((float(m["loss"]), [p.detach().clone() for p in state.params.values()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]


def test_trainer_runs_score_then_scale_epochs(tmp_path):
    cfg = tiny_test_config()
    trainer = Trainer(cfg, "score", steps_per_epoch=SPE, device="cpu", log_dir=str(tmp_path))
    state = trainer.init()
    with torch.no_grad():
        for p in trainer.agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(0)) * 0.05)
    batches = [_port_batch(_batch(cfg, 40 + i)) for i in range(2)]
    before = [p.detach().clone() for p in state.params.values()]
    last = trainer.train_epoch(batches, torch.Generator().manual_seed(7))
    assert trainer.state.step == 2 and bool(torch.isfinite(last["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params.values()))
    # ScaleNet on the frozen score encoder's features, its width from a batch
    rng = np.random.default_rng(41)
    raw = [dict(b, axes_training=_t(rng.normal(size=(B, 4, 3, 3))),
                bbox_side_len=_t(rng.uniform(0.05, 0.3, size=(B, 3)))) for b in batches]
    scale = Trainer(cfg, "scale", steps_per_epoch=SPE, frozen_score=(trainer.agent, state),
                    device="cpu", log_dir=str(tmp_path))
    scale.init(raw[0])
    width = trainer.agent.model.pts_encoder.out_channels
    assert scale.agent.model.fusion_tail_length[0].in_features == width + 256
    last = scale.train_epoch(raw)
    assert scale.state.step == 2 and bool(torch.isfinite(last["loss"]))
    # a raw collated batch goes through process_batch (not NOCS-style: no
    # augmentation) and trains as its prepared form does
    R = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0].astype(np.float32)
    raw_batch = {"pcl_in": batches[0]["pts"].numpy(), "rotation": R,
                 "translation": rng.uniform(-0.1, 0.1, (B, 3)).astype(np.float32)}
    prepared = trainer._prepare(raw_batch)
    assert prepared["zero_mean_gt_pose"].shape == (B, 9)
    last = trainer.train_epoch([raw_batch], torch.Generator().manual_seed(8))
    assert trainer.state.step == 3 and bool(torch.isfinite(last["loss"]))


def test_zero_init_energy_heads():
    cfg = tiny_test_config()
    agent = _randomized_agent(cfg, "energy")
    state = zero_init_energy_heads(agent, agent.init_state())
    net = agent.model.pose_score_net
    for name in net.head_names():
        assert not getattr(net, name)[-1].weight.any() and not getattr(net, name)[-1].bias.any()
        assert getattr(net, name)[0].weight.any()
    for k, p in state.params.items():
        assert torch.equal(state.ema_params[k], p)


def test_train_steps_equal_repeated_train_step():
    cfg = tiny_test_config()
    batches = [_port_batch(_batch(cfg, 50 + i)) for i in range(2)]
    runs = []
    for looped in (False, True):
        agent = _randomized_agent(cfg)
        state = agent.init_state()
        g = torch.Generator().manual_seed(8)
        if looped:
            state, metrics = agent.train_steps(state, batches, g)
        else:
            metrics = [agent.train_step(state, b, g)[1] for b in batches]
        runs.append(([float(m["loss"]) for m in metrics], list(state.params.values())))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_trainer_energy_with_ranking_takes_candidates(tmp_path):
    cfg = tiny_test_config()
    trainer = Trainer(cfg, "energy_with_ranking", steps_per_epoch=SPE, device="cpu",
                      log_dir=str(tmp_path))
    trainer.init()
    batches = [_port_batch(_batch(cfg, 60 + i, ranking=True)) for i in range(2)]
    last = trainer.train_epoch(batches, torch.Generator().manual_seed(9))
    assert trainer.state.step == 2 and "ranking_loss" in last
    assert bool(torch.isfinite(last["loss"]))
    # a prepared batch without candidates: the Trainer draws ranking_num of
    # them from the frozen score agent (its EMA weights), with their errors
    score = _randomized_agent(cfg, "score", 63)
    ranking = Trainer(cfg, "energy_with_ranking", steps_per_epoch=SPE, device="cpu",
                      log_dir=str(tmp_path),
                      frozen_score=(score, score.init_state()))
    ranking.init()
    rng = np.random.default_rng(62)
    R = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
    R *= np.sign(np.linalg.det(R))[:, None, None]
    raw = _port_batch(_batch(cfg, 62))
    batch = dict(raw, pts_center=raw["pts"].mean(1), gt_rotation=_t(R),
                 gt_translation=_t(rng.uniform(-0.1, 0.1, (B, 3)) + [0.0, 0.0, 0.8]),
                 sym_info=torch.tensor([[0, 2, 1, 0]] * B, dtype=torch.int32))
    prepared = ranking._prepare(batch, torch.Generator().manual_seed(64))
    num = cfg.train.ranking_num
    assert prepared["candidate_poses"].shape == (B, num, 9)
    assert prepared["candidate_metrics"].shape == (B, num, 2)
    assert bool((prepared["candidate_metrics"][..., 0] >= 0).all())
    last = ranking.train_epoch([batch], torch.Generator().manual_seed(65))
    assert ranking.state.step == 1 and "ranking_loss" in last
    assert bool(torch.isfinite(last["loss"]))
    with pytest.raises(ValueError, match="frozen score"):  # no agent to draw them from
        trainer.train_epoch([batch])


# ------------------------------------------------------------------ use_ema
KC, STEPS_C, T0_C = 4, 8, 0.55


def _trained_agents(agent_type, seed, steps=3):
    """A JAX agent and its state after ``steps`` train steps from randomised
    weights at lr 1e-2 without warmup (the EMA then lags the parameters well
    beyond the float32 bounds), and the port's agent and train state with the
    same parameters, EMA and BatchNorm statistics."""
    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, lr=1e-2, warmup=1))
    batch = _batch(pcfg, seed)
    jbatch = jax.tree.map(jnp.asarray, batch)
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=SPE)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"],
                          opt_state=agent.tx.init(vs["params"]))
    for i in range(steps):
        state, _ = agent.train_step(state, jbatch, jax.random.PRNGKey(300 + seed + i))
    state = jax.device_get(state)

    def sd(params):
        return posenet_state_dict({"params": params, "batch_stats": state.batch_stats,
                                   "constants": vs["constants"]}, pcfg.model)

    port = PoseAgent(pcfg, agent_type, device="cpu", steps_per_epoch=SPE)
    port.model.load_state_dict(sd(state.params))
    pstate = port.init_state()
    ema = sd(state.ema_params)
    for k, e in pstate.ema_params.items():
        e.copy_(ema[k])
    return {"jcfg": jcfg, "agent": agent, "state": state, "port": port, "pstate": pstate,
            "batch": batch}


@pytest.fixture(scope="module")
def trained():
    return {"score": _trained_agents("score", 70), "energy": _trained_agents("energy", 71)}


def _live(port):
    return {k: v.clone() for k, v in port.model.state_dict().items()}


@pytest.mark.parametrize("use_ema", [True, False])
def test_inference_reads_the_ema_like_jax(trained, use_ema):
    s, e = trained["score"], trained["energy"]
    jbatch = jax.tree.map(jnp.asarray, s["batch"])
    pbatch = _port_batch(s["batch"])
    live = _live(s["port"]), _live(e["port"])
    # float32 bounds as the slice tests': the encoder's (tests/test_models.py:446)
    want = np.asarray(s["agent"].extract_features(s["state"], jbatch, use_ema)[0])
    got = s["port"].extract_features(pbatch, state=s["pstate"], use_ema=use_ema)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # candidates from the same prior: the fused RK4's bound against the scan
    # (tests/test_ode_fused.py:112)
    key = jax.random.PRNGKey(80)
    prior = np.asarray(jax_init_sde(s["jcfg"].sde).prior_sample(key, (B * KC, 9), T=T0_C))
    want_poses = np.asarray(s["agent"].sample_candidates(
        s["state"], jbatch, key, repeat_num=KC, T0=T0_C, use_ema=use_ema, method="fixed",
        num_steps=STEPS_C))
    got_poses = s["port"].sample_candidates(pbatch, repeat_num=KC, T0=T0_C, method="fixed",
                                            num_steps=STEPS_C, prior=_t(prior),
                                            state=s["pstate"], use_ema=use_ema)
    np.testing.assert_allclose(got_poses.numpy(), want_poses, rtol=1e-4, atol=5e-4)
    # energies of the same candidates at the same t: s_theta divides by
    # std(1e-5), so float32 differences grow a hundredfold
    want_e = np.asarray(e["agent"].get_energy(e["state"], jax.tree.map(jnp.asarray, e["batch"]),
                                              want_poses, use_ema=use_ema, fixed_t=1e-5))
    got_e = e["port"].get_energy(_port_batch(e["batch"]), _t(want_poses), fixed_t=1e-5,
                                 state=e["pstate"], use_ema=use_ema)
    np.testing.assert_allclose(got_e.numpy(), want_e, rtol=2e-4, atol=1e-3)
    # the live weights are back
    for agent, before in zip((s["port"], e["port"]), live):
        assert _live(agent).keys() == before.keys()
        assert all(torch.equal(v, before[k]) for k, v in _live(agent).items())


@pytest.fixture(scope="module")
def trained_scale():
    """JAX's and the port's ScaleAgent after the same three train steps from
    the same weights and batches (lr 1e-2 without warmup, so that the EMA
    lags the parameters), and a batch to predict."""
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, lr=1e-2, warmup=1))
    pcfg = tiny_test_config()
    pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, lr=1e-2, warmup=1))
    rng = np.random.default_rng(73)
    S_AX, F = 4, 64

    def batch():
        return {"pts_feat": rng.normal(size=(B, F)).astype(np.float32),
                "axes_training": rng.normal(size=(B, S_AX, 3, 3)).astype(np.float32),
                "gt_length": rng.uniform(0.05, 0.3, size=(B, 3)).astype(np.float32)}

    agent = JaxScaleAgent(jcfg, steps_per_epoch=SPE)
    state = agent.init_state(jax.random.PRNGKey(0), pts_dim=F)
    vs = randomize({"params": state.params}, 74)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          opt_state=agent.tx.init(vs["params"]))
    port = ScaleAgent(pcfg, pts_dim=F, device="cpu", steps_per_epoch=SPE)
    port.model.load_state_dict(scalenet_state_dict(vs))
    pstate = port.init_state()
    for i in range(3):
        b = batch()
        state, _ = agent.train_step(state, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(i))
        port.train_step(pstate, {k: _t(v) for k, v in b.items()})
    return {"agent": agent, "state": jax.device_get(state), "port": port, "pstate": pstate,
            "feat": rng.normal(size=(5, F)).astype(np.float32),
            "axes": rng.normal(size=(5, 3, 3)).astype(np.float32)}


@pytest.mark.parametrize("use_ema", [True, False])
def test_scale_predict_reads_the_ema_like_jax(trained_scale, use_ema):
    s = trained_scale
    # JAX's predict is jitted with only the agent static, so a use_ema other
    # than the default reaches its Python ``if`` as a tracer: call the
    # function under the jit
    want = np.asarray(JaxScaleAgent.predict.__wrapped__(
        s["agent"], s["state"], jnp.asarray(s["feat"]), jnp.asarray(s["axes"]), use_ema))
    live = _live(s["port"])
    got = s["port"].predict(_t(s["feat"]), _t(s["axes"]), state=s["pstate"], use_ema=use_ema)
    # the scale lengths' float32 bound (tests/test_torch_port_slice.py)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    other = s["port"].predict(_t(s["feat"]), _t(s["axes"]), state=s["pstate"],
                              use_ema=not use_ema)
    # three steps at lr 1e-2 leave the two settings far beyond that bound apart
    assert float((got - other).abs().max()) > 1e-2 * float(got.abs().max())
    # without a state the model's own (live) weights run, and they are back
    raw = s["port"].predict(_t(s["feat"]), _t(s["axes"]))
    assert torch.equal(raw, other if use_ema else got)
    assert all(torch.equal(v, live[k]) for k, v in _live(s["port"]).items())


def test_ema_weights_differ_and_come_back_after_an_error(trained):
    s = trained["score"]
    pbatch = _port_batch(s["batch"])
    port, pstate = s["port"], s["pstate"]
    live = _live(port)
    ema = port.extract_features(pbatch, state=pstate)[0]
    raw = port.extract_features(pbatch, state=pstate, use_ema=False)[0]
    # three steps leave the EMA well apart: far beyond the bounds above
    assert float((ema - raw).abs().max()) > 1e-2 * float(raw.abs().max())
    # without a state the model's own (live) weights run
    assert torch.equal(port.extract_features(pbatch)[0], raw)
    with pytest.raises(KeyError):
        port.extract_features({"roi_xs": pbatch["pts"]}, state=pstate)
    assert all(torch.equal(v, live[k]) for k, v in _live(port).items())


def test_trainer_reads_the_frozen_score_features_through_the_ema(trained, tmp_path):
    s = trained["score"]
    cfg = tiny_test_config()
    rng = np.random.default_rng(72)
    raw = dict(_port_batch(s["batch"]), axes_training=_t(rng.normal(size=(B, 4, 3, 3))),
               bbox_side_len=_t(rng.uniform(0.05, 0.3, size=(B, 3))))
    scale = Trainer(cfg, "scale", steps_per_epoch=SPE, frozen_score=(s["port"], s["pstate"]),
                    device="cpu", log_dir=str(tmp_path))
    scale.init(raw)
    fed = scale._prepare(raw)["pts_feat"]
    assert torch.equal(fed, s["port"].extract_features(raw, state=s["pstate"])[0])
    assert not torch.equal(fed, s["port"].extract_features(raw)[0])
