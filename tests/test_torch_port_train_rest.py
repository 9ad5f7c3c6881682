"""The rest of training against the JAX package on the CPU: ``edm_loss``,
the EDM decoder's train step, the dino='global' score step and
energy-with-ranking step, and the distilled score step; then the Trainer
on the distilled path.

As in tests/test_torch_port_train_step.py: both packages start from the same
weights (JAX variables randomised from a numpy seed, carried over by
genpose2_tpu_torch/weights.py) and see the same batch; dropout and input
jitter are 0; the loss's draws and the ranking times are the JAX step's own,
rebuilt from its key (genpose2_tpu/training/agent.py:294,407,485,
diffusion/losses.py:39-44,85-92) and given to the port as explicit arrays;
the JAX gradients are read out of the step through an identity transform
chained in front of its optimizer, and the port's update is fed them.
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
from genpose2_tpu.diffusion.losses import edm_loss as jax_edm_loss
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.diffusion.losses import edm_loss
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.training.trainer import Trainer
from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict

B, N, K, SPE = 2, 128, 3, 4


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


def _global(cfg):
    return _no_dropout(cfg.replace(model=dataclasses.replace(cfg.model, dino="global")))


def _edm(cfg):
    return cfg.replace(sde=dataclasses.replace(cfg.sde, mode="edm"))


def _batch(cfg, seed, ranking=False):
    rng = np.random.default_rng(seed)
    b = {"pts": rng.uniform(-0.3, 0.3, size=(B, N, 3)) + [0.0, 0.0, 0.8],
         "zero_mean_gt_pose": rng.normal(size=(B, 9)) * 0.5}
    if cfg.model.dino == "global":
        S = cfg.model.img_size
        b["roi_rgb"] = rng.normal(size=(B, S, S, 3))
        b["roi_center_dir"] = rng.normal(size=(B, 3))
    if ranking:
        b["candidate_poses"] = rng.normal(size=(B, K, 9)) * 0.5
        b["candidate_metrics"] = rng.uniform(size=(B, K, 2))
    return {k: v.astype(np.float32) for k, v in b.items()}


def _capture_grads():
    """An optax transform that passes the updates on and keeps them as its
    state: chained first, its state after a step is the step's gradients."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _loss_keys(cfg, key):
    _, _, k_loss, k_rank = jax.random.split(key, 4)
    R = cfg.train.repeat_num
    return (jax.random.split(k_loss, R) if R > 1 else [k_loss]), k_rank


def _dsm_draws(cfg, key, ranking=False):
    keys, k_rank = _loss_keys(cfg, key)
    ts, zs = [], []
    for k in keys:
        kt, kz = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(kt, (B, 1), jnp.float32, 1e-5, 1.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, 9), jnp.float32)))
    d = {"t": _t(np.stack(ts)), "z": _t(np.stack(zs))}
    if ranking:
        d["rank_t"] = _t(jax.random.uniform(k_rank, (B * K, 1), jnp.float32, 1e-5, 1e-4))
    return d


def _edm_draws(cfg, key):
    keys, _ = _loss_keys(cfg, key)
    zs, us = [], []
    for k in keys:
        kz, ks = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(kz, (B, 9), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(ks, (B, 1), jnp.float32)))
    return {"z": _t(np.stack(zs)), "u": _t(np.stack(us))}


def test_edm_loss_matches_jax():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(5, 9)).astype(np.float32)
    W = rng.normal(size=(9, 9)).astype(np.float32) * 0.3
    key, R = jax.random.PRNGKey(3), 4

    def jden(x, sigma):
        return jnp.tanh(x @ W) / (1.0 + sigma) + x * (sigma / (1.0 + sigma))

    def pden(x, sigma):
        return torch.tanh(x @ _t(W)) / (1.0 + sigma) + x * (sigma / (1.0 + sigma))

    want = float(jax_edm_loss(key, jden, jnp.asarray(gt), 0.002, 80.0, repeat=R))
    zs, us = [], []
    for k in jax.random.split(key, R):
        kz, ks = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(kz, gt.shape)))
        us.append(np.asarray(jax.random.uniform(ks, (5, 1))))
    got = float(edm_loss(pden, _t(gt), _t(np.stack(zs)), _t(np.stack(us)), 0.002, 80.0))
    # float32: log-sigma's scalars rounded once in float32 on the JAX side
    assert abs(got - want) <= 1e-5 * abs(want)


def _sd(vs, params, stats, cfg, use_decoder):
    consts = {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}
    return {k: v.numpy() for k, v in posenet_state_dict(
        {"params": params, "batch_stats": stats, "constants": consts}, cfg.model,
        use_decoder).items()}


def _jax_state(agent, jbatch, seed):
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    return state.replace(params=vs["params"], ema_params=vs["params"],
                         batch_stats=vs["batch_stats"], constants=vs["constants"],
                         opt_state=agent.tx.init(vs["params"])), vs


def _port_agent(pcfg, agent_type, vs, use_decoder=False):
    port = PoseAgent(pcfg, agent_type, device="cpu", steps_per_epoch=SPE)
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model, use_decoder))
    if port.provider is not None:
        port.provider.vit.load_state_dict(dinov3_state_dict(vs["constants"][PROVIDER_KEY]))
    return port


def _step(name):
    """One JAX step and the port's loss, gradients and update from the same
    weights, batch and draws."""
    jcfg, pcfg, agent_type, seed = {
        "edm": (_edm(jax_tiny_config()), _edm(tiny_test_config()), "score", 1),
        "global_score": (_global(jax_flagship_config()), _global(tiny_flagship_config()),
                         "score", 2),
        "global_energy_ranking": (_global(jax_flagship_config()),
                                  _global(tiny_flagship_config()), "energy", 3),
        "distilled": (jax_tiny_config(), tiny_test_config(), "score", 4),
    }[name]
    ranking = name == "global_energy_ranking"
    decoder = name == "edm"
    batch = _batch(pcfg, seed, ranking)
    jbatch = jax.tree.map(jnp.asarray, batch)
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=SPE)
    agent.tx = optax.chain(_capture_grads(), agent.tx)
    state, vs = _jax_state(agent, jbatch, seed)
    key = jax.random.PRNGKey(100 + seed)
    teacher = None
    if name == "distilled":
        tstate, tvs = _jax_state(agent, jbatch, seed + 50)
        new, metrics = agent.train_step_distilled(state, tstate, jbatch, key)
        teacher_agent = _port_agent(pcfg, "score", tvs)
        teacher = (teacher_agent, teacher_agent.init_state())
    else:
        new, metrics = agent.train_step(state, jbatch, key)
    new, metrics = jax.device_get((new, metrics))
    want = {"loss": float(metrics["loss"]), "metrics": set(metrics),
            "grads": _sd(vs, new.opt_state[0], new.batch_stats, pcfg, decoder),
            "params": _sd(vs, new.params, new.batch_stats, pcfg, decoder),
            "ema": _sd(vs, new.ema_params, new.batch_stats, pcfg, decoder),
            "ranking_loss": float(metrics.get("ranking_loss", np.nan))}

    port = _port_agent(pcfg, agent_type, vs, decoder)
    pstate = port.init_state()
    draws = _edm_draws(jcfg, key) if decoder else _dsm_draws(jcfg, key, ranking)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m, grads, bn_stats = port.loss_and_grads(pstate, pbatch, draws=draws,
                                                   teacher=teacher)
    got = {"loss": float(loss.detach()), "metrics": m, "grads": grads}
    port.apply_gradients(pstate, loss, [_t(want["grads"][k]) for k in pstate.params], bn_stats)
    got.update(state=pstate, buffers={k: v.numpy() for k, v in pstate.buffers.items()},
               params={k: v.detach().numpy() for k, v in pstate.params.items()},
               ema={k: v.numpy() for k, v in pstate.ema_params.items()})
    if name == "distilled":
        # the port's own distilled step: the JAX step's metric names
        fresh = _port_agent(pcfg, agent_type, vs)
        _, dm = fresh.train_step_distilled(fresh.init_state(), teacher, pbatch, draws=draws)
        got["distilled_metrics"] = dm
    return want, got


STEPS = ["edm", "global_score", "global_energy_ranking", "distilled"]


@pytest.fixture(scope="module")
def steps():
    return {name: _step(name) for name in STEPS}


def _rel(got, want):
    diff = max(float(np.abs(np.asarray(got[k]) - want[k]).max()) for k in want)
    return diff / max(max(float(np.abs(w).max()) for w in want.values()), 1e-30)


@pytest.mark.parametrize("name", STEPS)
def test_step_loss_matches_jax(steps, name):
    want, got = steps[name]
    # float32: the encoder's module forward and the loss in another
    # summation order (the energy score is a second derivative)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    if name == "global_energy_ranking":
        assert abs(float(got["metrics"]["ranking_loss"]) - want["ranking_loss"]) <= 1e-5
    if name == "edm":
        assert want["metrics"] == {"score_loss", "loss", "lr", "grad_norm"}
        assert set(got["metrics"]) == {"score_loss", "loss"}
    if name == "distilled":
        assert want["metrics"] == {"loss", "distill_loss"}
        dm = got["distilled_metrics"]
        assert set(dm) == want["metrics"]
        assert abs(float(dm["distill_loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])


@pytest.mark.parametrize("name", STEPS)
def test_step_grads_match_jax(steps, name):
    want, got = steps[name]
    grads = {k: (np.zeros_like(want["grads"][k]) if g is None else g.numpy())
             for k, g in got["grads"].items()}
    assert set(grads) <= set(want["grads"])
    if name.startswith("global"):
        # the heads' rgb rows (after [pts, t, pose]) take gradients
        m = tiny_flagship_config().model
        rgb_dim = m.dino_dim + m.global_embedding_dim
        w1 = [k for k in grads if k.endswith("0.weight") and "fusion_tail" in k]
        assert w1 and all(np.abs(grads[k][:, -rgb_dim:]).max() > 0 for k in w1)
    # within 5e-4 of the largest gradient entry: train-mode BatchNorm
    # gradients summed in another order (tests/test_torch_port_train_step.py)
    assert _rel(grads, {k: want["grads"][k] for k in grads}) <= 5e-4


@pytest.mark.parametrize("name", STEPS)
def test_step_state_matches_jax(steps, name):
    want, got = steps[name]
    for k, v in got["buffers"].items():
        np.testing.assert_allclose(v, want["params"][k], rtol=1e-5, atol=1e-6, err_msg=k)
    # parameters and EMA after the same gradients: the same float32 clip,
    # Adam and EMA operations, up to the global norm's summation order
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want["params"][k], rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["ema"][k], want["ema"][k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["state"].step == 1 and got["state"].opt_state["count"] == 1


def _randomized(cfg, seed):
    torch.manual_seed(seed)
    agent = PoseAgent(cfg, "score", device="cpu", steps_per_epoch=SPE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return agent


def test_trainer_distilled_epoch(tmp_path):
    """With cfg.train.distillation and a frozen_score pair, the Trainer's
    epoch is train_step_distilled per batch with that pair as the teacher:
    the same parameters as the steps taken by hand from the same start."""
    cfg = tiny_test_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, distillation=True))
    teacher_agent = _randomized(cfg, 1)
    teacher = (teacher_agent, teacher_agent.init_state())
    batches = [{k: torch.from_numpy(v) for k, v in _batch(cfg, 10 + i).items()}
               for i in range(3)]
    trainer = Trainer(cfg, "score", steps_per_epoch=SPE, frozen_score=teacher, device="cpu",
                      log_dir=str(tmp_path))
    trainer.agent = _randomized(cfg, 2)
    trainer.init()
    last = trainer.train_epoch(batches, torch.Generator().manual_seed(7))
    assert set(last) == {"loss", "distill_loss"} and np.isfinite(float(last["loss"]))
    by_hand = _randomized(cfg, 2)
    state = by_hand.init_state()
    g = torch.Generator().manual_seed(7)
    for b in batches:
        state, _ = by_hand.train_step_distilled(state, teacher, b, g)
    assert trainer.state.step == state.step == 3
    for k, p in trainer.state.params.items():
        assert torch.equal(p, state.params[k]), k
    with open(tmp_path / "score_metrics.jsonl") as f:
        assert "distill_loss" in f.read()
