"""Data-parallel training of the port on the CPU: two ranks over gloo against
one process on the whole batch, and against the JAX package's step.

One group of two ranks (``parallel/launch.py``, the launcher of ``cli train
--data_parallel``) runs every rank-side check once; the tests read its
results. Rank bodies live in this module, which imports no JAX at its top:
``spawn`` imports it again in each rank. JAX runs in the test process only.

- meshes (2, 1) and (1, 2), ``shard_batch``, ``shard_stacked_batch``,
  ``shard_candidates``, ``host_local_slice``, and ``replicate`` turning each
  rank's own initialisation into rank 0's;
- one ``batch_norm`` layer's output, batch statistics and input gradient;
- score steps with explicit DSM draws at tiny_test_config and
  tiny_flagship_config (against one process and against JAX's
  ``train_step`` with the same draws), a step with the generator's own draws
  (input jitter and dropout on), an energy step with ranking candidates;
- ``Trainer.fit`` through ``cli.make_loader_fn``'s synthetic shards, rank 0
  alone writing, and a resume that repeats the run bit for bit;
- candidate-parallel energy ranking ((1, 2) and (2, 1) meshes, gathered);
- a one-rank group through torchrun's variables: bit for bit the mesh-less
  steps; ``python -m genpose2_tpu_torch.cli train --data_parallel 2``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genpose2_tpu_torch import cli
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.eval.aggregate import aggregate_candidates
from genpose2_tpu_torch.models.layers import batch_norm, batch_stats
from genpose2_tpu_torch.parallel.distributed import (host_local_slice, initialize_multihost,
                                                     rank, shutdown)
from genpose2_tpu_torch.parallel.launch import free_port, launch
from genpose2_tpu_torch.parallel.mesh import (Mesh, gather_candidates, make_mesh, replicate,
                                              shard_batch, shard_candidates,
                                              shard_stacked_batch, use_mesh)
from genpose2_tpu_torch.training.agent import PoseAgent
from genpose2_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, K, SPE, RANKS = 4, 128, 3, 4, 2


def _no_dropout(cfg):
    pn2 = dataclasses.replace(cfg.model.pointnet2, dropout=0.0, input_jitter=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, pointnet2=pn2))


def _synthetic(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, source="synthetic"))


def _batch(cfg, seed, ranking=False):
    """A global batch of B objects as tensors: clouds, poses, pixels with
    dino='pointwise', candidates and their errors with ``ranking``."""
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
    return {k: torch.from_numpy(v if v.dtype == np.int32 else v.astype(np.float32))
            for k, v in b.items()}


def _agent(cfg, agent_type, seed, sd=None, vit_sd=None):
    torch.manual_seed(seed)  # the modules' own initialisation
    agent = PoseAgent(cfg, agent_type, device="cpu", steps_per_epoch=SPE)
    if sd is not None:
        agent.model.load_state_dict(sd)
    if vit_sd is not None:
        agent.provider.vit.load_state_dict(vit_sd)
    return agent


def _backbone(agent):
    return None if agent.provider is None else agent.provider.vit


def _numpy(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _state_tensors(st):
    return [*st.params.values(), *st.buffers.values(), *st.ema_params.values(),
            *st.opt_state["mu"], *st.opt_state["nu"]]


def _checksum(st, model):
    tensors = _state_tensors(st) + list(model.state_dict().values())
    return float(sum(t.detach().double().abs().sum() for t in tensors)) + st.step


def _ema_checksum(st):
    return float(sum(p.double().abs().sum() for p in st.ema_params.values()))


def _step(agent, batch, seed, draws):
    """loss_and_grads (gradients averaged under a mesh) then train_step, each
    with a fresh generator of ``seed``: (averaged gradients, train_step's
    state and metrics)."""
    state = agent.init_state()
    loss, m, grads, _ = agent.loss_and_grads(state, batch, torch.Generator().manual_seed(seed),
                                             draws)
    _, _, grads = agent.data_parallel_mean(state, loss, m, grads.values())
    grads = {k: torch.zeros_like(p) if g is None else g  # the ImgEncoder's
             for (k, p), g in zip(state.params.items(), grads)}
    state, m = agent.train_step(state, batch, torch.Generator().manual_seed(seed), draws)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": _numpy(grads), "params": _numpy(state.params),
            "buffers": _numpy(state.buffers), "ema": _numpy(state.ema_params)}


def _local_draws(draws, mesh):
    """This rank's rows of global draws: t and z along axis 1, rank_t's
    object-major rows along axis 0."""
    if draws is None:
        return None
    i, n = mesh.data_index, mesh.data
    out = {}
    for k, v in draws.items():
        if k == "rank_t":
            rows = v.shape[0] // n
            out[k] = v[i * rows:(i + 1) * rows]
        else:
            cols = v.shape[1] // n
            out[k] = v[:, i * cols:(i + 1) * cols]
    return out


# ------------------------------------------------------------ rank bodies
def _fit_run(cfg, log_dir, seed, mesh=None, epochs=2, resume=None):
    torch.manual_seed(seed)
    tr = Trainer(cfg, "score", steps_per_epoch=SPE, device=None if mesh else "cpu",
                 log_dir=log_dir, resume_from=resume, mesh=mesh)
    tr.init()
    loader = cli.make_loader_fn(cfg, "train", "score", device="cpu")
    tr.fit(lambda e: loader(e, SPE), epochs=epochs)
    return tr


def _cand_rank(agent, batch, poses, mesh):
    """Energies of this rank's candidate block, gathered, and the aggregate."""
    local = shard_candidates(poses, mesh)
    energy = gather_candidates(agent.get_energy(shard_batch(batch, mesh), local, fixed_t=1e-5),
                               mesh)
    agg = aggregate_candidates(gather_candidates(local, mesh), energy, retain_ratio=0.4,
                               clustering=True, eps=0.05, minpts_ratio=1.0 / 6.0)
    return energy, agg["rotation"], agg["translation"]


def _rank_checks(payload: dict) -> dict:
    """Every rank-side check of the group; returns CPU values."""
    torch.set_num_threads(1)  # two ranks' thread pools side by side slow both
    r = rank()
    out = {}
    meshes = {"default": make_mesh(device="cpu"), "2x1": make_mesh(2, 1, "cpu"),
              "1x2": make_mesh(1, 2, "cpu")}
    out["meshes"] = {k: (m.data, m.cand, m.data_index, m.cand_index) for k, m in meshes.items()}
    m21, m12 = meshes["2x1"], meshes["1x2"]

    sh = payload["shard"]
    out["shard"] = shard_batch({"x": sh["x"], "arr": sh["x"].numpy(), "names": sh["names"],
                                "layers": [sh["x"], sh["x"] * 2]}, m21)
    out["stacked"] = shard_stacked_batch({"s": sh["s"]}, m21)["s"]
    out["cand_block"] = {k: shard_candidates(sh["c"], m) for k, m in (("2x1", m21),
                                                                       ("1x2", m12))}
    out["host_slice"] = host_local_slice(8)

    # replicate: each rank initialises its own agent, then takes rank 0's
    agent = _agent(tiny_test_config(), "score", 100 + r)
    state = agent.init_state()
    state.step, state.ema_updates = 3 + r, 1.5 * r
    before = _checksum(state, agent.model)
    replicate([state, agent.model], m21)
    out["replicate"] = (before, _checksum(state, agent.model), state.step, state.ema_updates)

    # one BatchNorm layer: output, statistics and input gradient
    bn = payload["bn"]
    module = torch.nn.BatchNorm2d(bn["x"].shape[-1])
    module.load_state_dict(bn["module"])
    rows = slice(r * B // RANKS, (r + 1) * B // RANKS)
    x = bn["x"][rows].clone().requires_grad_()
    with use_mesh(m21), batch_stats() as st:
        y = batch_norm(x, module, True)
    (y * bn["w"][rows]).sum().backward()
    out["bn"] = {"y": y.detach(), "grad": x.grad, "stats": st[module]}

    # training steps
    out["steps"] = {}
    for name, case in payload["steps"].items():
        agent = _agent(case["cfg"], case["type"], 200 + r)  # replaced by rank 0's
        if r == 0:
            agent.model.load_state_dict(case["sd"])
            if case["vit"] is not None:
                agent.provider.vit.load_state_dict(case["vit"])
        replicate([agent.model, _backbone(agent)], m21)
        with use_mesh(m21):
            out["steps"][name] = _step(agent, shard_batch(case["batch"], m21), case["seed"],
                                       _local_draws(case["draws"], m21))

    # Trainer.fit through the CLI's synthetic shards, and a resume
    fit = payload["fit"]
    whole = _fit_run(fit["cfg"], fit["whole"], 300 + r, m21)
    _fit_run(fit["cfg"], fit["first"], 300 + r, m21, epochs=1)
    resumed = _fit_run(fit["cfg"], fit["resumed"], 400 + r, m21,
                       resume=os.path.join(fit["first"], "ckpt", "final"))
    same = all(torch.equal(a, b) for a, b in zip(_state_tensors(resumed.state),
                                                  _state_tensors(whole.state)))
    out["fit"] = {"loss": float(whole.last_metrics["loss"]), "ema": _ema_checksum(whole.state),
                  "step": whole.state.step, "resume_equal": same,
                  "resume_step": resumed.state.step}

    # candidate-parallel energy ranking
    c = payload["cand"]
    agent = _agent(tiny_test_config(), "energy", 500 + r)
    if r == 0:
        agent.model.load_state_dict(c["sd"])
    replicate([agent.model], m21)
    out["cand"] = {k: _cand_rank(agent, c["batch"], c["poses"], m)
                   for k, m in (("1x2", m12), ("2x1", m21))}
    return out


# --------------------------------------------------------- JAX references
def _jax_draws(cfg, key, ranking=False):
    """The JAX step's DSM draws and ranking times, from its key
    (genpose2_tpu/training/agent.py:407,485, diffusion/losses.py:39-44)."""
    import jax
    import jax.numpy as jnp

    _, _, k_loss, k_rank = jax.random.split(key, 4)
    keys = jax.random.split(k_loss, cfg.train.repeat_num)
    ts, zs = [], []
    for k in keys:
        kt, kz = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(kt, (B, 1), jnp.float32, 1e-5, 1.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, 9), jnp.float32)))
    d = {"t": torch.from_numpy(np.stack(ts)), "z": torch.from_numpy(np.stack(zs))}
    if ranking:
        d["rank_t"] = torch.from_numpy(np.asarray(
            jax.random.uniform(k_rank, (B * K, 1), jnp.float32, 1e-5, 1e-4)))
    return d


def _jax_case(jcfg, pcfg, seed):
    """One JAX train_step from randomised variables: the port's state dicts
    of those variables, the batch, the JAX step's draws, and its loss,
    gradient norm and gradients (read through an identity transform chained
    before its optimizer)."""
    import jax
    import jax.numpy as jnp
    import optax

    from genpose2_tpu.models.provider import PROVIDER_KEY
    from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
    from genpose2_tpu_torch.weights import dinov3_state_dict, posenet_state_dict

    batch = _batch(pcfg, seed)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    agent = JaxPoseAgent(jcfg, "score", steps_per_epoch=SPE)
    capture = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                           lambda u, s, p=None: (u, u))
    agent.tx = optax.chain(capture, agent.tx)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    rng = np.random.default_rng(seed)

    def randomize(path, x):
        x, key = np.asarray(x, np.float32), path[-1].key
        if key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key in ("W", "rope_periods"):
            return x
        return (x + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)

    vs = jax.tree_util.tree_map_with_path(randomize, jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats, "constants": state.constants}))
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"],
                          opt_state=agent.tx.init(vs["params"]))
    key = jax.random.PRNGKey(100 + seed)
    new, metrics = jax.device_get(agent.train_step(state, jbatch, key))
    consts = {k: v for k, v in vs["constants"].items() if k != PROVIDER_KEY}
    grads = posenet_state_dict({"params": new.opt_state[0], "batch_stats": new.batch_stats,
                                "constants": consts}, pcfg.model)
    vit = (dinov3_state_dict(vs["constants"][PROVIDER_KEY])
           if PROVIDER_KEY in vs["constants"] else None)
    case = {"cfg": pcfg, "type": "score", "sd": posenet_state_dict(vs, pcfg.model), "vit": vit,
            "batch": batch, "draws": _jax_draws(jcfg, key), "seed": seed}
    want = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "grads": {k: v.numpy() for k, v in grads.items()}}
    return case, want


def _port_case(cfg, agent_type, seed, ranking=False):
    """A step of the port's own initialisation with the generator's draws."""
    agent = _agent(cfg, agent_type, 1000 + seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in agent.model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return {"cfg": cfg, "type": agent_type, "sd": agent.model.state_dict(),
            "vit": None if agent.provider is None else agent.provider.vit.state_dict(),
            "batch": _batch(cfg, seed, ranking), "draws": None, "seed": seed}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The JAX references, the one-process references, and the 2-rank group's
    results."""
    from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
    from genpose2_tpu.config import tiny_test_config as jax_tiny_config

    d = tmp_path_factory.mktemp("parallel")
    cases, jax_want = {}, {}
    cases["score_none"], jax_want["score_none"] = _jax_case(
        _no_dropout(jax_tiny_config()), _no_dropout(tiny_test_config()), 1)
    cases["score_flagship"], jax_want["score_flagship"] = _jax_case(
        _no_dropout(jax_flagship_config()), _no_dropout(tiny_flagship_config()), 2)
    # the generator's own draws: input jitter and dropout on
    cases["flagship_generator"] = _port_case(tiny_flagship_config(), "score", 3)
    cases["energy_ranking"] = _port_case(tiny_test_config(), "energy", 4, ranking=True)
    rng = np.random.default_rng(5)
    x = torch.arange(24.0).reshape(8, 3)
    bn_module = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn_module.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn_module.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
    cand_case = _port_case(tiny_test_config(), "energy", 6)
    payload = {
        "shard": {"x": x, "names": [f"obj{i}" for i in range(8)],
                  "s": torch.arange(48.0).reshape(2, 8, 3),
                  "c": torch.arange(B * 4 * 2.0).reshape(B, 4, 2)},
        "bn": {"x": torch.from_numpy(rng.normal(size=(B, 5, 6)).astype(np.float32) * 2 + 1),
               "w": torch.from_numpy(rng.normal(size=(B, 5, 6)).astype(np.float32)),
               "module": bn_module.state_dict()},
        "steps": cases,
        "fit": {"cfg": _synthetic(tiny_test_config()), "whole": str(d / "whole"),
                "first": str(d / "first"), "resumed": str(d / "resumed")},
        "cand": {"sd": cand_case["sd"], "batch": cand_case["batch"],
                 "poses": torch.from_numpy(rng.normal(size=(B, 4, 9)).astype(np.float32) * 0.5)},
    }
    ranks = launch(_rank_checks, RANKS, (payload,), device="cpu", timeout_s=400)

    # one process on the whole batch
    one = {"steps": {}}
    for name, case in cases.items():
        agent = _agent(case["cfg"], case["type"], 200, case["sd"], case["vit"])
        one["steps"][name] = _step(agent, case["batch"], case["seed"], case["draws"])
    whole = _fit_run(_synthetic(tiny_test_config()), str(d / "one"), 300)
    one["fit"] = {"loss": float(whole.last_metrics["loss"]), "ema": _ema_checksum(whole.state),
                  "step": whole.state.step}
    x = payload["bn"]["x"].clone().requires_grad_()
    with batch_stats() as st:
        y = batch_norm(x, bn_module, True)
    (y * payload["bn"]["w"]).sum().backward()
    one["bn"] = {"y": y.detach(), "grad": x.grad, "stats": st[bn_module]}
    agent = _agent(tiny_test_config(), "energy", 500, cand_case["sd"])
    energy = agent.get_energy(cand_case["batch"], payload["cand"]["poses"], fixed_t=1e-5)
    agg = aggregate_candidates(payload["cand"]["poses"], energy, retain_ratio=0.4,
                               clustering=True, eps=0.05, minpts_ratio=1.0 / 6.0)
    one["cand"] = (energy, agg["rotation"], agg["translation"])
    return {"ranks": ranks, "one": one, "jax": jax_want, "payload": payload, "dir": d}


def test_meshes_and_shards(group):
    p = group["payload"]["shard"]
    for r, got in enumerate(group["ranks"]):
        assert got["meshes"] == {"default": (2, 1, r, 0), "2x1": (2, 1, r, 0),
                                 "1x2": (1, 2, 0, r)}
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(got["shard"]["x"], p["x"][rows])
        assert torch.equal(got["shard"]["arr"], p["x"][rows])  # numpy -> tensor
        assert got["shard"]["names"] == p["names"][rows]
        assert torch.equal(got["shard"]["layers"][1], p["x"][rows] * 2)
        assert torch.equal(got["stacked"], p["s"][:, rows])
        assert torch.equal(got["cand_block"]["2x1"], p["c"][2 * r:2 * r + 2])
        assert torch.equal(got["cand_block"]["1x2"], p["c"][:, 2 * r:2 * r + 2])
        assert got["host_slice"] == rows
    with pytest.raises(ValueError, match="split"):
        shard_batch({"x": torch.zeros(3, 2)}, Mesh(2, 1, 0, 0, torch.device("cpu")))


def test_replicate_takes_rank_0s_state(group):
    (b0, a0, s0, e0), (b1, a1, s1, e1) = (g["replicate"] for g in group["ranks"])
    assert b0 != b1  # two initialisations
    assert a0 == a1 == b0 and s0 == s1 == 3 and e0 == e1 == 0.0


def test_batch_norm_forward_and_input_gradient(group):
    one = group["one"]["bn"]
    for r, got in enumerate(group["ranks"]):
        rows = slice(r * B // RANKS, (r + 1) * B // RANKS)
        # float32: the global moments as the mean of the two ranks' means
        np.testing.assert_allclose(got["bn"]["y"], one["y"][rows], rtol=0, atol=2e-6)
        np.testing.assert_allclose(got["bn"]["grad"], one["grad"][rows], rtol=0, atol=2e-6)
        for a, b in zip(got["bn"]["stats"], one["stats"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _rel(got, want):
    """max |got - want| over max |want|, over a dict of arrays."""
    diff = max(float(np.abs(np.asarray(got[k]) - want[k]).max()) for k in want)
    return diff / max(max(float(np.abs(w).max()) for w in want.values()), 1e-30)


STEPS = ["score_none", "score_flagship", "flagship_generator", "energy_ranking"]


@pytest.mark.parametrize("name", STEPS)
def test_two_ranks_step_equals_one_process(group, name):
    one = group["one"]["steps"][name]
    for got in (g["steps"][name] for g in group["ranks"]):
        # the JAX sharded step's bounds (tests/test_parallel.py:46-49): loss
        # 1e-4; parameters, BatchNorm statistics and EMA 2e-5 (Adam moves an
        # entry by up to lr = 1e-5 here whatever its gradient's size)
        assert abs(got["loss"] - one["loss"]) < 1e-4
        for key in ("params", "buffers", "ema"):
            for k, v in got[key].items():
                np.testing.assert_allclose(v, one[key][k], rtol=0, atol=2e-5, err_msg=k)
        # the averaged gradients: float32 reduction order in the split
        # BatchNorm sums and the mean over ranks
        assert _rel(got["grads"], one["grads"]) <= 2e-5
        assert abs(got["grad_norm"] - one["grad_norm"]) <= 1e-5 * one["grad_norm"]
    # every rank applied the same update
    a, b = (g["steps"][name] for g in group["ranks"])
    assert all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])


@pytest.mark.parametrize("name", ["score_none", "score_flagship"])
def test_two_ranks_step_equals_jax(group, name):
    want = group["jax"][name]
    got = group["ranks"][0]["steps"][name]
    # tests/test_torch_port_train_step.py's tolerances
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    assert _rel(got["grads"], {k: want["grads"][k] for k in got["grads"]}) <= 5e-4


def test_fit_equals_one_process_and_resumes_bit_for_bit(group):
    one, d = group["one"]["fit"], group["dir"]
    for got in (g["fit"] for g in group["ranks"]):
        assert got["step"] == one["step"] == 2 * SPE
        # the JAX multi-host test's bounds (tests/test_parallel.py:245-256)
        assert abs(got["loss"] - one["loss"]) < 1e-4
        assert abs(got["ema"] - one["ema"]) <= 1e-5 * one["ema"]
        assert got["resume_equal"] and got["resume_step"] == 2 * SPE
    # rank 0 alone wrote: one log, checkpoints and no temporary file
    for run in ("whole", "resumed"):
        assert sorted(os.listdir(d / run / "ckpt")) == ["epoch_2", "final"]
        with open(d / run / "score_metrics.jsonl") as f:
            epochs = [json.loads(line)["epoch"] for line in f if "epoch_time_s" in line]
        assert epochs == ([1, 2] if run == "whole" else [2])


@pytest.mark.parametrize("layout", ["1x2", "2x1"])
def test_candidate_parallel_energy_ranking(group, layout):
    energy, R, t = group["one"]["cand"]
    for got in (g["cand"][layout] for g in group["ranks"]):
        # float32 energies up to ~30 here: a rank's block of candidates
        # changes the products' row blocking, within 1e-6 of the largest
        np.testing.assert_allclose(got[0], energy, rtol=0,
                                   atol=1e-6 * float(energy.abs().max()))
        # the aggregate: tests/test_parallel.py:85-87's bound
        np.testing.assert_allclose(got[1], R, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[2], t, rtol=0, atol=1e-5)


def _state_tensors_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_state_tensors(a), _state_tensors(b)))


def test_one_rank_group_equals_the_mesh_less_steps(monkeypatch, tmp_path):
    """initialize_multihost's torchrun path with one rank: the collectives run
    and change no bit (chip_smoke's parallel phase does this over NCCL)."""
    cfg = tiny_flagship_config()  # dropout and input jitter on
    batches = [_batch(cfg, 20 + i) for i in range(2)]
    ref = _agent(cfg, "score", 0)
    state = ref.init_state()
    g = torch.Generator().manual_seed(7)
    losses = [float(ref.train_step(state, b, g)[1]["loss"]) for b in batches]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                     RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    assert initialize_multihost(device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        torch.manual_seed(0)
        tr = Trainer(cfg, "score", SPE, log_dir=str(tmp_path), mesh=mesh)
        tr.init()
        g_mesh = torch.Generator().manual_seed(7)
        got = [float(tr.train_epoch([b], g_mesh)["loss"]) for b in batches]
    finally:
        shutdown()
    assert got == losses
    assert _state_tensors_equal(tr.state, state)
    assert mesh.stats["gradients"]["count"] == 2 and mesh.stats["batch_norm"]["count"] > 0
    assert mesh.stats["batch_norm_backward"]["count"] == mesh.stats["batch_norm"]["count"]


def test_a_rank_without_local_rank_on_a_multi_gpu_host_raises(monkeypatch):
    """One rank a GPU: on a host of several GPUs a rank that does not know
    its LOCAL_RANK would take cuda:0 with every other rank, so it raises
    before it joins a group; on the CPU it needs none."""
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        initialize_multihost("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        initialize_multihost("127.0.0.1:1", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def test_python_m_cli_data_parallel_on_the_cpu(tmp_path):
    """``cli train --data_parallel 2 --device cpu`` (the real config at
    dino='none' and 512 points): two ranks over gloo, one checkpoint a save
    written by rank 0, the same EMA on both ranks."""
    out = subprocess.run(
        [sys.executable, "-m", "genpose2_tpu_torch.cli", "train", "--source", "synthetic",
         "--device", "cpu", "--data_parallel", "2", "--batch_size", "2", "--num_points", "512",
         "--n_epochs", "1", "--steps_per_epoch", "2", "--repeat_num", "1",
         "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=400,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["epoch_1", "final"]
    lines = [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
             if line.startswith("train_rank ")]
    assert sorted(x["rank"] for x in lines) == [0, 1]
    assert lines[0]["ema_checksum"] == lines[1]["ema_checksum"]
    assert all(x["step"] == 2 and np.isfinite(x["loss"]) for x in lines)
    assert out.stdout.count("backend gloo") == 2
