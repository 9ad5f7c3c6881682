"""The port's training ops and module forwards against the JAX package's, on
the CPU: ball query, SharedMLP, SetAbstractionMSG, PointNet2ClsMSG and
PointNet2ClsMSGFus in train mode (outputs, new BatchNorm statistics and the
gradients of a scalar), the DSM loss, the ranking loss, the EMA, the
learning-rate schedule and the clip + Adam / SGD updates.

Inputs are numpy arrays from a seed; JAX variables are randomised from a
numpy seed and carried over by genpose2_tpu_torch/weights.py. Dropout and
input jitter are 0 on both sides (the two packages draw different random
streams). Tolerances are stated at each assert.
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
from genpose2_tpu.diffusion.losses import dsm_loss as jax_dsm_loss
from genpose2_tpu.models.layers import SharedMLP as JaxSharedMLP
from genpose2_tpu.models.pointnet2 import PointNet2ClsMSG as JaxClsMSG
from genpose2_tpu.models.pointnet2 import PointNet2ClsMSGFus as JaxClsMSGFus
from genpose2_tpu.models.pointnet2 import SetAbstractionMSG as JaxSA
from genpose2_tpu.ops.ball_query import ball_query as jax_ball_query
from genpose2_tpu.ops.ball_query_pallas import ball_query_pallas
from genpose2_tpu.training.agent import make_lr_schedule as jax_lr_schedule
from genpose2_tpu.training.ema import ema_update as jax_ema_update
from genpose2_tpu.training.ranking import ranking_loss as jax_ranking_loss
from genpose2_tpu.training.ranking import sort_results as jax_sort_results
from genpose2_tpu_torch.config import PointNet2Config, tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.diffusion.losses import dsm_loss
from genpose2_tpu_torch.diffusion.sde import init_sde
from genpose2_tpu_torch.models.layers import SharedMLP, batch_stats, update_running_stats
from genpose2_tpu_torch.models.pointnet2 import (PointNet2ClsMSG, PointNet2ClsMSGFus,
                                                 SetAbstractionMSG)
from genpose2_tpu_torch.ops.ball_query import ball_query, ball_query_plain
from genpose2_tpu_torch.ops.grouping import group_points
from genpose2_tpu_torch.training.ema import ema_update
from genpose2_tpu_torch.training.optim import ClippedOptimizer, make_lr_schedule
from genpose2_tpu_torch.training.ranking import ranking_loss, sort_results
from genpose2_tpu_torch.weights import StateDict, _pointnet2_cls, _pointnet2_fus


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randomize(variables, seed, scale=0.1):
    """numpy copy of a variable tree with every leaf randomised (variances
    positive)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + rng.normal(0.0, scale, x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


# ------------------------------------------------------------------ ball query
def _ball_cases():
    rng = np.random.default_rng(0)
    far = rng.uniform(-0.5, 0.5, size=(2, 40, 3)).astype(np.float32)
    dense = rng.uniform(-0.05, 0.05, size=(2, 64, 3)).astype(np.float32)
    odd = rng.uniform(-0.3, 0.3, size=(3, 77, 3)).astype(np.float32)  # N not a multiple of 8
    return {
        # centroids 10 away: no hits, every slot 0
        "zero_hits": (far, np.full((2, 5, 3), 10.0, np.float32), 0.1, 8),
        "fewer_hits_than_nsample": (far, far[:, :12], 0.2, 16),
        "many_hits": (dense, dense[:, :20], 0.08, 8),
        "n_not_multiple_of_8": (odd, odd[:, 5:30], 0.15, 12),
    }


@pytest.mark.parametrize("case", list(_ball_cases()))
def test_ball_query_plain_matches_jax_exactly(case):
    xyz, new_xyz, radius, nsample = _ball_cases()[case]
    got = ball_query_plain(_t(xyz), _t(new_xyz), radius, nsample)
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], new_xyz.shape[1], nsample)
    # the Pallas kernel in interpret mode, as tests/test_ops.py:179-200 runs it,
    # and the XLA formulation the JAX package runs on the CPU
    want_pallas = np.asarray(ball_query_pallas(jnp.asarray(xyz), jnp.asarray(new_xyz), radius,
                                               nsample, 8))
    want_xla = np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(new_xyz), radius, nsample))
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(ball_query(_t(xyz), _t(new_xyz), radius, nsample).numpy(),
                                  want_xla)
    if case == "zero_hits":
        assert not got.any()


def test_group_points_backward_sums_every_slot():
    rng = np.random.default_rng(1)
    feats = _t(rng.normal(size=(2, 10, 3))).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 10, size=(2, 4, 5)).astype(np.int32))
    g = _t(rng.normal(size=(2, 4, 5, 3)))
    out = group_points(feats, idx)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  feats.detach().numpy()[np.arange(2)[:, None, None], idx.numpy()])
    out.backward(g)
    want = np.zeros((2, 10, 3), np.float32)
    np.add.at(want, (np.arange(2)[:, None, None], idx.numpy()), g.numpy())
    np.testing.assert_allclose(feats.grad.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ modules
def _run_jax(module, variables, args, weights):
    """Train-mode apply, jitted: (output, new batch_stats, grads of
    sum(out * weights) with respect to params and to the inputs)."""
    def f(params, *xs):
        out, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                *xs, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(1),
                                      "aug": jax.random.PRNGKey(2)})
        return jnp.sum(out.astype(jnp.float32) * weights), (out, mut["batch_stats"])

    argnums = tuple(range(len(args) + 1))
    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(f, argnums=argnums, has_aux=True))(
        variables["params"], *[jnp.asarray(a) for a in args])
    return jax.device_get((out, stats, grads))


_RUNNING = ("running_mean", "running_var")


def _module_runs(module, fill, jax_module, variables, args, weights, call,
                 input_grads: bool = True):
    """The same train-mode forward and backward through both packages, in
    the port's names: {"jax" | "port": {"out", "stats", "grads"}} (grads of
    the parameters, and with ``input_grads`` of the inputs as "input{i}")."""
    out, stats, grads = _run_jax(jax_module, variables, args, jnp.asarray(weights))
    d = StateDict()
    fill(d, variables["params"], variables["batch_stats"])
    module.load_state_dict(d.sd)
    ins = [_t(a).requires_grad_(input_grads) for a in args]
    with batch_stats() as bn_stats:
        got = call(module, *ins)
    (got.float() * _t(weights)).sum().backward()
    update_running_stats(bn_stats)
    want = StateDict()  # JAX's gradients in the parameter slots, its new statistics in the buffers'
    fill(want, grads[0], stats)
    named, state = dict(module.named_parameters()), module.state_dict()
    runs = {"jax": {"out": np.asarray(out, np.float32), "grads": {}, "stats": {}},
            "port": {"out": got.detach().float().numpy(), "grads": {}, "stats": {}}}
    for k, v in want.sd.items():
        if k.endswith(_RUNNING):
            runs["jax"]["stats"][k], runs["port"]["stats"][k] = v.numpy(), state[k].numpy()
        elif k in named:
            runs["jax"]["grads"][k], runs["port"]["grads"][k] = v.numpy(), named[k].grad.numpy()
    for i, (x, g) in enumerate(zip(ins, grads[1:])):
        if input_grads:
            runs["jax"]["grads"][f"input{i}"] = np.asarray(g)
            runs["port"]["grads"][f"input{i}"] = x.grad.numpy()
    return runs


def _shared_mlp(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    w = rng.normal(size=(2, 6, 5, 12)).astype(np.float32)
    jm = JaxSharedMLP((16, 12), dtype=DTYPES[dtype][0])
    vs = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)

    def fill(d, p, s):
        for j in range(2):
            d.conv_bn(p[f"Dense_{j}"]["kernel"], p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"],
                      f"layer{j}")

    return _module_runs(SharedMLP((7, 16, 12)), fill, jm, vs, (x,), w,
                        lambda m, xx: m(xx, True, DTYPES[dtype][1]))


SA_CFG = PointNet2Config(npoints=(24,), radii=((0.15, 0.3),), nsamples=((8, 16),),
                         mlps=(((8, 16), (8, 12, 16)),))


class _JaxSAFeatures:
    """A JAX SetAbstractionMSG that returns its features only."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, xyz, features, **kw):
        (_, out, _), mut = self.module.apply(variables, xyz, features, **kw)
        return out, mut


def _set_abstraction(dtype):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-0.3, 0.3, size=(2, 70, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 70, 5)).astype(np.float32)
    w = rng.normal(size=(2, 24, 32)).astype(np.float32)
    jm = JaxSA(24, SA_CFG.radii[0], SA_CFG.nsamples[0], SA_CFG.mlps[0], compute_dtype=dtype)
    vs = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats)), 5)

    def fill(d, p, s):
        sub = StateDict()
        _pointnet2_cls(sub, {"SetAbstractionMSG_0": p}, {"SetAbstractionMSG_0": s}, SA_CFG, "")
        d.sd.update({k[len("SA_modules.0."):]: v for k, v in sub.sd.items()})

    pm = SetAbstractionMSG(5, 24, SA_CFG.radii[0], SA_CFG.nsamples[0], SA_CFG.mlps[0])
    return _module_runs(pm, fill, _JaxSAFeatures(jm), vs, (xyz, feats), w,
                        lambda m, a, f: m(a, f, True, DTYPES[dtype][1])[1])


def _zero_dropout(cfg):
    pn2 = dataclasses.replace(cfg.model.pointnet2, dropout=0.0, input_jitter=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, pointnet2=pn2))


def _with_dtype(pn2, dtype):
    return dataclasses.replace(pn2, compute_dtype=dtype)


def _cls_msg(dtype):
    rng = np.random.default_rng(6)
    pc = rng.uniform(-0.3, 0.3, size=(2, 128, 3)).astype(np.float32)
    w = rng.normal(size=(2, 128)).astype(np.float32)
    pcfg = _with_dtype(tiny_test_config().model.pointnet2, dtype)
    jm = JaxClsMSG(_with_dtype(jax_tiny_config().model.pointnet2, dtype))
    vs = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(pc)), 7)
    return _module_runs(PointNet2ClsMSG(pcfg), lambda d, p, s: _pointnet2_cls(d, p, s, pcfg, ""),
                        jm, vs, (pc,), w, lambda m, x: m(x, True), input_grads=False)


def _cls_msg_fus(dtype):
    rng = np.random.default_rng(8)
    pc = np.concatenate([rng.uniform(-0.3, 0.3, size=(2, 128, 3)),
                         rng.normal(size=(2, 128, 48))], axis=-1).astype(np.float32)
    w = rng.normal(size=(2, 128)).astype(np.float32)
    pcfg = _with_dtype(_zero_dropout(tiny_flagship_config()).model.pointnet2, dtype)
    jm = JaxClsMSGFus(_with_dtype(_zero_dropout(jax_flagship_config()).model.pointnet2, dtype))
    vs = randomize(jm.init({"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1),
                            "dropout": jax.random.PRNGKey(2)}, jnp.asarray(pc)), 9)
    g = torch.Generator().manual_seed(0)
    return _module_runs(PointNet2ClsMSGFus(pcfg, 48),
                        lambda d, p, s: _pointnet2_fus(d, p, s, pcfg, ""), jm, vs, (pc,), w,
                        lambda m, x: m(x, True, g), input_grads=False)


DTYPES = {"float32": (None, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODULES = {"shared_mlp": _shared_mlp, "set_abstraction": _set_abstraction,
           "cls_msg": _cls_msg, "cls_msg_fus": _cls_msg_fus}
_RUNS = {}


def _runs(name, dtype):
    if (name, dtype) not in _RUNS:
        _RUNS[name, dtype] = MODULES[name](dtype)
    return _RUNS[name, dtype]


def _err(got, want):
    """max |got - want| over a dict of arrays, over the largest |want| (at least 1)."""
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    return diff / max(1.0, max(float(np.abs(w).max()) for w in want.values()))


def _l2(got, want):
    """||got - want|| / ||want|| over a dict of arrays flattened together."""
    keys = sorted(want)
    g = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    w = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODULES))
def test_module_train_forward_and_grads_match_jax(name, dtype):
    runs = _runs(name, dtype)
    jr, pr = runs["jax"], runs["port"]
    assert pr["out"].shape == jr["out"].shape
    assert set(pr["grads"]) == set(jr["grads"]) and len(jr["stats"]) > 0
    # outputs and new BatchNorm statistics, relative to the largest entry:
    # float32, the same math summed in another order through train-mode
    # BatchNorms (measured up to 1.7e-5); bf16, the same bf16 operands with
    # flips of single bf16 roundings carried through the later layers
    tol = 5e-5 if dtype == "float32" else 3e-2
    assert _err({"out": pr["out"]}, {"out": jr["out"]}) <= tol
    for k in jr["stats"]:
        assert _err({k: pr["stats"][k]}, {k: jr["stats"][k]}) <= tol, k
    if dtype == "float32":
        # every gradient within 5e-4 of the module's largest gradient entry:
        # batch-statistic gradients sum many terms that cancel (measured up
        # to 1.7e-4, SA stage 0's first BatchNorm of PointNet2ClsMSG)
        assert _err(pr["grads"], jr["grads"]) <= 5e-4
        return
    # bf16 gradients through train-mode BatchNorms at these tiny batch sizes
    # are dominated by bf16 rounding (a channel of small batch variance
    # multiplies its rounding by 1/std), and XLA's jit drops some float32 ->
    # bf16 -> float32 round trips that eager torch keeps. So the bounds are
    # set by JAX's own bf16 noise, its bf16 gradient's L2 distance from its
    # float32 one (relative to the float32 gradient's norm; 0.077 SharedMLP,
    # 0.37 SA, 0.075 PointNet2ClsMSG, 0.24 Fus):
    f32 = _runs(name, "float32")
    noise = _l2(jr["grads"], f32["jax"]["grads"])
    # the port's bf16 gradient lies within twice that noise of JAX's bf16
    # gradient (measured 0, 0.21, 0, 0.37: equal where no BatchNorm of a
    # grouped tensor rounds differently)
    assert _l2(pr["grads"], jr["grads"]) <= 2.0 * noise
    # and the port's bf16 setting computes in bf16: its gradient and output
    # move away from its own float32 ones by at least half as much as JAX's
    # do (measured 0.9-1.3x); a port that kept float32 would move by 0
    assert _l2(pr["grads"], f32["port"]["grads"]) >= 0.5 * noise
    out_noise = _err({"out": jr["out"]}, {"out": f32["jax"]["out"]})
    assert _err({"out": pr["out"]}, {"out": f32["port"]["out"]}) >= 0.5 * out_noise


# ------------------------------------------------------------------ loss, EMA, optimizer
@pytest.mark.parametrize("mode", ["ve", "vp"])
def test_dsm_loss_matches_jax(mode):
    B, D, R = 5, 9, 3
    rng = np.random.default_rng(10)
    gt = rng.normal(size=(B, D)).astype(np.float32)
    A = rng.normal(size=(D, D)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(11)
    jsde = jax_init_sde(mode)

    def jscore(x, t):
        return x @ A + t

    want = float(jax_dsm_loss(key, jscore, jnp.asarray(gt), jsde, R))
    # the draws of genpose2_tpu/diffusion/losses.py:39-44, one key per repeat
    ts, zs = [], []
    for k in jax.random.split(key, R):
        kt, kz = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(kt, (B, 1), jnp.float32, jsde.eps, 1.0)))
        zs.append(np.asarray(jax.random.normal(kz, (B, D), jnp.float32)))
    got = float(dsm_loss(lambda x, t: x @ _t(A) + t, _t(gt), init_sde(mode),
                         _t(np.stack(ts)), _t(np.stack(zs))))
    assert abs(got - want) <= 1e-6 * abs(want)  # float32 summation order


def test_ranking_loss_and_sort_results_match_jax():
    rng = np.random.default_rng(12)
    energy = rng.normal(size=(3, 6, 2)).astype(np.float32)
    metrics = rng.uniform(size=(3, 6, 2)).astype(np.float32)
    metrics[0, 2] = metrics[0, 4]  # a tie: the stable order keeps the lower index first
    want_sorted = np.asarray(jax_sort_results(jnp.asarray(energy), jnp.asarray(metrics)))
    got_sorted = sort_results(_t(energy), _t(metrics))
    np.testing.assert_array_equal(got_sorted.numpy(), want_sorted)  # a permutation: exact
    want, want_g = jax.value_and_grad(jax_ranking_loss)(jnp.asarray(want_sorted))
    e = _t(want_sorted).requires_grad_(True)
    got = ranking_loss(e)
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(13)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    jema, n = jax.tree.map(jnp.asarray, p0), jnp.asarray(0.0, jnp.float32)
    pema, pn = {k: _t(v) for k, v in p0.items()}, 0.0
    for step in range(4):
        new = {k: (v + rng.normal(size=v.shape)).astype(np.float32) for k, v in p0.items()}
        jema, n = jax_ema_update(jema, jax.tree.map(jnp.asarray, new), n, 0.999)
        pn = ema_update(pema, {k: _t(v) for k, v in new.items()}, pn, 0.999)
        assert pn == float(n)
        for k in p0:  # the same float32 operations
            np.testing.assert_allclose(pema[k].numpy(), np.asarray(jema[k]), rtol=1e-6, atol=1e-7)


def test_lr_schedule_matches_jax():
    cfg = tiny_test_config()
    want = jax_lr_schedule(jax_tiny_config(), 7)
    got = make_lr_schedule(cfg, 7)
    for step in (0, 1, 5, 50, 99, 100, 101, 700, 7000, 70000):
        # float32 throughout; decay ** epoch is a float32 pow of another
        # library, which may differ in the last bit
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-6 * w, step


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_clipped_optimizer_matches_optax(kind):
    rng = np.random.default_rng(14)
    cfg = jax_tiny_config()
    sched = jax_lr_schedule(cfg, 3)
    opt = {"adam": optax.adam(sched), "sgd": optax.sgd(sched, momentum=0.9)}[kind]
    tx = optax.chain(optax.clip_by_global_norm(cfg.train.grad_clip), opt)
    params = {"a": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    port = ClippedOptimizer(kind, make_lr_schedule(tiny_test_config(), 3), cfg.train.grad_clip)
    pp = [_t(params["a"]), _t(params["b"])]
    pstate = port.init(pp)
    # norms above the clip, one below it (the unclipped branch), one tiny
    for scale in (3.0, 0.05, 10.0, 1e-6, 1.0):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32) for k, v in params.items()}
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        port.step(pp, [_t(g["a"]), _t(g["b"])], pstate)
        # the same float32 operations, up to the global norm's summation
        # order: a few float32 steps of parameters of size ~1
        for got, k in zip(pp, ("a", "b")):
            np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
