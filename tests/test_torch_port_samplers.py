"""The port's samplers against the JAX package's: the SDEs (with 'edm' and
prior_logp), the adaptive RK45 solver, Euler and the trajectory of the
fixed grid, the predictor-corrector, the EDM decoder with its Heun sampler,
the exact likelihood, and ``sample_candidates`` / ``calc_likelihood`` per
method at tiny_test_config (tests/test_torch_port_samplers_flagship.py runs
the agents' tests again at tiny_flagship_config).

The same numpy inputs and weights go through both packages (JAX variables
randomised from a numpy seed, carried over by genpose2_tpu_torch/weights.py);
JAX's random draws are recomputed from its keys and handed to the port's
explicit-draw arguments, since the two frameworks' random numbers never
match. The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU. Tolerances are stated at each assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate

from genpose2_tpu.config import tiny_flagship_config as jax_flagship_config
from genpose2_tpu.config import tiny_test_config as jax_tiny_config
from genpose2_tpu.diffusion import edm_sampler as jax_edm_sampler
from genpose2_tpu.diffusion import init_sde as jax_init_sde
from genpose2_tpu.diffusion import ode_likelihood as jax_ode_likelihood
from genpose2_tpu.diffusion import ode_sampler as jax_ode_sampler
from genpose2_tpu.diffusion import pc_sampler as jax_pc_sampler
from genpose2_tpu.diffusion.samplers import _pf_ode_rhs as jax_pf_ode_rhs
from genpose2_tpu.diffusion.samplers import rk45_integrate as jax_rk45
from genpose2_tpu.eval.pipeline import SingleFrameEvaluator as JaxEvaluator
from genpose2_tpu.models.provider import PROVIDER_KEY
from genpose2_tpu.models.scorenet import PoseDecoderNet as JaxDecoder
from genpose2_tpu.models.scorenet import make_fast_score_fn as jax_fast_score_fn
from genpose2_tpu.so3.rotations import normalize_rotation as jax_normalize_rotation
from genpose2_tpu.training.agent import PoseAgent as JaxPoseAgent
from genpose2_tpu.training.agent import calc_likelihood as jax_calc_likelihood
from genpose2_tpu_torch.config import tiny_flagship_config, tiny_test_config
from genpose2_tpu_torch.diffusion import (SDE, edm_sampler, init_sde, ode_likelihood,
                                          ode_sampler, pc_sampler)
from genpose2_tpu_torch.diffusion.samplers import rk45_integrate
from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator
from genpose2_tpu_torch.models.scorenet import PoseDecoderNet, fast_score_weights
from genpose2_tpu_torch.ops.ode_rk4 import fast_score, pf_ode_rhs
from genpose2_tpu_torch.training.agent import PoseAgent, calc_likelihood
from genpose2_tpu_torch.weights import StateDict, _decoder_head, dinov3_state_dict
from genpose2_tpu_torch.weights import posenet_state_dict

B, K, T0 = 3, 8, 0.55
MODES = ("ve", "vp", "subvp", "edm")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def adaptive_bound(run, x, base):
    """The bound of an adaptive-solver result ``run(x)`` against the JAX
    package's: ``base`` plus sqrt(6 n) times the spread of run(x (1 +- 1e-6))
    about run(x), n the solver's iterations. The step sizes follow the error
    norm continuously, so float32 noise in any of the 6 n score evaluations
    moves the result as much as a 1e-6 move of the start does (at random
    weights by 1e-4 to 4e-3, several hundred times the move itself);
    independent noise at each evaluation adds up as a random walk."""
    stats = {}
    y = run(x, stats)
    spread = max(float((run(x * (1 + d), {}) - y).abs().max()) for d in (1e-6, -1e-6))
    return y, base + (6 * len(stats["err_norm"])) ** 0.5 * spread


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


def _edm(cfg):
    return cfg.replace(sde=dataclasses.replace(cfg.sde, mode="edm"))


def _agents(jcfg, pcfg, jbatch, agent_type, seed):
    """A JAX agent with randomised weights, its state, and the port's agent
    with the same weights."""
    agent = JaxPoseAgent(jcfg, agent_type, steps_per_epoch=4)
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(seed), jbatch)
    vs = randomize({"params": state.params, "batch_stats": state.batch_stats,
                    "constants": state.constants}, seed)
    state = state.replace(params=vs["params"], ema_params=vs["params"],
                          batch_stats=vs["batch_stats"], constants=vs["constants"])
    port = PoseAgent(pcfg, agent_type, device="cpu")
    port.model.load_state_dict(posenet_state_dict(vs, pcfg.model, use_decoder=agent.use_decoder))
    if port.provider is not None:
        port.provider.vit.load_state_dict(dinov3_state_dict(vs["constants"][PROVIDER_KEY]))
    return agent, state, port


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    m = cfg.model
    pts = rng.uniform(-0.3, 0.3, size=(B, m.num_points, 3)).astype(np.float32)
    arrays = {"pts": pts, "pts_center": pts.mean(axis=1)}
    if m.dino == "pointwise":
        arrays["roi_rgb"] = rng.normal(size=(B, m.img_size, m.img_size, 3)).astype(np.float32)
        arrays["roi_xs"] = rng.integers(0, m.img_size, (B, m.num_points)).astype(np.int32)
        arrays["roi_ys"] = rng.integers(0, m.img_size, (B, m.num_points)).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch["zero_mean_gt_pose"] = jnp.zeros((B, 9))
    return jbatch, {k: torch.from_numpy(v) for k, v in arrays.items()}


CONFIGS = {"tiny_test_config": (jax_tiny_config, tiny_test_config),
           "tiny_flagship_config": (jax_flagship_config, tiny_flagship_config)}


def make_agents(name):
    """Score, energy and decoder (sde 'edm') agents of both packages from the
    same weights, and a batch with the image features attached."""
    jcfg, pcfg = (f() for f in CONFIGS[name])
    jbatch, pbatch = _batches(pcfg, 0)
    out = {"name": name, "cfgs": (jcfg, pcfg)}
    for i, (name, kind, edm) in enumerate((("score", "score", False),
                                           ("energy", "energy", False),
                                           ("decoder", "score", True))):
        jc, pc = (_edm(jcfg), _edm(pcfg)) if edm else (jcfg, pcfg)
        agent, state, port = _agents(jc, pc, jbatch, kind, 20 + i)
        out[name] = (agent, state, port)
    agent, state, port = out["score"]
    out["jbatch"] = agent.with_image_features(state, jbatch)
    out["pbatch"] = port.with_image_features(pbatch)
    if "dino_layers" in out["pbatch"]:
        # both sides take JAX's ViT layers, so that the sampler's inputs agree
        out["pbatch"]["dino_layers"] = [_t(x) for x in out["jbatch"]["dino_layers"]]
    return out


@pytest.fixture(scope="module")
def agents():
    return make_agents("tiny_test_config")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The samplers run thousands of torch ops on tiny tensors: with torch's
    default thread pool beside other test processes they wait on each
    other's spinning threads (a likelihood 8x slower), so one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- SDE
@pytest.mark.parametrize("mode", MODES)
def test_sde_matches_jax(mode):
    jsde, psde = jax_init_sde(mode), init_sde(mode)
    assert (psde.eps, psde.T, psde.sigma_min, psde.sigma_max) == (
        jsde.eps, jsde.T, jsde.sigma_min, jsde.sigma_max)
    rng = np.random.default_rng(1)
    t = np.linspace(psde.eps, psde.T, 7).astype(np.float32)[:, None]
    x = rng.normal(size=(7, 9)).astype(np.float32)
    jmean, jstd = jsde.marginal_prob(jnp.asarray(x), jnp.asarray(t))
    pmean, pstd = psde.marginal_prob(_t(x), _t(t))
    pairs = [(pmean, jmean), (pstd, jstd), (psde.diffusion_coeff(_t(t)),
                                            jsde.diffusion_coeff(jnp.asarray(t))),
             (psde.drift(_t(x), _t(t)), jsde.drift(jnp.asarray(x), jnp.asarray(t))),
             (psde.prior_logp(_t(x) * 7.0), jsde.prior_logp(jnp.asarray(x) * 7.0))]
    for got, want in pairs:
        # float32 formulas of the same operations: 1e-6 of the value
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    # prior_sample scales N(0, 1) by the std at T (VE), sigma_max (EDM) or 1
    g = torch.Generator().manual_seed(2)
    z = torch.randn((5, 9), generator=torch.Generator().manual_seed(2))
    scale = {"ve": float(jsde.marginal_prob(None, jnp.asarray(0.25))[1]),
             "edm": jsde.sigma_max}.get(mode, 1.0)
    np.testing.assert_allclose(psde.prior_sample((5, 9), T=0.25, generator=g).numpy(),
                               z.numpy() * scale, rtol=1e-6)


# -------------------------------------------------------------------- RK45
@pytest.mark.parametrize("case", ["linear", "nonlinear"])
def test_rk45_matches_jax_and_scipy(case):
    """tests/test_diffusion.py's two ODEs through both solvers and scipy's
    RK45, within the JAX package's own bound against scipy (2e-4)."""
    if case == "linear":
        rng = np.random.default_rng(0)
        A = rng.normal(size=(6, 6)).astype(np.float32) * 0.8
        y0 = rng.normal(size=(2, 6)).astype(np.float32)
        span, tol = (1.0, 1e-5), 1e-5
        jf, pf = (lambda t, y: y @ A.T), (lambda t, y: y @ _t(A).T)

        def sf(t, y):
            return (y.reshape(2, 6) @ A.T).reshape(-1)
    else:
        y0 = np.linspace(-1.0, 1.5, 8).astype(np.float32).reshape(2, 4)
        span, tol = (0.0, 3.0), 1e-6

        def jf(t, y):
            return -jnp.sin(y) * (1.0 + t)

        def pf(t, y):
            return -torch.sin(y) * (1.0 + t)

        def sf(t, y):
            return -np.sin(y) * (1.0 + t)

    jy, jn = jax_rk45(jf, *span, jnp.asarray(y0), rtol=tol, atol=tol)
    py, pn = rk45_integrate(pf, *span, _t(y0), rtol=tol, atol=tol)
    ref = integrate.solve_ivp(sf, span, y0.reshape(-1), rtol=tol, atol=tol, method="RK45")
    assert int(pn) == int(jn)
    np.testing.assert_allclose(py.numpy(), _np(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(py.numpy().reshape(-1), ref.y[:, -1], rtol=2e-4, atol=2e-4)


def _score_fns(agents, name="score"):
    """Both packages' score closures of an agent over the batch's features
    repeated K times, and the repeated features."""
    agent, state, port = agents[name]
    jfeat, jrgb = agent.extract_features(state, agents["jbatch"])
    rep = (lambda a: None if a is None else jnp.repeat(a, K, axis=0))
    pfeat, prgb = (None if a is None else _t(a).repeat_interleave(K, 0) for a in (jfeat, jrgb))
    return agent.score_fn(state, rep(jfeat), rep(jrgb)), port.score_fn(pfeat, prgb)


@torch.no_grad()
def test_rk45_score_net_matches_jax(agents):
    """The probability-flow ODE of a score net from JAX's prior: the same
    number of steps, and y within 1e-5 of max |y| plus the adaptive solver's
    own spread (``adaptive_bound``). A step taken or rejected turns on
    err_norm < 1, so the test prints the error norm nearest 1: a
    summation-order difference can flip only a decision that close."""
    jcfg, pcfg = agents["cfgs"]
    jsfn, psfn = _score_fns(agents)
    jsde, psde = jax_init_sde(jcfg.sde), init_sde(pcfg.sde)
    x0 = jsde.prior_sample(jax.random.PRNGKey(3), (B * K, 9), T=T0)
    steps = jcfg.sampler.max_rk45_steps
    jy, jn = jax_rk45(lambda t, y: jax_pf_ode_rhs(jsfn, jsde, t, y), T0, jsde.eps, x0,
                      max_steps=steps)
    stats = {}
    py, pn = rk45_integrate(lambda t, y: pf_ode_rhs(psfn, psde, t, y), T0, psde.eps, _t(x0),
                            max_steps=steps, stats=stats)
    margin = min(abs(float(e) - 1.0) for e in stats["err_norm"][:int(pn)])
    print(f"{agents['name']}: {int(pn)} steps, smallest |err_norm - 1| {margin:.3e}")
    assert int(pn) == int(jn) and 0 < int(pn) < steps

    def run(x, st):
        return rk45_integrate(lambda t, y: pf_ode_rhs(psfn, psde, t, y), T0, psde.eps, x,
                              max_steps=steps, stats=st)[0]

    _, tol = adaptive_bound(run, _t(x0), 1e-5 * float(np.abs(jy).max()))
    np.testing.assert_allclose(py.numpy(), _np(jy), rtol=0, atol=tol)


def test_rk45_reads_done_every_few_steps():
    """Reading ``done`` every 8 steps and every step give the same y and
    nsteps (the steps after ``done`` change nothing); the host reads it about
    nsteps / 8 times."""
    mu = _t(np.linspace(-0.5, 0.5, 9))
    sde = init_sde("ve")

    def rhs(t, y):
        return pf_ode_rhs(lambda x, tt: -(x - mu) / sde.marginal_std(tt) ** 2, sde, t, y)

    x0 = sde.prior_sample((16, 9), T=T0, generator=torch.Generator().manual_seed(4))
    runs = {}
    for every in (1, 8):
        stats = {}
        y, n = rk45_integrate(rhs, T0, sde.eps, x0, check_every=every, stats=stats)
        runs[every] = (y, int(n), stats["host_reads"])
    (y1, n1, r1), (y8, n8, r8) = runs[1], runs[8]
    assert n1 == n8 and n1 > 8
    torch.testing.assert_close(y8, y1, rtol=0, atol=0)
    assert r1 == n1 + 1 and r8 == -(-n8 // 8) + 1


# ----------------------------------------------------- the other ODE methods
@torch.no_grad()
def test_ode_sampler_euler_and_trajectory_match_jax(agents):
    jcfg, pcfg = agents["cfgs"]
    jsfn, psfn = _score_fns(agents)
    jsde, psde = jax_init_sde(jcfg.sde), init_sde(pcfg.sde)
    key = jax.random.PRNGKey(5)
    prior = _t(jsde.prior_sample(key, (B * K, 9), T=T0))
    center = np.random.default_rng(5).normal(size=(B * K, 3)).astype(np.float32)
    for method, steps in (("euler", 20), ("fixed", 6)):
        traj = method == "fixed"
        want = jax_ode_sampler(key, jsfn, jsde, B * K, 9, T0=T0, num_steps=steps, method=method,
                               pts_center=jnp.asarray(center), return_trajectory=traj)
        got = ode_sampler(psfn, psde, B * K, 9, T0=T0, num_steps=steps, method=method,
                          pts_center=_t(center), return_trajectory=traj, prior=prior)
        if traj:
            assert tuple(got[1].shape) == (steps, B * K, 9)
        else:
            assert got[1] == int(want[1]) == steps
        for g, w in zip(got, want):
            # the fused RK4 kernel's bound against the scan after denoise,
            # renormalisation and the center re-add (tests/test_ode_fused.py:112)
            np.testing.assert_allclose(np.asarray(g), _np(w), rtol=1e-4, atol=5e-4,
                                       err_msg=method)


def _pc_draws(key, n, shape):
    """pc_sampler's draws from its key: the start and (n, 2, *shape) noises."""
    kp, kloop = jax.random.split(key)
    noise = [jnp.stack([jax.random.normal(k, shape) for k in jax.random.split(step)])
             for step in jax.random.split(kloop, n)]
    return kp, _t(jnp.stack(noise))


@torch.no_grad()
def test_pc_sampler_matches_jax(agents):
    jcfg, pcfg = agents["cfgs"]
    jsfn, psfn = _score_fns(agents)
    jsde, psde = jax_init_sde(jcfg.sde), init_sde(pcfg.sde)
    key, n = jax.random.PRNGKey(6), 12
    kp, noise = _pc_draws(key, n, (B * K, 9))
    want = jax_pc_sampler(key, jsfn, jsde, B * K, 9, num_steps=n)
    got = pc_sampler(psfn, psde, B * K, 9, num_steps=n, prior=_t(jsde.prior_sample(kp, (B * K, 9))),
                     noise=noise)
    # as the fixed grid's bound (tests/test_ode_fused.py:112): the Langevin
    # steps rescale by the batch's mean score norm, which float32 keeps alike
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=5e-4)


# --------------------------------------------------------------------- EDM
def test_edm_heun_matches_reference_loop():
    """tests/test_diffusion.py's step-exact Heun check, ported: the sampler
    against a numpy transcription of the reference's update equations, same
    latents, same deterministic denoiser (S_churn = 0)."""
    Bh, D, n, smin, smax, rho = 8, 9, 12, 0.002, 2.0, 7.0
    mu = np.linspace(-0.5, 0.5, D).astype(np.float32)
    latents = np.random.default_rng(11).normal(size=(Bh, D)).astype(np.float32)

    def denoiser_np(x, sigma):
        return np.tanh(x) / (1.0 + sigma) + mu * (sigma / (1.0 + sigma))

    def denoiser(x, sigma):
        return torch.tanh(x) / (1.0 + sigma) + _t(mu) * (sigma / (1.0 + sigma))

    got = edm_sampler(denoiser, Bh, D, num_steps=n, sigma_min=smin, sigma_max=smax, rho=rho,
                      latents=_t(latents)).numpy()
    i = np.arange(n)
    t = (smax ** (1 / rho) + i / (n - 1) * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
    t = np.concatenate([t, [0.0]]).astype(np.float32)
    x = latents * t[0]
    for s in range(n):
        tc, tn = np.float32(t[s]), np.float32(t[s + 1])
        d = (x - denoiser_np(x, tc)) / tc
        xn = x + (tn - tc) * d
        if s < n - 1:
            xn = x + (tn - tc) * (0.5 * d + (0.5 * ((xn - denoiser_np(xn, tn)) / tn)))
        x = xn.astype(np.float32)
    want_rot = _np(jax_normalize_rotation(jnp.asarray(x[:, :-3]), "rot_matrix"))
    # the JAX test's bound: late steps divide by sigma ~ 2e-3, amplifying
    # float32 rounding to ~1e-4; a wrong grid or step order errs at O(0.1)
    np.testing.assert_allclose(got[:, :-3], want_rot, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[:, -3:], x[:, -3:], rtol=0, atol=2e-3)


@torch.no_grad()
def test_decoder_and_uniform_t_score_match_jax():
    """PoseDecoderNet and fast_score(uniform_t=True) against JAX's modules
    with the same weights."""
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(6, 32)).astype(np.float32)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    sigma = np.full((6, 1), 0.37, np.float32)
    sde = init_sde("edm")
    for head in ("Rx_Ry_and_T", "RT"):
        jnet = JaxDecoder(lambda s: s, 9, head)
        params = randomize(jnet.init(jax.random.PRNGKey(7), jnp.asarray(feat), None,
                                     jnp.asarray(x), jnp.asarray(sigma)), 7)["params"]
        want = jnet.apply({"params": params}, jnp.asarray(feat), None, jnp.asarray(x),
                          jnp.asarray(sigma))
        net = PoseDecoderNet(sde.marginal_std, 9, head, 32)
        d = StateDict()
        _decoder_head(d, params, head, "")
        net.load_state_dict(d.sd)
        # float32 MLPs on the same inputs; sigma * out keeps the size of out
        np.testing.assert_allclose(net(_t(feat), _t(x), _t(sigma)).detach().numpy(), _np(want),
                                   rtol=1e-5, atol=1e-5, err_msg=head)
    with pytest.raises(NotImplementedError):
        PoseDecoderNet(sde.marginal_std, 9, "R_and_T", 32)

    jcfg, pcfg = jax_tiny_config(), tiny_test_config()
    jbatch, _ = _batches(pcfg, 1)
    agent, state, port = _agents(jcfg, pcfg, jbatch, "score", 8)
    v = agent._variables(state)
    ve = init_sde(pcfg.sde)
    t = np.full((6, 1), 0.3, np.float32)
    pts_feat = rng.normal(size=(6, 128)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jfn = jax_fast_score_fn(v["params"]["pose_net"], v["constants"]["pose_net"],
                                agent.marginal_std_fn, jnp.asarray(pts_feat),
                                uniform_t=True, compute_dtype=dtype)
        w = fast_score_weights(port.model.pose_score_net, _t(pts_feat))
        got = fast_score(w, _t(x), _t(t), ve.marginal_std, dtype, uniform_t=True)
        plain = fast_score(w, _t(x), _t(t), ve.marginal_std, dtype)
        want = _np(jfn(jnp.asarray(x), jnp.asarray(t)))
        # float32: summation order (the score divides by std(0.3) ~ 0.13);
        # bf16: flips of bf16 roundings of the products' operands
        tol = 1e-4 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                                   atol=tol * np.abs(want).max())


@torch.no_grad()
def test_edm_sampler_matches_jax(agents):
    """The decoder agent's Heun sampler through sample_candidates, with JAX's
    latents; and the warm-start refusals."""
    jcfg, pcfg = agents["cfgs"]
    agent, state, port = agents["decoder"]
    key, n = jax.random.PRNGKey(9), 8
    kl, _ = jax.random.split(key)
    want = agent.sample_candidates(state, agents["jbatch"], key, repeat_num=K, method="edm",
                                   num_steps=n)
    got = port.sample_candidates(agents["pbatch"], repeat_num=K, method="edm", num_steps=n,
                                 prior=_t(jax.random.normal(kl, (B * K, 9))))
    # the candidates' bound (tests/test_torch_port_slice.py); the chain starts
    # at sigma 80 and divides by sigma down to 2e-3, as the Heun check does
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=5e-4)
    for kw in ({"T0": 0.5}, {"init_x": torch.zeros(B, 9)}):
        with pytest.raises(ValueError, match="warm starts"):
            port.sample_candidates(agents["pbatch"], repeat_num=K, method="edm", **kw)
    # the decoder's score (D(x; sigma) - x) / sigma^2 drives the ODE too
    jsfn, psfn = _score_fns(agents, "decoder")
    x = jax.random.normal(jax.random.PRNGKey(10), (B * K, 9))
    t = jnp.full((B * K, 1), 1.5)
    np.testing.assert_allclose(psfn(_t(x), _t(t)).numpy(), _np(jsfn(x, t)), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ sample_candidates
@pytest.mark.parametrize("method", ["rk45", "pc", "energy"])
def test_sample_candidates_matches_jax(agents, method):
    """Each method through sample_candidates from the raw batch, JAX's draws
    handed over: 'rk45' (the default of both packages), 'pc' and the energy
    agent's rk45 (score = the energy's gradient)."""
    jcfg, pcfg = agents["cfgs"]
    agent, state, port = agents["energy" if method == "energy" else "score"]
    key = jax.random.PRNGKey(12)
    jsde = jax_init_sde(jcfg.sde)
    kw, pkw = {}, {"prior": _t(jsde.prior_sample(key, (B * K, 9), T=T0))}
    if method == "pc":
        kw = pkw = {"method": "pc", "num_steps": 12}
        kp, noise = _pc_draws(key, 12, (B * K, 9))
        pkw = dict(kw, prior=_t(jsde.prior_sample(kp, (B * K, 9))), noise=noise)
    want = agent.sample_candidates(state, agents["jbatch"], key, repeat_num=K, T0=T0, **kw)
    prior = pkw.pop("prior")

    def run(x, st):
        return port.sample_candidates(agents["pbatch"], repeat_num=K, T0=T0, prior=x, stats=st,
                                      **pkw)

    if method == "pc":
        got, tol = run(prior, {}), 5e-4
    else:
        got, tol = adaptive_bound(run, prior, 5e-4)
    assert tuple(got.shape) == (B, K, 9)
    # the candidates' bound (tests/test_torch_port_slice.py:123-162), for the
    # adaptive solver plus its own spread (adaptive_bound)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=tol)


def test_calc_likelihood_matches_jax(agents):
    """The likelihood (bits) of JAX's rk45 candidates with JAX's direction
    epsilon (PRNGKey(0), calc_likelihood's default); the solver reads done
    every few steps."""
    jcfg, pcfg = agents["cfgs"]
    agent, state, port = agents["score"]
    key = jax.random.PRNGKey(13)
    poses = agent.sample_candidates(state, agents["jbatch"], key, repeat_num=K, T0=T0)
    want = _np(jax_calc_likelihood(agent, state, agents["jbatch"], poses))
    eps = _t(jax.random.normal(jax.random.PRNGKey(0), (B * K, 9)))
    stats = {}
    got = calc_likelihood(port, agents["pbatch"], _t(poses), epsilon=eps, stats=stats)
    assert tuple(got.shape) == (B, K) and bool(torch.isfinite(got).all())
    assert stats["host_reads"] <= len(stats["err_norm"]) // 8 + 1

    def run(x, st):
        return calc_likelihood(port, agents["pbatch"], x, epsilon=eps, stats=st)

    # bits of a 9-d density, tens in size: 1e-4 of the value (float32
    # integration of the same steps) plus the adaptive solver's own spread
    _, tol = adaptive_bound(run, _t(poses), 1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_ode_likelihood_matches_jax():
    """ode_likelihood on the JAX package's analytic Gaussian score with its
    epsilon; points near the mode rank above far ones."""
    jsde, psde = jax_init_sde("ve"), init_sde("ve")
    mu = np.linspace(-0.2, 0.2, 4).astype(np.float32)
    x = np.concatenate([np.full((4, 4), 0.01), np.full((4, 4), 3.0)]).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jscore(xx, t):
        return -(xx - mu) / jsde.marginal_prob(None, t)[1] ** 2

    def pscore(xx, t):
        return -(xx - _t(mu)) / psde.marginal_std(t) ** 2

    jz, jll = jax_ode_likelihood(key, jscore, jsde, jnp.asarray(x))
    pz, pll = ode_likelihood(pscore, psde, _t(x), epsilon=_t(jax.random.normal(key, (8, 4))))
    np.testing.assert_allclose(pz.numpy(), _np(jz), rtol=1e-4, atol=1e-4)
    # bits, ~10 in size: float32 integration of the same steps
    np.testing.assert_allclose(pll.numpy(), _np(jll), rtol=1e-4, atol=1e-4)
    assert (pll[:4] > pll[4:]).all()


def test_sde_is_a_frozen_dataclass():
    sde = init_sde("edm")
    assert isinstance(sde, SDE) and sde.edm_like_sigma() == sde.sigma_max == 80.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        sde.eps = 0.1


# ---------------------------------------------------------- the evaluator
def test_evaluator_rk45_mode_matches_jax(agents):
    """SingleFrameEvaluator with cfg.sampler.mode 'rk45': the candidates of
    its score stage against the JAX evaluator's, from JAX's per-batch priors
    (the key folded by batch index)."""
    jcfg, pcfg = agents["cfgs"]
    agent, state, port = agents["score"]
    mode = dict(mode="rk45", sampling_steps=40)
    jcfg = jcfg.replace(sampler=dataclasses.replace(jcfg.sampler, **mode),
                        eval=dataclasses.replace(jcfg.eval, eval_repeat_num=K, T0=T0))
    pcfg = pcfg.replace(sampler=dataclasses.replace(pcfg.sampler, **mode),
                        eval=dataclasses.replace(pcfg.eval, eval_repeat_num=K, T0=T0))
    key = jax.random.PRNGKey(15)
    want = JaxEvaluator(jcfg, agent, state).inference_score([agents["jbatch"]], key)
    prior = _t(jax_init_sde(jcfg.sde).prior_sample(jax.random.fold_in(key, 0), (B * K, 9),
                                                   T=T0))
    evaluator = SingleFrameEvaluator(pcfg, port)
    assert evaluator.method == "rk45"
    got = evaluator.inference_score([agents["pbatch"]], priors=[prior])

    def run(x, st):
        return port.sample_candidates(agents["pbatch"], repeat_num=K, T0=T0, num_steps=40,
                                      prior=x, stats=st)

    # the candidates' bound (tests/test_torch_port_slice.py:123-162) plus
    # the adaptive solver's own spread (adaptive_bound)
    same, tol = adaptive_bound(run, prior, 5e-4)
    np.testing.assert_array_equal(got[0], same.numpy())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=tol)


def test_decoder_agent_refuses_to_train():
    """The decoder trains with edm_loss, not with the DSM loss (held against
    the JAX step in tests/test_torch_port_train_rest.py): its loss is
    edm_loss over the denoiser at the step's draws, and it still has no
    score head."""
    from genpose2_tpu_torch.diffusion.losses import edm_draws, edm_loss

    cfg = _edm(tiny_test_config())
    agent = PoseAgent(cfg, "score", device="cpu")
    assert agent.use_decoder
    pts = torch.rand(2, cfg.model.num_points, 3)
    gt = torch.randn(2, 9, generator=torch.Generator().manual_seed(0))
    batch = {"pts": pts, "zero_mean_gt_pose": gt}
    z, u = edm_draws(2, 9, cfg.train.repeat_num, torch.Generator().manual_seed(1))
    loss, metrics, grads, _ = agent.loss_and_grads(agent.init_state(), batch,
                                                   draws={"z": z, "u": u})
    assert set(metrics) == {"score_loss", "loss"} and bool(torch.isfinite(loss))
    # the same loss from the train-mode features through edm_loss by hand
    agent.model.train()
    with torch.no_grad():
        feat = agent.model.extract_pts_feature(pts, train=True)
    agent.model.eval()
    R = z.shape[0]
    feat_rep = feat[None].expand(R, *feat.shape).reshape(R * 2, -1)
    with torch.no_grad():
        want = edm_loss(lambda x, s: agent.model.denoise(feat_rep, x, s), gt, z, u,
                        cfg.sde.edm_sigma_min, cfg.sde.edm_sigma_max)
    torch.testing.assert_close(loss.detach(), want, rtol=1e-6, atol=0)
    assert any(g is not None and bool(g.abs().max() > 0) for g in grads.values())
    with pytest.raises(AssertionError):
        agent.model.score(torch.zeros(2, 128), torch.zeros(2, 9), torch.ones(2, 1))
