# Frozen copy of genpose2_tpu_torch/diffusion/samplers.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Samplers of the reverse-time process (port of
genpose2_tpu/diffusion/samplers.py).

- ``ode_sampler``: the probability-flow ODE from T0 to sde.eps, by the
  adaptive Dormand-Prince solver (``method='rk45'``, the default), fixed-grid
  RK4 (``'fixed'``: one fused kernel launch with ``fused_weights``, else the
  per-step loop, which also records a trajectory) or Euler (``'euler'``);
- ``pc_sampler``: Langevin corrector + Euler-Maruyama predictor;
- ``edm_sampler``: Karras et al.'s Heun sampler on an EDM denoiser;
- ``ode_likelihood``: the Skilling-Hutchinson log-likelihood in bits.

``score_fn(x, t)`` takes x (B, D) and t (B, 1) and returns the score (B, D).
Every draw comes from a ``torch.Generator``, unless the caller hands the
draws over (``prior``, ``noise``, ``latents``, ``epsilon``). Everything but
the fused RK4 launch is plain torch: the JAX package has no Pallas kernel
for these samplers either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bench_port.reference_vit7b.diffusion.sde import SDE
from bench_port.reference_vit7b.ops.ode_rk4 import fused_rk4_integrate, pf_ode_rhs, rk4_fixed_grid
from bench_port.reference_vit7b.so3.rotations import normalize_rotation
from bench_port.reference_vit7b.utils.profiling import to_host

# Dormand-Prince 5(4), as scipy.integrate.RK45
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
# error weights, the FSAL stage k7 last
_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)
_SAFETY, _MIN_FACTOR, _MAX_FACTOR = 0.9, 0.2, 10.0


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


def _combine(y, h, coeffs, ks):
    """y + h * sum_i coeffs[i] * ks[i], zero coefficients skipped."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            acc = c * k if acc is None else acc + c * k
    return y + h * acc


def rk45_integrate(f: Callable, t0: float, t1: float, y0: torch.Tensor, rtol: float = 1e-5,
                   atol: float = 1e-5, max_steps: int = 2000, check_every: int = 8,
                   stats: Optional[dict] = None):
    """Integrate dy/dt = f(t, y) from t0 to t1 (either direction) by adaptive
    Dormand-Prince 5(4) with scipy.integrate.RK45's control: its initial-step
    heuristic, an RMS error norm over the whole state (so the step size is
    batch-global), safety 0.9, factors clamped to [0.2, 10], no growth right
    after a rejection, a step at the float32 minimum always accepted, and at
    most ``max_steps`` steps. ``f`` takes a 0-d float32 tensor t. Returns
    (y1, nsteps), nsteps a 0-d int32 tensor.

    Accept or reject, the next step and the ``done`` flag stay tensors on
    y0's device; the host reads ``done`` only every ``check_every`` steps,
    and a step after ``done`` changes nothing (t, y, f, h and nsteps kept by
    ``torch.where``), so the result equals a loop that stops at once.
    ``stats``, when given, receives ``nsteps``, ``host_reads`` and
    ``err_norm`` (the error norm of each iteration, a list of 0-d tensors;
    those past nsteps belong to the frozen steps)."""
    dev = y0.device
    f32 = torch.float32
    y0 = y0.to(f32)
    direction = 1.0 if t1 > t0 else -1.0
    t0_t = torch.tensor(t0, dtype=f32, device=dev)
    interval = torch.tensor(t1 - t0, dtype=f32, device=dev).abs()
    f0 = f(t0_t, y0)

    # scipy's _select_initial_step
    scale0 = atol + torch.abs(y0) * rtol
    d0, d1 = _rms_norm(y0 / scale0), _rms_norm(f0 / scale0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-30))
    f1 = f(t0_t + h0 * direction, y0 + h0 * direction * f0)
    d2 = _rms_norm((f1 - f0) / scale0) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / 6.0))
    h_abs = torch.minimum(torch.minimum(100 * h0, h1), interval)

    tiny = 10.0 * torch.finfo(f32).eps
    t, y, fy = t0_t, y0, f0
    rejected = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    nsteps = torch.zeros((), dtype=torch.int32, device=dev)
    reads, norms = 0, []
    for i in range(max_steps):
        if i % check_every == 0:
            reads += 1
            if bool(to_host(done)):
                break
        h_try = torch.minimum(h_abs, torch.abs(t1 - t))  # no overshoot
        h = h_try * direction
        ks = [fy]
        for s in range(1, 6):
            ks.append(f(t + _C[s] * h, _combine(y, h, _A[s], ks)))
        y_new = _combine(y, h, _B, ks)
        t_new = t + h
        ks.append(f(t_new, y_new))  # FSAL
        err = h * sum(c * k for c, k in zip(_E, ks) if c != 0.0)
        scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
        err_norm = _rms_norm(err / scale)

        grow = torch.clamp(_SAFETY * err_norm ** -0.2, max=_MAX_FACTOR)
        factor_acc = torch.where(err_norm == 0.0, _MAX_FACTOR, grow)
        factor_acc = torch.where(rejected, torch.clamp(factor_acc, max=1.0), factor_acc)
        factor_rej = torch.clamp(_SAFETY * err_norm ** -0.2, min=_MIN_FACTOR)
        min_step = tiny * torch.clamp(torch.abs(t), min=1e-3)
        # a step that cannot shrink further is taken (scipy would stop with an error)
        accept = (err_norm < 1.0) | (h_try <= min_step)
        h_next = torch.clamp(torch.where(accept, h_try * factor_acc, h_try * factor_rej),
                             min=min_step)
        t_out = torch.where(accept, t_new, t)
        y_out = torch.where(accept, y_new, y)
        f_out = torch.where(accept, ks[6], fy)
        reached = torch.abs(t_out - t0_t) >= interval - 1e-12
        # a step after done changes nothing
        t, y, fy = (torch.where(done, a, b) for a, b in ((t, t_out), (y, y_out), (fy, f_out)))
        h_abs = torch.where(done, h_abs, h_next)
        rejected = torch.where(done, rejected, ~accept)
        nsteps = nsteps + (~done).to(torch.int32)
        done = done | reached
        norms.append(err_norm)
    if stats is not None:
        stats["nsteps"] = nsteps
        stats["host_reads"] = reads
        stats["err_norm"] = norms
    return y, nsteps


def _finish(x: torch.Tensor, pose_mode: str, pts_center: Optional[torch.Tensor]):
    """Rotation renormalised, the point-cloud center re-added."""
    trans = x[..., -3:]
    if pts_center is not None:
        trans = trans + pts_center
    return torch.cat([normalize_rotation(x[..., :-3], pose_mode), trans], dim=-1)


def ode_sampler(
    score_fn: Callable,
    sde: SDE,
    batch_size: int,
    pose_dim: int,
    *,
    T0: Optional[float] = None,
    init_x: Optional[torch.Tensor] = None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    num_steps: Optional[int] = 500,
    denoise: bool = True,
    pose_mode: str = "rot_matrix",
    pts_center: Optional[torch.Tensor] = None,
    method: str = "rk45",
    max_steps: int = 2000,
    return_trajectory: bool = False,
    fused_weights: Optional[dict] = None,
    compute_dtype: str = "float32",
    prior: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    stats: Optional[dict] = None,
):
    """Integrate the reverse probability-flow ODE from T0 to sde.eps.

    ``prior`` (batch_size, pose_dim) is the start noise; when None it is drawn
    from ``sde.prior_sample`` with ``generator``. A given ``init_x`` (tracking
    warm start) has the prior noise added to it. Then the optional denoise
    step at eps (its step divides by ``num_steps`` whatever the method, as
    the JAX package's does), the Gram-Schmidt renormalisation of the
    rotation and the re-added point-cloud center. Returns (poses, nsteps),
    or with ``return_trajectory`` (method 'fixed' only, always the per-step
    loop) (poses, trajectory (num_steps, batch_size, pose_dim)) of the
    in-process poses renormalised and re-centred. ``stats`` goes to
    ``rk45_integrate``."""
    T0 = sde.T if T0 is None else T0
    eps = sde.eps
    n = 500 if num_steps is None else num_steps
    if prior is None:
        prior = sde.prior_sample((batch_size, pose_dim), T=T0, generator=generator, device=device)
    x0 = prior if init_x is None else init_x + prior

    def rhs(t, y):
        return pf_ode_rhs(score_fn, sde, t, y)

    traj = [] if return_trajectory and method == "fixed" else None
    if method == "rk45":
        x, nsteps = rk45_integrate(rhs, T0, eps, x0, rtol=rtol, atol=atol, max_steps=max_steps,
                                   stats=stats)
    elif method == "fixed" and fused_weights is not None and traj is None:
        x, nsteps = fused_rk4_integrate(x0, fused_weights, sde, T0, n, compute_dtype), n
    elif method == "fixed":
        x, nsteps = rk4_fixed_grid(rhs, x0, T0, eps, n, trajectory=traj), n
    elif method == "euler":
        ts = torch.linspace(T0, eps, n + 1, dtype=torch.float32, device=x0.device)
        x = x0
        for i in range(n):
            x = x + (ts[i + 1] - ts[i]) * rhs(ts[i], x)
        nsteps = n
    else:
        raise NotImplementedError(f"sampler method {method!r}")

    if denoise:
        # the reverse-diffusion predictor step at eps
        eps_t = torch.tensor(eps, dtype=torch.float32, device=x.device)
        g = sde.diffusion_coeff(eps_t)
        t_vec = eps_t.reshape(1, 1).expand(batch_size, 1)
        drift = sde.drift(x, eps_t) - (g * g) * score_fn(x, t_vec)
        x = x + drift * ((1.0 - eps) / (1000 if num_steps is None else num_steps))

    final = _finish(x, pose_mode, pts_center)
    if traj is not None:
        return final, _finish(torch.stack(traj), pose_mode,
                              None if pts_center is None else pts_center[None])
    return final, nsteps


def _mid_normalize(x: torch.Tensor, pose_mode: str) -> torch.Tensor:
    """The corrector's renormalisation: the quaternion scaled to unit length,
    Euler angles as they are, else (rot_matrix, euler_xyz_sx_cx) the first two
    3-vectors scaled to unit length each."""
    if pose_mode in ("quat_wxyz", "quat_xyzw"):
        return torch.cat([x[:, :4] / torch.linalg.norm(x[:, :4], dim=-1, keepdim=True),
                          x[:, 4:]], dim=-1)
    if pose_mode == "euler_xyz":
        return x
    a1 = x[:, :3] / torch.linalg.norm(x[:, :3], dim=-1, keepdim=True)
    a2 = x[:, 3:6] / torch.linalg.norm(x[:, 3:6], dim=-1, keepdim=True)
    return torch.cat([a1, a2, x[:, 6:]], dim=-1)


def pc_sampler(
    score_fn: Callable,
    sde: SDE,
    batch_size: int,
    pose_dim: int,
    *,
    num_steps: int = 500,
    snr: float = 0.16,
    init_x: Optional[torch.Tensor] = None,
    pose_mode: str = "rot_matrix",
    pts_center: Optional[torch.Tensor] = None,
    prior: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Langevin corrector, then an Euler-Maruyama predictor, with the rotation
    renormalised after each; from t = 1 (sde.T's prior; T0 plays no part)
    down to sde.eps in ``num_steps`` steps. Returns the last predictor mean,
    renormalised and re-centred.

    The start is ``init_x`` when given, else ``prior`` (a draw of
    ``sde.prior_sample`` when None). ``noise`` (num_steps, 2, B, D) holds each
    step's corrector and predictor draws; when None each step draws both with
    ``generator``. The corrector's step uses the mean over the batch of the
    score's norm, kept on the device."""
    if init_x is not None:
        x = init_x
    elif prior is not None:
        x = prior
    else:
        x = sde.prior_sample((batch_size, pose_dim), generator=generator, device=device)
    dev = x.device
    ts = torch.linspace(1.0, sde.eps, num_steps, dtype=torch.float32, device=dev)
    step_size = ts[0] - ts[1]
    noise_norm = float(pose_dim) ** 0.5
    mean_x = x
    for i in range(num_steps):
        t = ts[i]
        z = (noise[i].to(dev) if noise is not None
             else torch.randn((2, batch_size, pose_dim), generator=generator, device=dev))
        # corrector (Langevin MCMC)
        grad = score_fn(x, t.reshape(1, 1).expand(batch_size, 1))
        grad_norm = torch.mean(torch.linalg.norm(grad, dim=-1))
        langevin_eps = 2 * (snr * noise_norm / torch.clamp(grad_norm, min=1e-12)) ** 2
        x = x + langevin_eps * grad + torch.sqrt(2 * langevin_eps) * z[0]
        x = _mid_normalize(x, pose_mode)
        # predictor: Song et al.'s reverse-SDE step x + (g^2 s - f) dt, the
        # sign the JAX package chose (the reference's flipped sign diverges
        # for VE)
        g = sde.diffusion_coeff(t)
        mean_x = x + ((g * g) * grad - sde.drift(x, t)) * step_size
        x = mean_x + g * torch.sqrt(step_size) * z[1]
        x = torch.cat([normalize_rotation(x[..., :-3], pose_mode), x[..., -3:]], dim=-1)
    return _finish(mean_x, pose_mode, pts_center)


def edm_sampler(
    denoiser_fn: Callable,
    batch_size: int,
    pose_dim: int,
    *,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    s_churn: float = 0.0,
    s_noise: float = 1.0,
    pose_mode: str = "rot_matrix",
    pts_center: Optional[torch.Tensor] = None,
    latents: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Karras et al.'s Heun 2nd-order sampler; denoiser_fn(x, sigma (B, 1))
    returns the denoised x. The rho-spaced noise levels are computed in
    float32 as the JAX package does, with 0 appended; Heun's correction is
    skipped on the last step (t_next = 0). ``latents`` (B, D) N(0, 1) start
    the chain at latents * t_0; ``noise`` (num_steps, B, D) are the churn
    draws (used only with ``s_churn`` > 0). Either is drawn with
    ``generator`` when None."""
    if latents is None:
        latents = torch.randn((batch_size, pose_dim), generator=generator, device=device)
    dev = latents.device
    i = torch.arange(num_steps, dtype=torch.float32)
    a, b = sigma_max ** (1 / rho), sigma_min ** (1 / rho)
    t_steps = (a + i / (num_steps - 1) * (b - a)) ** rho
    t_steps = torch.cat([t_steps, torch.zeros(1)]).tolist()
    gamma = min(s_churn / num_steps, 2.0 ** 0.5 - 1) if s_churn > 0 else 0.0

    def denoise(x, sigma):
        return denoiser_fn(x, torch.full((batch_size, 1), sigma, dtype=x.dtype, device=dev))

    def f32(v):
        return float(torch.tensor(v, dtype=torch.float32))

    x = latents * t_steps[0]
    for n in range(num_steps):
        t_cur, t_next = t_steps[n], t_steps[n + 1]
        t_hat = f32(t_cur + gamma * t_cur)
        x_hat = x
        if gamma > 0:
            z = (noise[n].to(dev) if noise is not None
                 else torch.randn(x.shape, generator=generator, device=dev))
            x_hat = x + f32(max(t_hat ** 2 - t_cur ** 2, 0.0)) ** 0.5 * s_noise * z
        d_cur = (x_hat - denoise(x_hat, t_hat)) / t_hat
        x_next = x_hat + (t_next - t_hat) * d_cur
        if t_next > 0:  # the 2nd-order correction
            d_prime = (x_next - denoise(x_next, t_next)) / t_next
            x_next = x_hat + (t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
        x = x_next
    return _finish(x, pose_mode, pts_center)


def ode_likelihood(
    score_fn: Callable,
    sde: SDE,
    x0: torch.Tensor,
    *,
    epsilon: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    max_steps: int = 2000,
    stats: Optional[dict] = None,
):
    """The log-likelihood of x0 (B, D) under the probability-flow ODE: the
    Skilling-Hutchinson divergence estimate eps^T J eps (one
    ``torch.func.jvp`` in the direction ``epsilon``, N(0, 1), drawn with
    ``generator`` when None) integrated with x forward from sde.eps to 1 by
    ``rk45_integrate``, plus ``sde.prior_logp`` of the end point. Returns
    (z_T (B, D), log-likelihood in bits (B,))."""
    B, D = x0.shape
    if epsilon is None:
        epsilon = torch.randn((B, D), generator=generator, device=x0.device)
    epsilon = epsilon.to(x0.device, torch.float32)

    def rhs(t, state):
        x = state[:, :D]
        t_vec = t.reshape(1, 1).expand(B, 1)
        g = sde.diffusion_coeff(t)

        def vf(xx):
            return sde.drift(xx, t) - 0.5 * (g * g) * score_fn(xx, t_vec)

        dx, jvp_eps = torch.func.jvp(vf, (x,), (epsilon,))
        div = torch.sum(jvp_eps * epsilon, dim=-1, keepdim=True)
        return torch.cat([dx, div], dim=-1)

    state0 = torch.cat([x0.float(), x0.new_zeros((B, 1), dtype=torch.float32)], dim=-1)
    state1, _ = rk45_integrate(rhs, sde.eps, 1.0, state0, rtol=rtol, atol=atol,
                               max_steps=max_steps, stats=stats)
    z = state1[:, :D]
    return z, (sde.prior_logp(z) + state1[:, -1]) / torch.log(torch.tensor(2.0))
