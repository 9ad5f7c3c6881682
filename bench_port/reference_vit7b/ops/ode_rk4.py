# Frozen copy of genpose2_tpu_torch/ops/ode_rk4.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten, 1 kernel route(s) removed. Do not edit.
"""Fixed-grid RK4 probability-flow integration (port of genpose2_tpu/ops/ode_rk4.py).

``fused_rk4_integrate`` runs the whole ``num_steps`` integration as one CUDA
kernel (``csrc/ode_rk4.cu``) on CUDA tensors, with the score net folded by
``models/scorenet.py:fast_score_weights`` and everything that depends on t
precomputed by ``_time_tables``. On CPU tensors it runs
``fused_rk4_plain``: the per-step RK4 loop of ``diffusion/samplers.py``
(method='fixed') over the fast score function, which is the formulation the
JAX kernel is held against (tests/test_ode_fused.py there).

The RK4 loop, the ODE right-hand side and the fast score function live here
so that the sampler and the score net share them with the plain version.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

def compute_dtype_of(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def pf_ode_rhs(score_fn: Callable, sde, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dx/dt = f(x, t) - 0.5 g(t)^2 score(x, t), t a 0-d tensor."""
    t_vec = t.reshape(1, 1).expand(x.shape[0], 1)
    g = sde.diffusion_coeff(t)
    return sde.drift(x, t) - 0.5 * (g * g) * score_fn(x, t_vec)


def rk4_fixed_grid(rhs: Callable, x0: torch.Tensor, T0: float, eps: float,
                   num_steps: int, trajectory: Optional[list] = None) -> torch.Tensor:
    """Classic RK4 on ``num_steps`` equal steps from T0 down to eps; each
    step's x is appended to ``trajectory`` when one is given."""
    ts = torch.linspace(T0, eps, num_steps + 1, dtype=torch.float32, device=x0.device)
    x = x0
    for i in range(num_steps):
        t, t_next = ts[i], ts[i + 1]
        h = t_next - t
        k1 = rhs(t, x)
        k2 = rhs(t + h / 2, x + h / 2 * k1)
        k3 = rhs(t + h / 2, x + h / 2 * k2)
        k4 = rhs(t_next, x + h * k3)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        if trajectory is not None:
            trajectory.append(x)
    return x


def fast_score(w: dict, x: torch.Tensor, t: torch.Tensor, marginal_std_fn: Callable,
               compute_dtype: str = "float32", uniform_t: bool = False) -> torch.Tensor:
    """The score of ``fast_score_weights``' folded net at (x (R, D), t (R, 1)).

    Products take their operands in the compute dtype and sum in float32; the
    t embedding, biases, activations and 1/std stay float32
    (genpose2_tpu/models/scorenet.py:make_fast_score_fn). ``uniform_t``: every
    row has t[0]'s time, so the t embedding and its first-layer rows are
    computed on that one row (float32) and broadcast."""
    dt = compute_dtype_of(compute_dtype)

    def mm(a, W):
        return a.to(dt).float() @ W.to(dt).float()

    def t_embed(tt):
        proj = tt[:, 0:1] * w["fourier_W"][None, :] * 2.0 * math.pi
        t_feat = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        return torch.relu(t_feat @ w["t_dense"]["kernel"] + w["t_dense"]["bias"])

    h = x
    for layer in ("Dense_0", "Dense_1"):
        p = w["pose_mlp"][layer]
        h = torch.relu(mm(h, p["kernel"]) + p["bias"])
    if uniform_t:
        t_rows = t_embed(t[:1]) @ w["W1_t"].float()
        hidden = torch.relu(mm(h, w["W1_pose"]) + (w["static"] + t_rows))
    else:
        hidden = torch.relu(mm(torch.cat([t_embed(t), h], dim=-1), w["W1_dyn"]) + w["static"])
    return (mm(hidden, w["W2bd"]) + w["b2cat"]) / (marginal_std_fn(t) + 1e-7)


def _time_tables(weights: dict, sde, T0: float, eps: float, num_steps: int):
    """Everything that depends on t, for every (step, stage time j): the
    t-embedding rows through the heads' first layer (n, 3, H1), and per step
    the scalars [h, q0, q1, q2, a0, a1, a2] (n, 7), with q = -0.5 g^2 /
    (std + 1e-7) and a the linear drift coefficient (0 for VE)."""
    dev = weights["static"].device
    n = num_steps
    ts = torch.linspace(T0, eps, n + 1, dtype=torch.float32, device=dev)
    h = ts[1:] - ts[:-1]
    t_all = torch.stack([ts[:-1], (ts[:-1] + ts[1:]) / 2.0, ts[1:]], dim=1)  # (n, 3)
    flat = t_all.reshape(-1, 1)
    proj = flat * weights["fourier_W"][None, :] * 2.0 * math.pi
    t_feat = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    t_emb = torch.relu(t_feat @ weights["t_dense"]["kernel"] + weights["t_dense"]["bias"])
    trows = (t_emb @ weights["W1_t"]).float().reshape(n, 3, -1)
    g = sde.diffusion_coeff(flat[:, 0])
    std = sde.marginal_std(flat[:, 0])
    q = (-0.5 * g * g) / (std + 1e-7)
    if sde.mode in ("vp", "subvp"):
        a = -0.5 * (sde.beta_0 + flat[:, 0] * (sde.beta_1 - sde.beta_0))
    else:
        a = torch.zeros_like(q)
    scal = torch.cat([h[:, None], q.reshape(n, 3), a.reshape(n, 3)], dim=1)
    return trows.contiguous(), scal.float().contiguous()


def fused_rk4_plain(x0: torch.Tensor, weights: dict, sde, T0: float, num_steps: int,
                    compute_dtype: str = "float32") -> torch.Tensor:
    def score(x, t):
        return fast_score(weights, x, t, sde.marginal_std, compute_dtype)

    return rk4_fixed_grid(lambda t, x: pf_ode_rhs(score, sde, t, x), x0, T0, sde.eps,
                          num_steps)


def fused_rk4_integrate(x0: torch.Tensor, weights: dict, sde, T0: float, num_steps: int,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """Integrate the reverse probability-flow ODE from T0 to sde.eps in
    ``num_steps`` RK4 steps. x0 (R, D) float32; weights from
    ``fast_score_weights`` with ``static`` (R, H1). Returns (R, D) float32."""
    return fused_rk4_plain(x0, weights, sde, T0, num_steps, compute_dtype)
