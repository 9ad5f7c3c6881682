"""Fixed-grid RK4 probability-flow integration (port of genpose2_tpu/ops/ode_rk4.py).

``fused_rk4_integrate`` runs the whole ``num_steps`` integration as one CUDA
kernel (``csrc/ode_rk4.cu``) on CUDA tensors, with the score net folded by
``models/scorenet.py:fast_score_weights`` and everything that depends on t
precomputed by ``_time_tables``. Otherwise (``_cuda.launches``) it runs
``fused_rk4_plain``: the per-step RK4 loop of ``diffusion/samplers.py``
(method='fixed') over the fast score function, which is the formulation the
JAX kernel is held against (tests/test_ode_fused.py there).

The RK4 loop, the ODE right-hand side and the fast score function live here
so that the sampler and the score net share them with the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from genpose2_tpu_torch.ops import _cuda


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


def _weight(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight matrix in the compute dtype, contiguous and 16-byte aligned
    (the TMA copies it from there): a view off 16 bytes is copied."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rk4_operands(x0, weights, sde, T0, num_steps, compute_dtype):
    """gp2_rk4's operands, checked: its twelve tensors (x0, the output,
    static, the t rows, the step scalars, w0, b0, w1, b1, Wpose, W2, b2) and
    its seven ints (R, D, P1, P2, H1, steps, bf16)."""
    dev = x0.device
    R, D = x0.shape
    dt = compute_dtype_of(compute_dtype)
    static = weights["static"].float().contiguous()
    H1 = static.shape[1]
    w0 = _weight(weights["pose_mlp"]["Dense_0"]["kernel"], dt)
    w1 = _weight(weights["pose_mlp"]["Dense_1"]["kernel"], dt)
    P1, P2 = w0.shape[1], w1.shape[1]
    b0 = weights["pose_mlp"]["Dense_0"]["bias"].float().contiguous()
    b1 = weights["pose_mlp"]["Dense_1"]["bias"].float().contiguous()
    wp = _weight(weights["W1_pose"], dt)
    w2 = _weight(weights["W2bd"], dt)
    b2 = weights["b2cat"].float().contiguous()
    if D > 16:
        raise ValueError(f"pose dim {D}: the kernel's last product holds at most 16 columns")
    if P1 % 256 or P2 % 256 or H1 % 256:
        raise ValueError(f"widths {P1}, {P2}, {H1}: the kernel takes multiples of 256 columns")
    if dt == torch.float32 and (P1, P2) != (256, 256):
        raise ValueError(f"pose MLP widths {P1}, {P2}: the float32 kernel holds 256 and 256")
    if H1 > 2048:
        raise ValueError(f"heads' width {H1}: the kernel walks at most 8 chunks of 256 columns")
    trows, scal = _time_tables(weights, sde, T0, float(sde.eps), num_steps)
    for t, name, dtype, shape in (
        (x0, "x0", torch.float32, (R, D)), (static, "static", torch.float32, (R, H1)),
        (w0, "pose_mlp.Dense_0", dt, (D, P1)), (b0, "b0", torch.float32, (P1,)),
        (w1, "pose_mlp.Dense_1", dt, (P1, P2)), (b1, "b1", torch.float32, (P2,)),
        (wp, "W1_pose", dt, (P2, H1)), (w2, "W2bd", dt, (H1, D)),
        (b2, "b2cat", torch.float32, (D,)), (trows, "t-rows", torch.float32, (num_steps, 3, H1)),
        (scal, "step scalars", torch.float32, (num_steps, 7)),
    ):
        _cuda.require(t, name, dtype, shape, dev)
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    tensors = (x0, out, static, trows, scal, w0, b0, w1, b1, wp, w2, b2)
    return tensors, (R, D, P1, P2, H1, num_steps, int(dt == torch.bfloat16))


def _rk4_cuda(x0, weights, sde, T0, num_steps, compute_dtype):
    tensors, ints = rk4_operands(x0, weights, sde, T0, num_steps, compute_dtype)
    lib = _cuda.library("ode_rk4")
    lib.gp2_rk4.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.gp2_rk4.restype = ctypes.c_int
    rounds = ctypes.c_int(0)
    code = lib.gp2_rk4(*(t.data_ptr() for t in tensors), *ints, _cuda.stream_ptr(x0),
                       ctypes.byref(rounds))
    _cuda.check(lib, code, "fused_rk4_integrate")
    _cuda.launch_counts["fused_rk4"] += 1
    # the launch's rounds of blocks on the card, from its plan (one where
    # every block of 64 rows or fewer fits on an SM at once)
    _cuda.launch_counts["fused_rk4_rounds"] += rounds.value
    return tensors[1]


def fused_rk4_integrate(x0: torch.Tensor, weights: dict, sde, T0: float, num_steps: int,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """Integrate the reverse probability-flow ODE from T0 to sde.eps in
    ``num_steps`` RK4 steps. x0 (R, D) float32; weights from
    ``fast_score_weights`` with ``static`` (R, H1). Returns (R, D) float32."""
    if not _cuda.launches(x0):
        return fused_rk4_plain(x0, weights, sde, T0, num_steps, compute_dtype)
    return _rk4_cuda(x0.contiguous(), weights, sde, T0, num_steps, compute_dtype)
