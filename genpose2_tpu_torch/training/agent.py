"""The agents (port of genpose2_tpu/training/agent.py): the inference surface
(PoseAgent.with_image_features / extract_features / sample_candidates /
get_energy / score_fn / denoiser_fn, ``calc_likelihood``,
ScaleAgent.predict) and training (``init_state``, ``train_step`` /
``train_steps``).

A training step follows the JAX package's ``train_step``: the frozen
backbone's features without gradients, the encoder's module forward in train
mode (FPS and ball-query kernels on the card), the repeat_num-draw DSM loss
(plus the ranking loss when an energy batch carries candidates; the EDM
loss for the decoder agent; with dino='global' the heads also take the
global rgb feature), gradients by autograd, the global-norm clip and Adam or
SGD step, the EMA update. ``train_step_distilled`` is the same step with a
teacher's score as the DSM target. A step whose loss is not finite changes
nothing but the step counter: no parameter, optimizer state, BatchNorm
statistic or EMA entry. Inside ``parallel/mesh.py:use_mesh`` a step is
one data-parallel step: each rank's loss over its rows, the global batch's
BatchNorm statistics and draws, then gradients, loss and metrics averaged
over the data ranks before the update, so that every rank applies the same
one.

Each agent owns its network (``.model``) and, with dino='pointwise' or
'global', its frozen backbone (``.provider.vit``) on its device; weights
come in through ``agent.model.load_state_dict`` /
``agent.provider.vit.load_state_dict`` in the reference layouts
(genpose2_tpu_torch/weights.py turns the JAX package's variables into them).
The inference methods run the model's weights, or, given a train state, its
EMA weights (``use_ema=True``, the JAX package's default) or its live ones.
The device is ``cuda`` unless the caller passes one; without a card and
without a device the agents raise.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from genpose2_tpu_torch.config import Config
from genpose2_tpu_torch.device import resolve_device
from genpose2_tpu_torch.diffusion import (edm_sampler, init_sde, ode_likelihood, ode_sampler,
                                          pc_sampler)
from genpose2_tpu_torch.diffusion.losses import dsm_draws, dsm_loss, edm_draws, edm_loss
from genpose2_tpu_torch.models.layers import batch_stats, update_running_stats
from genpose2_tpu_torch.models.posenet import GFObjectPose
from genpose2_tpu_torch.models.provider import ImageFeatureProvider
from genpose2_tpu_torch.models.scalenet import ScaleNet, scale_loss
from genpose2_tpu_torch.models.scorenet import fast_score_weights
from genpose2_tpu_torch.ops.ode_rk4 import fast_score
from genpose2_tpu_torch.parallel.mesh import active_mesh, batch_rand
from genpose2_tpu_torch.training.ema import ema_init, ema_update
from genpose2_tpu_torch.training.optim import ClippedOptimizer, global_norm, make_lr_schedule
from genpose2_tpu_torch.training.ranking import ranking_loss, sort_results
from genpose2_tpu_torch.utils.profiling import note_backbone_weights, span

# the diffusion time range of the ranking energies and of detection-mode
# energies (genpose2_tpu/training/agent.py:485, 683)
RANK_T = (1e-5, 1e-4)
_RUNNING = ("running_mean", "running_var")


@dataclass
class TrainState:
    """What a training step advances. ``params`` and ``buffers`` are the
    model's own tensors (trainable parameters, BatchNorm running statistics)
    by state-dict name, updated in place; ``opt_state`` the optimizer's;
    ``ema_params`` a copy of ``params`` moved by the EMA, ``ema_updates``
    its update count."""

    step: int
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt_state: Dict
    ema_params: Dict[str, torch.Tensor]
    ema_updates: float = 0.0


class _Trainable:
    """Train state and update shared by the agents: ``model``, ``optimizer``
    and ``cfg`` are the agent's."""

    @contextlib.contextmanager
    def weights(self, state: Optional[TrainState] = None, use_ema: bool = True):
        """Inside the block the model runs ``state.ema_params`` in place of
        its parameters when a state is given and ``use_ema`` is set; the live
        values come back afterwards, also on an exception. Without a state,
        or with ``use_ema=False`` (``state.params`` are the model's own
        tensors), nothing changes."""
        if state is None or not use_ema:
            yield
            return
        live = {k: p.detach().clone() for k, p in state.params.items()}
        try:
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(state.ema_params[k])
            yield
        finally:
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(live[k])

    def init_state(self) -> TrainState:
        """A train state over the model's current weights."""
        params = {k: p for k, p in self.model.named_parameters() if p.requires_grad}
        buffers = {k: b for k, b in self.model.named_buffers() if k.endswith(_RUNNING)}
        return TrainState(step=0, params=params, buffers=buffers,
                          opt_state=self.optimizer.init(list(params.values())),
                          ema_params=ema_init(params))

    @staticmethod
    def data_parallel_mean(state: TrainState, loss: torch.Tensor, metrics: dict, grads):
        """(loss, metrics, gradients as a list over ``state.params``): under an
        active mesh averaged over its data ranks (the gradients in one
        flattened buffer, a missing one as zeros), else as they are."""
        grads = list(grads)
        mesh = active_mesh()
        if mesh is None:
            return loss, metrics, grads
        grads = mesh.mean_gradients(list(state.params.values()), grads)
        loss, metrics = mesh.mean_metrics(loss, metrics)
        return loss, metrics, grads

    def apply_gradients(self, state: TrainState, loss: torch.Tensor,
                        grads: Sequence[Optional[torch.Tensor]], bn_stats: dict) -> torch.Tensor:
        """The second half of a step: the NaN guard, the optimizer step, the
        batch's BatchNorm statistics ``bn_stats`` (from ``loss_and_grads``)
        and the EMA, then step + 1. ``grads`` follow ``state.params``; a
        parameter without a gradient (the ImgEncoder's, behind the
        stop-gradient) has a zero one, as in JAX. Returns the gradients'
        global norm."""
        params = list(state.params.values())
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        norm = global_norm(grads)
        if bool(torch.isfinite(loss)):
            update_running_stats(bn_stats)
            self.optimizer.step(params, grads, state.opt_state, norm)
            state.ema_updates = ema_update(state.ema_params, state.params, state.ema_updates,
                                           self.cfg.train.ema_rate)
        state.step += 1
        return norm


class PoseAgent(_Trainable):
    """A score or energy GFObjectPose on one device; in eval mode except
    inside a training step. A score agent whose sde mode is 'edm' runs the
    EDM denoiser (``use_decoder``)."""

    def __init__(self, cfg: Config, agent_type: Optional[str] = None, device=None,
                 steps_per_epoch: int = 1000):
        self.cfg = cfg
        self.agent_type = agent_type or cfg.train.agent_type
        self.device = resolve_device(device)
        self.sde = init_sde(cfg.sde)
        self.use_decoder = self.agent_type == "score" and cfg.sde.mode == "edm"
        self.model = GFObjectPose(cfg.model, self.sde.marginal_std, self.agent_type,
                                  use_decoder=self.use_decoder)
        self.model.to(self.device).eval()
        # the frozen image backbone belongs to the agent, not to the model
        self.provider = None
        if cfg.model.dino != "none" and cfg.model.backbone != "none":
            self.provider = ImageFeatureProvider(cfg.model, device=self.device)
            note_backbone_weights(sum(p.numel() * p.element_size()
                                      for p in self.provider.vit.parameters()))
        self.lr_schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.optimizer = ClippedOptimizer(cfg.train.optimizer, self.lr_schedule,
                                          cfg.train.grad_clip)

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
        """One optimization step; returns (state, metrics) with metrics
        ``loss``, ``score_loss``, ``ranking_loss`` (energy batches with
        candidates), ``lr`` and ``grad_norm``. Arguments as
        ``loss_and_grads``."""
        loss, metrics, grads, bn_stats = self.loss_and_grads(state, batch, generator, draws)
        loss, metrics, grads = self.data_parallel_mean(state, loss, metrics, grads.values())
        lr = self.lr_schedule(state.step)
        metrics.update(lr=lr, grad_norm=self.apply_gradients(state, loss, grads, bn_stats))
        return state, metrics

    def train_step_distilled(self, state: TrainState, teacher, batch: dict,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[dict] = None):
        """One score-distillation step: the DSM target is the teacher's
        score at the same perturbed poses and times, over the teacher's own
        features. ``teacher`` is a (score agent, its train state) pair of
        this agent's architecture; the teacher runs its state's EMA weights
        (the fast encoder and the module score net, without gradients).
        Returns (state, metrics ``loss`` and ``distill_loss``, the JAX
        package's); the NaN guard and the EMA update are ``train_step``'s.
        Arguments as ``loss_and_grads``."""
        loss, metrics, grads, bn_stats = self.loss_and_grads(state, batch, generator, draws,
                                                             teacher=teacher)
        loss, metrics, grads = self.data_parallel_mean(state, loss, metrics, grads.values())
        self.apply_gradients(state, loss, grads, bn_stats)
        return state, {"loss": metrics["loss"], "distill_loss": metrics["loss"]}

    def loss_and_grads(self, state: TrainState, batch: dict,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None, teacher=None):
        """The training loss of a batch, its gradients and its BatchNorm
        statistics: (loss, metrics, {name: gradient or None} over
        ``state.params``, bn_stats for ``apply_gradients``). The model and
        the state are not changed.

        batch: ``pts`` (B, N, 3) the camera-frame cloud, ``zero_mean_gt_pose``
        (B, D), with dino='pointwise' ``roi_xs``/``roi_ys`` and ``dino_layers``
        or ``roi_rgb``, with dino='global' ``roi_center_dir`` and
        ``dino_global`` or ``roi_rgb``; energy batches may add
        ``candidate_poses`` (B, K, D) and ``candidate_metrics`` (B, K, 2). The
        loss: DSM over ``repeat_num`` draws (with ``teacher``, a (score agent,
        state) pair, the teacher's score as the target), for the decoder
        agent (sde mode 'edm') the EDM loss; plus the ranking loss for energy
        batches with candidates. With dino='global' the heads also take the
        global rgb feature, repeated over the draws and the candidates.
        Input jitter, dropout masks and the loss's draws come from
        ``generator`` (on the agent's device) in that order, unless ``draws``
        gives the DSM draws ``t`` (R, B, 1) and ``z`` (R, B, D), the EDM draws
        ``z`` (R, B, D) and ``u`` (R, B, 1), and the ranking times ``rank_t``
        (B * K, 1)."""
        dev = self.device
        draws = draws or {}
        with torch.no_grad():  # the frozen backbone
            batch = self.with_image_features(batch)
        gt = batch["zero_mean_gt_pose"].to(dev, torch.float32)
        B, D = gt.shape
        R = self.cfg.train.repeat_num
        self.model.train()
        try:
            with torch.enable_grad(), batch_stats() as bn_stats:
                feat = self._features(batch, train=True, generator=generator)
                rgb = self._global_rgb(batch)
                if self.use_decoder:
                    z, u = ((draws["z"].to(dev), draws["u"].to(dev)) if "u" in draws
                            else edm_draws(B, D, R, generator, dev))
                    feat_rep, rgb_rep = _repeat(feat, z.shape[0]), _repeat(rgb, z.shape[0])
                    sde = self.cfg.sde
                    loss = edm_loss(lambda x, sigma: self.model.denoise(feat_rep, x, sigma,
                                                                        rgb_rep),
                                    gt, z, u, sde.edm_sigma_min, sde.edm_sigma_max)
                else:
                    t, z = ((draws["t"].to(dev), draws["z"].to(dev)) if "t" in draws
                            else dsm_draws(B, D, self.sde, R, generator, dev))
                    feat_rep, rgb_rep = _repeat(feat, t.shape[0]), _repeat(rgb, t.shape[0])
                    if self.agent_type == "score":
                        def score_fn(x, tt):
                            return self.model.score(feat_rep, x, tt, rgb_rep)
                    else:
                        def score_fn(x, tt):
                            return self.model.energy_score(feat_rep, x, tt, rgb_rep)
                    target = None
                    if teacher is not None:
                        target = _teacher_score(teacher, batch, t.shape[0])
                    loss = dsm_loss(score_fn, gt, self.sde, t, z, teacher_score_fn=target)
                metrics = {"score_loss": loss.detach()}
                if self.agent_type == "energy" and "candidate_poses" in batch:
                    r_loss = self._ranking_loss(batch, feat, rgb, draws.get("rank_t"), generator)
                    metrics["ranking_loss"] = r_loss.detach()
                    loss = loss + r_loss
                grads = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True)
        finally:
            self.model.eval()
        metrics["loss"] = loss.detach()
        return loss, metrics, dict(zip(state.params, grads)), bn_stats

    def _global_rgb(self, batch: dict) -> Optional[torch.Tensor]:
        """dino='global': the global rgb feature of a batch whose image
        features are attached; else None."""
        if self.cfg.model.dino != "global":
            return None
        return self.model.extract_global_rgb_feature(batch["dino_global"].to(self.device),
                                                     batch["roi_center_dir"].to(self.device))

    def train_steps(self, state: TrainState, batches: Sequence[dict],
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Sequence[dict]] = None):
        """One ``train_step`` per batch; returns (state, list of metrics)."""
        metrics: List[dict] = []
        for i, batch in enumerate(batches):
            state, m = self.train_step(state, batch, generator,
                                       None if draws is None else draws[i])
            metrics.append(m)
        return state, metrics

    def _ranking_loss(self, batch: dict, feat: torch.Tensor, rgb: Optional[torch.Tensor],
                      rank_t, generator):
        """The candidates' decoupled energies at t ~ U(1e-5, 1e-4), sorted
        by their ground-truth errors, through the pairwise ranking loss."""
        cand = batch["candidate_poses"].to(self.device, torch.float32)
        B, K, D = cand.shape
        if rank_t is None:
            lo, hi = RANK_T
            rank_t = batch_rand((B * K, 1), generator, self.device)  # object-major rows
            rank_t = rank_t * (hi - lo) + lo
        def rep(x):  # (B, F) -> (B * K, F), object-major
            return None if x is None else x[:, None].expand(B, K, x.shape[-1]).reshape(B * K, -1)

        energy = self.model.energy(rep(feat), cand.reshape(B * K, D), rank_t.to(self.device),
                                   True, rep(rgb)).reshape(B, K, 2)
        return ranking_loss(sort_results(energy, batch["candidate_metrics"].to(self.device)))

    def _features(self, batch: dict, train: bool = False,
                  generator: Optional[torch.Generator] = None):
        """The point feature of a batch whose image features are attached."""
        pts = batch["pts"].to(self.device, torch.float32)
        if self.cfg.model.dino != "pointwise":
            return self.model.extract_pts_feature(pts, train=train, generator=generator)
        layers = [t.to(self.device, torch.float32) for t in batch["dino_layers"]]
        return self.model.extract_pts_feature(pts, layers, batch["roi_xs"].to(self.device),
                                              batch["roi_ys"].to(self.device), train=train,
                                              generator=generator)

    def with_image_features(self, batch: dict) -> dict:
        """The batch with the backbone's features computed from ``roi_rgb``
        (B, S, S, 3): ``dino_layers`` (dino='pointwise') or ``dino_global``
        (dino='global'), unless it carries them already (then the backbone
        does not run)."""
        key = "dino_global" if self.cfg.model.dino == "global" else "dino_layers"
        if self.provider is None or key in batch or "roi_rgb" not in batch:
            return batch
        with span("backbone"):
            if key == "dino_global":
                return dict(batch,
                            dino_global=self.provider.global_feature(batch["roi_rgb"]))
            return dict(batch, dino_layers=self.provider.patch_features(batch["roi_rgb"]))

    @torch.no_grad()
    def extract_features(self, batch: dict, state: Optional[TrainState] = None,
                         use_ema: bool = True):
        """batch['pts'] (B, N, 3) -> (pts_feat (B, C_final), rgb_feat). With
        dino='pointwise' the batch also carries ``roi_xs``/``roi_ys`` (B, N)
        and ``dino_layers`` or ``roi_rgb``; with dino='global'
        ``roi_center_dir`` (B, 3) and ``dino_global`` or ``roi_rgb`` (see
        with_image_features), and rgb_feat is the global rgb feature (B,
        dino_dim + global_embedding_dim); otherwise rgb_feat is None.
        ``state`` and ``use_ema`` pick the weights (see ``weights``)."""
        with span(f"{self.agent_type}.encode"):
            batch = self.with_image_features(batch)
            with self.weights(state, use_ema):
                return self._features(batch), self._global_rgb(batch)

    def _pose_net(self, state: Optional[TrainState], use_ema: bool):
        """The pose net, or with a state whose EMA weights are asked for a
        copy of it holding them (a closure may outlive ``weights``)."""
        if state is None or not use_ema:
            return self.model.pose_score_net
        with self.weights(state, use_ema):
            return copy.deepcopy(self.model.pose_score_net)

    def denoiser_fn(self, pts_feat: torch.Tensor, rgb_feat: Optional[torch.Tensor] = None,
                    state: Optional[TrainState] = None, use_ema: bool = True):
        """(x (R, D), sigma (R, 1)) -> the denoised x, the EDM decoder's
        D(x; sigma) over the features (R, F) (decoder agents only)."""
        assert self.use_decoder
        net = self._pose_net(state, use_ema)

        def fn(x, sigma):
            return net(pts_feat, x, sigma, rgb_feat)

        return fn

    def score_fn(self, pts_feat: torch.Tensor, rgb_feat: Optional[torch.Tensor] = None,
                 state: Optional[TrainState] = None, use_ema: bool = True):
        """(x (R, D), t (R, 1)) -> the score over the features (R, F) (and
        rgb_feat (R, rgb_dim) with dino='global'), for the samplers:
        - a decoder agent: (D(x; sigma) - x) / (sigma^2 + 1e-12), sigma the
          marginal std at t;
        - a score agent: ``fast_score`` over the folded net (cfg.model.
          score_dtype products, one t embedding per row);
        - an energy agent: the gradient of the summed coupled energy with
          respect to x, by ``torch.func.grad`` (so that ``torch.func.jvp``
          composes with it, and it runs under ``torch.no_grad``)."""
        net = self._pose_net(state, use_ema)
        if self.use_decoder:
            dfn = self.denoiser_fn(pts_feat, rgb_feat, state, use_ema)
            std = self.sde.marginal_std

            def decoder_score(x, t):
                sigma = std(t)
                return (dfn(x, sigma) - x) / (sigma * sigma + 1e-12)

            return decoder_score
        if self.agent_type == "score":
            return self._fast_score(fast_score_weights(net, pts_feat, rgb_feat))

        def energy_score(x, t):
            return torch.func.grad(
                lambda p: net(pts_feat, p, t, False, rgb_feat).sum())(x)

        return energy_score

    def _fast_score(self, w: dict):
        dtype, std = self.cfg.model.score_dtype, self.sde.marginal_std

        def score(x, t):
            return fast_score(w, x, t, std, dtype)

        return score

    @torch.no_grad()
    @span("score.sample")
    def sample_candidates(self, batch: dict, repeat_num: int = 50, T0: float = 1.0,
                          init_x: Optional[torch.Tensor] = None, method: str = "rk45",
                          num_steps: int = 500, features=None,
                          generator: Optional[torch.Generator] = None,
                          prior: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None,
                          state: Optional[TrainState] = None, use_ema: bool = True,
                          stats: Optional[dict] = None) -> torch.Tensor:
        """``repeat_num`` pose candidates per object, (B, K, D), camera frame.

        ``method``: 'rk45' (the adaptive ODE solver, cfg.sampler's atol, rtol
        and max_rk45_steps), 'fixed' (``num_steps`` RK4 steps; with
        cfg.sampler.fused_fixed and a score agent one fused kernel launch,
        otherwise the per-step loop), 'euler', 'pc'
        (predictor-corrector from t = 1, ``T0`` plays no part; snr
        cfg.sampler.snr) or 'edm' (the Heun sampler, decoder agents only,
        no warm start). ``features`` (pts_feat, rgb_feat) from
        ``extract_features`` skips the encoder. ``prior`` (B * K, D) is the
        start noise (for 'edm' the N(0, 1) latents), ``noise`` the per-step
        draws of 'pc' (num_steps, 2, B * K, D) and 'edm' (num_steps, B * K,
        D); when None they are drawn with ``generator``. ``init_x`` (B, D) or
        (B, K, D), zero-mean, warm-starts the integration (tracking): the
        prior is added to it ('pc' starts from it). ``state`` and ``use_ema``
        pick the weights of the encoder and the pose net (see ``weights``);
        ``stats`` receives the adaptive solver's host reads and error norms
        (``rk45_integrate``)."""
        if method == "edm":
            assert self.use_decoder, "method 'edm' needs a decoder agent (sde mode 'edm')"
            # edm starts from fresh latents at sigma_max: a warm start would be dropped
            if init_x is not None or T0 != 1.0:
                raise ValueError("method='edm' does not support warm starts: init_x must be "
                                 "None and T0 must be 1.0 (use method='rk45' for tracking-style "
                                 "warm-started sampling)")
        with self.weights(state, use_ema):
            pts_feat, rgb_feat = (features if features is not None
                                  else self.extract_features(batch))
            B, K, D = pts_feat.shape[0], repeat_num, self.cfg.model.pose_dim
            feat_rep = pts_feat.repeat_interleave(K, dim=0)
            rgb_rep = None if rgb_feat is None else rgb_feat.repeat_interleave(K, dim=0)
            center = batch.get("pts_center")
            center_rep = None if center is None else center.to(self.device).repeat_interleave(K, 0)
            if init_x is not None:
                init_x = init_x.to(self.device)
                init_x = (init_x.repeat_interleave(K, 0) if init_x.ndim == 2
                          else init_x.reshape(B * K, D))
            prior = None if prior is None else prior.to(self.device)
            common = dict(generator=generator, device=self.device,
                          pose_mode=self.cfg.model.pose_mode, pts_center=center_rep)
            if method == "edm":
                sde = self.cfg.sde
                poses = edm_sampler(self.denoiser_fn(feat_rep, rgb_rep), B * K, D,
                                    num_steps=num_steps, sigma_min=sde.edm_sigma_min,
                                    sigma_max=sde.edm_sigma_max, latents=prior, noise=noise,
                                    **common)
                return poses.reshape(B, K, D)
            fast = self.agent_type == "score" and not self.use_decoder
            w = fast_score_weights(self.model.pose_score_net, feat_rep, rgb_rep) if fast else None
            sfn = self._fast_score(w) if fast else self.score_fn(feat_rep, rgb_rep)
            if method == "pc":
                poses = pc_sampler(sfn, self.sde, B * K, D, num_steps=num_steps,
                                   snr=self.cfg.sampler.snr, init_x=init_x, prior=prior,
                                   noise=noise, **common)
                return poses.reshape(B, K, D)
            # 'fixed': the whole integration as one kernel launch over the folded net
            fused = w if method == "fixed" and self.cfg.sampler.fused_fixed else None
            sc = self.cfg.sampler
            poses, _ = ode_sampler(
                sfn, self.sde, B * K, D, T0=T0, init_x=init_x, num_steps=num_steps,
                method=method, atol=sc.atol, rtol=sc.rtol, max_steps=sc.max_rk45_steps,
                fused_weights=fused, compute_dtype=self.cfg.model.score_dtype, prior=prior,
                stats=stats, **common)
            return poses.reshape(B, K, D)

    @torch.no_grad()
    @span("energy.rank")
    def get_energy(self, batch: dict, poses: torch.Tensor, fixed_t: Optional[float] = 1e-5,
                   features=None, generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   state: Optional[TrainState] = None, use_ema: bool = True) -> torch.Tensor:
        """Energy of camera-frame candidates (B, K, D) -> (B, K, 2); the cloud
        center is subtracted first. Diffusion time: ``fixed_t`` for every row,
        or with ``fixed_t=None`` (detection mode) one draw per row from
        U[1e-5, 1e-4) with ``generator``, unless ``t`` (B * K, 1) gives them.
        ``state`` and ``use_ema`` pick the weights (see ``weights``)."""
        assert self.agent_type == "energy"
        with self.weights(state, use_ema):
            pts_feat, rgb_feat = (features if features is not None
                                  else self.extract_features(batch))
            B, K, D = poses.shape
            poses = poses.to(self.device).clone()
            center = batch.get("pts_center")
            if center is not None:
                poses[..., -3:] -= center.to(self.device)[:, None, :]
            flat = poses.reshape(B * K, D)
            if t is not None:
                t = t.to(self.device, flat.dtype).reshape(B * K, 1)
            elif fixed_t is None:
                lo, hi = RANK_T
                t = torch.rand((B * K, 1), generator=generator, device=self.device) * (hi - lo) + lo
            else:
                t = torch.full((B * K, 1), fixed_t, dtype=flat.dtype, device=self.device)
            rgb_rep = None if rgb_feat is None else rgb_feat.repeat_interleave(K, 0)
            energy = self.model.energy(pts_feat.repeat_interleave(K, 0), flat, t, True, rgb_rep)
            return energy.reshape(B, K, 2)


def _repeat(x: Optional[torch.Tensor], r: int) -> Optional[torch.Tensor]:
    """(B, F) -> (r * B, F), the draws' stacking order (draw-major)."""
    return None if x is None else x[None].expand(r, *x.shape).reshape(r * x.shape[0], -1)


def _teacher_score(teacher, batch: dict, repeat: int):
    """The distillation target: (x, t) -> the teacher agent's score at
    (x, t) over its own features of ``batch``, from its state's EMA
    weights, without gradients. ``teacher`` = (score agent, train state)."""
    agent, state = teacher
    with torch.no_grad():
        feat, rgb = agent.extract_features(batch, state=state)
    feat_rep, rgb_rep = _repeat(feat, repeat), _repeat(rgb, repeat)

    def score(x, t):
        with torch.no_grad(), agent.weights(state):
            return agent.model.score(feat_rep, x, t, rgb_rep)

    return score


@torch.no_grad()
def calc_likelihood(agent: PoseAgent, batch: dict, poses: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    epsilon: Optional[torch.Tensor] = None,
                    state: Optional[TrainState] = None,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """The log-likelihood in bits (B, K) of camera-frame poses (B, K, D)
    under the agent's probability-flow ODE (``ode_likelihood``; the cloud
    center subtracted first). ``epsilon`` (B * K, D) is the divergence
    estimate's N(0, 1) direction, drawn with ``generator`` when None;
    ``state`` picks EMA weights; ``stats`` goes to ``rk45_integrate``."""
    with agent.weights(state):
        pts_feat, rgb_feat = agent.extract_features(batch)
        B, K, D = poses.shape
        poses = poses.to(agent.device, torch.float32).clone()
        center = batch.get("pts_center")
        if center is not None:
            poses[..., -3:] -= center.to(agent.device)[:, None, :]
        rgb_rep = None if rgb_feat is None else rgb_feat.repeat_interleave(K, 0)
        sfn = agent.score_fn(pts_feat.repeat_interleave(K, 0), rgb_rep)
        sc = agent.cfg.sampler
        _, ll = ode_likelihood(sfn, agent.sde, poses.reshape(B * K, D), epsilon=epsilon,
                               generator=generator, atol=sc.atol, rtol=sc.rtol,
                               max_steps=sc.max_rk45_steps, stats=stats)
        return ll.reshape(B, K)


class ScaleAgent(_Trainable):
    """ScaleNet on the frozen score-encoder feature, on one device."""

    def __init__(self, cfg: Config, pts_dim: int = 1024, device=None,
                 steps_per_epoch: int = 1000):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = ScaleNet(cfg.model.scale_embedding, pts_dim).to(self.device).eval()
        self.lr_schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.optimizer = ClippedOptimizer("adam", self.lr_schedule, cfg.train.grad_clip)

    def train_step(self, state: TrainState, batch: dict):
        """batch: ``pts_feat`` (B, F) frozen score-encoder features,
        ``axes_training`` (B, S, 3, 3) noised ground-truth axes, ``gt_length``
        (B, 3). Returns (state, {'loss'})."""
        loss, grads = self.loss_and_grads(state, batch)
        loss, _, grads = self.data_parallel_mean(state, loss, {}, grads.values())
        self.apply_gradients(state, loss, grads, {})  # ScaleNet has no BatchNorm
        return state, {"loss": loss.detach()}

    def loss_and_grads(self, state: TrainState, batch: dict):
        """The scale loss of a batch (see ``train_step``) and its gradients
        {name: gradient} over ``state.params``."""
        dev = self.device
        axes = batch["axes_training"].to(dev, torch.float32)
        B, S = axes.shape[:2]
        feat = batch["pts_feat"].to(dev, torch.float32)
        gt = batch["gt_length"].to(dev, torch.float32)
        self.model.train()
        try:
            with torch.enable_grad():
                pred = self.model(feat[:, None].expand(B, S, feat.shape[-1]).reshape(B * S, -1),
                                  axes.reshape(B * S, 3, 3))
                loss = scale_loss(pred, gt[:, None].expand(B, S, 3).reshape(B * S, 3))
                grads = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True)
        finally:
            self.model.eval()
        return loss, dict(zip(state.params, grads))

    @torch.no_grad()
    @span("scale.predict")
    def predict(self, pts_feat: torch.Tensor, axes: torch.Tensor,
                state: Optional[TrainState] = None, use_ema: bool = True) -> torch.Tensor:
        """pts_feat (B, F), axes (B, 3, 3) -> box side lengths (B, 3). With a
        train state the EMA weights run unless ``use_ema=False`` (see
        ``weights``); without one, the model's own."""
        with self.weights(state, use_ema):
            return self.model(pts_feat.to(self.device), axes.to(self.device))
