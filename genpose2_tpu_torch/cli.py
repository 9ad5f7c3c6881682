"""Command line: train / eval / track (port of genpose2_tpu/cli.py).

The flags are the JAX CLI's, plus ``--device`` (the card unless it says
``cpu``; nothing falls back to the CPU unasked):

    python -m genpose2_tpu_torch.cli train --agent_type score --data_path DIR --dino pointwise
    python -m genpose2_tpu_torch.cli train --agent_type scale --score_ckpt LOG/ckpt/final ...
    python -m genpose2_tpu_torch.cli train --agent_type energy_with_ranking --score_ckpt ...
    python -m genpose2_tpu_torch.cli eval  --data_path DIR --score_ckpt ... --energy_ckpt ...
    python -m genpose2_tpu_torch.cli track --data_path VIDEOS --score_ckpt ... --T0 0.25

``--source`` is ``Omni6DPose`` (frames on disk, ``data/omni6dpose.py``),
``xyzibd`` (BOP scenes, ``data/xyzibd.py``) or ``synthetic``
(``data/synthetic.py``, ``--steps_per_epoch`` batches an epoch, their poses
in ``--pose_mode``; the JAX CLI's synthetic batches stay 9-D whatever the
mode). A file
source's epoch is one pass of its ``DataLoader``, and the trainer counts
that pass's steps as its epoch (the JAX CLI keeps ``--steps_per_epoch``
there).

Data-parallel training runs one rank (process) a GPU (``parallel/``):
``train --data_parallel N`` starts N ranks on this machine, over NCCL where
each has a GPU of its own and gloo where they share one or run on the CPU;
``train --multihost --coordinator HOST:PORT --num_hosts W --host_id R`` makes
this process rank R of W (one a GPU; torchrun's variables work too).
``--batch_size`` is the global batch: each rank draws the synthetic batch
whole and keeps its rows, or loads its shard of a file source's batches, and
a world size that does not divide it raises. Rank 0 writes the log and the
checkpoints; the in-training sampling evaluation runs only in a
one-process run, as in the JAX CLI. ``eval`` and ``track`` run on one
device whatever the flags say (the JAX CLI builds no mesh there).
"""

from __future__ import annotations

import argparse
import json
import os
from itertools import chain
from typing import Optional

import torch

from genpose2_tpu_torch.config import (Config, DataConfig, EvalConfig, ModelConfig,
                                       SamplerConfig, SDEConfig, TrainConfig)
from genpose2_tpu_torch.device import resolve_device
from genpose2_tpu_torch.parallel.distributed import host_local_slice, rank, world_size


def build_config(args) -> Config:
    if getattr(args, "sampler_mode", None) == "edm" and args.sde_mode != "edm":
        raise SystemExit("--sampler_mode edm requires --sde_mode edm")
    model = ModelConfig(
        pose_mode=args.pose_mode, regression_head=args.regression_head,
        pts_encoder=args.pts_encoder, dino=args.dino, num_points=args.num_points,
        img_size=args.img_size, energy_mode=args.energy_mode, s_theta_mode=args.s_theta_mode,
        norm_energy=args.norm_energy)
    train = TrainConfig(
        agent_type=args.agent_type, batch_size=args.batch_size, n_epochs=args.n_epochs,
        lr=args.lr, warmup=args.warmup, lr_decay=args.lr_decay, grad_clip=args.grad_clip,
        ema_rate=args.ema_rate, repeat_num=args.repeat_num, eval_freq=args.eval_freq,
        seed=args.seed, optimizer=args.optimizer, scan_chunk=args.scan_chunk)
    ev = EvalConfig(
        eval_repeat_num=args.eval_repeat_num, retain_ratio=args.retain_ratio,
        clustering=bool(args.clustering), clustering_eps=args.clustering_eps,
        clustering_minpts_ratio=args.clustering_minpts, T0=args.T0,
        batch_size=args.batch_size)
    data = DataConfig(
        data_path=args.data_path, source=args.source, num_points=args.num_points,
        img_size=args.img_size, per_obj=args.per_obj, percentage_data=args.percentage_data,
        seed=args.seed, dzi_type="none" if args.eval_mode else "uniform",
        roi_mask_pro=0.0 if args.eval_mode else 0.5,
        bop_cameras=tuple(c for c in getattr(args, "bop_cameras", "").split(",") if c),
        trans_stats_dir=getattr(args, "trans_stats_dir", ""))
    sampler = SamplerConfig(mode=args.sampler_mode, sampling_steps=args.sampling_steps)
    return Config(sde=SDEConfig(mode=args.sde_mode), sampler=sampler, model=model,
                  train=train, eval=ev, data=data, log_dir=args.log_dir)


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--source", type=str, default="Omni6DPose",
                   choices=["Omni6DPose", "xyzibd", "synthetic"])
    p.add_argument("--batch_size", type=int, default=192)
    p.add_argument("--pose_mode", type=str, default="rot_matrix")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--per_obj", type=str, default="")
    p.add_argument("--percentage_data", type=float, default=1.0)
    # BOP multi-camera val/test enumeration, comma-separated
    p.add_argument("--bop_cameras", type=str, default="")
    # directory with {xyzibd}_trans_{mean,std}.npy
    p.add_argument("--trans_stats_dir", type=str, default="")
    # 'edm' = Karras-Heun over the EDM denoiser; requires --sde_mode edm
    p.add_argument("--sampler_mode", type=str, default="fixed",
                   choices=["fixed", "rk45", "pc", "euler", "edm"])
    p.add_argument("--sampling_steps", type=int, default=100)
    p.add_argument("--sde_mode", type=str, default="ve")
    p.add_argument("--regression_head", type=str, default="Rx_Ry_and_T")
    p.add_argument("--pts_encoder", type=str, default="pointnet2")
    p.add_argument("--energy_mode", type=str, default="IP")
    p.add_argument("--s_theta_mode", type=str, default="score")
    p.add_argument("--norm_energy", type=str, default="identical")
    p.add_argument("--dino", type=str, default="none", choices=["none", "global", "pointwise"])
    p.add_argument("--agent_type", type=str, default="score",
                   choices=["score", "energy", "energy_with_ranking", "scale"])
    p.add_argument("--n_epochs", type=int, default=1000)
    p.add_argument("--log_dir", type=str, default="results")
    p.add_argument("--optimizer", type=str, default="adam")
    p.add_argument("--eval_freq", type=int, default=100)
    p.add_argument("--repeat_num", type=int, default=20)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--lr_decay", type=float, default=0.98)
    p.add_argument("--eval_repeat_num", type=int, default=50)
    p.add_argument("--T0", type=float, default=0.55)
    p.add_argument("--clustering", type=int, default=1)
    p.add_argument("--clustering_eps", type=float, default=0.05)
    p.add_argument("--clustering_minpts", type=float, default=0.1667)
    p.add_argument("--retain_ratio", type=float, default=0.4)
    p.add_argument("--score_ckpt", type=str, default=None)
    p.add_argument("--energy_ckpt", type=str, default=None)
    p.add_argument("--scale_ckpt", type=str, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    # resume training from a whole-state checkpoint
    p.add_argument("--use_pretrain", action="store_true")
    p.add_argument("--pretrain_path", type=str, default=None)
    # train: N ranks on this machine, one a GPU (eval and track run on one device)
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--scan_chunk", type=int, default=8)
    # train: this process is one rank of a group (one GPU; on a host of several
    # GPUs start one process a GPU with LOCAL_RANK / LOCAL_WORLD_SIZE set)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_hosts", type=int, default=None)
    p.add_argument("--host_id", type=int, default=None)
    # 'cuda' (the default: the card) or 'cpu' (the plain versions of the kernels)
    p.add_argument("--device", type=str, default=None)


def _check_divides(batch_size: int, world: int) -> None:
    if batch_size % world:
        raise ValueError(f"batch_size={batch_size} is the GLOBAL batch size and must be "
                         f"divisible by the {world} ranks; a remainder would silently shrink "
                         "the effective global batch")


def make_loader_fn(cfg: Config, mode: str, agent_type: str = "score", device=None):
    """epoch -> the epoch's batches. Synthetic: ``steps_per_epoch`` prepared
    batches on ``device``, batch i of epoch e from a generator seeded with
    e * 1000 + i; a file source: a ``DataLoader`` over its dataset, shuffled
    with seed cfg.train.seed + epoch when training (collated raw batches).
    In a process group cfg.train.batch_size is the global batch and each rank
    gets its rows: the synthetic batch is drawn whole on every rank and
    sliced (``host_local_slice``), a file source's ``DataLoader`` loads this
    rank's shard."""
    from genpose2_tpu_torch.data.loader import DataLoader

    world = world_size()
    _check_divides(cfg.train.batch_size, world)
    if cfg.data.source == "synthetic":
        from genpose2_tpu_torch.data.synthetic import SyntheticPoseData
        from genpose2_tpu_torch.so3.noise import add_noise_to_R
        from genpose2_tpu_torch.so3.rotations import get_pose_representation

        data = SyntheticPoseData(num_points=cfg.data.num_points)
        dev = resolve_device(device)
        pose_mode = cfg.model.pose_mode

        def synthetic_fn(epoch, steps_per_epoch=50):
            for i in range(steps_per_epoch):
                g = torch.Generator(dev).manual_seed(epoch * 1000 + i)
                b = data.batch(g, cfg.train.batch_size)
                if pose_mode != "rot_matrix":
                    rot = get_pose_representation(b["gt_rotation"], pose_mode)
                    b["zero_mean_gt_pose"] = torch.cat([rot, b["zero_mean_gt_pose"][:, -3:]], -1)
                if agent_type == "scale":
                    S = cfg.train.scale_batch_size
                    B = b["gt_rotation"].shape[0]
                    rep = b["gt_rotation"].repeat_interleave(S, 0)
                    b = dict(b, axes_training=add_noise_to_R(rep, 10.0, g).reshape(B, S, 3, 3))
                if world > 1:
                    sl = host_local_slice(cfg.train.batch_size)
                    b = {k: v[sl] for k, v in b.items()}
                yield b

        return synthetic_fn
    if cfg.data.source == "xyzibd":
        from genpose2_tpu_torch.data.xyzibd import XyzibdDataset, load_translation_stats

        tm = ts = None
        if cfg.data.trans_stats_dir:
            tm, ts = load_translation_stats(cfg.data.trans_stats_dir)
        # multi-camera enumeration is for val/test splits only
        cams = list(cfg.data.bop_cameras) if mode != "train" else None
        ds = XyzibdDataset(cfg.data, cfg.data.data_path, mode=mode, cameras=cams or None,
                           trans_mean=tm, trans_std=ts)
    else:
        from genpose2_tpu_torch.data.omni6dpose import Omni6DPoseDataset

        ds = Omni6DPoseDataset(cfg.data, mode=mode, agent_type=agent_type)

    def loader_fn(epoch):
        return DataLoader(ds, cfg.train.batch_size // world, shuffle=(mode == "train"),
                          seed=cfg.train.seed + epoch, shard_index=rank(), num_shards=world)

    return loader_fn


def _processed(cfg: Config, device):
    from genpose2_tpu_torch.data.loader import process_batch

    def proc(b):
        return b if "zero_mean_gt_pose" in b else process_batch(b, cfg.model.pose_mode, device)

    return proc


def _frozen_score(cfg: Config, path: str, device, steps_per_epoch: int = 1000):
    """A score agent holding the EMA weights of the checkpoint at ``path``."""
    from genpose2_tpu_torch.training.agent import PoseAgent
    from genpose2_tpu_torch.training.checkpoint import load_params_only

    agent = PoseAgent(cfg, "score", device, steps_per_epoch)
    state = load_params_only(path, agent.init_state(), use_ema_as_params=True, agent=agent)
    return agent, state


def cmd_train(args):
    """Train one agent; returns the Trainer, or with ``--data_parallel`` N > 1
    each rank's summary (``_train_rank``) in rank order."""
    if args.multihost:
        from genpose2_tpu_torch.parallel.distributed import initialize_multihost

        if args.data_parallel != 1:
            raise ValueError("--multihost makes this process one rank (one GPU); start one "
                             "process a GPU and leave --data_parallel at 1")
        initialize_multihost(args.coordinator, args.num_hosts, args.host_id, device=args.device)
    elif args.data_parallel > 1:
        from genpose2_tpu_torch.parallel.launch import launch

        _check_divides(args.batch_size, args.data_parallel)
        return launch(_train_rank, args.data_parallel, (args,), device=args.device)
    return _train(args)


def _train_rank(args) -> dict:
    """One rank of ``train --data_parallel N``: its summary line's values."""
    return _summary(_train(args))


def _summary(trainer) -> dict:
    """A rank's step, last loss and EMA checksum (equal on every rank)."""
    state, loss = trainer.state, trainer.last_metrics.get("loss")
    return {"rank": rank(), "world": world_size(), "step": int(state.step),
            "loss": None if loss is None else float(loss),
            "ema_checksum": float(sum(p.double().abs().sum() for p in state.ema_params.values()))}


def _train(args):
    cfg = build_config(args)
    from genpose2_tpu_torch.training.eval_hooks import make_sampling_eval_fn
    from genpose2_tpu_torch.training.trainer import Trainer

    mesh = None
    if world_size() > 1:
        from genpose2_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    base_loader = make_loader_fn(cfg, "train", args.agent_type, device)
    if cfg.data.source == "synthetic":
        steps_per_epoch = args.steps_per_epoch

        def loader_fn(e):
            return base_loader(e, steps_per_epoch)
    else:
        loader_fn = base_loader
        steps_per_epoch = len(base_loader(0))
    frozen = None
    if args.agent_type in ("energy_with_ranking", "scale") and args.score_ckpt:
        frozen = _frozen_score(cfg, args.score_ckpt, device, steps_per_epoch)
    trainer = Trainer(cfg, args.agent_type, steps_per_epoch, frozen_score=frozen, device=device,
                      log_dir=args.log_dir, score_ckpt=args.score_ckpt,
                      resume_from=args.pretrain_path if args.use_pretrain else None, mesh=mesh)
    sample = next(iter(loader_fn(0))) if args.agent_type == "scale" else None
    trainer.init(sample)

    # the in-training sampling evaluation on a held-out batch (one process)
    eval_fn = None
    if args.agent_type != "scale" and mesh is None:
        eval_loader_fn = make_loader_fn(cfg, "test", args.agent_type, device)
        proc = _processed(cfg, device)

        def eval_batch_fn(epoch):
            return proc(next(iter(eval_loader_fn(10_000 + epoch))))

        eval_fn = make_sampling_eval_fn(trainer.agent, cfg, eval_batch_fn, log_dir=args.log_dir,
                                        repeat_num=min(10, cfg.eval.eval_repeat_num),
                                        num_steps=cfg.sampler.sampling_steps)
    trainer.fit(loader_fn, eval_fn=eval_fn)
    if mesh is not None:  # each rank's line, one write: the ranks share stdout
        print("train_rank " + json.dumps(_summary(trainer)) + "\n", end="", flush=True)
    return trainer


def _load_eval_agents(cfg: Config, args, batch0: dict, device):
    """The score agent (required), the energy agent and ScaleNet's
    ``scale_fn`` (each when its checkpoint is given), every one holding its
    checkpoint's EMA weights."""
    from genpose2_tpu_torch.training.agent import PoseAgent, ScaleAgent
    from genpose2_tpu_torch.training.checkpoint import load_params_only

    sa = PoseAgent(cfg, "score", device)
    if args.score_ckpt:
        load_params_only(args.score_ckpt, sa.init_state(), use_ema_as_params=True, agent=sa)
    ea = None
    if args.energy_ckpt:
        ea = PoseAgent(cfg, "energy", device)
        load_params_only(args.energy_ckpt, ea.init_state(), use_ema_as_params=True, agent=ea)
    scale_fn = None
    if args.scale_ckpt:
        pts_dim = int(sa.extract_features(batch0)[0].shape[-1])
        sc = ScaleAgent(cfg, pts_dim, device)
        load_params_only(args.scale_ckpt, sc.init_state(), use_ema_as_params=True, agent=sc)

        def scale_fn(batch, R, t, pts_feat=None):
            # ScaleNet reads the score encoder's feature and the estimated axes
            if pts_feat is None:
                pts_feat, _ = sa.extract_features(batch)
            return sc.predict(pts_feat, R)

    return sa, ea, scale_fn


def cmd_eval(args):
    """Evaluate the three agents over the test split, one batch at a time
    (``SingleFrameEvaluator.run_streaming``, caches and metrics.json in
    ``<log_dir>/eval``); returns the PoseMetrics."""
    cfg = build_config(args)
    from genpose2_tpu_torch.eval.pipeline import SingleFrameEvaluator

    device = resolve_device(args.device)
    proc = _processed(cfg, device)
    it = iter(make_loader_fn(cfg, "test", device=device)(0))
    first = next(it)
    batch0 = proc(first)
    sa, ea, scale_fn = _load_eval_agents(cfg, args, batch0, device)
    ev = SingleFrameEvaluator(cfg, sa, ea, scale_fn=scale_fn,
                              out_dir=os.path.join(args.log_dir, "eval"))
    g = torch.Generator(device).manual_seed(cfg.train.seed)
    metrics = ev.run_streaming((proc(b) for b in chain([batch0], it)), generator=g)
    print("deg_mean:", metrics.deg_mean, "sht_mean:", metrics.sht_mean)
    print("iou_acc:", metrics.iou_acc)
    print("pose_acc:", metrics.pose_acc)
    print("VUS:", metrics.pose_auc)
    return metrics


def cmd_track(args):
    """Track every video under --data_path (one folder each; failures go to
    ``<log_dir>/tracking_fail.txt``), multiplexed under an object budget of
    --batch_size; returns the PoseMetrics."""
    cfg = build_config(args)
    from genpose2_tpu_torch.data.loader import process_batch
    from genpose2_tpu_torch.data.tracking import open_video_datasets
    from genpose2_tpu_torch.eval.tracking import PoseTracker
    from genpose2_tpu_torch.eval.tracking_multiplex import (track_videos_multiplexed,
                                                            tracking_metrics)

    device = resolve_device(args.device)
    os.makedirs(args.log_dir, exist_ok=True)
    videos = open_video_datasets(cfg.data, cfg.data.data_path,
                                 fail_log=os.path.join(args.log_dir, "tracking_fail.txt"))
    if not videos:
        raise FileNotFoundError(f"no usable video under {cfg.data.data_path}")
    batch0 = process_batch(videos[0][0], cfg.model.pose_mode, device)
    sa, ea, scale_fn = _load_eval_agents(cfg, args, batch0, device)
    tracker = PoseTracker(cfg, sa, ea, scale_fn=scale_fn, T0=args.T0,
                          num_steps=args.sampling_steps)
    results = track_videos_multiplexed(tracker, videos,
                                       torch.Generator(device).manual_seed(cfg.train.seed),
                                       object_budget=cfg.eval.batch_size,
                                       pose_mode=cfg.model.pose_mode)
    metrics = tracking_metrics(results)
    print("tracking deg_mean:", metrics.deg_mean, "sht_mean:", metrics.sht_mean)
    print("pose_acc:", metrics.pose_acc)
    return metrics


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("genpose2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, fn in (("train", cmd_train), ("eval", cmd_eval), ("track", cmd_track)):
        p = sub.add_parser(name)
        add_common_flags(p)
        p.set_defaults(fn=fn, eval_mode=(name != "train"))
    return parser


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
