# Frozen copy of genpose2_tpu_torch/config.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Immutable dataclass configuration tree.

Replaces the reference's single global argparse (reference: configs/config.py:5-135)
which was even consumed at import time (reference: networks/pts_encoder/pointnet2.py:28,
a layering violation). Here configuration is an explicit, frozen, hashable tree that
can be passed into jitted functions as a static argument.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SDEConfig:
    """SDE family and hyperparameters (reference: networks/gf_algorithms/sde.py:96-142)."""

    mode: str = "ve"  # 've' | 'vp' | 'subvp' | 'edm'
    # VE
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    # VP / sub-VP
    beta_0: float = 0.1
    beta_1: float = 20.0
    # EDM
    edm_sigma_min: float = 0.002
    edm_sigma_max: float = 80.0

    @property
    def eps(self) -> float:
        return {"ve": 1e-5, "vp": 1e-3, "subvp": 1e-3, "edm": 0.002}[self.mode]

    @property
    def T(self) -> float:
        return self.edm_sigma_max if self.mode == "edm" else 1.0


@dataclass(frozen=True)
class SamplerConfig:
    """Sampler knobs (reference: configs/config.py:29-30,80, samplers.py:180-258)."""

    mode: str = "ode"  # 'ode' | 'ode_fixed' | 'pc' | 'edm'
    sampling_steps: int = 500  # for pc / fixed-grid ode
    atol: float = 1e-5
    rtol: float = 1e-5
    snr: float = 0.16  # Langevin corrector SNR (pc sampler)
    denoise: bool = True
    T0: float = 1.0  # ODE start time (0.55 single-frame eval, 0.25/0.15 tracking)
    # Maximum RK45 iterations for the on-device adaptive solver (safety bound for
    # lax.while_loop; scipy runs unbounded).
    max_rk45_steps: int = 2000
    # fixed-grid RK4 as ONE fused Pallas program (ops/ode_rk4.py); off falls
    # back to the lax.scan XLA formulation (parity: tests/test_ode_fused.py)
    fused_fixed: bool = True


@dataclass(frozen=True)
class PointNet2Config:
    """MSG set-abstraction stack = ClsMSG_CFG_Light
    (reference: networks/pts_encoder/pointnet2.py:77-89)."""

    npoints: Tuple[Optional[int], ...] = (512, 256, 128, 64, None)
    radii: Tuple[Tuple[Optional[float], ...], ...] = (
        (0.01, 0.02),
        (0.02, 0.04),
        (0.04, 0.08),
        (0.08, 0.16),
        (None, None),
    )
    nsamples: Tuple[Tuple[Optional[int], ...], ...] = (
        (16, 32),
        (16, 32),
        (16, 32),
        (16, 32),
        (None, None),
    )
    mlps: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
        ((512, 512), (512, 512)),
    )
    use_xyz: bool = True
    # 'bfloat16' runs the SA-stack matmuls in bf16 (f32 params/BN); 'float32'
    # keeps everything f32
    compute_dtype: str = "float32"
    dropout: float = 0.1  # Fus variant (reference: pointnet2.py:274)
    num_heads: int = 8
    input_jitter: float = 1e-3  # train-time cloud jitter (reference: pointnet2.py:332-333)


LIGHTER_POINTNET2 = PointNet2Config(
    npoints=(512, 256, 128, 64, None),
    radii=((0.01,), (0.02,), (0.04,), (0.08,), (None,)),
    nsamples=((64,), (32,), (16,), (8,), (None,)),
    mlps=(
        ((32, 32, 64),),
        ((64, 64, 128),),
        ((128, 196, 256),),
        ((256, 256, 512),),
        ((512, 512, 1024),),
    ),
)


@dataclass(frozen=True)
class ModelConfig:
    """Network composition (reference: networks/posenet.py:27-124)."""

    pose_mode: str = "rot_matrix"  # 'rot_matrix'(9D) | 'quat_wxyz' | 'quat_xyzw' | 'euler_xyz'
    regression_head: str = "Rx_Ry_and_T"  # 'RT' | 'R_and_T' | 'Rx_Ry_and_T'
    pts_encoder: str = "pointnet2"  # 'pointnet2' | 'pointnet' | 'pointnet_and_pointnet2'
    dino: str = "pointwise"  # 'none' | 'global' | 'pointwise'
    dino_dim: int = 384
    # frozen image backbone: 'dinov3_vits16plus' (the fork's actual backbone,
    # reference: networks/posenet.py:56-62) | 'dinov2_vits16' | 'none'
    # ('none' = features are supplied precomputed in the batch)
    backbone: str = "dinov3_vits16plus"
    backbone_depth: int = 12  # truncated in tests for speed
    backbone_dtype: str = "bfloat16"  # frozen-feature compute dtype
    dino_layer_ids: Tuple[int, ...] = (2, 6, 11)  # reference: posenet.py:138-144
    global_embedding_dim: int = 60  # roi-center-dir embedding for dino='global'
    num_points: int = 1024
    img_size: int = 256
    patch_size: int = 16
    pointnet2: PointNet2Config = field(default_factory=PointNet2Config)
    # EnergyNet modes (reference: networks/gf_algorithms/energynet.py:32-52)
    energy_mode: str = "IP"  # 'DAE' | 'L2' | 'IP'
    s_theta_mode: str = "score"  # 'score' | 'decoder' | 'identical'
    norm_energy: str = "identical"  # 'identical' | 'std' | 'minus'
    # ScaleNet (reference: networks/scalenet.py:12-31, configs/config.py:41)
    scale_embedding: int = 180
    # sampler fast-path matmul dtype ('float32' | 'bfloat16'); see
    # models/scorenet.py:make_fast_score_fn
    score_dtype: str = "float32"

    @property
    def pose_dim(self) -> int:
        return {"quat_wxyz": 7, "quat_xyzw": 7, "euler_xyz": 6, "rot_matrix": 9}[
            self.pose_mode
        ]


@dataclass(frozen=True)
class TrainConfig:
    """Optimization (reference: configs/config.py:54-70, networks/posenet_agent.py:121-139)."""

    agent_type: str = "score"  # 'score' | 'energy' | 'energy_with_ranking' | 'scale'
    batch_size: int = 192
    n_epochs: int = 1000
    lr: float = 1e-3
    warmup: int = 100  # steps of linear LR warmup
    lr_decay: float = 0.98  # per-epoch exponential decay
    lr_floor: float = 1e-4  # (reference: posenet_agent.py:724-730)
    optimizer: str = "adam"
    grad_clip: float = 1.0
    ema_rate: float = 0.999
    repeat_num: int = 20  # DSM loss repeats per step, vmapped
    eval_freq: int = 100
    seed: int = 0
    scale_batch_size: int = 64  # noised-axes candidates per object (scale agent)
    ranking_num: int = 5  # candidates per object pulled for ranking loss
    distillation: bool = False
    # batches stacked per device-resident lax.scan dispatch: amortizes the
    # per-call host round trip (~30 ms on remote backends vs ~1 ms/step of
    # actual compute; measured 33 -> 824-1686 steps/s). 1 = step-per-dispatch.
    scan_chunk: int = 8


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation / aggregation (reference: configs/config.py:72-107)."""

    eval_repeat_num: int = 50  # pose candidates per object
    retain_ratio: float = 0.4
    clustering: bool = True
    clustering_eps: float = 0.05
    clustering_minpts_ratio: float = 0.1667
    T0: float = 0.55  # single-frame; 0.25 tracking eval; 0.15 infer tracking
    batch_size: int = 128


@dataclass(frozen=True)
class DataConfig:
    """Dataset & augmentation (reference: configs/config.py:9-26,112-131)."""

    data_path: str = ""
    source: str = "Omni6DPose"  # 'Omni6DPose' | 'xyzibd' | 'synthetic'
    num_points: int = 1024
    img_size: int = 256
    per_obj: str = ""
    percentage_data: float = 1.0
    seed: int = 0
    # decoded-frame LRU size (frames); REPCNT oversampling and multi-object
    # frames re-decode the same image many times per epoch without it
    frame_cache: int = 32
    # Dynamic zoom-in (reference: cfg.DYNAMIC_ZOOM_IN_PARAMS)
    dzi_pad_scale: float = 1.5
    dzi_type: str = "uniform"  # 'uniform' | 'roi10d' | 'truncnorm' | 'none'
    dzi_scale_ratio: float = 0.25
    dzi_shift_ratio: float = 0.25
    # 2D mask deformation (reference: cfg.DEFORM_2D_PARAMS)
    roi_mask_r: int = 3
    roi_mask_pro: float = 0.5
    # BOP/XYZ-IBD multi-camera val/test enumeration (reference:
    # xyzibd_dataset.py:583-608, cam_ids ['xyz','realsense','photoneo']);
    # empty -> unsuffixed single-camera layout
    bop_cameras: tuple = ()
    # directory holding {name}_trans_{mean,std}.npy translation stats
    # (reference: configs/xyzibd_trans_*.npy, xyzibd_dataset.py:796-804);
    # empty -> identity normalization
    trans_stats_dir: str = ""
    # NOCS-style cloud aug (reference: cfg.PTS_AUG_PARAMS)
    aug_pc_pro: float = 0.2
    aug_pc_r: float = 0.2
    aug_rt_pro: float = 0.3
    aug_bb_pro: float = 0.3
    aug_bc_pro: float = 0.3

    def pts_aug_params(self) -> dict:
        """cfg.PTS_AUG_PARAMS dict, as data_augment consumes it
        (reference: configs/config.py:119-126)."""
        return {
            "aug_pc_pro": self.aug_pc_pro,
            "aug_pc_r": self.aug_pc_r,
            "aug_rt_pro": self.aug_rt_pro,
            "aug_bb_pro": self.aug_bb_pro,
            "aug_bc_pro": self.aug_bc_pro,
        }


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout. The reference is single-GPU (nn.DataParallel at best,
    reference: networks/posenet_agent.py:116-118); here data- and candidate-
    parallelism are first-class mesh axes."""

    data_axis: str = "data"
    candidate_axis: str = "cand"
    data_parallel: int = 1
    candidate_parallel: int = 1


@dataclass(frozen=True)
class Config:
    sde: SDEConfig = field(default_factory=SDEConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    log_dir: str = "results"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()


def tiny_test_config() -> Config:
    """A small config for unit tests / CPU runs: fewer points, tiny MLPs."""
    pn2 = PointNet2Config(
        npoints=(32, 16, None),
        radii=((0.04, 0.08), (0.08, 0.16), (None, None)),
        nsamples=((8, 8), (8, 8), (None, None)),
        mlps=(
            ((8, 16), (8, 16)),
            ((16, 32), (16, 32)),
            ((32, 64), (32, 64)),
        ),
    )
    model = ModelConfig(num_points=128, pointnet2=pn2, dino="none", img_size=64)
    return Config(
        model=model,
        data=DataConfig(num_points=128, img_size=64),
        # a gentler VE schedule: with sigma_max=50 an under-trained tiny score
        # net sends ODE trajectories off the typical set (full-size training
        # uses the reference's sigma_max=50 default)
        sde=SDEConfig(sigma_max=2.0),
        train=TrainConfig(batch_size=4, repeat_num=2),
        eval=EvalConfig(eval_repeat_num=8, batch_size=4),
        sampler=SamplerConfig(sampling_steps=20, max_rk45_steps=200),
    )


def tiny_flagship_config() -> Config:
    """tiny_test_config with the flagship pointwise-DINO wiring: a truncated
    DinoV3 backbone computes features from 64px pixels end-to-end."""
    base = tiny_test_config()
    model = dataclasses.replace(
        base.model,
        dino="pointwise",
        dino_dim=48,  # 6 heads x 8 head-dim (RoPE needs head_dim % 4 == 0)
        backbone="dinov3_vits16plus",
        backbone_depth=2,
        backbone_dtype="float32",
        dino_layer_ids=(0, 1, 1),
        img_size=64,
        patch_size=16,
    )
    return base.replace(model=model)
