# Frozen copy of genpose2_tpu_torch/models/backbones.py as the change that adds the
# DINOv3 ViT-7B/16 backbone leaves it (on 1aa1e826eb50c0ba74bfa36081a388a0f11ebab4), made by the rules of
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""The frozen image backbones GenPose++ takes, keyed by ``ModelConfig.backbone``.

Each entry holds a backbone's published architecture: width, depth, heads,
FFN width, whether q, k and v carry a bias, and the storage (register)
tokens. ``ModelConfig.dino_dim`` and ``backbone_depth`` are checked against
it: the depth may be cut (tests run two blocks), and a width below the
published one is taken for tests, with the heads and the FFN scaled as the
entry says (``at``). A deployment runs the published width.

- ``dinov3_vits16plus``: DINOv3 ViT-S+/16, the fork's backbone
  (reference: networks/posenet.py:56-62; facebookresearch/dinov3
  ``dinov3/hub/backbones.py:dinov3_vits16plus``);
- ``dinov3_vit7b16``: DINOv3 ViT-7B/16, the teacher of that family
  (``dinov3_vit7b16``; arXiv:2508.10104): 40 blocks of 4,096, 32 heads of
  128, SwiGLU 8,192, no q/k/v bias, 6.7 B parameters. It is built on the
  agent's device with its matrices held in the compute dtype (13.4 GB in
  bf16); LayerNorms, biases and LayerScale gammas stay float32;
- ``dinov2_vits16``: the DINOv2-style ViT-S/16 (``ViT``), plain PyTorch.

The S+ and DINOv2 entries build exactly the modules they built before the
registry: on the host in float32, then moved to the agent's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bench_port.reference_vit7b.models.vit import DinoV3ViT, ViT


@dataclass(frozen=True)
class Backbone:
    family: str           # 'dinov3' (DinoV3ViT) | 'dinov2' (ViT)
    dim: int              # published embedding width
    depth: int            # published blocks
    num_heads: int        # published heads
    ffn_hidden: int       # published FFN width (SwiGLU's hidden for DINOv3)
    qkv_bias: bool
    storage_tokens: int   # storage / register tokens beside the class token
    keep_head_dim: bool   # at a narrower width: keep the head dim (else the head count)
    held_in_compute_dtype: bool  # built on the device, matrices in the compute dtype

    def at(self, dim: int, depth: int) -> dict:
        """The module's arguments at width ``dim`` and ``depth`` blocks;
        raises where the entry cannot take them."""
        if not 1 <= depth <= self.depth:
            raise ValueError(f"backbone_depth {depth}: the backbone has {self.depth} blocks")
        if not 1 <= dim <= self.dim:
            raise ValueError(f"dino_dim {dim}: the backbone's width is {self.dim}")
        head_dim = self.dim // self.num_heads
        heads = dim // head_dim if self.keep_head_dim else self.num_heads
        if (heads < 1 or dim % heads or (self.keep_head_dim and dim % head_dim)
                or (self.family == "dinov3" and (dim // heads) % 4)):
            rule = f"heads of {head_dim}" if self.keep_head_dim else f"{heads} heads"
            raise ValueError(f"dino_dim {dim} does not split into the backbone's {rule}"
                             + (" with a head dim a multiple of 4" if self.family == "dinov3"
                                else ""))
        return {"dim": dim, "depth": depth, "num_heads": heads,
                "ffn_hidden": self.ffn_hidden * dim // self.dim}


BACKBONES = {
    "dinov3_vits16plus": Backbone("dinov3", 384, 12, 6, 1536, qkv_bias=True, storage_tokens=4,
                                  keep_head_dim=False, held_in_compute_dtype=False),
    "dinov3_vit7b16": Backbone("dinov3", 4096, 40, 32, 8192, qkv_bias=False, storage_tokens=4,
                               keep_head_dim=True, held_in_compute_dtype=True),
    "dinov2_vits16": Backbone("dinov2", 384, 12, 6, 1536, qkv_bias=True, storage_tokens=0,
                              keep_head_dim=False, held_in_compute_dtype=False),
}


def backbone(name: str) -> Backbone:
    if name not in BACKBONES:
        raise NotImplementedError(f"backbone {name!r}; the registry has {', '.join(BACKBONES)}")
    return BACKBONES[name]


def build(cfg, device=None) -> torch.nn.Module:
    """The frozen backbone of ``cfg`` (a ``ModelConfig``) on ``device``, in
    eval mode."""
    entry = backbone(cfg.backbone)
    a = entry.at(cfg.dino_dim, cfg.backbone_depth)
    dt = torch.bfloat16 if cfg.backbone_dtype == "bfloat16" else None
    if entry.family == "dinov2":
        vit = ViT((cfg.img_size // cfg.patch_size) ** 2, patch_size=cfg.patch_size,
                  dim=a["dim"], depth=a["depth"], num_heads=a["num_heads"],
                  mlp_ratio=a["ffn_hidden"] / a["dim"], dtype=dt)
    else:
        held = {"device": device, "weight_dtype": dt} if entry.held_in_compute_dtype else {}
        vit = DinoV3ViT(patch_size=cfg.patch_size, num_storage_tokens=entry.storage_tokens,
                        qkv_bias=entry.qkv_bias, dtype=dt, **held, **a)
    return vit.to(device).eval() if device is not None else vit.eval()
