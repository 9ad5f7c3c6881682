# Frozen copy of genpose2_tpu_torch/models/provider.py at commit 63c19dccd00dbac2648896cacad45283dbc0da37, made by
# bench_port/tools/freeze_reference.py: imports rewritten. Do not edit.
"""Image feature provider: the frozen ViT backbone as a pipeline stage (port of
genpose2_tpu/models/provider.py:ImageFeatureProvider).

The backbone belongs to the agent, not to GFObjectPose: the agent computes
``dino_layers`` (dino='pointwise') or ``dino_global`` (dino='global') from
``roi_rgb`` pixels once per batch, unless the batch already carries them.
``cfg.backbone`` picks ``dinov3_vits16plus`` (``DinoV3ViT``) or
``dinov2_vits16`` (the DINOv2-style ``ViT``).
"""

from __future__ import annotations

import torch

from bench_port.reference.config import ModelConfig
from bench_port.reference.models.vit import ViT, DinoV3ViT


class ImageFeatureProvider:
    """Builds the frozen backbone that ``cfg.backbone`` names (``.vit``)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.backbone_dtype == "bfloat16" else None
        if cfg.backbone == "dinov3_vits16plus":
            self.vit = DinoV3ViT(
                patch_size=cfg.patch_size, dim=cfg.dino_dim, depth=cfg.backbone_depth,
                num_heads=6, num_storage_tokens=4, ffn_hidden=cfg.dino_dim * 4, dtype=dt)
        elif cfg.backbone == "dinov2_vits16":
            self.vit = ViT((cfg.img_size // cfg.patch_size) ** 2, patch_size=cfg.patch_size,
                           dim=cfg.dino_dim, depth=cfg.backbone_depth, num_heads=6, dtype=dt)
        else:
            raise NotImplementedError(cfg.backbone)
        # intermediate layer ids, clipped into the (possibly truncated) depth
        self.layer_ids = tuple(min(i, cfg.backbone_depth - 1) for i in cfg.dino_layer_ids)

    def _pixels(self, rgb: torch.Tensor) -> torch.Tensor:
        return rgb.to(self.vit.cls_token.device, torch.float32)

    def patch_features(self, rgb: torch.Tensor, plain: bool = False):
        """rgb (B, S, S, 3) normalised -> list of (B, P, dino_dim) float32
        patch tokens of the tapped blocks."""
        return self.vit(self._pixels(rgb), self.layer_ids, plain=plain)

    def global_feature(self, rgb: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """rgb (B, S, S, 3) normalised -> the final normed class token
        (B, dino_dim) float32 (dino='global')."""
        return self.vit(self._pixels(rgb), plain=plain, return_class_token=True)
