"""Image feature provider: the frozen ViT backbone as a pipeline stage (port of
genpose2_tpu/models/provider.py:ImageFeatureProvider, ``dinov3_vits16plus``
only).

The backbone belongs to the agent, not to GFObjectPose: the agent computes
``dino_layers`` from ``roi_rgb`` pixels once per batch, unless the batch
already carries them.
"""

from __future__ import annotations

import torch

from genpose2_tpu_torch.config import ModelConfig
from genpose2_tpu_torch.models.vit import DinoV3ViT


class ImageFeatureProvider:
    """Builds the frozen backbone that ``cfg.backbone`` names (``.vit``)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.backbone != "dinov3_vits16plus":
            raise NotImplementedError(
                f"backbone={cfg.backbone!r}: the port has only dinov3_vits16plus (see ROADMAP.md)")
        self.cfg = cfg
        self.vit = DinoV3ViT(
            patch_size=cfg.patch_size, dim=cfg.dino_dim, depth=cfg.backbone_depth, num_heads=6,
            num_storage_tokens=4, ffn_hidden=cfg.dino_dim * 4,
            dtype=torch.bfloat16 if cfg.backbone_dtype == "bfloat16" else None)
        # intermediate layer ids, clipped into the (possibly truncated) depth
        self.layer_ids = tuple(min(i, cfg.backbone_depth - 1) for i in cfg.dino_layer_ids)

    def patch_features(self, rgb: torch.Tensor, plain: bool = False):
        """rgb (B, S, S, 3) normalised -> list of (B, P, dino_dim) float32
        patch tokens of the tapped blocks."""
        dev = self.vit.cls_token.device
        return self.vit(rgb.to(dev, torch.float32), self.layer_ids, plain=plain)
