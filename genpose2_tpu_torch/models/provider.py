"""Image feature provider: the frozen ViT backbone as a pipeline stage (port of
genpose2_tpu/models/provider.py:ImageFeatureProvider).

The backbone belongs to the agent, not to GFObjectPose: the agent computes
``dino_layers`` (dino='pointwise') or ``dino_global`` (dino='global') from
``roi_rgb`` pixels once per batch, unless the batch already carries them.
``cfg.backbone`` names an entry of the registry (``models/backbones.py``):
``dinov3_vits16plus`` or ``dinov3_vit7b16`` (``DinoV3ViT``), or
``dinov2_vits16`` (the DINOv2-style ``ViT``).
"""

from __future__ import annotations

import torch

from genpose2_tpu_torch.config import ModelConfig
from genpose2_tpu_torch.models import backbones


class ImageFeatureProvider:
    """Builds the frozen backbone that ``cfg.backbone`` names (``.vit``), on
    ``device`` when one is given."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.vit = backbones.build(cfg, device)
        # intermediate layer ids, clipped into the (possibly truncated) depth
        self.layer_ids = tuple(min(i, cfg.backbone_depth - 1) for i in cfg.dino_layer_ids)

    def _pixels(self, rgb: torch.Tensor) -> torch.Tensor:
        return rgb.to(self.vit.cls_token.device, torch.float32)

    def patch_features(self, rgb: torch.Tensor):
        """rgb (B, S, S, 3) normalised -> list of (B, P, dino_dim) float32
        patch tokens of the tapped blocks."""
        return self.vit(self._pixels(rgb), self.layer_ids)

    def global_feature(self, rgb: torch.Tensor) -> torch.Tensor:
        """rgb (B, S, S, 3) normalised -> the final normed class token
        (B, dino_dim) float32 (dino='global')."""
        return self.vit(self._pixels(rgb), return_class_token=True)
