"""Feature backbone + positional encodings.

Counterpart of `poet_tpu/models/backbone.py:MaskRCNNFeatureBackbone` and
`add_position_embeddings`. The detector heads (`MaskRCNNDetectorBackbone`,
bbox_mode='backbone') are not ported yet (ROADMAP queue A, detect+pose).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn

from poet_tpu_torch.models.resnet_fpn import ResNetFPN, downsample_mask
from poet_tpu_torch.ops.embeddings import position_embedding_sine


class MaskRCNNFeatureBackbone(nn.Module):
    """Frozen ResNet-50-FPN levels ['2', '3', 'pool'] (strides 16/32/64).

    The submodule is named `backbone` after the reference checkpoint's
    `backbone.0.backbone.*` (the detector's torchvision FPN backbone); the
    JAX package names the same subtree `fpn_body`.
    """

    def __init__(self, return_layers: Sequence[str] = ("2", "3", "pool"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_layers = tuple(return_layers)
        self.num_channels = (256,) * len(self.return_layers)
        self.backbone = ResNetFPN(dtype=dtype, levels=self.return_layers)
        self.backbone.requires_grad_(False)     # frozen, as in the reference

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor):
        # frozen: no autograd graph, so no activations kept for a backward
        # (poet_tpu/models/backbone.py:49 stop_gradient)
        with torch.no_grad():
            feats = self.backbone(images)
        features, masks = [], []
        for name in sorted(self.return_layers):
            x = feats[name]
            features.append(x)
            masks.append(downsample_mask(pad_mask, x.shape[1:3]))
        return features, masks, None   # no detections


def add_position_embeddings(masks: List[torch.Tensor], hidden_dim: int,
                            dtype: torch.dtype = torch.float32,
                            scale: float = 2 * math.pi) -> List[torch.Tensor]:
    """Sine embedding per level (computed in f32, returned in `dtype`)."""
    return [position_embedding_sine(m, num_pos_feats=hidden_dim // 2, scale=scale).to(dtype)
            for m in masks]
