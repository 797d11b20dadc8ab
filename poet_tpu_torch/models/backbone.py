"""Backbones + positional encodings.

Counterpart of `poet_tpu/models/backbone.py`: `MaskRCNNFeatureBackbone`
(gt/jitter modes: FPN levels only), `MaskRCNNDetectorBackbone`
(bbox_mode='backbone': the same levels plus the detector's per-image
detections from one FPN pass), `add_position_embeddings` (sine) and
`PositionEmbeddingLearned`.

The learned embedding's tables: the port keeps them at
`position_embedding.{row,col}_embed.weight` (a submodule of PoET, as JAX's
`position_embedding/{row,col}_embed`), where the reference's Joiner keeps
them at `backbone.1.{row,col}_embed.weight`; a zoo `.pth` is remapped on
load (`engine/checkpoint.py:load_resume`). Not under `backbone.`, they
label 'main' in `engine/train.py:label_params`, as in JAX.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from poet_tpu_torch.models.layers import Embedding
from poet_tpu_torch.models.maskrcnn import MaskRCNNDetector
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


class MaskRCNNDetectorBackbone(MaskRCNNDetector):
    """ResNet-50-FPN levels ['2', '3', 'pool'] plus per-image fixed-size
    detections from the RPN + RoI heads, all from one FPN pass, frozen.

    torchvision's GeneralizedRCNN layout: `backbone` (every FPN level),
    `rpn` and `roi_heads` side by side, so a detector state_dict loads as it
    is. The detector computes in `dtype` (bf16 heads on the native bf16 maps
    at bf16; ranking stays f32). `obj_id_map` ((raw, new), ...) is the LM-O
    id remap: labels map through it and unmapped ids are dropped.
    """

    def __init__(self, num_classes: int = 22, max_detections: int = 100,
                 post_nms_top_n: int = 1000,
                 obj_id_map: Optional[Tuple[Tuple[int, int], ...]] = None,
                 return_layers: Sequence[str] = ("2", "3", "pool"),
                 anchor_sizes: Optional[Tuple[Tuple[int, ...], ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, max_detections=max_detections,
                         post_nms_top_n=post_nms_top_n, anchor_sizes=anchor_sizes,
                         dtype=dtype)
        self.obj_id_map = obj_id_map
        self.return_layers = tuple(return_layers)
        self.num_channels = (256,) * len(self.return_layers)
        self.backbone = ResNetFPN(dtype=dtype)
        self.requires_grad_(False)              # frozen, as in the reference

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor):
        with torch.no_grad():
            feats = self.backbone(images)
            dets = super().forward(feats, tuple(images.shape[1:3]))
        return self.outputs(feats, dets, pad_mask)

    def outputs(self, feats, dets, pad_mask):
        """(features, masks, detections) of the return layers, the LM-O
        remap applied."""
        if self.obj_id_map is not None:
            raw = dets["labels"]
            mapped = torch.full_like(raw, -1)
            for src, dst in self.obj_id_map:
                mapped = torch.where(raw == src, dst, mapped)
            dets["valid"] = dets["valid"] & (mapped > 0)
            dets["labels"] = mapped
        features, masks = [], []
        for name in sorted(self.return_layers):
            x = feats[name]
            features.append(x)
            masks.append(downsample_mask(pad_mask, x.shape[1:3]))
        return features, masks, dets


def add_position_embeddings(masks: List[torch.Tensor], hidden_dim: int,
                            dtype: torch.dtype = torch.float32,
                            scale: float = 2 * math.pi) -> List[torch.Tensor]:
    """Sine embedding per level (computed in f32, returned in `dtype`)."""
    return [position_embedding_sine(m, num_pos_feats=hidden_dim // 2, scale=scale).to(dtype)
            for m in masks]


class PositionEmbeddingLearned(nn.Module):
    """Learned 50x50 absolute embedding. Counterpart of
    `poet_tpu/models/backbone.py:PositionEmbeddingLearned`: row and column
    tables of `num_pos_feats` each, U[0, 1) at init; the output's channels
    are the x (column) features first, then the y (row) features, the
    opposite of the sine embedding. One instance serves every level, the
    extra ones included. A level larger than 50x50 raises, as in JAX."""

    SIZE = 50

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = Embedding(self.SIZE, num_pos_feats, init="uniform")
        self.col_embed = Embedding(self.SIZE, num_pos_feats, init="uniform")

    def forward(self, pad_mask: torch.Tensor) -> torch.Tensor:
        """(B, H, W) mask -> (B, H, W, 2 * num_pos_feats) f32."""
        B, H, W = pad_mask.shape
        if H > self.SIZE or W > self.SIZE:
            raise ValueError(f"PositionEmbeddingLearned: level {H}x{W} exceeds the "
                             f"{self.SIZE}x{self.SIZE} table")
        F_ = self.num_pos_feats
        x_emb = self.col_embed.weight[:W]                   # (W, F)
        y_emb = self.row_embed.weight[:H]                   # (H, F)
        pos = torch.cat([x_emb[None, :, :].expand(H, W, F_),
                         y_emb[:, None, :].expand(H, W, F_)], dim=-1)
        return pos[None].expand(B, H, W, 2 * F_)
