"""PoET — multi-object 6D pose estimation transformer.

Counterpart of `poet_tpu/models/poet.py:PoET`. The queries come from one
of two sources: in gt/jitter modes the caller supplies boxes, pre-padded to
`num_queries` with a valid count; in bbox_mode='backbone' the detector
backbone's detections are reduced to the top `num_queries` by score
(`_select_detections`). Dummy slots keep the reference conventions (boxes
-1, query-embedding fill -10, class -1). Per-decoder-layer heads give
stacked outputs (n_layers, B, Q, ...). The same module trains in gt/jitter
modes: in `train()` mode the transformer applies dropout from the generator
passed to `forward`, and the frozen backbone runs without autograd (the
JAX package's stop_gradient).

Not ported yet (ROADMAP queue A): training in bbox_mode='backbone' (the
matcher on detections), learned query embeddings/reference points/position
embeddings, and the aleatoric heads.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from poet_tpu_torch.config import ModelConfig
from poet_tpu_torch.models.backbone import add_position_embeddings
from poet_tpu_torch.models.layers import Conv, Dense, GroupNorm
from poet_tpu_torch.models.resnet_fpn import downsample_mask
from poet_tpu_torch.models.transformer import DeformableTransformer
from poet_tpu_torch.ops.detection import NEG_INF, topk
from poet_tpu_torch.ops.embeddings import bbox_embedding_sine
from poet_tpu_torch.utils.boxes import box_normalize_cxcywh, box_xyxy_to_cxcywh
from poet_tpu_torch.utils.rotations import rotation_6d_to_matrix

DUMMY_EMBED_FILL = -10.0
DUMMY_BOX_FILL = -1.0


def compute_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def gt_queries(targets: Dict[str, torch.Tensor], num_queries: int, bbox_mode: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gt/jitter query source, from the targets alone: (boxes (B, Q, 4)
    f32 with dummy slots -1, classes (B, Q) with dummy slots -1, n_boxes (B,),
    valid (B, Q)). The model builds its queries from it, and the trainer
    matches on the host from the same boxes and classes."""
    t_boxes = targets["boxes"] if bbox_mode == "gt" else targets["jitter_boxes"]
    n_boxes = targets["n_boxes"]
    valid_q = torch.arange(num_queries, device=n_boxes.device)[None, :] < n_boxes[:, None]
    t_boxes = torch.where(valid_q[..., None], t_boxes.float(), DUMMY_BOX_FILL)
    t_classes = torch.where(valid_q, targets["labels"], -1)
    return t_boxes, t_classes, n_boxes, valid_q


class MLP(nn.Module):
    """3-layer ReLU MLP head (f32)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        dims = (in_dim, hidden_dim, hidden_dim, output_dim)
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class PoET(nn.Module):
    """The pose-estimation transformer on an injected feature backbone."""

    def __init__(self, backbone: nn.Module, cfg: ModelConfig,
                 position_embedding: str = "sine",
                 position_embedding_scale: float = 2 * math.pi):
        super().__init__()
        if cfg.bbox_mode not in ("gt", "jitter", "backbone"):
            raise NotImplementedError(f"bbox_mode={cfg.bbox_mode!r}")
        unported = [f for f, ok in (
            ("position_embedding", position_embedding == "sine"),
            ("query_embedding", cfg.query_embedding == "bbox"),
            ("reference_points", cfg.reference_points == "bbox"),
            ("aleatoric", not cfg.aleatoric)) if not ok]
        if unported:
            raise NotImplementedError(f"{unported}: not ported yet (ROADMAP queue A)")
        self.cfg = cfg
        self.backbone = backbone
        self.position_embedding_scale = position_embedding_scale
        C = cfg.hidden_dim
        dt = compute_dtype_of(cfg)
        self.compute_dtype = dt

        n_backbone = len(backbone.num_channels)
        projs = [nn.Sequential(Conv(cin, C, 1, compute_dtype=dt), GroupNorm(32, C, dt))
                 for cin in backbone.num_channels]
        for e in range(max(0, cfg.num_feature_levels - n_backbone)):
            cin = backbone.num_channels[-1] if e == 0 else C
            projs.append(nn.Sequential(Conv(cin, C, 3, stride=2, padding=1, compute_dtype=dt),
                                       GroupNorm(32, C, dt)))
        self.input_proj = nn.ModuleList(projs)

        self.transformer = DeformableTransformer(
            d_model=C, nhead=cfg.nheads, num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward,
            num_feature_levels=cfg.num_feature_levels, dec_n_points=cfg.dec_n_points,
            enc_n_points=cfg.enc_n_points, dtype=dt, dropout=cfg.dropout)

        n_classes = cfg.n_classes + 1           # +1 dummy/background
        class_mult = n_classes if cfg.class_mode == "specific" else 1
        self.translation_head = nn.ModuleList(
            MLP(C, C, 3 * class_mult) for _ in range(cfg.dec_layers))
        self.rotation_head = nn.ModuleList(
            MLP(C, C, cfg.rot_dim * class_mult) for _ in range(cfg.dec_layers))

    def forward(self, images: torch.Tensor,            # (B, H, W, 3) in [0, 1]
                pad_mask: torch.Tensor,                # (B, H, W) bool, True = padded
                targets: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                detections: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """`targets` carry the gt/jitter boxes; in bbox_mode='backbone'
        `detections` (boxes (B, K, 4) xyxy pixels, scores, labels, valid)
        replace the backbone's own. `generator` draws the dropout masks in
        train() mode (required there when cfg.dropout > 0); eval() ignores
        it."""
        cfg = self.cfg
        C, Q = cfg.hidden_dim, cfg.num_queries
        dt = self.compute_dtype
        scale = self.position_embedding_scale

        features, masks, backbone_dets = self.backbone(images, pad_mask)
        pos = add_position_embeddings(masks, C, dt, scale=scale)

        # ---- query construction -------------------------------------------
        if cfg.bbox_mode == "backbone":
            dets = backbone_dets if detections is None else detections
            if dets is None:
                raise ValueError("bbox_mode='backbone' needs detections (the detector "
                                 "backbone or the caller's)")
            t_boxes, t_classes, t_scores, n_boxes, valid_q = self._select_detections(
                dets, Q, tuple(images.shape[1:3]))
            t_boxes = torch.where(valid_q[..., None], t_boxes, DUMMY_BOX_FILL)
            t_classes = torch.where(valid_q, t_classes, -1)
        else:
            t_boxes, t_classes, n_boxes, valid_q = gt_queries(targets, Q, cfg.bbox_mode)
            t_scores = valid_q.float()
        embed = bbox_embedding_sine(t_boxes, num_pos_feats=C // 8)     # (B, Q, C)
        embed = torch.cat([embed, embed], dim=-1)
        query_embeds = torch.where(valid_q[..., None], embed, DUMMY_EMBED_FILL)

        # ---- input projections + extra stride-2 levels --------------------
        srcs = [proj(f.permute(0, 3, 1, 2))
                for proj, f in zip(self.input_proj, features)]         # NCHW
        masks = list(masks)
        for e, proj in enumerate(self.input_proj[len(features):]):
            x = proj(features[-1].permute(0, 3, 1, 2) if e == 0 else srcs[-1])
            srcs.append(x)
            m = downsample_mask(pad_mask, x.shape[-2:])
            masks.append(m)
            pos += add_position_embeddings([m], C, dt, scale=scale)
        srcs = [s.permute(0, 2, 3, 1) for s in srcs]                    # NHWC

        hs, _, _ = self.transformer(srcs, masks, pos, query_embeds, t_boxes[:, :, :2],
                                    generator)

        # ---- per-layer heads ----------------------------------------------
        output_idx = torch.where(t_classes > 0, t_classes, 0)
        translations, rotations = [], []
        for lvl in range(cfg.dec_layers):
            out_t = self.translation_head[lvl](hs[lvl])
            out_r = self.rotation_head[lvl](hs[lvl])
            if cfg.class_mode == "specific":
                out_t = self._select_class(out_t, output_idx)
                out_r = self._select_class(out_r, output_idx)
            translations.append(out_t)
            rotations.append(self._process_rotation(out_r))
        return {
            "translations": torch.stack(translations),   # (n_layers, B, Q, 3)
            "rotations": torch.stack(rotations),         # (n_layers, B, Q, 3, 3|4)
            "pred_boxes": t_boxes,                       # (B, Q, 4)
            "pred_classes": t_classes,                   # (B, Q)
            "pred_scores": t_scores,                     # (B, Q): detector scores in
            # backbone mode, 1 for valid gt/jitter queries
            "n_boxes": n_boxes,                          # (B,)
            "query_valid": valid_q,                      # (B, Q)
        }

    @staticmethod
    def _select_detections(dets: Dict[str, torch.Tensor], Q: int, image_size):
        """The top-Q detections by score -> (boxes (B, Q, 4) normalized
        cxcywh, labels (B, Q) with -1 padding, scores (B, Q), n_boxes (B,),
        valid (B, Q)). Ties keep the lower index first, as `lax.top_k`."""
        scores = torch.where(dets["valid"], dets["scores"], NEG_INF)
        k = min(Q, scores.shape[1])
        top_s, top_i = topk(scores, k)
        boxes = torch.gather(dets["boxes"], 1, top_i[..., None].expand(*top_i.shape, 4))
        labels = torch.gather(dets["labels"], 1, top_i)
        valid = torch.isfinite(top_s)
        if k < Q:
            pad = Q - k
            boxes = F.pad(boxes, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
            valid = F.pad(valid, (0, pad))
            top_s = F.pad(top_s, (0, pad))
        scores = torch.where(valid, top_s, 0.0)
        n_boxes = valid.sum(1).to(torch.int32)
        boxes = box_normalize_cxcywh(box_xyxy_to_cxcywh(boxes.float()), image_size)
        return boxes, labels, scores, n_boxes, valid

    def _select_class(self, out: torch.Tensor, output_idx: torch.Tensor) -> torch.Tensor:
        """(B, Q, n_classes * d) -> (B, Q, d), the row of each query's class."""
        B, Q, _ = out.shape
        out = out.reshape(B, Q, self.cfg.n_classes + 1, -1)
        idx = output_idx.long()[:, :, None, None].expand(B, Q, 1, out.shape[-1])
        return torch.gather(out, 2, idx)[:, :, 0, :]

    def _process_rotation(self, pred: torch.Tensor) -> torch.Tensor:
        """6d -> SO(3) via Gram–Schmidt; quaternions -> L2 normalized."""
        if self.cfg.rotation_representation == "6d":
            return rotation_6d_to_matrix(pred)
        return pred / torch.clamp(torch.linalg.vector_norm(pred, dim=-1, keepdim=True),
                                  min=1e-12)
