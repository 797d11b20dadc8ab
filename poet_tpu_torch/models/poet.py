"""PoET — multi-object 6D pose estimation transformer.

Counterpart of `poet_tpu/models/poet.py:PoET`. The queries come from one
of two sources: in gt/jitter modes the caller supplies boxes, pre-padded to
`num_queries` with a valid count; in bbox_mode='backbone' the detector
backbone's detections are reduced to the top `num_queries` by score
(`_select_detections`). Dummy slots keep the reference conventions (boxes
-1, query-embedding fill -10, class -1). Per-decoder-layer heads give
stacked outputs (n_layers, B, Q, ...). The same module trains in every
bbox mode: in `train()` mode the transformer applies dropout from the
generator passed to `forward`, and the frozen backbone runs without
autograd (the JAX package's stop_gradient).

The options of JAX's PoET: `query_embedding='learned'` (a (Q, 2C) table,
`query_embed`, N(0, 1) at init, in place of the box embedding for every
query, dummies included), `reference_points='learned'` (the transformer's
sigmoid(Linear(qe)) in place of the box centres), `position_embedding=
'learned'` (`models/backbone.py:PositionEmbeddingLearned`, one module for
every level) and `aleatoric` (per-layer log-variance heads beside the pose
heads, `translations_aleatoric` / `rotations_aleatoric`, (n_layers, B, Q,
3), selected by class as the pose heads are).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from poet_tpu_torch.config import ModelConfig
from poet_tpu_torch.models.backbone import PositionEmbeddingLearned, add_position_embeddings
from poet_tpu_torch.models.layers import Conv, Dense, Embedding, GroupNorm
from poet_tpu_torch.models.resnet_fpn import downsample_mask
from poet_tpu_torch.models.transformer import DeformableTransformer
from poet_tpu_torch.ops.detection import NEG_INF, topk
from poet_tpu_torch.ops.embeddings import bbox_embedding_sine
from poet_tpu_torch.utils.boxes import box_normalize_cxcywh, box_xyxy_to_cxcywh
from poet_tpu_torch.utils.rotations import rotation_6d_to_matrix
from poet_tpu_torch.utils.tracing import span

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
        for name, value, default in (("position_embedding", position_embedding, "sine"),
                                     ("query_embedding", cfg.query_embedding, "bbox"),
                                     ("reference_points", cfg.reference_points, "bbox")):
            if value not in (default, "learned"):
                raise ValueError(f"{name}={value!r} not in ({default!r}, 'learned')")
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
        self.position_embedding = (PositionEmbeddingLearned(C // 2)
                                   if position_embedding == "learned" else None)
        self.query_embed = (Embedding(cfg.num_queries, 2 * C)
                            if cfg.query_embedding == "learned" else None)

        self.transformer = DeformableTransformer(
            d_model=C, nhead=cfg.nheads, num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward,
            num_feature_levels=cfg.num_feature_levels, dec_n_points=cfg.dec_n_points,
            enc_n_points=cfg.enc_n_points, dtype=dt, dropout=cfg.dropout,
            enc_impl=cfg.enc_deform_impl, dec_impl=cfg.dec_deform_impl,
            merged_adjoint=cfg.merged_adjoint,
            learned_reference_points=cfg.reference_points == "learned")

        n_classes = cfg.n_classes + 1           # +1 dummy/background
        class_mult = n_classes if cfg.class_mode == "specific" else 1
        self.translation_head = nn.ModuleList(
            MLP(C, C, 3 * class_mult) for _ in range(cfg.dec_layers))
        self.rotation_head = nn.ModuleList(
            MLP(C, C, cfg.rot_dim * class_mult) for _ in range(cfg.dec_layers))
        if cfg.aleatoric:
            # s = log sigma^2 per axis, of the translation and of the rotation
            self.translation_head_aleatoric = nn.ModuleList(
                MLP(C, C, 3 * class_mult) for _ in range(cfg.dec_layers))
            self.rotation_head_aleatoric = nn.ModuleList(
                MLP(C, C, 3 * class_mult) for _ in range(cfg.dec_layers))

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

        # gt and jitter mode read no detections: the backbone skips its
        # decode and NMS (XLA drops them as dead code from poet_tpu's step)
        features, masks, backbone_dets = self.backbone(
            images, pad_mask, detections=cfg.bbox_mode == "backbone")
        pos = [self._embed_level(m) for m in masks]

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
        if self.query_embed is not None:
            query_embeds = self.query_embed.weight                     # (Q, 2C)
        else:
            embed = bbox_embedding_sine(t_boxes, num_pos_feats=C // 8)  # (B, Q, C)
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
            pos.append(self._embed_level(m))
        srcs = [s.permute(0, 2, 3, 1) for s in srcs]                    # NHWC

        reference_points = t_boxes[:, :, :2] if cfg.reference_points == "bbox" else None
        with span("transformer"):
            hs, _, _ = self.transformer(srcs, masks, pos, query_embeds, reference_points,
                                        generator)

        # ---- per-layer heads ----------------------------------------------
        output_idx = torch.where(t_classes > 0, t_classes, 0)
        heads = [self.translation_head, self.rotation_head]
        if cfg.aleatoric:
            heads += [self.translation_head_aleatoric, self.rotation_head_aleatoric]
        per_head = [[] for _ in heads]
        for lvl in range(cfg.dec_layers):
            for outs, head in zip(per_head, heads):
                out = head[lvl](hs[lvl])
                if cfg.class_mode == "specific":
                    out = self._select_class(out, output_idx)
                outs.append(out)
        translations, rotations = per_head[:2]
        rotations = [self._process_rotation(r) for r in rotations]
        out = {
            "translations": torch.stack(translations),   # (n_layers, B, Q, 3)
            "rotations": torch.stack(rotations),         # (n_layers, B, Q, 3, 3|4)
            "pred_boxes": t_boxes,                       # (B, Q, 4)
            "pred_classes": t_classes,                   # (B, Q)
            "pred_scores": t_scores,                     # (B, Q): detector scores in
            # backbone mode, 1 for valid gt/jitter queries
            "n_boxes": n_boxes,                          # (B,)
            "query_valid": valid_q,                      # (B, Q)
        }
        if cfg.aleatoric:
            out["translations_aleatoric"] = torch.stack(per_head[2])   # (n_layers, B, Q, 3)
            out["rotations_aleatoric"] = torch.stack(per_head[3])      # (n_layers, B, Q, 3)
        return out

    def _embed_level(self, mask: torch.Tensor) -> torch.Tensor:
        """A level's position embedding in the compute dtype: the learned
        tables or the sine embedding at `position_embedding_scale`."""
        if self.position_embedding is not None:
            return self.position_embedding(mask).to(self.compute_dtype)
        return add_position_embeddings([mask], self.cfg.hidden_dim, self.compute_dtype,
                                       scale=self.position_embedding_scale)[0]

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
