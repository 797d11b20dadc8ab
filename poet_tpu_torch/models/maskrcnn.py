"""Mask R-CNN detection heads (RPN + box RoI heads), inference only.

Counterpart of `poet_tpu/models/maskrcnn.py`, the torchvision detection
stack the reference drives for bbox_mode='backbone'. Submodules carry the
reference checkpoint's names (`rpn.head.{conv,cls_logits,bbox_pred}`,
`roi_heads.box_head.{fc6,fc7}`, `roi_heads.box_predictor.{cls_score,
bbox_pred}`), so torchvision state_dicts load as they are.

Shapes are fixed, as in JAX: per-level top-k, NMS and per-class filtering
keep padded candidate sets with validity masks (`ops/detection.py`). The
port batches what JAX vmaps: every image and every RPN level run one NMS
fixed point (each level's candidates padded to `PRE_NMS_TOP_N` with -inf),
and the final per-class NMS takes the certified pruned fast path for the
whole batch, falling back to the exact per-class suppression when any
image's certificate fails (the `cond` operator: one host read of the
certificates; a `torch.export`ed program holds both branches).

Compute dtype (`poet_tpu/models/backbone.py:53-69`): at f32 every head
runs f32; at bf16 the RPN convs, fc6/fc7 and the predictor run bf16 on the
native bf16 maps. Head outputs are f32, and every ranking step (top-k,
box decode, softmax, NMS) is f32 in both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._higher_order_ops.cond import cond_op

from poet_tpu_torch.models.layers import Conv, Dense
from poet_tpu_torch.ops.detection import (
    NEG_INF,
    batched_class_nms,
    class_nms_select_pruned,
    exact_class_nms_mask,
    nms_keep_mask,
    topk,
)
from poet_tpu_torch.ops.roi_align_cuda import multiscale_roi_align
from poet_tpu_torch.utils.tables import device_table
from poet_tpu_torch.utils.tracing import traced

# torchvision GeneralizedRCNN defaults (used by MaskRCNN in the reference)
ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ASPECT_RATIOS = (0.5, 1.0, 2.0)
PRE_NMS_TOP_N = 1000
POST_NMS_TOP_N = 1000
RPN_NMS_THRESH = 0.7
RPN_MIN_SIZE = 1e-3
BOX_SCORE_THRESH = 0.05
BOX_NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
LEVELS = ("0", "1", "2", "3", "pool")


def generate_anchors(grid_sizes, strides, sizes=ANCHOR_SIZES, ratios=ASPECT_RATIOS):
    """Per-level anchor grids (numpy). torchvision AnchorGenerator: h =
    s*sqrt(r), w = s/sqrt(r), rounded base anchors centred at 0, shifted by
    stride * (x, y); `strides` entries are scalars or (sy, sx) pairs."""
    all_anchors = []
    for (gh, gw), stride, size in zip(grid_sizes, strides, sizes):
        sy_stride, sx_stride = stride if isinstance(stride, (tuple, list)) else (stride, stride)
        s = np.asarray(size, dtype=np.float32)
        r = np.asarray(ratios, dtype=np.float32)
        h_r = np.sqrt(r)
        w_r = 1.0 / h_r
        ws = (w_r[:, None] * s[None, :]).reshape(-1)
        hs = (h_r[:, None] * s[None, :]).reshape(-1)
        base = np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0)
        sx = np.arange(gw, dtype=np.float32) * sx_stride
        sy = np.arange(gh, dtype=np.float32) * sy_stride
        yy, xx = np.meshgrid(sy, sx, indexing="ij")
        shifts = np.stack([xx, yy, xx, yy], axis=-1).reshape(-1, 1, 4)
        all_anchors.append((shifts + base[None]).reshape(-1, 4).astype(np.float32))
    return all_anchors


@device_table
def anchor_grids(grid_sizes, strides, sizes, device) -> Tuple[torch.Tensor, ...]:
    """`generate_anchors` on `device`, made once per grid, strides and sizes."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in generate_anchors(grid_sizes, strides, sizes=sizes))


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """torchvision BoxCoder.decode: (..., 4) deltas + (..., 4) xyxy anchors."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    cx = anchors[..., 0] + 0.5 * widths
    cy = anchors[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    H, W = image_size
    x = boxes[..., 0::2].clamp(0, W)
    y = boxes[..., 1::2].clamp(0, H)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def _pruned_selection(boxes_pc, masked, labels_pc, sel, keep_valid):
    """The certified pruned selection, as the `cond` branch beside the exact one."""
    return sel.long(), keep_valid.clone()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, k) rows at idx (..., M) -> (..., M, k)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


class RPNHead(nn.Module):
    """torchvision RPNHead: shared 3x3 conv + 1x1 objectness / deltas.
    NHWC levels in, per level (B, H, W, A) logits and (B, H, W, 4A) deltas
    out, both f32."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, in_channels, 3, padding=1, compute_dtype=dtype)
        self.cls_logits = Conv(in_channels, num_anchors, 1, compute_dtype=dtype)
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 1, compute_dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f.permute(0, 3, 1, 2)))
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).float())
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1).float())
        return logits, deltas


class TwoMLPHead(nn.Module):
    """torchvision TwoMLPHead (fc6/fc7, 1024 each) on pooled (N, o, o, C)
    blocks. fc6 keeps torchvision's (1024, C*o*o) weight in (C, o, o) order;
    each forward reorders the weight (12.8 M values at C=256) to the
    block's (o, o, C) order instead of transposing the pooled block (401 MB
    of bf16 at 16 x 1000 boxes)."""

    def __init__(self, in_channels: int = 256, output_size: int = 7,
                 representation: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels, self.output_size = in_channels, output_size
        self.fc6 = Dense(in_channels * output_size ** 2, representation, dtype)
        self.fc7 = Dense(representation, representation, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C, o, dt = self.in_channels, self.output_size, self.fc6.compute_dtype
        w = self.fc6.weight.to(dt).view(-1, C, o, o).permute(0, 2, 3, 1).reshape(-1, o * o * C)
        x = F.relu(F.linear(x.reshape(x.shape[0], -1).to(dt), w, self.fc6.bias.to(dt)))
        return F.relu(self.fc7(x))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Dense(in_channels, num_classes, dtype)
        self.bbox_pred = Dense(in_channels, num_classes * 4, dtype)

    def forward(self, x: torch.Tensor):
        # scores and deltas feed f32 softmax, box decode and NMS ranking
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskRCNNDetector(nn.Module):
    """RPN + box RoI heads over the FPN level dict {'0'..'3', 'pool'}
    (NHWC, in the compute dtype). `forward` returns {boxes (B, K, 4) xyxy
    pixels, scores (B, K), labels (B, K) int32, valid (B, K)}, K =
    `max_detections`, score-descending with the valid rows first.

    `nms_prune_k` sizes the certified pruned fast path of the final NMS (0
    disables it); the output is the exact per-class NMS either way.
    `nms_candidates` (None or 0: off, the default) is JAX's opt-in cap: the
    final NMS suppresses only the score-top-`nms_candidates` candidates,
    with no exactness fallback, so a saturated cap can keep other boxes
    than the exact NMS would (`poet_tpu/models/maskrcnn.py:455-470`).
    """

    def __init__(self, num_classes: int, max_detections: int = DETECTIONS_PER_IMG,
                 score_thresh: float = BOX_SCORE_THRESH, nms_thresh: float = BOX_NMS_THRESH,
                 post_nms_top_n: int = POST_NMS_TOP_N, nms_prune_k: int = 1024,
                 nms_candidates: Optional[int] = None,
                 anchor_sizes: Optional[Tuple[Tuple[int, ...], ...]] = None,
                 in_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.max_detections = max_detections
        self.score_thresh, self.nms_thresh = score_thresh, nms_thresh
        self.post_nms_top_n = post_nms_top_n
        self.nms_prune_k = nms_prune_k
        self.nms_candidates = nms_candidates
        self.anchor_sizes = tuple(anchor_sizes or ANCHOR_SIZES)
        n_anchors = len(self.anchor_sizes[0]) * len(ASPECT_RATIOS)
        self.rpn = nn.ModuleDict({"head": RPNHead(in_channels, n_anchors, dtype)})
        self.roi_heads = nn.ModuleDict({
            "box_head": TwoMLPHead(in_channels, 7, 1024, dtype),
            "box_predictor": FastRCNNPredictor(1024, num_classes, dtype)})

    def anchors(self, grid_sizes, strides, device) -> Tuple[torch.Tensor, ...]:
        return anchor_grids(tuple(grid_sizes), tuple(strides), self.anchor_sizes,
                            torch.device(device))

    @traced("detector.select")
    def proposals(self, logits, deltas, anchors, image_size):
        """Per image: per-level top-k, decode, clip, min-size, NMS; then the
        top `post_nms_top_n` over the levels -> (boxes (B, P, 4), objectness
        logits (B, P), -inf where invalid). All images and levels share one
        NMS fixed point."""
        B = logits[0].shape[0]
        K = PRE_NMS_TOP_N
        cand_boxes, cand_scores, ks = [], [], []
        for lg, dl, anc in zip(logits, deltas, anchors):
            obj = lg.reshape(B, -1)                                   # (B, H*W*A)
            dts = dl.reshape(B, obj.shape[1], 4)
            k = min(K, obj.shape[1])
            top_s, top_i = topk(obj, k)
            boxes = clip_boxes(decode_boxes(_gather_rows(dts, top_i), anc[top_i]), image_size)
            valid = ((boxes[..., 2] - boxes[..., 0]) >= RPN_MIN_SIZE) & \
                    ((boxes[..., 3] - boxes[..., 1]) >= RPN_MIN_SIZE)
            scores = torch.where(valid, top_s, NEG_INF)
            cand_boxes.append(F.pad(boxes, (0, 0, 0, K - k)))
            cand_scores.append(F.pad(scores, (0, K - k), value=NEG_INF))
            ks.append(k)
        boxes = torch.stack(cand_boxes, 1)                            # (B, L, K, 4)
        scores = torch.stack(cand_scores, 1)                          # (B, L, K)
        keep = nms_keep_mask(boxes, scores, RPN_NMS_THRESH)
        kept_s, kept_i = topk(torch.where(keep, scores, NEG_INF), K)
        lvl_boxes, lvl_scores = [], []
        for lv, k in enumerate(ks):
            m = min(self.post_nms_top_n, k)
            kv = kept_s[:, lv, :m] > NEG_INF
            idx = torch.where(kv, kept_i[:, lv, :m], 0)
            lvl_boxes.append(_gather_rows(boxes[:, lv], idx))
            lvl_scores.append(torch.where(kv, torch.gather(scores[:, lv], -1, idx), NEG_INF))
        all_boxes, all_scores = torch.cat(lvl_boxes, 1), torch.cat(lvl_scores, 1)
        top_s, top_i = topk(all_scores, min(self.post_nms_top_n, all_scores.shape[1]))
        return _gather_rows(all_boxes, top_i), top_s

    @traced("detector.select")
    def select(self, boxes_pc, masked, labels_pc):
        """Per-class NMS + top-`max_detections` of (B, PN) candidates ->
        (sel (B, md) indices, keep_valid (B, md)). With the pruned fast path
        the certificate picks between it and the exact selection through the
        `cond` operator: one host read for the batch, and a traced program
        (`torch.export`) holds both branches. With `nms_candidates` set, the
        capped selection instead."""
        md, PN = self.max_detections, masked.shape[1]
        if self.nms_candidates:
            return self._capped(boxes_pc, masked, labels_pc)
        prune_k = self.nms_prune_k
        if not (prune_k and PN > prune_k > md):
            return self._exact(boxes_pc, masked, labels_pc)
        sel, keep_valid, cert = class_nms_select_pruned(
            boxes_pc, masked, labels_pc, self.nms_thresh, md, prune_k)
        return cond_op(cert.all(), _pruned_selection, self._exact,
                       (boxes_pc, masked, labels_pc, sel, keep_valid))

    def _exact(self, boxes_pc, masked, labels_pc, *pruned):
        """Exact per-class NMS of every candidate + top-`max_detections`."""
        keep = exact_class_nms_mask(boxes_pc, masked, self.num_classes, self.nms_thresh)
        top_s, sel = topk(torch.where(keep, masked, NEG_INF), self.max_detections)
        keep_valid = torch.isfinite(top_s)
        return torch.where(keep_valid, sel, 0), keep_valid

    def _capped(self, boxes_pc, masked, labels_pc):
        """Class-offset NMS over the score-top-`nms_candidates` candidates
        alone, their indices mapped back (an invalid slot holds the top
        candidate's index, as in JAX)."""
        cand_scores, cand_i = topk(masked, min(self.nms_candidates, masked.shape[1]))
        keep_idx, keep_valid = batched_class_nms(
            _gather_rows(boxes_pc, cand_i), cand_scores, labels_pc[cand_i],
            torch.isfinite(cand_scores), self.nms_thresh, self.max_detections)
        return torch.gather(cand_i, 1, keep_idx.long()), keep_valid

    def forward(self, fpn_feats: Dict[str, torch.Tensor], image_size) -> Dict[str, torch.Tensor]:
        feats = [fpn_feats[k] for k in LEVELS]
        dev = feats[0].device
        grid_sizes = [tuple(f.shape[1:3]) for f in feats]
        # torchvision computes strides per axis: image_size // grid_size
        strides = [(image_size[0] // g[0], image_size[1] // g[1]) for g in grid_sizes]
        logits, deltas = self.rpn["head"](feats)
        prop_boxes, prop_scores = self.proposals(
            logits, deltas, self.anchors(grid_sizes, strides, dev), image_size)
        # RoI heads: levels 0-3, the whole batch in one kernel launch
        pooled = multiscale_roi_align([f.contiguous() for f in feats[:4]],
                                      [s[0] for s in strides[:4]], prop_boxes,
                                      output_size=7, sampling_ratio=2)   # (B, P, 7, 7, C)
        class_logits, box_deltas = self.box_heads(pooled)
        return self.detections(class_logits, box_deltas, prop_boxes, prop_scores, image_size)

    def box_heads(self, pooled: torch.Tensor):
        """fc6/fc7 + predictor over the (B, P, o, o, C) pooled block, the
        whole batch in one matmul each -> f32 (B*P, ncls), (B*P, 4 ncls)."""
        x = self.roi_heads["box_head"](pooled.reshape(-1, *pooled.shape[2:]))
        return self.roi_heads["box_predictor"](x)

    def detections(self, class_logits, box_deltas, prop_boxes, prop_scores, image_size):
        """Per-class decode (weights (10, 10, 5, 5)), score/size filters,
        per-class NMS and the top `max_detections`."""
        B, P = prop_boxes.shape[:2]
        ncls = self.num_classes
        PN = P * ncls
        dev = prop_boxes.device
        scores_pc = torch.softmax(class_logits, dim=-1).reshape(B, PN)
        labels_pc = torch.arange(ncls, device=dev).repeat(P)           # proposal-major
        boxes_pc = clip_boxes(decode_boxes(box_deltas.reshape(B, PN, 4),
                                           prop_boxes.repeat_interleave(ncls, dim=1),
                                           weights=(10.0, 10.0, 5.0, 5.0)), image_size)
        valid_pc = ((labels_pc > 0)                                      # drop background
                    & (scores_pc > self.score_thresh)
                    & torch.isfinite(prop_scores).repeat_interleave(ncls, dim=1)
                    & ((boxes_pc[..., 2] - boxes_pc[..., 0]) >= 1e-2)    # remove_small 0.01
                    & ((boxes_pc[..., 3] - boxes_pc[..., 1]) >= 1e-2))
        masked = torch.where(valid_pc, scores_pc, NEG_INF)
        sel, keep_valid = self.select(boxes_pc, masked, labels_pc)
        return {
            "boxes": _gather_rows(boxes_pc, sel),
            "scores": torch.where(keep_valid, torch.gather(scores_pc, 1, sel), 0.0),
            "labels": torch.where(keep_valid, labels_pc[sel], -1).to(torch.int32),
            "valid": keep_valid,
        }
