"""Pose matcher — bipartite prediction/target assignment.

Counterpart of `poet_tpu/models/matcher.py:match_poses`: the same costs per
bbox_mode (gt: L1 of full boxes; jitter: class mismatch; backbone: center
L1 + class mismatch, then the GIoU / class post-filter), the same square
padding with BIG_COST, the same certified identity shortcut and the same JV
solver (`ops/hungarian.py`), so the port and `poet_tpu` pick the same pairs.

One matching serves every decoder layer (the matcher reads only the boxes
and classes the layers share). In gt and jitter mode those depend only on
the targets (`models/poet.py:gt_queries`), so the trainer matches on the
host from the CPU targets, before the upload (`engine/train.py`), and the
step holds no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from poet_tpu_torch.ops.hungarian import hungarian
from poet_tpu_torch.utils.boxes import box_cxcywh_to_xyxy

BIG_COST = 1e6


class MatchResult(NamedTuple):
    """Assignment as fixed-size tensors.

    tgt_idx: (B, Q) int32 — target slot assigned to each prediction slot.
    valid:   (B, Q) bool — True where the pair is a real (kept) match.
    """

    tgt_idx: torch.Tensor
    valid: torch.Tensor

    @property
    def num_matched(self) -> torch.Tensor:
        return self.valid.sum()

    def to(self, device) -> "MatchResult":
        return MatchResult(self.tgt_idx.to(device, non_blocking=True),
                           self.valid.to(device, non_blocking=True))


def match_poses(
    pred_boxes: torch.Tensor,     # (B, Q, 4) cxcywh normalized (dummy = -1s)
    pred_classes: torch.Tensor,   # (B, Q) int (dummy = -1)
    tgt_boxes: torch.Tensor,      # (B, Q, 4)
    tgt_labels: torch.Tensor,     # (B, Q) int (dummy = -1)
    n_pred: torch.Tensor,         # (B,) number of real predictions
    n_tgt: torch.Tensor,          # (B,) number of real targets
    bbox_mode: str = "gt",
    class_mode: str = "specific",
    cost_bbox: float = 1.0,
    cost_class: float = 1.0,
    giou_thresh: float = 0.5,
) -> MatchResult:
    """Match predictions to targets. Runs where its inputs lie; the solver
    (when the identity certificate fails) runs on the host."""
    B, Q = pred_classes.shape
    dev = pred_classes.device
    f32 = torch.float32

    if bbox_mode == "gt":
        cost = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
        cost = cost.to(f32) * cost_bbox
    elif bbox_mode == "jitter":
        mismatch = (pred_classes[:, :, None] != tgt_labels[:, None, :]).to(f32)
        cost = mismatch * cost_class
    elif bbox_mode == "backbone":
        center_l1 = (pred_boxes[:, :, None, :2] - tgt_boxes[:, None, :, :2]).abs().sum(-1)
        mismatch = (pred_classes[:, :, None] != tgt_labels[:, None, :]).to(f32)
        cost = cost_bbox * center_l1.to(f32) + cost_class * mismatch
    else:
        raise NotImplementedError(f"bbox_mode {bbox_mode}")

    # square padding: rows beyond n_pred / cols beyond n_tgt cost BIG_COST
    # everywhere, which keeps the rectangular optimum
    ids = torch.arange(Q, device=dev)
    pad = ((ids[None, :, None] >= n_pred[:, None, None])
           | (ids[None, None, :] >= n_tgt[:, None, None]))
    cost = torch.where(pad, torch.full_like(cost, BIG_COST), cost)

    # certified identity shortcut: costs are >= 0, so a zero diagonal over
    # the valid prefix (every element of the batch) is the optimum — the
    # training case in gt/jitter mode, whose queries ARE the targets in order
    diag = torch.diagonal(cost, dim1=1, dim2=2)
    prefix = ids[None, :] < torch.minimum(n_pred, n_tgt)[:, None]
    if bool((torch.where(prefix, diag, torch.zeros_like(diag)) == 0.0).all()):
        tgt_idx = ids.to(torch.int32)[None].expand(B, Q).clone()
    else:
        tgt_idx = hungarian(cost).to(dev)
    valid = (ids[None, :] < n_pred[:, None]) & (tgt_idx < n_tgt[:, None])

    if bbox_mode == "backbone":
        # post-filter: drop matches with GIoU < giou_thresh, and in specific
        # mode those whose predicted class disagrees
        idx = tgt_idx.long()
        matched = torch.gather(tgt_boxes, 1, idx[..., None].expand(B, Q, 4))
        valid &= pairwise_diag_giou(pred_boxes, matched) >= giou_thresh
        if class_mode == "specific":
            valid &= pred_classes == torch.gather(tgt_labels, 1, idx)

    return MatchResult(tgt_idx=tgt_idx, valid=valid)


def pairwise_diag_giou(boxes1_cxcywh: torch.Tensor, boxes2_cxcywh: torch.Tensor) -> torch.Tensor:
    """GIoU of corresponding (B, Q, 4) box pairs (the pair matrix's diagonal).
    Counterpart of `poet_tpu/models/matcher.py:_pairwise_diag_giou`."""
    b1 = box_cxcywh_to_xyxy(boxes1_cxcywh)
    b2 = box_cxcywh_to_xyxy(boxes2_cxcywh)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union
    lt_e = torch.minimum(b1[..., :2], b2[..., :2])
    rb_e = torch.maximum(b1[..., 2:], b2[..., 2:])
    wh_e = torch.clamp(rb_e - lt_e, min=0)
    enc = wh_e[..., 0] * wh_e[..., 1]
    return iou - (enc - union) / enc
