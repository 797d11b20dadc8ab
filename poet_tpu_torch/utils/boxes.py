"""Bounding-box math. Counterpart of `poet_tpu/utils/boxes.py:13-85`: what
the matcher needs (cxcywh -> xyxy, pairwise IoU and GIoU)."""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) cxcywh -> xyxy."""
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> ((N, M) iou, (N, M) union)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of (N, 4) x (M, 4) xyxy boxes -> (N, M). No degeneracy
    asserts: padded/dummy boxes are the caller's to mask out."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area
