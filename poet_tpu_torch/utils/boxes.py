"""Bounding-box math. Counterpart of `poet_tpu/utils/boxes.py`: cxcywh <->
xyxy, normalization and rescaling by the image size, pairwise IoU and GIoU,
and the boxes of binary masks."""

from __future__ import annotations

from typing import Tuple

import torch

from poet_tpu_torch.utils.tables import device_table


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) cxcywh -> xyxy."""
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> cxcywh."""
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_normalize_cxcywh(x: torch.Tensor, image_size) -> torch.Tensor:
    """Normalize (..., 4) cxcywh by the image's (H, W).

    A true division by a tensor, as in JAX: PyTorch on CUDA multiplies by
    the reciprocal when the divisor is a Python number, one ulp off, and the
    dyadic box embedding (`ops/embeddings.py:bbox_embedding_sine`, up to
    2^31 x the coordinate) turns one ulp into another pose."""
    return x / _image_scale(float(image_size[1]), float(image_size[0]), x.dtype, x.device)


def box_rescale_cxcywh(x: torch.Tensor, image_size) -> torch.Tensor:
    """(..., 4) normalized cxcywh back to pixels of the image's (H, W)."""
    return x * _image_scale(float(image_size[1]), float(image_size[0]), x.dtype, x.device)


def box_normalize_xyxy(x: torch.Tensor, image_size) -> torch.Tensor:
    """Normalize (..., 4) xyxy by the image's (H, W), a true division as
    `box_normalize_cxcywh`'s."""
    return x / _image_scale(float(image_size[1]), float(image_size[0]), x.dtype, x.device)


def box_rescale_xyxy(x: torch.Tensor, image_size) -> torch.Tensor:
    """(..., 4) normalized xyxy back to pixels of the image's (H, W)."""
    return x * _image_scale(float(image_size[1]), float(image_size[0]), x.dtype, x.device)


@device_table
def _image_scale(iw: float, ih: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per image size and device: a tensor built from a host list
    # on every call would be a blocking copy
    return torch.tensor([iw, ih, iw, ih], dtype=dtype, device=device)


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


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) binary masks -> (N, 4) xyxy f32 boxes of their set pixels;
    (0, 4) for no masks. An empty mask's minima stay at the 1e8 sentinel and
    its maxima at 0, as in JAX."""
    if masks.numel() == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=masks.device)
    n, (h, w) = masks.shape[0], masks.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=masks.device),
                            torch.arange(w, dtype=torch.float32, device=masks.device),
                            indexing="ij")
    m, on = masks.float(), masks.bool()
    x_max = (m * xx).reshape(n, -1).amax(-1)
    y_max = (m * yy).reshape(n, -1).amax(-1)
    x_min = torch.where(on, xx, 1e8).reshape(n, -1).amin(-1)
    y_min = torch.where(on, yy, 1e8).reshape(n, -1).amin(-1)
    return torch.stack([x_min, y_min, x_max, y_max], dim=1)
