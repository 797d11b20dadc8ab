"""The flagship serving configuration and its synthetic batch.

Numpy-only twin of `__graft_entry__.py:_flagship_setup`: the paper config
(5 enc / 5 dec / 16 heads, hidden 256, 10 queries, 4 levels x 4 points,
gt bbox mode, class-specific heads, 6D rotations, sine embeddings) on the
Mask R-CNN feature backbone, and a YCB-V-shaped batch drawn from the same
seeded numpy stream, so both packages see the same arrays.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from poet_tpu_torch.config import ModelConfig, PoETConfig


def flagship_config(dtype: str = "bfloat16") -> PoETConfig:
    cfg = PoETConfig()
    cfg.backbone.name = "maskrcnn"
    cfg.model.dtype = dtype
    return cfg


def flagship_batch(B: int, H: int = 480, W: int = 640, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """(images (B,H,W,3) f32 in [0,1], pad_mask (B,H,W) bool, targets), the
    arrays `_flagship_setup(B, H, W, seed)` builds, in the same draw order."""
    rng = np.random.default_rng(seed)
    model_cfg = ModelConfig()
    Q, n_classes = model_cfg.num_queries, model_cfg.n_classes
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    pad_mask = np.zeros((B, H, W), dtype=bool)
    n_boxes = np.minimum(rng.integers(1, Q + 1, size=(B,)), Q).astype(np.int32)
    boxes = rng.uniform(0.2, 0.7, size=(B, Q, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.2, size=(B, Q, 2)).astype(np.float32)
    labels = rng.integers(1, n_classes + 1, size=(B, Q)).astype(np.int32)
    for b in range(B):
        boxes[b, n_boxes[b]:] = -1.0
        labels[b, n_boxes[b]:] = -1
    # random rotations via QR
    a = rng.normal(size=(B * Q, 3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    det = np.linalg.det(q)
    q[:, :, 0] *= det[:, None]
    targets = {
        "boxes": boxes,
        "labels": labels,
        "n_boxes": n_boxes,
        "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
        "relative_rotation": q.reshape(B, Q, 3, 3).astype(np.float32),
    }
    return images, pad_mask, targets
