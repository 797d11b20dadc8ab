"""Positional embeddings. Counterpart of `poet_tpu/ops/embeddings.py`.

Images and features are channels-last (B, H, W, C), as in the JAX package.
"""

from __future__ import annotations

import math

import torch


def position_embedding_sine(
    pad_mask: torch.Tensor,
    num_pos_feats: int = 128,
    scale: float = 2 * math.pi,
) -> torch.Tensor:
    """2D sine embedding (normalized, temperature 10000) from a (B, H, W)
    bool mask, True on padded pixels; f32.

    Returns (B, H, W, 2 * num_pos_feats): y-features first, then x-features.
    """
    not_mask = (~pad_mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps = 1e-6
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pad_mask.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # interleave sin/cos as the reference's stack(...).flatten(3)
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=4).flatten(3)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=4).flatten(3)
    return torch.cat([pos_y, pos_x], dim=3)


def bbox_embedding_sine(bboxes: torch.Tensor, num_pos_feats: int = 32) -> torch.Tensor:
    """Dyadic sine/cosine embedding of (..., 4) cxcywh boxes.

    Returns (..., 8 * num_pos_feats): per coordinate (x, y, w, h),
    concat(sin(c * 2^k), cos(c * 2^k)) for k in [0, num_pos_feats).
    """
    dim_t = 2.0 ** torch.arange(num_pos_feats, dtype=bboxes.dtype,
                                device=bboxes.device)
    enc = bboxes[..., :, None] * dim_t                  # (..., 4, npf)
    enc = torch.cat([enc.sin(), enc.cos()], dim=-1)     # (..., 4, 2*npf)
    return enc.reshape(*bboxes.shape[:-1], 8 * num_pos_feats)
