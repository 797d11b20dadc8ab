"""Multi-scale deformable attention sampling core — plain PyTorch version.

Counterpart of `poet_tpu/ops/deform_attn.py:ms_deform_attn_xla` (the
contract every JAX formulation and the Pallas kernels hold):

  * sampling locations are normalized to [0, 1] per level, (x, y) order,
  * bilinear interpolation with `align_corners=False` pixel mapping
    (pix = loc * size - 0.5) and ZERO padding outside the feature map,
  * output = sum over (levels, points) of attention weight * sampled value,
    accumulated in f32 and returned in the value dtype.

A sampling point with a NaN or infinite pixel coordinate follows the C1
rule that every CUDA kernel of the port shares
(`csrc/ms_deform_attn_point.cuh`): its (b, q, h) output row is NaN, as in
every JAX formulation; its d_attn and both of its d_loc coordinates are
NaN; it adds nothing to d_value. An explicit mask (`nonfinite_points`)
carries the rule, so the CPU (whose `F.grid_sample` returns NaN for such a
point) and CUDA (whose `F.grid_sample` drops it) give the same answer.

This and its adjoint `ms_deform_attn_torch_backward` are the CPU path of
`ops/deform_attn_cuda.py:ms_deform_attn` and the versions the CUDA kernels
are held against on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


# where a masked point samples: past every level's border, so grid_sample
# reads nothing there and its backward adds nothing
_OFF_MAP = -2.0


def nonfinite_points(spatial_shapes: Sequence[Tuple[int, int]],
                     sampling_locations: torch.Tensor) -> torch.Tensor:
    """(B, Q, H, L, P) bool: the points whose pixel coordinate
    loc * size - 0.5 is NaN or infinite on their level (the C1 rule)."""
    loc = sampling_locations.float()
    return torch.stack([~(torch.isfinite(loc[:, :, :, l, :, 0] * w - 0.5)
                          & torch.isfinite(loc[:, :, :, l, :, 1] * h - 0.5))
                        for l, (h, w) in enumerate(spatial_shapes)], dim=3)


def ms_deform_attn_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Deformable sampling through `F.grid_sample`, one call per level.

    Args:
      value: (B, S, H, D), S >= sum(Hl * Wl); padded tokens already zeroed.
      spatial_shapes: static (Hl, Wl) per level.
      sampling_locations: (B, Q, H, L, P, 2) normalized, (x, y) order.
      attention_weights: (B, Q, H, L, P), softmax-normalized over (L, P).

    Returns:
      (B, Q, H * D) in value.dtype.
    """
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L:
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for {L} levels")
    if sum(h * w for h, w in spatial_shapes) > S:
        raise ValueError(f"levels {tuple(spatial_shapes)} exceed S={S}")
    v = value.float()
    bad = nonfinite_points(spatial_shapes, sampling_locations)
    locs = torch.where(bad[..., None], _OFF_MAP, sampling_locations.float())
    attention_weights = torch.where(bad, 0.0, attention_weights.float())
    grids = 2.0 * locs - 1.0                           # grid_sample's [-1, 1]
    out = torch.zeros((B * H, D, Q), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        v_l = v[:, start:start + Hl * Wl].permute(0, 2, 3, 1).reshape(B * H, D, Hl, Wl)
        start += Hl * Wl
        grid = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        sampled = F.grid_sample(v_l, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)    # (B*H, D, Q, P)
        a = attention_weights[:, :, :, lvl].float().transpose(1, 2)
        out += (sampled * a.reshape(B * H, 1, Q, P)).sum(-1)
    # a constant NaN on the rows that met such a point: autograd still sends
    # dout to the row's other points, as JAX's gradient does
    nan_rows = torch.where(bad.flatten(-2).any(-1), float("nan"), 0.0)   # (B, Q, H)
    out = out.view(B, H, D, Q).permute(0, 3, 1, 2) + nan_rows[..., None]
    return out.reshape(B, Q, H * D).to(value.dtype)


def ms_deform_attn_torch_backward(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint of `ms_deform_attn_torch`, by autograd through it.

    dout is (B, Q, H * D) in value's dtype. Returns (d_value (B, S, H, D) in
    value's dtype, summed in f32, rows past sum(Hl * Wl) zero; d_loc
    (B, Q, H, L, P, 2) f32 w.r.t. the normalized locations; d_attn
    (B, Q, H, L, P) f32). The CPU path of the model's entry, and the version
    the two adjoint kernels are held against on the card. A point with a
    non-finite coordinate gets NaN in d_attn and in both d_loc coordinates
    and adds nothing to d_value (the C1 rule).
    """
    with torch.enable_grad():
        inputs = tuple(t.detach().requires_grad_()
                       for t in (value, sampling_locations, attention_weights))
        out = ms_deform_attn_torch(inputs[0], spatial_shapes, *inputs[1:])
        d_value, d_loc, d_attn = torch.autograd.grad(out, inputs, dout)
    bad = nonfinite_points(spatial_shapes, sampling_locations)
    return (d_value, torch.where(bad[..., None], float("nan"), d_loc),
            torch.where(bad, float("nan"), d_attn))
