"""Multi-scale deformable attention sampling core — plain PyTorch version.

Counterpart of `poet_tpu/ops/deform_attn.py:ms_deform_attn_xla` (the
contract every JAX formulation and the Pallas kernels hold):

  * sampling locations are normalized to [0, 1] per level, (x, y) order,
  * bilinear interpolation with `align_corners=False` pixel mapping
    (pix = loc * size - 0.5) and ZERO padding outside the feature map,
  * output = sum over (levels, points) of attention weight * sampled value,
    accumulated in f32 and returned in the value dtype.

This and its adjoint `ms_deform_attn_torch_backward` are the CPU path of
`ops/deform_attn_cuda.py:ms_deform_attn` and the versions the CUDA kernels
are held against on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


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
    grids = 2.0 * sampling_locations.float() - 1.0     # grid_sample's [-1, 1]
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
    out = out.view(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
    return out.to(value.dtype)


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
    the two adjoint kernels are held against on the card.
    """
    with torch.enable_grad():
        inputs = tuple(t.detach().requires_grad_()
                       for t in (value, sampling_locations, attention_weights))
        out = ms_deform_attn_torch(inputs[0], spatial_shapes, *inputs[1:])
        return torch.autograd.grad(out, inputs, dout)
