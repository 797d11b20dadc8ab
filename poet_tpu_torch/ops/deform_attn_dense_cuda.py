"""The dense route of deformable attention: `enc_deform_impl` /
`dec_deform_impl` = 'pallas'.

Counterpart of `poet_tpu/ops/deform_attn_pallas.py:ms_deform_attn_pallas`,
whose TPU kernels build a dense one-hot sampling matrix (queries x a level's
zero-bordered tokens) and multiply it with the value slab on the matrix
unit. The Hopper kernels (`csrc/ms_deform_attn_dense.cu`) do the same on the
tensor cores, chunked along the tokens; the adjoint sums d_value = W^T dout
over the query tiles inside a block, without atomics (the same bits from run
to run), and gathers d_loc / d_attn at each point's corners.

`ms_deform_attn_dense` is a `torch.autograd.Function`: CPU tensors run the
plain PyTorch forward and backward (`ops/deform_attn.py`, the same as the
gather route's), CUDA tensors launch the two kernels or raise. Importing
this module builds nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from poet_tpu_torch.ops.cuda_build import (
    DENSE_LIB,
    DTYPE_CODE,
    level_hw,
    stream_of,
    vec_width,
)
from poet_tpu_torch.ops.deform_attn import (
    ms_deform_attn_torch,
    ms_deform_attn_torch_backward,
)
from poet_tpu_torch.ops.deform_attn_cuda import _check_inputs


def padded_tokens(spatial_shapes: Sequence[Tuple[int, int]]) -> int:
    """S_pad = sum over levels of (Hl + 2) * (Wl + 2): the columns of the
    dense sampling matrix (each level with its one-token zero border)."""
    return sum((h + 2) * (w + 2) for h, w in spatial_shapes)


class MSDeformAttnDenseForward:
    """Launches the dense one-hot forward kernel; same contract as
    `ms_deform_attn_torch`, CUDA tensors only. `launches` counts launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        lib = DENSE_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_dense_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), stream_of(value))
        DENSE_LIB.check(rc, "ms_deform_attn_dense_fwd")
        self.launches += 1
        return out


class MSDeformAttnDenseAdjoint:
    """Launches the dense one-hot adjoint kernel: (d_value (B, S, H, D) in
    value's dtype, summed in f32 in a fixed order, rows past sum(Hl * Wl)
    exactly 0; d_loc (B, Q, H, L, P, 2) f32 with respect to the normalized
    locations; d_attn (B, Q, H, L, P) f32), as the merged adjoint returns.
    CUDA tensors only; `launches` counts launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        lib = DENSE_LIB.build()
        # the kernel writes every token row of the levels, and no other
        S_lv = sum(h * w for h, w in spatial_shapes)
        d_value = (torch.empty if S == S_lv else torch.zeros)(
            (B, S, H, D), dtype=value.dtype, device=value.device)
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        vec = min(vec_width(value, D), vec_width(dout, D))
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_dense_bwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_value.data_ptr(),
                d_loc.data_ptr(), d_attn.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, stream_of(value))
        DENSE_LIB.check(rc, "ms_deform_attn_dense_bwd")
        self.launches += 1
        return d_value, d_loc, d_attn


MS_DEFORM_ATTN_DENSE_FWD = MSDeformAttnDenseForward()
MS_DEFORM_ATTN_DENSE_BWD = MSDeformAttnDenseAdjoint()
KERNELS = (MS_DEFORM_ATTN_DENSE_FWD, MS_DEFORM_ATTN_DENSE_BWD)


class _MSDeformAttnDense(torch.autograd.Function):
    """Deformable sampling with its adjoint: CPU -> plain versions, CUDA ->
    the two dense kernels."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        if value.device.type == "cpu":
            return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                        attention_weights)
        return MS_DEFORM_ATTN_DENSE_FWD(value, spatial_shapes, sampling_locations,
                                        attention_weights)

    @staticmethod
    def backward(ctx, dout):
        value, locs, attn = ctx.saved_tensors
        dout = dout.contiguous()
        if value.device.type == "cpu":
            grads = ms_deform_attn_torch_backward(value, ctx.spatial_shapes, locs, attn, dout)
        else:
            grads = MS_DEFORM_ATTN_DENSE_BWD(value, ctx.spatial_shapes, locs, attn, dout)
        d_value, d_loc, d_attn = grads
        return d_value, None, d_loc, d_attn


def ms_deform_attn_dense(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """The 'pallas' deformable-attention entry (differentiable), same
    contract as `ops/deform_attn_cuda.py:ms_deform_attn`: CPU -> plain
    version, CUDA -> the dense one-hot kernels (which raise on what they do
    not take)."""
    return _MSDeformAttnDense.apply(value, tuple(spatial_shapes), sampling_locations,
                                    attention_weights)
