"""The gather route of deformable attention: its entry, its Hopper kernels'
wrappers and its adjoint.

`ms_deform_attn` is the entry the model calls for every `enc_deform_impl` /
`dec_deform_impl` but 'pallas' (that one is `ops/deform_attn_dense_cuda.py`;
the table is `config.DEFORM_IMPLS`). It is a `torch.autograd.Function`:
  * CPU tensors run the plain PyTorch forward and backward
    (`ops/deform_attn.py`);
  * CUDA tensors launch the hand-written kernels — the forward
    `csrc/ms_deform_attn_fwd.cu`, and in the backward, by its `adjoint`
    argument, either the pair of `csrc/ms_deform_attn_bwd.cu` (the d_value
    scatter and the d_loc/d_attn gather) or the merged kernel of the same
    file (all three gradients in one pass) — or raise.
There is no fallback from one to the other.

The kernels are built by `ops/cuda_build.py` (nvcc at first use, loaded
with ctypes); this module re-exports its `CudaLibrary`, `build_all`,
`BUILD_DIR`, `NVCC_FLAGS` and `LIBRARIES`. Importing it builds nothing
and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from poet_tpu_torch.ops.cuda_build import (  # noqa: F401  (re-exported)
    BUILD_DIR,
    BWD_LIB,
    DTYPE_CODE,
    FWD_LIB,
    LIBRARIES,
    NVCC_FLAGS,
    CudaLibrary,
    build_all,
    level_hw,
    stream_of,
    vec_width,
)
from poet_tpu_torch.ops.deform_attn import (
    ms_deform_attn_torch,
    ms_deform_attn_torch_backward,
)

_MAX_LEVELS = 8                     # POET_MAX_LEVELS in the sources


def _check_inputs(value, spatial_shapes, locs, attn, dout=None):
    """Validate the operands a kernel takes; returns (B, S, Q, H, D, L, P)."""
    tensors = (value, locs, attn) + (() if dout is None else (dout,))
    if value.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {value.device}")
    if any(t.device != value.device for t in tensors):
        raise ValueError("value, locations, attention (and dout) must share one device")
    if value.dtype not in DTYPE_CODE:
        raise TypeError(f"value dtype {value.dtype} not in (float32, bfloat16)")
    if locs.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("sampling locations and attention weights must be float32")
    if value.dim() != 4 or locs.dim() != 6 or attn.dim() != 5:
        raise ValueError("expected value (B,S,H,D), locations (B,Q,H,L,P,2), "
                         "attention (B,Q,H,L,P)")
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    if tuple(locs.shape) != (B, Q, H, L, P, 2) or tuple(attn.shape) != (B, Q, H, L, P):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, locations "
                         f"{tuple(locs.shape)}, attention {tuple(attn.shape)}")
    if dout is not None and (dout.dtype != value.dtype
                             or tuple(dout.shape) != (B, Q, H * D)):
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} != "
                         f"{(B, Q, H * D)} {value.dtype}")
    if len(spatial_shapes) != L or not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for {L} levels "
                         f"(at most {_MAX_LEVELS})")
    if sum(h * w for h, w in spatial_shapes) > S:
        raise ValueError(f"levels {tuple(spatial_shapes)} exceed S={S}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("value, locations, attention and dout must be contiguous")
    return B, S, Q, H, D, L, P


class MSDeformAttnForward:
    """Launches the forward kernel (`csrc/ms_deform_attn_fwd.cu`).

    `launches` counts kernel launches made through `__call__`, and nothing
    else: a run that reads it before and after a forward learns how many
    times the model went through the kernel.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        """Same contract as `ms_deform_attn_torch`; CUDA tensors only."""
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        lib = FWD_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec_width(value, D),
                stream_of(value))
        FWD_LIB.check(rc, "ms_deform_attn_fwd")
        self.launches += 1
        return out


class MSDeformAttnDValue:
    """Launches the d_value scatter kernel (`csrc/ms_deform_attn_bwd.cu`).

    Returns d_value (B, S, H, D) in value's dtype, summed in an f32 buffer
    with float4 atomics (scalar ones when D % 4 != 0). Rows past
    sum(Hl * Wl) are exactly 0. `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor) -> torch.Tensor:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        lib = BWD_LIB.build()
        d_value = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
        # one thread per 4 channels: a 16-byte slice of the f32 accumulator,
        # one float4 atomic per corner
        vec = 4 if D % 4 == 0 and dout.data_ptr() % (4 * dout.element_size()) == 0 else 1
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_bwd_dvalue(
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                dout.data_ptr(), d_value.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_dvalue")
        self.launches += 1
        return d_value.to(value.dtype)


class MSDeformAttnDLocAttn:
    """Launches the d_loc / d_attn gather kernel (`csrc/ms_deform_attn_bwd.cu`).

    Returns (d_loc (B, Q, H, L, P, 2), d_attn (B, Q, H, L, P)), f32, d_loc
    with respect to the normalized locations. `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        lib = BWD_LIB.build()
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        vec = min(vec_width(value, D), vec_width(dout, D))
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_bwd_dloc(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_loc.data_ptr(),
                d_attn.data_ptr(), DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P,
                level_hw(spatial_shapes), vec, stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_dloc")
        self.launches += 1
        return d_loc, d_attn


class MSDeformAttnMergedAdjoint:
    """Launches the merged adjoint kernel (`csrc/ms_deform_attn_bwd.cu`):
    d_value, d_loc and d_attn in one pass over the sampling points.

    Returns what `MSDeformAttnDValue` and `MSDeformAttnDLocAttn` return
    together: (d_value (B, S, H, D) in value's dtype, summed in f32 with
    float4 atomics, rows past sum(Hl * Wl) exactly 0; d_loc (B, Q, H, L, P,
    2) f32 with respect to the normalized locations; d_attn (B, Q, H, L, P)
    f32). `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        lib = BWD_LIB.build()
        d_value = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        # 4 channels per lane for both dtypes: one float4 atomic per corner
        aligned = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (value, dout))
        vec = 4 if D % 4 == 0 and aligned else 1
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_bwd_merged(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_value.data_ptr(),
                d_loc.data_ptr(), d_attn.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_merged")
        self.launches += 1
        return d_value.to(value.dtype), d_loc, d_attn


MS_DEFORM_ATTN_FWD = MSDeformAttnForward()
MS_DEFORM_ATTN_DVALUE = MSDeformAttnDValue()
MS_DEFORM_ATTN_DLOC = MSDeformAttnDLocAttn()
MS_DEFORM_ATTN_MERGED = MSDeformAttnMergedAdjoint()
KERNELS = (MS_DEFORM_ATTN_FWD, MS_DEFORM_ATTN_DVALUE, MS_DEFORM_ATTN_DLOC,
           MS_DEFORM_ATTN_MERGED)
ADJOINTS = ("merged", "pair")


class _MSDeformAttn(torch.autograd.Function):
    """Deformable sampling with its adjoint: CPU -> plain versions, CUDA ->
    the forward kernel and the adjoint chosen by `adjoint` ('pair': the
    d_value scatter and the d_loc/d_attn gather; 'merged': one kernel)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights, adjoint):
        ctx.spatial_shapes, ctx.adjoint = spatial_shapes, adjoint
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        if value.device.type == "cpu":
            return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                        attention_weights)
        return MS_DEFORM_ATTN_FWD(value, spatial_shapes, sampling_locations,
                                  attention_weights)

    @staticmethod
    def backward(ctx, dout):
        value, locs, attn = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        dout = dout.contiguous()
        if value.device.type == "cpu":
            d_value, d_loc, d_attn = ms_deform_attn_torch_backward(value, shapes, locs,
                                                                   attn, dout)
        elif ctx.adjoint == "merged":
            d_value, d_loc, d_attn = MS_DEFORM_ATTN_MERGED(value, shapes, locs, attn, dout)
        else:
            d_value = MS_DEFORM_ATTN_DVALUE(value, shapes, locs, attn, dout)
            d_loc, d_attn = MS_DEFORM_ATTN_DLOC(value, shapes, locs, attn, dout)
        return d_value, None, d_loc, d_attn, None


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                   adjoint: str = "merged") -> torch.Tensor:
    """The model's deformable-attention entry on the gather kernels
    (differentiable): CPU -> plain version, CUDA -> the hand-written kernels
    (which raise on what they do not take). `adjoint` picks the backward on
    CUDA tensors: 'merged' (one kernel, the faster on the H100) or 'pair'
    (d_value scatter + d_loc/d_attn gather); both compute the same
    gradients."""
    if adjoint not in ADJOINTS:
        raise ValueError(f"adjoint {adjoint!r} not in {ADJOINTS}")
    return _MSDeformAttn.apply(value, tuple(spatial_shapes), sampling_locations,
                               attention_weights, adjoint)
