"""The dense route of deformable attention: `enc_deform_impl` /
`dec_deform_impl` = 'pallas'.

Counterpart of `poet_tpu/ops/deform_attn_pallas.py:ms_deform_attn_pallas`,
whose TPU kernels (`_fwd_kernel`, `_bwd_kernel`) build a dense one-hot
sampling matrix W (queries x a level's zero-bordered tokens) and multiply it
with the value slab on the matrix unit. The Hopper kernels
(`csrc/ms_deform_attn_dense.cu`) keep the one-hot products on the tensor
cores (hi/lo TF32 split, so the f32 weights keep ~22 bits) but not the
TPU's sweep of every token chunk for every query tile, which on Hopper cost
more than the products:

* forward: a block per (64-query tile, b, h, channel group) computes each
  of its points' corner terms once, buckets the corners by 64-token chunk
  with a counting sort (per-thread counts, a block scan: each chunk's list
  in (q, p, corner) order, no atomics), and walks only the occupied chunks:
  each warp builds its 16 rows of the one-hot tile from its own segment of
  the list, multiplies it by the chunk's value rows (staged by cp.async,
  two stages, the next chunk in flight) and zeroes the cells it wrote;
* adjoint: one launch. d_value blocks per (b, h, level or band of a level,
  channel group) walk the queries in tiles, compute each point's corners
  once, sort the tile's corners by token (counts and ranks, no float
  atomics) and add each token's run in (q, p, corner) order into sums a
  lane group keeps in registers: the same bits from run to run. The d_loc /
  d_attn blocks gather dout . v at each point's corners.

`ms_deform_attn_dense` is a `torch.autograd.Function`: CPU tensors run the
plain PyTorch forward and backward (`ops/deform_attn.py`, the same as the
gather route's), CUDA tensors launch the two kernels or raise. The shared
memory each launch asks for is planned here (`plan_dense_forward`,
`plan_dense_adjoint`, the same arithmetic as the source's) and a shape over
the 232 448 B a block may opt into raises before any launch. Importing this
module builds nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

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
from poet_tpu_torch.ops.deform_attn_cuda import SMEM_OPTIN_MAX, _check_inputs

# the source's block sizes (csrc/ms_deform_attn_dense.cu)
KC = 64                  # tokens per chunk: the one-hot tile's columns
QT = 64                  # forward: queries per block
FWD_THREADS = 128
W_LD = KC + 4            # one-hot tile row stride (floats)
NSTAGE = 2               # the forward's ring of staged value chunks
BWD_THREADS = 256
BWD_WARPS = BWD_THREADS // 32
MAX_UNITS = 64
TPG = 20                 # adjoint: tokens per lane group (their sums in registers)
TILE_PTS = 1024          # adjoint: points per d_value tile
PARTS = {"all": 0, "d_value": 1, "d_loc": 2}


def padded_tokens(spatial_shapes: Sequence[Tuple[int, int]]) -> int:
    """S_pad = sum over levels of (Hl + 2) * (Wl + 2): the columns of the
    TPU kernel's dense sampling matrix (each level with its one-token zero
    border)."""
    return sum((h + 2) * (w + 2) for h, w in spatial_shapes)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def group_width(D: int) -> int:
    """Channels a block covers: min(D, 64) rounded up to 8, then to 8 x a
    power of two (the source's column tiles)."""
    tiles = (min(D, 64) + 7) // 8
    return 8 * next(n for n in (1, 2, 4, 8) if n >= tiles)


class ForwardPlan(NamedTuple):
    chunks: int          # 64-token chunks over the levels' tokens
    groups: int          # channel groups (blocks per (query tile, b, h))
    smem_bytes: int


def plan_dense_forward(spatial_shapes, D: int, dtype: torch.dtype, P: int) -> ForwardPlan:
    """The forward's chunks, channel groups and dynamic shared memory: the
    chunk table, 16-bit per-(chunk, thread) counts, the sorted corner list (6
    bytes a corner), then the larger of the point records and the one-hot
    tile with its two value stages."""
    S_lv = sum(h * w for h, w in spatial_shapes)
    LP = len(spatial_shapes) * P
    DG = group_width(D)
    chunks = -(-S_lv // KC)
    itemsize = torch.empty((), dtype=dtype).element_size()
    tiles = QT * W_LD * 4 + NSTAGE * KC * (DG + 8) * itemsize
    smem = (_align16((2 * chunks + 1 + QT + 1) * 4) + _align16(chunks * FWD_THREADS * 2)
            + QT * LP * 16 + _align16(QT * LP * 8) + max(QT * LP * 16, tiles))
    return ForwardPlan(chunks, -(-D // DG), smem)


class AdjointPlan(NamedTuple):
    units: Tuple[Tuple[int, int, int], ...]   # (level, first token in it, tokens)
    band_max: int
    tile_queries: int    # queries per d_value tile
    smem_bytes: int


def adjoint_units(spatial_shapes, D: int):
    """The d_value blocks' units: each level whole, or cut into the fewest
    equal bands of at most the tokens the lane groups hold in registers (256
    threads / (group width / 4) x TPG)."""
    per = BWD_THREADS // (group_width(D) // 4) * TPG
    units = []
    for l, (h, w) in enumerate(spatial_shapes):
        n = h * w
        size = -(-n // -(-n // per))
        units += [(l, t, min(size, n - t)) for t in range(0, n, size)]
    return tuple(units)


def tile_slots(P: int) -> int:
    """The d_value blocks' point slots per tile: its TILE_PTS // P queries'
    points, rounded up to a whole round of 32 per warp."""
    pts = max(1, TILE_PTS // P) * P
    return -(-pts // BWD_THREADS) * BWD_THREADS


def plan_dense_adjoint(spatial_shapes, D: int, P: int) -> AdjointPlan:
    """The adjoint's d_value units and dynamic shared memory per d_value
    block: per-(token, warp) counts and the run starts (16 bits each) over
    the largest unit, the tile's corners (token and query row, weight: 32
    bytes a point slot), its runs (an f32 weight and a 16-bit query row for
    each of a slot's four corners), its dout rows (f32, 4 floats of
    padding)."""
    units = adjoint_units(spatial_shapes, D)
    band_max = max(n for _, _, n in units)
    qt, slots = max(1, TILE_PTS // P), tile_slots(P)
    smem = (_align16(BWD_WARPS * band_max * 2) + _align16((band_max + 1) * 2) + slots * 48
            + _align16(slots * 8) + qt * (group_width(D) + 4) * 4)
    return AdjointPlan(units, band_max, qt, smem)


def _fits(what: str, smem: int, units: int = 0) -> None:
    if smem > SMEM_OPTIN_MAX:
        raise ValueError(f"{what} needs {smem} B of shared memory per block, over the "
                         f"{SMEM_OPTIN_MAX} B a block may opt into")
    if units > MAX_UNITS:
        raise ValueError(f"{what}: {units} d_value units, over the kernel's {MAX_UNITS}")


class MSDeformAttnDenseForward:
    """Launches the dense one-hot forward kernel; same contract as
    `ms_deform_attn_torch`, CUDA tensors only. `launches` counts launches
    (none while a stream captures: nothing launches then)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        _fits("the dense forward", plan_dense_forward(spatial_shapes, D, value.dtype,
                                                      P).smem_bytes)
        lib = DENSE_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_dense_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), stream_of(value))
        DENSE_LIB.check(rc, "ms_deform_attn_dense_fwd")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return out


class MSDeformAttnDenseAdjoint:
    """Launches the dense one-hot adjoint kernel: (d_value (B, S, H, D) in
    value's dtype, summed in f32 in (q, p, corner) order, rows past
    sum(Hl * Wl) exactly 0; d_loc (B, Q, H, L, P, 2) f32 with respect to the
    normalized locations; d_attn (B, Q, H, L, P) f32), as the merged adjoint
    returns. CUDA tensors only; `launches` counts launches (none while a
    stream captures).

    For measurement only: `part='d_value'` or `'d_loc'` launches one kind of
    block alone (the other outputs are left unwritten)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor,
                 part: str = "all") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if part not in PARTS:
            raise ValueError(f"part {part!r}: the parts are {tuple(PARTS)}")
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        if P > TILE_PTS:
            raise ValueError(f"the dense adjoint takes at most {TILE_PTS} points per level, "
                             f"got P={P}")
        plan = plan_dense_adjoint(spatial_shapes, D, P)
        _fits("the dense adjoint", plan.smem_bytes if part != "d_loc" else 0, len(plan.units))
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
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, PARTS[part],
                stream_of(value))
        DENSE_LIB.check(rc, "ms_deform_attn_dense_bwd")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
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
