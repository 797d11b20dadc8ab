"""The gather route of deformable attention: its entry, its Hopper kernels'
wrappers and its adjoint.

`ms_deform_attn` is the entry the model calls for every `enc_deform_impl` /
`dec_deform_impl` but 'pallas' (that one is `ops/deform_attn_dense_cuda.py`;
the table is `config.DEFORM_IMPLS`). It is the custom operator
`torch.ops.poet_tpu_torch.ms_deform_attn` (`torch.library.custom_op`, with
a fake implementation for tracing and its adjoint registered for autograd),
so eager calls and a `torch.export`ed program take the same path:
  * CPU tensors run the plain PyTorch forward and backward
    (`ops/deform_attn.py`);
  * CUDA tensors launch the hand-written kernels — the forward
    `csrc/ms_deform_attn_fwd.cu`, and in the backward, by its `adjoint`
    argument, either the pair of `csrc/ms_deform_attn_bwd.cu` (d_value and
    the d_loc/d_attn gather, each on its route) or the merged adjoint of the same
    file (all three gradients in one pass) — or raise.
There is no fallback from one to the other.

The forward and the merged adjoint each have two routes, each its own
kernel and wrapper with its own launch count, chosen by a written rule on
(S, D, dtype, Q) and the points per query (L, P) from the shared-memory
budget of one block, `SMEM_OPTIN_MAX` (never by catching a failure):
  * `plan_forward`: the SLAB route (`MS_DEFORM_ATTN_FWD_SLAB`, one block
    per (b, h) on its value slab staged in shared memory) where the slab
    fits and each staged token is read at least `SLAB_MIN_READS` times
    (4 L P Q / S: 64 in the encoder), else the DIRECT route
    (`MS_DEFORM_ATTN_FWD`, corners gathered from the L2; the decoder, Q=10,
    reads each token 0.4 times). The two give the same bits.
  * `plan_merged`: the SLAB route (`MS_DEFORM_ATTN_MERGED_SLAB`, d_value
    summed in an f32 slab in shared memory and written once in the value
    dtype; the value slab staged beside it by the same reads rule where
    both fit) wherever the f32 d_value slab fits, else (the YOLO pyramid,
    S = 6380) the BANDED route for bf16 (`MS_DEFORM_ATTN_MERGED_BANDED`,
    the same block per (b, h) walking its token rows in bands that fit,
    `plan_merged_bands`) and the ATOMIC route for f32
    (`MS_DEFORM_ATTN_MERGED`, float4 atomics into a zeroed f32 buffer in
    device memory, cast after), each the faster where measured.
The pair's two kernels have two routes each:
  * `plan_dvalue`: the SLAB route (`MS_DEFORM_ATTN_DVALUE_SLAB`, a block per
    (b, h, channel group of up to `DVALUE_GROUP_MAX`) sums its (S, group)
    f32 slab in shared memory and writes it once in the value dtype: no
    zeroed buffer, no cast) where that slab fits and each token takes at
    most `DVALUE_SLAB_MAX_READS` corner adds (the decoder, Q = 10), else
    the ATOMIC scatter (`MS_DEFORM_ATTN_DVALUE`, float4 atomics into a
    zeroed f32 buffer, cast after): the encoder, where the L2's atomics
    outrun the shared adds' compare-and-swap loops at a model's sampling
    locations, and the YOLO pyramid, whose 16-channel slab does not fit.
  * `plan_dloc`: the d_loc/d_attn gather's SLAB route
    (`MS_DEFORM_ATTN_DLOC_SLAB`, a block per (b, h) stages its value slab
    in shared memory and walks the pair's points a lane each) by
    `plan_forward`'s rule, else the DIRECT route (`MS_DEFORM_ATTN_DLOC`,
    the same walk reading the corners from device memory, a block per
    (b, h, 256 points): the decoder, and the YOLO pyramid in f32). Both
    are instances of one wrapper, `MSDeformAttnDLoc`.

The kernels are built by `ops/cuda_build.py` (nvcc at first use, loaded
with ctypes); this module re-exports its `CudaLibrary`, `build_all`,
`BUILD_DIR`, `NVCC_FLAGS` and `LIBRARIES`. Importing it builds nothing
and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
    device_guard,
    level_hw,
    stream_of,
    vec_width,
)
from poet_tpu_torch.ops.deform_attn import (
    ms_deform_attn_torch,
    ms_deform_attn_torch_backward,
)

_MAX_LEVELS = 8                     # POET_MAX_LEVELS in the sources
SMEM_OPTIN_MAX = 232448             # shared memory one block may opt into on the H100
# staging a value slab pays where each staged token is read at least this
# many times (corner reads 4 L P Q over S tokens); 64 in the encoder at the
# flagship shape, 0.4 in its decoder (Q = 10)
SLAB_MIN_READS = 8.0
# the pair's d_value slab route (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
# phases 6 and 18). Channels per block: the largest divisor of D up to
# DVALUE_GROUP_MAX; at the flagship encoder (S = 1600) 16 channels x 512
# threads (two 102 400 B slabs per SM) ran 0.5625 ms on uniform locations,
# 8 channels (four slabs per SM, each repeating the points' coordinate math,
# up to four lanes on a bank) 0.8095; at the YOLO pyramid (S = 6380), where
# only 8 channels fit, the best split ran 3.2310 ms against the scatter's
# 2.6075. Corner adds per token: at a model's sampling locations
# (chip_smoke.grid_locations, bf16, S = 1600) the slab beat the scatter up
# to 16 per token (Q = 400: 0.1431 against 0.1471 ms; Q = 10: 0.0124
# against 0.0259) and lost from 32 (Q = 800: 0.2871 against 0.2743; Q =
# 1600: 0.5426 against 0.5005): neighbouring queries' corners share L2
# lines for the atomics and contend in the shared adds.
DVALUE_GROUP_MAX = 16
DVALUE_THREADS = 512
DVALUE_SLAB_MAX_READS = 16.0


class Plan(NamedTuple):
    """A route of the forward ('slab' or 'direct') or of the merged adjoint
    ('slab', 'banded' or 'atomic'), whether it stages the value slab (or each
    band's value rows) in shared memory, and the dynamic shared memory one
    block of it takes (bytes; 0 for 'banded', whose shared memory is its band
    plan's, `plan_merged_bands`)."""
    route: str
    stage: bool
    smem_bytes: int


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def corner_reads_per_token(S: int, Q: int, L: int, P: int) -> float:
    """How often each of a (b, h)'s S tokens is read, on average: 4 corners
    of L x P points for each of its Q queries."""
    return 4.0 * L * P * Q / S


def merged_slab_bytes(S: int, D: int, dtype: torch.dtype, stage: bool) -> int:
    """Shared memory of the merged adjoint's slab route: the f32 d_value slab
    (S, D) and, with `stage`, the value slab after it at the next 16 bytes."""
    acc = S * D * 4
    return -(-acc // 16) * 16 + S * D * _itemsize(dtype) if stage else acc


def plan_forward(S: int, D: int, dtype: torch.dtype, Q: int, L: int, P: int) -> Plan:
    """The forward's route: 'slab' where the (S, D) value slab fits one
    block's shared memory and each token is read at least SLAB_MIN_READS
    times, else 'direct'."""
    slab = S * D * _itemsize(dtype)
    if slab <= SMEM_OPTIN_MAX and corner_reads_per_token(S, Q, L, P) >= SLAB_MIN_READS:
        return Plan("slab", True, slab)
    return Plan("direct", False, 0)


def plan_dloc(S: int, D: int, dtype: torch.dtype, Q: int, L: int, P: int) -> Plan:
    """The d_loc/d_attn gather's route, by the forward's rule: 'slab' where
    the (S, D) value slab fits one block's shared memory and each token is
    read at least SLAB_MIN_READS times (the encoder: 64), else 'direct' (the
    decoder: 0.4; the YOLO pyramid in f32, whose slab does not fit)."""
    return plan_forward(S, D, dtype, Q, L, P)


def plan_merged(S: int, D: int, dtype: torch.dtype, Q: int, L: int, P: int) -> Plan:
    """The merged adjoint's route: 'slab' where the f32 d_value slab fits one
    block's shared memory, staging the value slab too where both fit and
    each token is read at least SLAB_MIN_READS times. Where it does not fit,
    'banded' for bf16 values, staging each band's value rows by the same
    reads rule, and 'atomic' for f32.

    Measured on an NVIDIA H100 80GB HBM3, 700 W, at the YOLO pyramid (S =
    6380, B = 16, H = 16, D = 16, L = P = 4; tools/bench_banded.py, two runs
    in one call), device ms banded / atomic at uniform locations, then at a
    model's (chip_smoke.grid_locations): bf16 encoder (Q = 6380, staged)
    3.166-3.186 / 3.590-3.593 and 2.779-2.798 / 3.133-3.138; bf16 decoder
    (Q = 10, unstaged) 0.062 / 0.133 and 0.061 / 0.130; f32 encoder
    (staged) 4.201-4.216 / 3.578-3.581 and 3.246 / 3.092-3.097; f32 decoder
    (unstaged) 0.080 / 0.081 and 0.079 / 0.077. In f32 the atomic route's
    f32 buffer needs no cast and the banded route's staged rows take twice
    the bytes (four bands, not three). Staging by the reads rule: bf16
    encoder 3.166-3.186 staged against 3.700-3.721 unstaged, decoder 0.087
    against 0.062. At the flagship encoder (S = 1600) the slab route still
    beats the atomic one at a model's locations: bf16 0.639 against 0.714,
    f32 0.676 against 0.699."""
    reads = corner_reads_per_token(S, Q, L, P) >= SLAB_MIN_READS
    if merged_slab_bytes(S, D, dtype, False) > SMEM_OPTIN_MAX:
        return Plan("banded", reads, 0) if dtype == torch.bfloat16 else Plan("atomic", False, 0)
    staged = merged_slab_bytes(S, D, dtype, True)
    if staged <= SMEM_OPTIN_MAX and reads:
        return Plan("slab", True, staged)
    return Plan("slab", False, merged_slab_bytes(S, D, dtype, False))


MAX_BANDS = 64                      # POET_MAX_BANDS
BAND_HEAD = (MAX_BANDS + 2 * _MAX_LEVELS) * 4    # kBandHead: list lengths, level rows


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def merged_band_bytes(tokens: int, staged: int, D: int, dtype: torch.dtype,
                      stage: bool) -> int:
    """Shared memory of one band of the banded route (`band_bytes` in the
    source): the block's head (the carry lists' lengths, each level's rows
    in the band), the f32 d_value slab of its `tokens` rows and, with
    `stage`, the `staged` value rows (the band's and its halo row)."""
    return BAND_HEAD + _align16(tokens * D * 4) + (staged * D * _itemsize(dtype) if stage else 0)


class BandPlan(NamedTuple):
    """The banded route's bands: token boundaries 0 = bounds[0] < ... <
    bounds[-1] = sum(H_l W_l), each at the start of a row of a level; the
    dynamic shared memory of the block (its largest band's, bytes); and the
    carry lists a block keeps, one per band that starts inside a level."""
    bounds: Tuple[int, ...]
    smem_bytes: int
    lists: int


def plan_merged_bands(shapes: Sequence[Tuple[int, int]], D: int, dtype: torch.dtype,
                      stage: bool, budget: int = SMEM_OPTIN_MAX) -> BandPlan:
    """Cut the concatenated level rows into bands of whole rows, greedily in
    order, each band's shared memory (`merged_band_bytes`: its f32 slab and,
    with `stage`, its value rows plus the halo row, the level's next row,
    where it ends inside a level) within `budget`. Raises where one row
    alone does not fit, or where more than MAX_BANDS bands would be needed."""
    rows, start = [], 0                   # (first token, tokens, halo tokens after it)
    for h, w in shapes:
        rows += [(start + y * w, w, w if y + 1 < h else 0) for y in range(h)]
        start += h * w

    def size(first, end, halo):
        return merged_band_bytes(end - first, end + halo - first, D, dtype, stage)

    bounds, smem, first, last, lists = [0], 0, 0, None, 0
    for t, w, halo in rows:
        if size(first, t + w, halo) > budget and t > first:
            smem = max(smem, size(first, t, last))
            bounds.append(t)
            lists += last > 0                 # the band ended inside a level
            first = t
        if size(first, t + w, halo) > budget:
            raise ValueError(
                f"the banded route cannot fit a row of {w} tokens (halo {halo}): "
                f"{size(t, t + w, halo)} B of shared memory over the budget of {budget} B "
                f"(D={D}, {dtype}, stage={stage})")
        last = halo
    smem = max(smem, size(first, start, last))
    bounds.append(start)
    if len(bounds) - 1 > MAX_BANDS:
        raise ValueError(f"the banded route would need {len(bounds) - 1} bands within "
                         f"{budget} B, over its {MAX_BANDS}")
    return BandPlan(tuple(bounds), smem, lists)


class DValuePlan(NamedTuple):
    """The pair's d_value route ('slab' or 'atomic'), the channels and
    threads of one slab block, and its dynamic shared memory (bytes)."""
    route: str
    group: int
    threads: int
    smem_bytes: int


def _slab_vec(n: int) -> int:
    """Channels per lane of the slab kernels where the pointers allow."""
    return next(v for v in (8, 4, 1) if n % v == 0)


def dvalue_slab_shape(S: int, D: int, Q: int, L: int, P: int) -> DValuePlan:
    """The slab route's block for these operands, whichever route the rule
    takes: the channel group (the largest divisor of D up to
    DVALUE_GROUP_MAX), DVALUE_THREADS threads, fewer where the Q L P points
    cannot keep them busy (a warp multiple, at least 128), and the (S,
    group) f32 slab's bytes."""
    group = max(g for g in range(1, min(D, DVALUE_GROUP_MAX) + 1) if D % g == 0)
    lanes = Q * L * P * _group_lanes(group // _slab_vec(group))
    threads = min(DVALUE_THREADS, max(128, -(-lanes // 32) * 32))
    return DValuePlan("slab", group, threads, S * group * 4)


def plan_dvalue(S: int, D: int, dtype: torch.dtype, Q: int, L: int, P: int) -> DValuePlan:
    """The pair's d_value route: 'slab' (`dvalue_slab_shape`'s block) where
    its slab fits one block's shared memory and each token takes at most
    DVALUE_SLAB_MAX_READS corner adds, else 'atomic'. The value dtype does
    not change the slab (f32 either way)."""
    slab = dvalue_slab_shape(S, D, Q, L, P)
    if (slab.smem_bytes > SMEM_OPTIN_MAX
            or corner_reads_per_token(S, Q, L, P) > DVALUE_SLAB_MAX_READS):
        return DValuePlan("atomic", 0, 0, 0)
    return slab


def _group_lanes(chunks: int) -> int:
    """Lanes per sampling point (`group_lanes` in the source): the power of
    two >= chunks, at most 32."""
    G = 1
    while G < chunks and G < 32:
        G <<= 1
    return G


def _plan_of(plan, value, locs) -> Plan:
    _, S, _, D = value.shape
    return plan(S, D, value.dtype, locs.shape[1], locs.shape[3], locs.shape[4])


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
    """Launches the forward kernel's direct route (`csrc/ms_deform_attn_fwd.cu`,
    `ms_deform_attn_fwd_kernel`: corners gathered from device memory).

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
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec_width(value, D),
                stream_of(value))
        FWD_LIB.check(rc, "ms_deform_attn_fwd")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return out


class MSDeformAttnForwardSlab:
    """Launches the forward kernel's slab route (`csrc/ms_deform_attn_fwd.cu`,
    `ms_deform_attn_fwd_slab_kernel`): one block per (b, h) stages its (S, D)
    value slab in shared memory and walks all Q queries of the pair. Its
    output equals the direct route's bit for bit. Raises where the slab
    exceeds SMEM_OPTIN_MAX. `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        """Same contract as `ms_deform_attn_torch`; CUDA tensors only."""
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        if S * D * value.element_size() > SMEM_OPTIN_MAX:
            raise ValueError(f"a value slab of S={S} x D={D} {value.dtype} exceeds the "
                             f"{SMEM_OPTIN_MAX} B of shared memory a block may use")
        lib = FWD_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_fwd_slab(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec_width(value, D),
                stream_of(value))
        FWD_LIB.check(rc, "ms_deform_attn_fwd_slab")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
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
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_bwd_dvalue(
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                dout.data_ptr(), d_value.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_dvalue")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_value.to(value.dtype)


class MSDeformAttnDValueSlab:
    """Launches the d_value kernel's slab route (`csrc/ms_deform_attn_bwd.cu`,
    `ms_deform_attn_dvalue_slab_kernel`): one block per (b, h, channel group)
    sums its (S, group) f32 slab in shared memory and writes every row once
    in the value's dtype (rows past sum(Hl * Wl) exactly 0): no zeroed
    buffer, no cast. `group` and `threads` default to `dvalue_slab_shape`'s.

    Returns what `MSDeformAttnDValue` returns. Raises where the slab exceeds
    SMEM_OPTIN_MAX. `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor, group: Optional[int] = None,
                 threads: Optional[int] = None) -> torch.Tensor:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        shape = dvalue_slab_shape(S, D, Q, L, P)
        group = shape.group if group is None else group
        threads = shape.threads if threads is None else threads
        if not group or D % group or S * group * 4 > SMEM_OPTIN_MAX:
            raise ValueError(f"the d_value slab route does not take S={S} x D={D} in groups "
                             f"of {group} channels within the {SMEM_OPTIN_MAX} B a block "
                             f"may use")
        lib = BWD_LIB.build()
        d_value = torch.empty_like(value)         # every row written by the kernel
        vec = next(n for n in (8, 4, 1) if group % n == 0
                   and dout.data_ptr() % (n * dout.element_size()) == 0)
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_bwd_dvalue_slab(
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                dout.data_ptr(), d_value.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, group, threads,
                stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_dvalue_slab")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_value


class MSDeformAttnDLoc:
    """Launches one route of a d_loc / d_attn gather: `entry` of `lib`, a
    lane per sampling point (`csrc/ms_deform_attn_point.cuh`,
    `ms_deform_attn_dloc_kernel` / `ms_deform_attn_dloc_slab_kernel` under
    the library's corner rule). With `slab`, one block per (b, h) stages its
    (S, D) value slab in shared memory and walks the pair's points; without,
    a block per (b, h, 256 points) reads the corners from device memory.

    Returns (d_loc (B, Q, H, L, P, 2), d_attn (B, Q, H, L, P)), f32, d_loc
    with respect to the normalized locations. CUDA tensors only; with `slab`
    raises where the slab exceeds SMEM_OPTIN_MAX. `launches` counts launches
    (none while a stream captures: nothing launches then); each instance
    keeps its own.
    """

    def __init__(self, lib: CudaLibrary, entry: str, slab: bool):
        self.lib, self.entry, self.slab = lib, entry, slab
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        if self.slab and S * D * value.element_size() > SMEM_OPTIN_MAX:
            raise ValueError(f"a value slab of S={S} x D={D} {value.dtype} exceeds the "
                             f"{SMEM_OPTIN_MAX} B of shared memory a block may use")
        lib = self.lib.build()
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        # a staged slab's rows are packed and 16-byte aligned: there only
        # dout's loads need its pointer aligned for VEC channels a load
        vec = vec_width(dout, D) if self.slab else min(vec_width(value, D), vec_width(dout, D))
        with device_guard(value):
            rc = getattr(lib, self.entry)(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_loc.data_ptr(),
                d_attn.data_ptr(), DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P,
                level_hw(spatial_shapes), vec, stream_of(value))
        self.lib.check(rc, self.entry.removeprefix("poet_"))
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_loc, d_attn


class MSDeformAttnMergedAdjoint:
    """Launches the merged adjoint's atomic route (`csrc/ms_deform_attn_bwd.cu`,
    `ms_deform_attn_merged_kernel`): d_value, d_loc and d_attn in one pass
    over the sampling points, d_value added into device memory.

    Returns what `MSDeformAttnDValue` and `MSDeformAttnDLoc` return
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
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_bwd_merged(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_value.data_ptr(),
                d_loc.data_ptr(), d_attn.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_merged")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_value.to(value.dtype), d_loc, d_attn


class MSDeformAttnMergedSlab:
    """Launches the merged adjoint's slab route (`csrc/ms_deform_attn_bwd.cu`,
    `ms_deform_attn_merged_slab_kernel`): one block per (b, h) walks the
    pair's queries, sums d_value in an f32 slab in shared memory (no global
    atomics) and writes it once, in the value's dtype, every row (rows past
    sum(Hl * Wl) exactly 0). `stage` (default: `plan_merged`'s) also stages
    the value slab in shared memory; False reads it from device memory.

    Returns what `MSDeformAttnMergedAdjoint` returns. Raises where the slab
    exceeds SMEM_OPTIN_MAX. `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor, stage: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        if stage is None:
            stage = plan_merged(S, D, value.dtype, Q, L, P).stage
        smem = merged_slab_bytes(S, D, value.dtype, stage)
        if smem > SMEM_OPTIN_MAX:
            raise ValueError(f"the merged adjoint's slab of S={S} x D={D} ({value.dtype}, "
                             f"stage={stage}) takes {smem} B, over the {SMEM_OPTIN_MAX} B "
                             f"a block may use")
        lib = BWD_LIB.build()
        d_value = torch.empty_like(value)         # every row written by the kernel
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        # 8 channels per lane where D and the pointers allow (2 lanes per point
        # at D = 16), else 4, else 1
        vec = next(n for n in (8, 4, 1) if D % n == 0 and all(
            t.data_ptr() % (n * t.element_size()) == 0 for t in (value, dout)))
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_bwd_merged_slab(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_value.data_ptr(),
                d_loc.data_ptr(), d_attn.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, int(stage),
                stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_merged_slab")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_value, d_loc, d_attn


class MSDeformAttnMergedBanded:
    """Launches the merged adjoint's banded route (`csrc/ms_deform_attn_bwd.cu`,
    `ms_deform_attn_merged_banded_kernel`): one block per (b, h) walks the
    pair's token rows in bands of whole level rows (`plan_merged_bands`
    within `budget`), sums each band's d_value in an f32 slab in shared
    memory and writes it once, in the value's dtype, every row (rows past
    sum(Hl * Wl) exactly 0): no zeroed buffer, no global atomics. A band
    walks the points of the levels that start in it and, of a level it
    continues, the points an earlier band handed on to it (its carry list,
    an int32 scratch this call allocates). `stage` (default: `plan_merged`'s
    reads rule) stages each band's value rows and halo row.

    Returns what `MSDeformAttnMergedAdjoint` returns. Raises where a band
    plan does not fit (with its numbers). `launches` counts launches.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 dout: torch.Tensor, stage: Optional[bool] = None,
                 budget: int = SMEM_OPTIN_MAX
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights, dout)
        if stage is None:
            stage = corner_reads_per_token(S, Q, L, P) >= SLAB_MIN_READS
        plan = plan_merged_bands(spatial_shapes, D, value.dtype, stage, budget)
        lib = BWD_LIB.build()
        d_value = torch.empty_like(value)         # every row written by the kernel
        d_loc = torch.empty_like(sampling_locations)
        d_attn = torch.empty_like(attention_weights)
        bounds = (ctypes.c_int * len(plan.bounds))(*plan.bounds)
        # the carry lists: the points a band hands on to a later band of their level
        lists = torch.empty(B * H * Q * P * plan.lists, dtype=torch.int32, device=value.device)
        # 8 channels per lane where D and the pointers allow (2 lanes per point
        # at D = 16), else 4, else 1: the slab route's
        vec = next(n for n in (8, 4, 1) if D % n == 0 and all(
            t.data_ptr() % (n * t.element_size()) == 0 for t in (value, dout)))
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_bwd_merged_banded(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_value.data_ptr(),
                d_loc.data_ptr(), d_attn.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec, int(stage), bounds,
                len(plan.bounds) - 1, lists.data_ptr(), lists.numel(), stream_of(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_merged_banded")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return d_value, d_loc, d_attn


MS_DEFORM_ATTN_FWD = MSDeformAttnForward()
MS_DEFORM_ATTN_FWD_SLAB = MSDeformAttnForwardSlab()
MS_DEFORM_ATTN_DVALUE = MSDeformAttnDValue()
MS_DEFORM_ATTN_DLOC = MSDeformAttnDLoc(BWD_LIB, "poet_ms_deform_attn_bwd_dloc", slab=False)
MS_DEFORM_ATTN_MERGED = MSDeformAttnMergedAdjoint()
MS_DEFORM_ATTN_MERGED_SLAB = MSDeformAttnMergedSlab()
MS_DEFORM_ATTN_DVALUE_SLAB = MSDeformAttnDValueSlab()
MS_DEFORM_ATTN_DLOC_SLAB = MSDeformAttnDLoc(BWD_LIB, "poet_ms_deform_attn_bwd_dloc_slab",
                                            slab=True)
MS_DEFORM_ATTN_MERGED_BANDED = MSDeformAttnMergedBanded()
KERNELS = (MS_DEFORM_ATTN_FWD, MS_DEFORM_ATTN_DVALUE, MS_DEFORM_ATTN_DLOC,
           MS_DEFORM_ATTN_MERGED, MS_DEFORM_ATTN_FWD_SLAB, MS_DEFORM_ATTN_MERGED_SLAB,
           MS_DEFORM_ATTN_DVALUE_SLAB, MS_DEFORM_ATTN_DLOC_SLAB, MS_DEFORM_ATTN_MERGED_BANDED)
ADJOINTS = ("merged", "pair")


def forward_kernel(value, locs):
    """The forward route's wrapper for these operands (`plan_forward`)."""
    slab = _plan_of(plan_forward, value, locs).route == "slab"
    return MS_DEFORM_ATTN_FWD_SLAB if slab else MS_DEFORM_ATTN_FWD


def merged_adjoint(value, spatial_shapes, locs, attn, dout):
    """The merged adjoint on the route `plan_merged` gives these operands."""
    plan = _plan_of(plan_merged, value, locs)
    if plan.route == "slab":
        return MS_DEFORM_ATTN_MERGED_SLAB(value, spatial_shapes, locs, attn, dout, plan.stage)
    if plan.route == "banded":
        return MS_DEFORM_ATTN_MERGED_BANDED(value, spatial_shapes, locs, attn, dout, plan.stage)
    return MS_DEFORM_ATTN_MERGED(value, spatial_shapes, locs, attn, dout)


def dvalue_adjoint(value, spatial_shapes, locs, attn, dout):
    """The pair's d_value on the route `plan_dvalue` gives these operands."""
    plan = _plan_of(plan_dvalue, value, locs)
    if plan.route == "slab":
        return MS_DEFORM_ATTN_DVALUE_SLAB(value, spatial_shapes, locs, attn, dout, plan.group,
                                          plan.threads)
    return MS_DEFORM_ATTN_DVALUE(value, spatial_shapes, locs, attn, dout)


def dloc_adjoint(value, spatial_shapes, locs, attn, dout):
    """The pair's d_loc / d_attn on the route `plan_dloc` gives these operands."""
    slab = _plan_of(plan_dloc, value, locs).route == "slab"
    kernel = MS_DEFORM_ATTN_DLOC_SLAB if slab else MS_DEFORM_ATTN_DLOC
    return kernel(value, spatial_shapes, locs, attn, dout)


def gather_adjoint(value, spatial_shapes, locs, attn, dout, adjoint: str = "merged"):
    """The gather route's (d_value, d_loc, d_attn): CPU -> the plain adjoint,
    CUDA -> by `adjoint`, the merged kernel or the pair, each on its route."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch_backward(value, spatial_shapes, locs, attn, dout)
    if adjoint == "merged":
        return merged_adjoint(value, spatial_shapes, locs, attn, dout)
    d_value = dvalue_adjoint(value, spatial_shapes, locs, attn, dout)
    return (d_value, *dloc_adjoint(value, spatial_shapes, locs, attn, dout))


def level_pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The custom ops' flattened (H_0, W_0, H_1, W_1, ...) as (H_l, W_l) pairs."""
    return tuple(zip(flat[0::2], flat[1::2]))


def flat_levels(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """(H_l, W_l) pairs as the custom ops' `int[]` argument."""
    return [int(v) for hw in spatial_shapes for v in hw]


def deform_attn_fake(value, spatial_shapes, sampling_locations, attention_weights, *args):
    """The output a deformable-attention op gives: (B, Q, H * D) in value's dtype."""
    B, _, H, D = value.shape
    return value.new_empty((B, sampling_locations.shape[1], H * D))


@torch.library.custom_op("poet_tpu_torch::ms_deform_attn", mutates_args=(), device_types="cpu")
def _ms_deform_attn_op(value: torch.Tensor, spatial_shapes: List[int],
                       sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                       adjoint: str) -> torch.Tensor:
    """The gather route's forward as one operator: the plain version on the
    CPU; the kernel on `plan_forward`'s route on CUDA (below)."""
    return ms_deform_attn_torch(value, level_pairs(spatial_shapes), sampling_locations,
                                attention_weights).contiguous()


@_ms_deform_attn_op.register_kernel("cuda")
def _ms_deform_attn_cuda(value, spatial_shapes, sampling_locations, attention_weights, adjoint):
    return forward_kernel(value, sampling_locations)(
        value, level_pairs(spatial_shapes), sampling_locations, attention_weights)


_ms_deform_attn_op.register_fake(deform_attn_fake)


def save_operands(ctx, inputs, output):
    """Both deformable ops' autograd context: the operands and the levels
    (and the gather route's `adjoint`)."""
    value, spatial_shapes, locs, attn = inputs[:4]
    ctx.spatial_shapes = level_pairs(spatial_shapes)
    ctx.adjoint = inputs[4] if len(inputs) > 4 else None
    ctx.save_for_backward(value, locs, attn)


def _gather_backward(ctx, dout):
    value, locs, attn = ctx.saved_tensors
    d_value, d_loc, d_attn = gather_adjoint(value, ctx.spatial_shapes, locs, attn,
                                            dout.contiguous(), ctx.adjoint)
    return d_value, None, d_loc, d_attn, None


_ms_deform_attn_op.register_autograd(_gather_backward, setup_context=save_operands)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                   adjoint: str = "merged") -> torch.Tensor:
    """The model's deformable-attention entry on the gather kernels
    (differentiable), the operator `torch.ops.poet_tpu_torch.ms_deform_attn`:
    CPU -> plain version, CUDA -> the hand-written kernels on the routes
    `plan_forward`, `plan_merged`, `plan_dvalue` and `plan_dloc` give
    (which raise on what they do not take). `adjoint` picks the backward on
    CUDA tensors: 'merged' (one kernel, the faster on the H100) or 'pair'
    (d_value + the d_loc/d_attn gather, each on its route); both compute the same
    gradients. A traced program (`torch.export`) holds the operator itself,
    so the same kernels run wherever the program is loaded."""
    if adjoint not in ADJOINTS:
        raise ValueError(f"adjoint {adjoint!r} not in {ADJOINTS}")
    return _ms_deform_attn_op(value, flat_levels(spatial_shapes), sampling_locations,
                              attention_weights, adjoint)
