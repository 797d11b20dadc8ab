"""The separable (v2) deformable-attention forward: its entry and its Hopper
kernel's wrapper.

Counterpart of `poet_tpu/ops/deform_attn_pallas_v2.py:ms_deform_attn_pallas_v2`,
forward only, as JAX's is (it has no VJP). No model path reaches it, in JAX
or here: `ModelConfig` has no v2 value, so it is an op entry of its own.

  * CPU tensors run the plain version, `ops/deform_attn.py:ms_deform_attn_torch`:
    v2 computes the same function (grid_sample bilinear, zero padding,
    `align_corners=False`, f32 sums, the result in the value's dtype).
  * CUDA tensors launch `csrc/ms_deform_attn_v2.cu`, which samples a
    zero-bordered value slab staged in shared memory in row bands
    (`plan_bands`), or raise.
  * Inputs that require grad raise on either device.

Importing this module builds nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from poet_tpu_torch.ops.cuda_build import DTYPE_CODE, V2_LIB, level_hw, stream_of, vec_width
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
from poet_tpu_torch.ops.deform_attn_cuda import _check_inputs

MAX_BANDS = 64                 # POET_V2_MAX_BANDS in the source
SMEM_OPTIN_MAX = 232448        # bytes of shared memory one block may use on the H100
# a band's default budget: two blocks fit one SM (228 KB, 1 KB of it
# reserved per block)
DEFAULT_SMEM_BUDGET = 112 * 1024
THREADS_PER_BLOCK = 512        # the query chunk's target: (queries x slices)


def padded_rows(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """Cells in each padded row, levels in order: H_l + 2 rows of W_l + 2."""
    return [w + 2 for h, w in spatial_shapes for _ in range(h + 2)]


def _greedy(row_bytes: List[int], cap: int) -> List[int]:
    """First padded row of each band when bands are filled in order up to
    `cap` bytes, then the total row count."""
    starts, used = [0], 0
    for r, b in enumerate(row_bytes):
        if used + b > cap:
            starts.append(r)
            used = 0
        used += b
    return starts + [len(row_bytes)]


def plan_bands(spatial_shapes: Sequence[Tuple[int, int]], D: int, itemsize: int,
               budget: int = DEFAULT_SMEM_BUDGET) -> List[int]:
    """Cut the padded rows of a pyramid into row bands for the v2 kernel.

    Returns the first padded row of each band and then the total row count
    (n_bands + 1 ints, in order). A band holds whole padded rows, at most
    `budget` bytes of them (cells of D values of `itemsize` bytes). The
    fewest bands the budget allows, and among those the smallest largest
    band: the kernel's shared memory is the largest band, so an even split
    leaves room for more blocks per SM. Raises when one padded row exceeds
    the budget or more than MAX_BANDS bands are needed.
    """
    cell = D * itemsize
    row_bytes = [w * cell for w in padded_rows(spatial_shapes)]
    if max(row_bytes) > budget:
        raise ValueError(f"a padded row of {max(row_bytes)} bytes exceeds the band budget "
                         f"of {budget} bytes")
    n = len(_greedy(row_bytes, budget)) - 1
    if n > MAX_BANDS:
        raise ValueError(f"{n} bands needed at a budget of {budget} bytes; the kernel takes "
                         f"at most {MAX_BANDS}")
    lo, hi = max(max(row_bytes), -(-sum(row_bytes) // n)), budget
    while lo < hi:                       # the least cap that still needs n bands
        mid = (lo + hi) // 2
        if len(_greedy(row_bytes, mid)) - 1 <= n:
            hi = mid
        else:
            lo = mid + 1
    return _greedy(row_bytes, lo)


def query_chunk(B: int, H: int, Q: int, slices: int, sms: int) -> int:
    """Queries per block: THREADS_PER_BLOCK threads of `slices` channel
    slices each, fewer when the grid would not fill the card's `sms` SMs."""
    qc = max(1, min(Q, THREADS_PER_BLOCK // slices))
    blocks_per_bh = -(-sms // max(1, B * H))
    if B * H * -(-Q // qc) < sms and blocks_per_bh > 1:
        qc = max(1, min(qc, Q // blocks_per_bh))
    return qc


class MSDeformAttnV2:
    """Launches the v2 slab kernel (`csrc/ms_deform_attn_v2.cu`).

    `launches` counts kernel launches made through `__call__`, and nothing
    else. `smem_budget` caps a band's shared memory (bytes); the default
    leaves room for two blocks per SM.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                 smem_budget: int = DEFAULT_SMEM_BUDGET) -> torch.Tensor:
        """Same contract as `ms_deform_attn_torch`; CUDA tensors only."""
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, sampling_locations,
                                            attention_weights)
        bands = plan_bands(spatial_shapes, D, value.element_size(), smem_budget)
        vec = vec_width(value, D)
        sms = torch.cuda.get_device_properties(value.device).multi_processor_count
        lib = V2_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_v2_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw(spatial_shapes), vec,
                (ctypes.c_int * len(bands))(*bands), len(bands) - 1, smem_budget,
                query_chunk(B, H, Q, D // vec, sms), stream_of(value))
        V2_LIB.check(rc, "ms_deform_attn_v2_fwd")
        self.launches += 1
        return out


MS_DEFORM_ATTN_V2 = MSDeformAttnV2()


def ms_deform_attn_v2(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """The v2 forward (no gradient): CPU -> the plain version, CUDA -> the
    slab kernel (which raises on what it does not take). Raises if any
    input requires grad."""
    if any(t.requires_grad for t in (value, sampling_locations, attention_weights)):
        raise ValueError("ms_deform_attn_v2 is forward only (JAX's v2 has no VJP): "
                         "its inputs must not require grad")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return MS_DEFORM_ATTN_V2(value, spatial_shapes, sampling_locations, attention_weights)
