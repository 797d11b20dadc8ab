"""Multi-scale RoIAlign: the entry the detector calls and its Hopper kernel's wrapper.

`multiscale_roi_align` takes per-level (B, H_l, W_l, C) features and
(B, R, 4) xyxy image-pixel boxes and returns (B, R, o, o, C). It computes
the geometry, then calls the custom operator
`torch.ops.poet_tpu_torch.roi_align_blend` (a fake implementation for
tracing, so a `torch.export`ed detector holds the operator itself):
  * CPU tensors run the plain version (`ops/detection.py:roi_blend_plain`,
    what `multiscale_roi_align_torch` blends with);
  * CUDA tensors launch `csrc/roi_align_fwd.cu` on the route `plan_roi`
    gives, or raise. There is no fallback from one to the other.
The kernel has two routes, each its own wrapper with its own launch count,
chosen by a written rule on (C, dtype, output size, sampling ratio), never
by catching a failure:
  * TILES (`ROI_ALIGN_TILES`): one block per box walks C in channel chunks,
    staging the box's distinct footprint cells of each chunk once in shared
    memory (two buffers: the next chunk's copies fly while one is blended)
    and blending separably; `plan_roi` cuts C into the largest chunks whose
    two buffers of the worst footprint, (2 o s)^2 cells each, fit
    `ROI_SMEM_TARGET` (four blocks per SM), or one 16-byte slice per chunk
    up to `SMEM_OPTIN_MAX`;
  * GATHER (`ROI_ALIGN_FWD`): a thread per (box, bin, 16-byte slice) reads
    its corners from the L2, where no chunk's footprint fits (an output grid
    or sampling ratio past the tiles route's limits).
Both take the geometry from torch (`ops/detection.py:roi_geometry`, shared
with the plain version); the kernels only gather and blend. There is no
gradient: the detector is frozen, and the JAX op raises under
differentiation too, so a CUDA input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from poet_tpu_torch.ops.cuda_build import (
    DTYPE_CODE,
    ROI_LIB,
    device_guard,
    level_hw,
    stream_of,
    vec_width,
)
from poet_tpu_torch.ops.detection import RoiGeometry, roi_blend_plain, roi_geometry

_MAX_LEVELS = 8                     # POET_ROI_MAX_LEVELS in the source
# the tiles route's limits (POET_ROI_MAX_OUT, POET_ROI_MAX_S, POET_ROI_MAX_N)
TILES_MAX_OUT, TILES_MAX_S, TILES_MAX_N = 16, 4, 32
SMEM_OPTIN_MAX = 232448             # shared memory one block may opt into on the H100
# the tiles route's shared memory per block that the rule aims under: four
# blocks of two 25 088 B buffers (16 bf16 or 8 f32 channels at the worst
# 28 x 28 footprint) and their cell offsets share an SM's 228 KB
ROI_SMEM_TARGET = 56 * 1024
# threads per tiles block (at most kTileThreads, 256): 128 ran 1.0267 ms at
# the detect+pose shape in bf16 against 256's 1.1120 (four blocks per SM by
# their shared memory either way)
ROI_THREADS = 128


class RoiPlan(NamedTuple):
    """The RoIAlign route ('tiles' or 'gather'), the channels of one staged
    chunk of the tiles route, and its dynamic shared memory (bytes)."""
    route: str
    chunk: int
    smem_bytes: int


def tiles_smem_bytes(N: int, chunk: int, itemsize: int) -> int:
    """The tiles route's shared memory: an int offset per cell and two
    buffers of the worst footprint of N samples per axis, 2N rows x 2N
    columns, of `chunk` channels."""
    cells = (2 * N) ** 2
    return -(-cells * 4 // 16) * 16 + 2 * cells * chunk * itemsize


def plan_roi(C: int, dtype: torch.dtype, output_size: int = 7,
             sampling_ratio: int = 2) -> RoiPlan:
    """The route for C channels of `dtype`: 'tiles' with the largest chunk
    (a divisor of C, a multiple of the 16-byte slice where C allows) whose
    worst footprint fits ROI_SMEM_TARGET, else the slice alone where it fits
    SMEM_OPTIN_MAX; 'gather' past the tiles route's limits or budget."""
    N = output_size * sampling_ratio
    if (output_size > TILES_MAX_OUT or sampling_ratio > TILES_MAX_S or N > TILES_MAX_N
            or C < 1):
        return RoiPlan("gather", 0, 0)
    size = torch.finfo(dtype).bits // 8
    vec = 16 // size if C % (16 // size) == 0 else 1
    chunks = [c for c in range(vec, C + 1, vec) if C % c == 0]
    fits = [c for c in chunks if tiles_smem_bytes(N, c, size) <= ROI_SMEM_TARGET]
    chunk = max(fits) if fits else vec
    smem = tiles_smem_bytes(N, chunk, size)
    if smem > SMEM_OPTIN_MAX:
        return RoiPlan("gather", 0, 0)
    return RoiPlan("tiles", chunk, smem)


def _check_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor):
    """Validate the operands the kernel takes; returns (B, R, C)."""
    tensors = list(features) + [boxes]
    if boxes.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {boxes.device}")
    if any(t.device != boxes.device for t in tensors):
        raise ValueError("features and boxes must share one device")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("multiscale RoIAlign has no gradient (the detector is frozen)")
    if not 1 <= len(features) <= _MAX_LEVELS:
        raise ValueError(f"{len(features)} levels (1 to {_MAX_LEVELS})")
    dt = features[0].dtype
    if dt not in DTYPE_CODE or any(f.dtype != dt for f in features):
        raise TypeError(f"features must all be float32 or all bfloat16, got "
                        f"{[f.dtype for f in features]}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, R, 4) float32, got {tuple(boxes.shape)} "
                         f"{boxes.dtype}")
    B, R = boxes.shape[:2]
    C = features[0].shape[-1]
    if any(f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C for f in features):
        raise ValueError(f"features must be (B={B}, H_l, W_l, C={C}), got "
                         f"{[tuple(f.shape) for f in features]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("features and boxes must be contiguous")
    return B, R, C


def _check_geometry(geo: RoiGeometry, boxes: torch.Tensor, B: int, R: int,
                    output_size: int) -> int:
    """Validate the geometry `roi_geometry` gave for these boxes; returns N,
    the samples per axis."""
    N = geo.ylo.shape[1]
    parts = (geo.level, geo.ylo, geo.yw, geo.xlo, geo.xw)
    if ([tuple(t.shape) for t in parts] != [(B * R,), (B * R, N), (B * R, N, 2),
                                             (B * R, N), (B * R, N, 2)]
            or N % output_size or N == 0
            or any(t.device != boxes.device or not t.is_contiguous() for t in parts)):
        raise ValueError("the geometry does not belong to these boxes")
    return N


class RoIAlignForward:
    """Launches the RoIAlign kernel's gather route (`csrc/roi_align_fwd.cu`,
    `roi_align_fwd_kernel`).

    `__call__` computes the geometry and launches; `launch` takes the
    geometry made beforehand. `launches` counts kernel launches and nothing
    else: a run that reads it before and after a forward learns how many
    times the detector went through the kernel.
    """

    def __init__(self):
        self.launches = 0

    def __call__(self, features: Sequence[torch.Tensor], strides: Sequence[int],
                 boxes: torch.Tensor, output_size: int = 7,
                 sampling_ratio: int = 2) -> torch.Tensor:
        """Same contract as `multiscale_roi_align_torch`; CUDA tensors only."""
        shapes = [tuple(f.shape[1:3]) for f in features]
        return self.launch(features, boxes,
                           roi_geometry(shapes, strides, boxes, output_size, sampling_ratio),
                           output_size)

    def launch(self, features: Sequence[torch.Tensor], boxes: torch.Tensor, geo: RoiGeometry,
               output_size: int = 7) -> torch.Tensor:
        """The kernel alone, on the geometry `roi_geometry` gave for these
        features and boxes -> (B, R, o, o, C)."""
        B, R, C = _check_inputs(features, boxes)
        shapes = [tuple(f.shape[1:3]) for f in features]
        N = _check_geometry(geo, boxes, B, R, output_size)
        sampling_ratio = N // output_size
        lib = ROI_LIB.build()
        out = torch.empty((B, R, output_size, output_size, C), dtype=features[0].dtype,
                          device=boxes.device)
        vec = min(vec_width(t, C) for t in list(features) + [out])
        ptrs = (ctypes.c_void_p * len(features))(*[f.data_ptr() for f in features])
        with device_guard(boxes):
            rc = lib.poet_roi_align_fwd(
                ptrs, level_hw(shapes), len(features), geo.level.data_ptr(),
                geo.ylo.data_ptr(), geo.yw.data_ptr(), geo.xlo.data_ptr(),
                geo.xw.data_ptr(), out.data_ptr(), DTYPE_CODE[features[0].dtype], B, R, C,
                output_size, sampling_ratio, vec, stream_of(boxes))
        ROI_LIB.check(rc, "roi_align_fwd")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return out


class RoIAlignTiles(RoIAlignForward):
    """Launches the RoIAlign kernel's tiles route (`csrc/roi_align_fwd.cu`,
    `roi_align_tiles_kernel`): one block per box, its footprint staged in
    shared memory chunk by chunk. `chunk` (default: `plan_roi`'s) is the
    channels of one staged chunk, `threads` those of one block. Raises
    where the route does not take the shape. `launches` counts launches."""

    def launch(self, features: Sequence[torch.Tensor], boxes: torch.Tensor, geo: RoiGeometry,
               output_size: int = 7, chunk: Optional[int] = None,
               threads: int = ROI_THREADS) -> torch.Tensor:
        B, R, C = _check_inputs(features, boxes)
        N = _check_geometry(geo, boxes, B, R, output_size)
        plan = plan_roi(C, features[0].dtype, output_size, N // output_size)
        chunk = plan.chunk if chunk is None else chunk
        if plan.route != "tiles" or chunk < 1 or C % chunk or tiles_smem_bytes(
                N, chunk, features[0].element_size()) > SMEM_OPTIN_MAX:
            raise ValueError(f"the tiles route does not take C={C} in chunks of {chunk} at "
                             f"output {output_size}, {N // output_size} samples per bin")
        lib = ROI_LIB.build()
        out = torch.empty((B, R, output_size, output_size, C), dtype=features[0].dtype,
                          device=boxes.device)
        vec = min(vec_width(t, chunk) for t in list(features) + [out])
        ptrs = (ctypes.c_void_p * len(features))(*[f.data_ptr() for f in features])
        shapes = [tuple(f.shape[1:3]) for f in features]
        with device_guard(boxes):
            rc = lib.poet_roi_align_tiles(
                ptrs, level_hw(shapes), len(features), geo.level.data_ptr(),
                geo.ylo.data_ptr(), geo.yw.data_ptr(), geo.xlo.data_ptr(),
                geo.xw.data_ptr(), out.data_ptr(), DTYPE_CODE[features[0].dtype], B, R, C,
                output_size, N // output_size, vec, chunk, threads, stream_of(boxes))
        ROI_LIB.check(rc, "roi_align_tiles")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
            self.launches += 1
        return out


ROI_ALIGN_FWD = RoIAlignForward()
ROI_ALIGN_TILES = RoIAlignTiles()


def roi_align_kernel(features: Sequence[torch.Tensor], output_size: int = 7,
                     sampling_ratio: int = 2) -> RoIAlignForward:
    """The RoIAlign route's wrapper for these features (`plan_roi`)."""
    plan = plan_roi(features[0].shape[-1], features[0].dtype, output_size, sampling_ratio)
    return ROI_ALIGN_TILES if plan.route == "tiles" else ROI_ALIGN_FWD


@torch.library.custom_op("poet_tpu_torch::roi_align_blend", mutates_args=(),
                         device_types="cpu")
def _roi_align_blend_op(features: List[torch.Tensor], boxes: torch.Tensor, level: torch.Tensor,
                        ylo: torch.Tensor, yw: torch.Tensor, xlo: torch.Tensor,
                        xw: torch.Tensor, output_size: int) -> torch.Tensor:
    """RoIAlign's gather and blend from `roi_geometry`'s geometry of `boxes`,
    as one operator: the plain blend on the CPU; the kernel on `plan_roi`'s
    route on CUDA (below)."""
    B, R = boxes.shape[:2]
    return roi_blend_plain(features, RoiGeometry(level, ylo, yw, xlo, xw), B, R, output_size)


@_roi_align_blend_op.register_kernel("cuda")
def _roi_align_blend_cuda(features, boxes, level, ylo, yw, xlo, xw, output_size):
    kernel = roi_align_kernel(features, output_size, ylo.shape[1] // output_size)
    return kernel.launch(features, boxes, RoiGeometry(level, ylo, yw, xlo, xw), output_size)


@_roi_align_blend_op.register_fake
def _roi_align_blend_fake(features, boxes, level, ylo, yw, xlo, xw, output_size):
    B, R = boxes.shape[:2]
    return features[0].new_empty((B, R, output_size, output_size, features[0].shape[-1]))


def multiscale_roi_align(features: Sequence[torch.Tensor], strides: Sequence[int],
                         boxes: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2, canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """The detector's RoIAlign entry: the geometry (`roi_geometry`, torch),
    then the operator `torch.ops.poet_tpu_torch.roi_align_blend`: CPU ->
    plain version, CUDA -> the hand-written kernel on the route `plan_roi`
    gives (which raises on what it does not take)."""
    geo = roi_geometry([tuple(f.shape[1:3]) for f in features], strides, boxes,
                       output_size, sampling_ratio, canonical_scale, canonical_level)
    return _roi_align_blend_op(list(features), boxes, geo.level, geo.ylo, geo.yw, geo.xlo,
                               geo.xw, output_size)
