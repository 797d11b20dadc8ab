"""Multi-scale RoIAlign: the entry the detector calls and its Hopper kernel's wrapper.

`multiscale_roi_align` takes per-level (B, H_l, W_l, C) features and
(B, R, 4) xyxy image-pixel boxes and returns (B, R, o, o, C):
  * CPU tensors run the plain version (`ops/detection.py:
    multiscale_roi_align_torch`);
  * CUDA tensors launch `csrc/roi_align_fwd.cu` through `ROI_ALIGN_FWD`, or
    raise. There is no fallback from one to the other.
Both compute the geometry the same way (`ops/detection.py:roi_geometry`, in
torch); the kernel only gathers and blends. There is no gradient: the
detector is frozen, and the JAX op raises under differentiation too, so a
CUDA input that requires grad is refused.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from poet_tpu_torch.ops.cuda_build import DTYPE_CODE, ROI_LIB, level_hw, stream_of, vec_width
from poet_tpu_torch.ops.detection import RoiGeometry, multiscale_roi_align_torch, roi_geometry

_MAX_LEVELS = 8                     # POET_ROI_MAX_LEVELS in the source


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


class RoIAlignForward:
    """Launches the RoIAlign kernel (`csrc/roi_align_fwd.cu`).

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
        N = geo.ylo.shape[1]
        sampling_ratio = N // output_size
        parts = (geo.level, geo.ylo, geo.yw, geo.xlo, geo.xw)
        if ([tuple(t.shape) for t in parts] != [(B * R,), (B * R, N), (B * R, N, 2),
                                                 (B * R, N), (B * R, N, 2)]
                or N != output_size * sampling_ratio
                or any(t.device != boxes.device or not t.is_contiguous() for t in parts)):
            raise ValueError("the geometry does not belong to these boxes")
        lib = ROI_LIB.build()
        out = torch.empty((B, R, output_size, output_size, C), dtype=features[0].dtype,
                          device=boxes.device)
        vec = min(vec_width(t, C) for t in list(features) + [out])
        ptrs = (ctypes.c_void_p * len(features))(*[f.data_ptr() for f in features])
        with torch.cuda.device(boxes.device):
            rc = lib.poet_roi_align_fwd(
                ptrs, level_hw(shapes), len(features), geo.level.data_ptr(),
                geo.ylo.data_ptr(), geo.yw.data_ptr(), geo.xlo.data_ptr(),
                geo.xw.data_ptr(), out.data_ptr(), DTYPE_CODE[features[0].dtype], B, R, C,
                output_size, sampling_ratio, vec, stream_of(boxes))
        ROI_LIB.check(rc, "roi_align_fwd")
        self.launches += 1
        return out


ROI_ALIGN_FWD = RoIAlignForward()


def multiscale_roi_align(features: Sequence[torch.Tensor], strides: Sequence[int],
                         boxes: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """The detector's RoIAlign entry: CPU -> plain version, CUDA -> the
    hand-written kernel (which raises on what it does not take)."""
    if boxes.device.type == "cpu":
        return multiscale_roi_align_torch(features, strides, boxes, output_size,
                                          sampling_ratio)
    return ROI_ALIGN_FWD(features, strides, boxes, output_size, sampling_ratio)
