"""The deformable-attention entry, its Hopper kernels' wrappers and its adjoint.

`ms_deform_attn` is the one entry the model calls (encoder self-attention
and decoder cross-attention alike). It is a `torch.autograd.Function`:
  * CPU tensors run the plain PyTorch forward and backward
    (`ops/deform_attn.py`);
  * CUDA tensors launch the hand-written kernels — the forward
    `csrc/ms_deform_attn_fwd.cu`, and in the backward the d_value scatter and
    the d_loc/d_attn gather of `csrc/ms_deform_attn_bwd.cu` — or raise.
There is no fallback from one to the other.

Each source is compiled with nvcc at first use into `build/poet_tpu_torch/`
under the repository root (keyed by a hash of the source and flags), as a
shared library with a plain C interface loaded through ctypes;
`build_all()` starts every build at once. Importing this module builds
nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from poet_tpu_torch.ops.deform_attn import (
    ms_deform_attn_torch,
    ms_deform_attn_torch_backward,
)

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "poet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MAX_LEVELS = 8                     # POET_MAX_LEVELS in the sources
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the deformable-attention kernels cannot be built")


class CudaLibrary:
    """One CUDA source built into a shared library and loaded with ctypes.

    `functions` maps each exported C function to its argument types (all
    return an int: 0, a negative argument code, or a cudaError_t).
    """

    def __init__(self, source: Path, functions: dict):
        self.source = source
        self.functions = functions
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{key}.so"

    def build(self):
        """Compile (if this source has not been built yet) and load."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        so = self.library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)   # atomic: a concurrent build never sees a partial file
        lib = ctypes.CDLL(str(so))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.poet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.poet_cuda_error_string.restype = ctypes.c_char_p
        self._lib = lib
        self.build_seconds = time.perf_counter() - t0
        return lib

    def check(self, rc: int, what: str) -> None:
        if rc != 0:
            why = (self._lib.poet_cuda_error_string(rc).decode() if rc > 0
                   else "argument rejected by the kernel")
            raise RuntimeError(f"{what} launch failed ({rc}): {why}")


_LEVELS = ctypes.POINTER(ctypes.c_int)
FWD_LIB = CudaLibrary(_PKG / "csrc" / "ms_deform_attn_fwd.cu", {
    "poet_ms_deform_attn_fwd": [_P] * 4 + [_I] * 8 + [_LEVELS, _I, _P]})
BWD_LIB = CudaLibrary(_PKG / "csrc" / "ms_deform_attn_bwd.cu", {
    "poet_ms_deform_attn_bwd_dvalue": [_P] * 4 + [_I] * 8 + [_LEVELS, _I, _P],
    "poet_ms_deform_attn_bwd_dloc": [_P] * 6 + [_I] * 8 + [_LEVELS, _I, _P]})
LIBRARIES = (FWD_LIB, BWD_LIB)


def build_all() -> None:
    """Build every kernel library at once: one nvcc per source, in parallel."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.build) for lib in LIBRARIES]:
            fut.result()


def _check_inputs(value, spatial_shapes, locs, attn, dout=None):
    """Validate the operands a kernel takes; returns (B, S, Q, H, D, L, P)."""
    tensors = (value, locs, attn) + (() if dout is None else (dout,))
    if value.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {value.device}")
    if any(t.device != value.device for t in tensors):
        raise ValueError("value, locations, attention (and dout) must share one device")
    if value.dtype not in _DTYPE_CODE:
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


def _vec(t: torch.Tensor, D: int) -> int:
    """Channels per thread: one 16-byte load where D and the pointer allow."""
    width = 16 // t.element_size()
    return width if D % width == 0 and t.data_ptr() % 16 == 0 else 1


def _level_hw(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(x) for hw in spatial_shapes for x in hw])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
                attention_weights.data_ptr(), out.data_ptr(), _DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, _level_hw(spatial_shapes), _vec(value, D),
                _stream(value))
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
                dout.data_ptr(), d_value.data_ptr(), _DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, _level_hw(spatial_shapes), vec, _stream(value))
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
        vec = min(_vec(value, D), _vec(dout, D))
        with torch.cuda.device(value.device):
            rc = lib.poet_ms_deform_attn_bwd_dloc(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), dout.data_ptr(), d_loc.data_ptr(),
                d_attn.data_ptr(), _DTYPE_CODE[value.dtype], B, S, Q, H, D, L, P,
                _level_hw(spatial_shapes), vec, _stream(value))
        BWD_LIB.check(rc, "ms_deform_attn_bwd_dloc")
        self.launches += 1
        return d_loc, d_attn


MS_DEFORM_ATTN_FWD = MSDeformAttnForward()
MS_DEFORM_ATTN_DVALUE = MSDeformAttnDValue()
MS_DEFORM_ATTN_DLOC = MSDeformAttnDLocAttn()
KERNELS = (MS_DEFORM_ATTN_FWD, MS_DEFORM_ATTN_DVALUE, MS_DEFORM_ATTN_DLOC)


class _MSDeformAttn(torch.autograd.Function):
    """Deformable sampling with its adjoint: CPU -> plain versions, CUDA ->
    the three kernels."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = spatial_shapes
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
        else:
            d_value = MS_DEFORM_ATTN_DVALUE(value, shapes, locs, attn, dout)
            d_loc, d_attn = MS_DEFORM_ATTN_DLOC(value, shapes, locs, attn, dout)
        return d_value, None, d_loc, d_attn


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The model's deformable-attention entry (differentiable): CPU -> plain
    version, CUDA -> the hand-written kernels (which raise on what they do
    not take)."""
    return _MSDeformAttn.apply(value, tuple(spatial_shapes), sampling_locations,
                               attention_weights)
