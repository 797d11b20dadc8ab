"""The deformable-attention entry and its Hopper kernel's wrapper.

`ms_deform_attn` is the one entry the model calls (encoder self-attention
and decoder cross-attention alike). A CPU tensor goes to the plain PyTorch
version (`ops/deform_attn.py`); a CUDA tensor launches the hand-written
kernel `csrc/ms_deform_attn_fwd.cu` or raises — there is no fallback.

The kernel is compiled with nvcc at first use into `build/poet_tpu_torch/`
under the repository root (keyed by a hash of the source and flags), as a
shared library with a plain C interface loaded through ctypes. Importing
this module builds nothing and needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ms_deform_attn_fwd.cu"
BUILD_DIR = _PKG.parent / "build" / "poet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_MAX_LEVELS = 8                     # POET_MAX_LEVELS in the source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the deformable-attention kernel cannot be built")


class MSDeformAttnForward:
    """Builds, loads and launches the forward kernel.

    `launches` counts kernel launches made through `__call__`, and nothing
    else: a run that reads it before and after a forward learns how many
    times the model went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        key = hashlib.sha256(SOURCE.read_bytes()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"ms_deform_attn_fwd_{key}.so"

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
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)   # atomic: a concurrent build never sees a partial file
        lib = ctypes.CDLL(str(so))
        fn = lib.poet_ms_deform_attn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.poet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.poet_cuda_error_string.restype = ctypes.c_char_p
        self._lib = lib
        self.build_seconds = time.perf_counter() - t0
        return lib

    def __call__(self, value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
        """Same contract as `ms_deform_attn_torch`; CUDA tensors only."""
        tensors = (value, sampling_locations, attention_weights)
        if value.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {value.device}")
        if any(t.device != value.device for t in tensors):
            raise ValueError("value, locations and attention must share one device")
        if any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "the deformable-attention CUDA kernel is forward-only: run under "
                "torch.inference_mode(); the adjoint kernels (d_value, d_loc/d_attn, "
                "ROADMAP queue B) come with the training port")
        if value.dtype not in _DTYPE_CODE:
            raise TypeError(f"value dtype {value.dtype} not in (float32, bfloat16)")
        if sampling_locations.dtype != torch.float32 or attention_weights.dtype != torch.float32:
            raise TypeError("sampling locations and attention weights must be float32")
        if value.dim() != 4 or sampling_locations.dim() != 6 or attention_weights.dim() != 5:
            raise ValueError("expected value (B,S,H,D), locations (B,Q,H,L,P,2), "
                             "attention (B,Q,H,L,P)")
        B, S, H, D = value.shape
        _, Q, _, L, P, _ = sampling_locations.shape
        if (tuple(sampling_locations.shape) != (B, Q, H, L, P, 2)
                or tuple(attention_weights.shape) != (B, Q, H, L, P)):
            raise ValueError(f"shape mismatch: value {tuple(value.shape)}, locations "
                             f"{tuple(sampling_locations.shape)}, attention "
                             f"{tuple(attention_weights.shape)}")
        if len(spatial_shapes) != L or not 1 <= L <= _MAX_LEVELS:
            raise ValueError(f"{len(spatial_shapes)} spatial shapes for {L} levels "
                             f"(at most {_MAX_LEVELS})")
        if sum(h * w for h, w in spatial_shapes) > S:
            raise ValueError(f"levels {tuple(spatial_shapes)} exceed S={S}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("value, locations and attention must be contiguous")

        lib = self.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        width = 16 // value.element_size()          # one 16-byte vector load
        vec = width if D % width == 0 and value.data_ptr() % 16 == 0 else 1
        level_hw = (ctypes.c_int * (2 * L))(*[int(x) for hw in spatial_shapes for x in hw])
        with torch.cuda.device(value.device):
            stream = torch.cuda.current_stream(value.device).cuda_stream
            rc = lib.poet_ms_deform_attn_fwd(
                value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(), _DTYPE_CODE[value.dtype],
                B, S, Q, H, D, L, P, level_hw, vec, stream)
        if rc != 0:
            why = (lib.poet_cuda_error_string(rc).decode() if rc > 0
                   else "argument rejected by the kernel")
            raise RuntimeError(f"ms_deform_attn_fwd launch failed ({rc}): {why}")
        self.launches += 1
        return out


MS_DEFORM_ATTN_FWD = MSDeformAttnForward()


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The model's deformable-attention entry: CPU -> plain version, CUDA ->
    the hand-written kernel (which raises on what it does not take)."""
    if value.device.type == "cpu":
        return ms_deform_attn_torch(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return MS_DEFORM_ATTN_FWD(value, spatial_shapes, sampling_locations,
                              attention_weights)
