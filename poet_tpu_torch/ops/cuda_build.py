"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under `csrc/` is compiled at first use into
`build/poet_tpu_torch/` under the repository root (keyed by a hash of the
flags, the source and the `#include "..."` headers it reads), as a shared
library with a plain C interface; `build_all()` starts one nvcc per source
at once. Importing this module builds nothing and needs neither nvcc nor a
GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "poet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
P, I = ctypes.c_void_p, ctypes.c_int
INTS = ctypes.POINTER(ctypes.c_int)
PTRS = ctypes.POINTER(ctypes.c_void_p)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(source: Path) -> list:
    """`source` and every file it reads through `#include "..."`, directly
    or through another such header, resolved beside the including file: the
    files a library's key must cover, in a fixed order."""
    seen, todo = [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo.extend((path.parent / m.decode()).resolve()
                    for m in _INCLUDE.findall(path.read_bytes()))
    return seen


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
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in local_includes(self.source):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"

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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def vec_width(t: torch.Tensor, n: int) -> int:
    """Channels per thread: one 16-byte load where the channel count `n`
    and the pointer allow, else 1."""
    width = 16 // t.element_size()
    return width if n % width == 0 and t.data_ptr() % 16 == 0 else 1


def level_hw(shapes) -> ctypes.Array:
    """(H_l, W_l) per level as the kernels' host array of 2 L ints."""
    return (ctypes.c_int * (2 * len(shapes)))(*[int(x) for hw in shapes for x in hw])


FWD_LIB = CudaLibrary(CSRC / "ms_deform_attn_fwd.cu", {
    "poet_ms_deform_attn_fwd": [P] * 4 + [I] * 8 + [INTS, I, P],
    "poet_ms_deform_attn_fwd_slab": [P] * 4 + [I] * 8 + [INTS, I, P]})
BWD_LIB = CudaLibrary(CSRC / "ms_deform_attn_bwd.cu", {
    "poet_ms_deform_attn_bwd_dvalue": [P] * 4 + [I] * 8 + [INTS, I, P],
    "poet_ms_deform_attn_bwd_dvalue_slab": [P] * 4 + [I] * 8 + [INTS, I, I, I, P],
    "poet_ms_deform_attn_bwd_dloc": [P] * 6 + [I] * 8 + [INTS, I, P],
    "poet_ms_deform_attn_bwd_merged": [P] * 7 + [I] * 8 + [INTS, I, P],
    "poet_ms_deform_attn_bwd_merged_slab": [P] * 7 + [I] * 8 + [INTS, I, I, P]})
ROI_LIB = CudaLibrary(CSRC / "roi_align_fwd.cu", {
    "poet_roi_align_fwd": [PTRS, INTS, I] + [P] * 6 + [I] * 7 + [P],
    "poet_roi_align_tiles": [PTRS, INTS, I] + [P] * 6 + [I] * 9 + [P]})
STEM_LIB = CudaLibrary(CSRC / "conv_stem_fwd.cu", {
    "poet_conv_stem_fwd": [P] * 4 + [I] * 15 + [P]})
NN_LIB = CudaLibrary(CSRC / "min_dist_sq_fwd.cu", {
    "poet_min_dist_sq_fwd": [P] * 3 + [I] * 3 + [P]})
DENSE_LIB = CudaLibrary(CSRC / "ms_deform_attn_dense.cu", {
    "poet_ms_deform_attn_dense_fwd": [P] * 4 + [I] * 8 + [INTS, P],
    "poet_ms_deform_attn_dense_bwd": [P] * 7 + [I] * 8 + [INTS, I, I, P]})
V2_LIB = CudaLibrary(CSRC / "ms_deform_attn_v2.cu", {
    "poet_ms_deform_attn_v2_fwd": [P] * 4 + [I] * 8 + [INTS, I, INTS, I, I, I, P]})
# the probes (poet_tpu_torch/tools/)
KPAD_LIB = CudaLibrary(CSRC / "probe_kpad.cu", {
    "poet_probe_kpad": [P] * 3 + [I] * 5 + [P]})
VARIANTS_LIB = CudaLibrary(CSRC / "ms_deform_attn_fwd_variants.cu", {
    "poet_ms_deform_attn_fwd_variant": [P] * 4 + [I] * 8 + [INTS, P]})
GATHER_LIB = CudaLibrary(CSRC / "take_along_axis.cu", {
    "poet_take_along_axis": [P] * 3 + [I] * 4 + [P]})
LIBRARIES = (FWD_LIB, BWD_LIB, ROI_LIB, STEM_LIB, NN_LIB, DENSE_LIB, V2_LIB, KPAD_LIB,
             VARIANTS_LIB, GATHER_LIB)


def build_all() -> None:
    """Build every kernel library at once: one nvcc per source, in parallel."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.build) for lib in LIBRARIES]:
            fut.result()
