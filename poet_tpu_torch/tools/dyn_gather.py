"""A dynamic gather along rows on the card: out[r, c] = table[idx[r, c], c].

    python3 -m poet_tpu_torch.tools.dyn_gather [--iters 50]

The Hopper counterpart of `scripts/test_dyn_gather.py`, which tried
`jnp.take_along_axis(table, idx, axis=0)` inside a Pallas kernel. It runs
the script's four cases (a (512, 128) f32 table with a same-shape index; a
64-row index into it; the table in bf16; a 4800-row table, the size of the
encoder's level 0) through the kernel (`csrc/take_along_axis.cu`) and
prints, for each, whether it equals the plain version
(`torch.take_along_dim`) exactly, and the times of the kernel, the plain
version and `torch.gather`: per call launched from the host, and on the
device alone (the calls replayed from a CUDA graph; at these sizes the host
launch takes longer than the gather). Needs one CUDA device.

`take_along_axis` is the entry: CPU tensors run the plain version, CUDA
tensors the kernel, or raise. An index outside [0, T) raises on every
device; on the card the range is checked there before the launch (one
host sync: numpy raises here too, and JAX's Pallas result is undefined).
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from poet_tpu_torch.ops.cuda_build import (
    DTYPE_CODE,
    GATHER_LIB,
    device_guard,
    slice_width,
    stream_of,
)

# (name, table rows, index rows, dtype): the script's four cases, 128 columns
CASES = (("same shape (512, 128) f32", 512, 512, torch.float32),
         ("64-row index into a 512-row table", 512, 64, torch.float32),
         ("bf16 table", 512, 512, torch.bfloat16),
         ("4800-row table", 4800, 4800, torch.float32))
COLUMNS = 128
THREADS, BLOCKS_PER_SM = 256, 8          # kThreads, kBlocksPerSm in the source


def take_along_axis_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version."""
    return torch.take_along_dim(table, idx.long(), dim=0)


def _check(table, idx, check_range=True):
    t_shape, i_shape = table.shape, idx.shape
    if len(t_shape) != 2 or len(i_shape) != 2 or i_shape[1] != t_shape[1]:
        raise ValueError(f"expected table (T, C) and idx (R, C), got {tuple(t_shape)}, "
                         f"{tuple(i_shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.get_device() != table.get_device() or idx.device.type != table.device.type:
        raise ValueError(f"table and idx on two devices: {table.device}, {idx.device}")
    if t_shape[0] < 1:
        raise ValueError("an empty table has no row to take")
    if check_range and not bool(((idx >= 0) & (idx < table.shape[0])).all()):
        raise IndexError(f"an index outside [0, {table.shape[0]})")


def grid_blocks(R: int, C: int, vec: int, sms: int) -> int:
    """Blocks of THREADS the source launches: one thread a slice, at most
    BLOCKS_PER_SM on each of the card's `sms` SMs (the rest walked)."""
    return min(-(-R * (C // vec) // THREADS), sms * BLOCKS_PER_SM)


class TakeAlongAxis:
    """Launches the gather kernel (`csrc/take_along_axis.cu`); `launches`
    counts its launches (a call captured into a CUDA graph launches nothing:
    `timing.graph_ms` counts the replays). The library is built and its C
    function bound at the first call."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, table: torch.Tensor, idx: torch.Tensor,
                 check_range: bool = True) -> torch.Tensor:
        """`check_range=False` skips the range check and its host sync (for
        timing the kernel alone on indices already checked)."""
        _check(table, idx, check_range)
        code = DTYPE_CODE.get(table.dtype)
        if code is None:
            raise TypeError(f"table dtype {table.dtype} not in (float32, bfloat16)")
        if table.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {table.device}")
        if not table.is_contiguous():
            table = table.contiguous()
        if not idx.is_contiguous():
            idx = idx.contiguous()
        if self._fn is None:
            self._fn = GATHER_LIB.build().poet_take_along_axis
        (T, C), R = table.shape, idx.shape[0]
        out = torch.empty_like(idx, dtype=table.dtype)
        t_ptr, i_ptr, o_ptr = table.data_ptr(), idx.data_ptr(), out.data_ptr()
        vec = slice_width(C, table.element_size(), t_ptr, i_ptr, o_ptr)
        with device_guard(table):
            rc = self._fn(t_ptr, i_ptr, o_ptr, code, T, R, C, vec, stream_of(table))
        if rc:
            GATHER_LIB.check(rc, "take_along_axis")
        if not torch.cuda.is_current_stream_capturing():
            self.launches += 1
        return out


TAKE_ALONG_AXIS = TakeAlongAxis()


def take_along_axis(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, c] = table[idx[r, c], c]: CPU -> the plain version, CUDA -> the
    kernel. Raises IndexError on an index outside [0, T)."""
    if table.device.type == "cpu":
        _check(table, idx)
        return take_along_axis_torch(table, idx)
    return TAKE_ALONG_AXIS(table, idx)


def case_inputs(T: int, R: int, dtype, seed: int = 0, device="cuda"):
    """A (T, 128) normal table in `dtype` and an (R, 128) int32 index in
    [0, T), from a seeded generator."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn((T, COLUMNS), generator=g).to(dtype)
    idx = torch.randint(0, T, (R, COLUMNS), generator=g, dtype=torch.int32)
    return table.to(device), idx.to(device)


def time_case(table: torch.Tensor, idx: torch.Tensor, iters: int = 50) -> dict:
    """Times of one case on the card, for the kernel (without its range
    check), the plain version and `torch.gather` (keys prefixed "", "plain_",
    "library_"): `ms` on the device (the calls replayed from a CUDA graph)
    and `host_ms` per call launched from the host."""
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    idx64 = idx.long()
    fns = {"": lambda: TAKE_ALONG_AXIS(table, idx, False),
           "plain_": lambda: take_along_axis_torch(table, idx),
           "library_": lambda: torch.gather(table, 0, idx64)}
    return ({f"{k}ms": graph_ms(fn, counted=TAKE_ALONG_AXIS if k == "" else None)
             for k, fn in fns.items()}
            | {f"{k}host_ms": cuda_ms(fn, iters=iters) for k, fn in fns.items()})


def host_breakdown(table: torch.Tensor, idx: torch.Tensor, calls: int = 10000) -> dict:
    """Host microseconds of each step of one `TakeAlongAxis` call without
    its range check, each step timed alone over `calls` calls
    (`timing.host_us`), in the call's order, then the whole call; the forms
    the call used before (marked "was:") and `torch.gather` beside them."""
    from poet_tpu_torch.tools.timing import host_us

    (T, C), R = table.shape, idx.shape[0]
    fn = GATHER_LIB.build().poet_take_along_axis
    out = torch.empty((R, C), dtype=table.dtype, device=table.device)
    ptrs = (table.data_ptr(), idx.data_ptr(), out.data_ptr())
    vec = slice_width(C, table.element_size(), *ptrs)
    code, stream = DTYPE_CODE[table.dtype], stream_of(table)
    idx64 = idx.long()

    def guard():
        with device_guard(table):
            pass

    def old_guard():
        with torch.cuda.device(table.device):
            pass

    steps = {
        "_check": lambda: _check(table, idx, False),
        "dtype, device and contiguity tests": lambda: (
            DTYPE_CODE.get(table.dtype), table.device.type, table.is_contiguous(),
            idx.is_contiguous()),
        "torch.empty_like": lambda: torch.empty_like(idx, dtype=table.dtype),
        "data_ptr x3, slice_width": lambda: slice_width(
            C, table.element_size(), table.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "device_guard (device current)": guard,
        "stream_of (raw handle)": lambda: stream_of(table),
        "ctypes call (launch)": lambda: fn(*ptrs, code, T, R, C, vec, stream),
        "is_current_stream_capturing": torch.cuda.is_current_stream_capturing,
        "whole call": lambda: TAKE_ALONG_AXIS(table, idx, False),
        "was: .contiguous() x2": lambda: (table.contiguous(), idx.contiguous()),
        "was: GATHER_LIB.build()": GATHER_LIB.build,
        "was: torch.cuda.device context": old_guard,
        "was: torch.empty((R, C), dtype=, device=)": lambda: torch.empty(
            (R, C), dtype=table.dtype, device=table.device),
        "was: torch.cuda.current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(
            table.device).cuda_stream,
        "torch.gather, whole call": lambda: torch.gather(table, 0, idx64),
    }
    return {name: host_us(step, calls) for name, step in steps.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dyn_gather: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    for name, T, R, dtype in CASES:
        table, idx = case_inputs(T, R, dtype)
        got, ref = TAKE_ALONG_AXIS(table, idx), take_along_axis_torch(table, idx)
        t = time_case(table, idx, args.iters)
        print(f"{name}: kernel {'==' if torch.equal(got, ref) else '!='} plain; ms per call "
              f"(device ms in a CUDA graph): kernel {t['host_ms']:.4f} ({t['ms']:.4f}; without "
              f"its range check), plain {t['plain_host_ms']:.4f} ({t['plain_ms']:.4f}), "
              f"torch.gather {t['library_host_ms']:.4f} ({t['library_ms']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
