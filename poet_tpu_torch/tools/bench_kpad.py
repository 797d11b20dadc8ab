"""What a bf16 tensor-core contraction costs as a function of its depth K.

    python3 poet_tpu_torch/tools/bench_kpad.py [--root DIR] [--M 960] [--N 512]
        [--R 64] [--G 66,88] [--warpgroups 2,4] [--ks 128,112,96,80,64,40,32,16,27,8]

The Hopper counterpart of `scripts/bench_kpad.py`. Its kernel
(`csrc/probe_kpad.cu`: `wgmma.mma_async` on b resident in shared memory,
staged by TMA) chains R dependent (M, K) @ (K, N) bf16 products, G times
over, each product's left operand mixed with the last accumulator scaled by
1e-30 (`a_i = a + bf16(acc[:, :K] * 1e-30)`, as the script's `bench_k`),
and writes the f32 accumulator. For each K, G and warpgroup count it prints
one JSON line: the time of one launch, the TFLOP/s for the true K and for K
padded to the wgmma depth of 16, t(K) / t(first K), the bound, its share,
the tasks' waves over the card's SMs, the kernel's error at R = 1 against
the plain version, and the device time of `torch.matmul` on one
(M, K) @ (K, N) product as the library yardstick. K = 27 is the YOLO stem
conv's contraction (3 x 3 x 3), K = 8 is below the wgmma depth. G = 66
leaves the last of 7.5 waves half full at M = 960; G = 88 runs 10 whole
waves.

`--root` times the package under DIR (default: this checkout; another
checkout, such as a parent commit unpacked beside it, for parent, change,
change, parent in one call). Run it as a script path: `-m` imports this
checkout's package whatever `--root` says. A package whose entry has no
`warpgroups` (before the wgmma design) is timed once per K and G. The
card's name and power limit come first. Needs one CUDA device.

`kpad_chain` is the entry: CPU tensors run the plain version
(`kpad_chain_torch`), CUDA tensors the kernel, or raise.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


if __name__ == "__main__":      # a script path: the package under --root first
    _pre = argparse.ArgumentParser(add_help=False)
    _pre.add_argument("--root", default=REPO)
    sys.path.insert(0, os.path.abspath(_pre.parse_known_args()[0].root))

import torch  # noqa: E402

from poet_tpu_torch.ops.cuda_build import KPAD_LIB, device_guard, stream_of  # noqa: E402

KS = (128, 112, 96, 80, 64, 40, 32, 16, 27, 8)
BF16_TC_FLOP_PER_S = 989e12        # H100 SXM, dense
MMA_DEPTH = 16                     # wgmma's k for 16-bit operands
STRIP = 64                         # rows of a task: one wgmma's M
WARPGROUPS = (2, 4)                # at N = 512: m64n256 or m64n128 a warpgroup
SMS = 132                          # H100 SXM


def default_warpgroups(K: int) -> int:
    """The faster design at depth K (measured on the H100 at M=960 N=512
    R=64, G=66 and 88; PERF.md row 11a): four warpgroups of m64n128 while
    K <= 64; above, their 128-register cap (512 threads) spills the A
    fragments, and two warpgroups of m64n256 are faster."""
    return 4 if K <= 64 else 2


def kpad_chain_torch(a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    """The plain version: acc (M, N) f32 after R chained products
    acc += (a + bf16(acc[:, :K] * 1e-30)) @ b, the products in f32."""
    K = a.shape[1]
    bf = b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for _ in range(R):
        a_i = a + (acc[:, :K] * 1e-30).to(a.dtype)
        acc = acc + a_i.float() @ bf
    return acc


def kpad_plan(M: int, N: int, K: int, G: int, warpgroups: Optional[int] = None,
              sms: int = SMS) -> dict:
    """What the kernel's launch takes (`csrc/probe_kpad.cu:launch`): the
    accumulator columns of a warpgroup (`wg_n`), the warpgroups a CTA runs
    (N padded to them), K padded to the wgmma depth, the tasks (a 64-row
    strip, a repeat), one CTA an SM, the waves of tasks, and the shared
    bytes (b's 64-column blocks of kp rows, the strip's a and two a_i
    buffers, the mbarrier, 1024 bytes of alignment). warpgroups: the
    design at N = 512 (default: `default_warpgroups(K)`)."""
    warpgroups = default_warpgroups(K) if warpgroups is None else warpgroups
    if warpgroups not in WARPGROUPS:
        raise ValueError(f"warpgroups must be one of {WARPGROUPS}, got {warpgroups}")
    wg_n = 512 // warpgroups
    n_wg = -(-N // wg_n)
    kp = -(-K // MMA_DEPTH) * MMA_DEPTH
    strips = -(-M // STRIP)
    tasks = strips * G
    blocks = min(tasks, sms)
    n_blocks = n_wg * wg_n // 64
    return {"wg_n": wg_n, "n_wg": n_wg, "threads": 128 * n_wg, "kp": kp, "strips": strips,
            "tasks": tasks, "blocks": blocks, "waves": tasks / blocks,
            "tma_blocks": -(-N // 64), "zero_blocks": n_blocks - -(-N // 64),
            "smem": 1024 + n_blocks * kp * 64 * 2 + 3 * STRIP * kp * 2 + 16}


def _check(a, b, R, G, warpgroups=None):
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"a and b must be bfloat16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a (M, K) and b (K, N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    if M % 16 or N % 32 or N > 512 or not 1 <= K <= min(N, 128):
        raise ValueError(f"the kernel takes M % 16 == 0, N % 32 == 0, N <= 512 and "
                         f"1 <= K <= min(N, 128); got M={M} N={N} K={K}")
    if R < 1 or G < 1:
        raise ValueError(f"R and G must be >= 1, got {R}, {G}")
    if warpgroups is not None and warpgroups not in WARPGROUPS:
        raise ValueError(f"warpgroups must be one of {WARPGROUPS}, got {warpgroups}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA kernel takes CUDA tensors on one device, got "
                         f"{a.device}, {b.device}")
    return M, N, K


class KPadChain:
    """Launches the probe kernel (`csrc/probe_kpad.cu`); `launches` counts
    its launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor, R: int, G: int = 1,
                 warpgroups: Optional[int] = None) -> torch.Tensor:
        M, N, K = _check(a, b, R, G, warpgroups)
        warpgroups = default_warpgroups(K) if warpgroups is None else warpgroups
        if b.data_ptr() % 16:
            b = b.clone()                    # TMA reads b from a 16-byte aligned base
        lib = KPAD_LIB.build()
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        with device_guard(a):
            rc = lib.poet_probe_kpad(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, R, G,
                                     512 // warpgroups, stream_of(a))
        KPAD_LIB.check(rc, "probe_kpad")
        self.launches += 1
        return out


KPAD_CHAIN = KPadChain()


def kpad_chain(a: torch.Tensor, b: torch.Tensor, R: int, G: int = 1,
               warpgroups: Optional[int] = None) -> torch.Tensor:
    """The chained product: CPU -> the plain version (G does not change the
    result), CUDA -> the kernel, which repeats the chain G times (in the
    design `warpgroups` names, default `default_warpgroups(K)`)."""
    if a.device.type == "cpu":
        if R < 1 or G < 1:
            raise ValueError(f"R and G must be >= 1, got {R}, {G}")
        return kpad_chain_torch(a, b, R)
    return KPAD_CHAIN(a, b, R, G, warpgroups)


def flops(M: int, N: int, K: int, R: int, G: int) -> float:
    """2 M N K R G: the products' operations at depth K."""
    return 2.0 * M * N * K * R * G


def operands(K: int, M: int, N: int, seed: int = 0, device="cuda"):
    """a (M, K) and b (K, N) bf16 from a seeded normal draw."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((M, K), generator=g).to(device=device, dtype=torch.bfloat16)
    b = torch.randn((K, N), generator=g).to(device=device, dtype=torch.bfloat16)
    return a, b


def bench_k(K: int, M: int = 960, N: int = 512, R: int = 64, G: int = 66, iters: int = 10,
            warpgroups: Optional[int] = None) -> dict:
    """One K of the sweep on the card: kernel ms, TFLOP/s (true K and K
    padded to 16), the bound and torch.matmul's ms for one (M, K) @ (K, N)
    product (on the device, replayed from a CUDA graph: launched from the
    host, the product takes less time than its launch)."""
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    a, b = operands(K, M, N)
    ms = cuda_ms(lambda: KPAD_CHAIN(a, b, R, G, warpgroups), iters=iters)
    kp = -(-K // MMA_DEPTH) * MMA_DEPTH
    matmul_ms = graph_ms(lambda: torch.matmul(a, b))
    bound_ms = flops(M, N, K, R, G) / BF16_TC_FLOP_PER_S * 1e3
    return {"K": K, "G": G, "warpgroups": warpgroups or default_warpgroups(K), "ms": ms,
            "tflops": flops(M, N, K, R, G) / ms * 1e-9,
            "tflops_pad16": flops(M, N, kp, R, G) / ms * 1e-9, "matmul_ms": matmul_ms,
            "bound_ms": bound_ms, "share": bound_ms / ms,
            "waves": kpad_plan(M, N, K, G, warpgroups)["waves"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--M", type=int, default=960)
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--R", type=int, default=64)
    ap.add_argument("--G", default="66,88")
    ap.add_argument("--warpgroups", default=",".join(map(str, WARPGROUPS)))
    ap.add_argument("--ks", default=",".join(map(str, KS)))
    args = ap.parse_args(argv)
    kp = importlib.import_module("poet_tpu_torch.tools.bench_kpad")   # the package under test
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    if not torch.cuda.is_available():
        print("bench_kpad: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    print(f"package: {os.path.dirname(os.path.dirname(kp.__file__))}; M={args.M} N={args.N} "
          f"R={args.R} bf16 -> f32, chained products on resident operands", flush=True)
    big = torch.randn((8192, 8192), device="cuda").bfloat16()
    gemm_ms = graph_ms(lambda: torch.matmul(big, big), iters=5)
    print(f"torch.matmul 8192^3 bf16 (cuBLAS, the card's reachable rate): {gemm_ms:.4f} ms, "
          f"{2 * 8192 ** 3 / gemm_ms * 1e-9:.1f} TFLOP/s", flush=True)
    del big
    has_wg = "warpgroups" in inspect.signature(kp.KPAD_CHAIN.__call__).parameters
    wgs = [int(w) for w in args.warpgroups.split(",")] if has_wg else [None]
    M, N, R = args.M, args.N, args.R
    first = {}
    for K in [int(k) for k in args.ks.split(",")]:
        a, b = kp.operands(K, M, N)
        ref = kp.kpad_chain_torch(a, b, 1)
        matmul_ms = graph_ms(lambda: torch.matmul(a, b))
        for G in [int(x) for x in args.G.split(",")]:
            for wg in wgs:
                extra = {} if wg is None else {"warpgroups": wg}
                got = kp.KPAD_CHAIN(a, b, 1, 1, **extra)
                err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
                ms = cuda_ms(lambda: kp.KPAD_CHAIN(a, b, R, G, **extra), iters=10)
                bound_ms = flops(M, N, K, R, G) / BF16_TC_FLOP_PER_S * 1e3
                kpad16 = -(-K // MMA_DEPTH) * MMA_DEPTH
                key = (G, wg)
                first.setdefault(key, (K, ms))
                row = {"K": K, "G": G, "warpgroups": wg, "ms": ms,
                       "tflops": flops(M, N, K, R, G) / ms * 1e-9,
                       "tflops_pad16": flops(M, N, kpad16, R, G) / ms * 1e-9,
                       f"t_over_t{first[key][0]}": ms / first[key][1],
                       "bound_ms": bound_ms, "share": bound_ms / ms,
                       "waves": kpad_plan(M, N, K, G)["waves"],
                       "matmul_ms": matmul_ms, "r1_rel_err": err}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
