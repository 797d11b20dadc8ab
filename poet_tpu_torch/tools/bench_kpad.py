"""What a bf16 tensor-core contraction costs as a function of its depth K.

    python3 -m poet_tpu_torch.tools.bench_kpad [--M 960] [--N 512] [--R 64]
        [--G 256] [--ks 128,112,96,80,64,40,32,16,27,8]

The Hopper counterpart of `scripts/bench_kpad.py`. Its kernel
(`csrc/probe_kpad.cu`, hand-written `mma.sync` m16n8k16) chains R dependent
(M, K) @ (K, N) bf16 products on resident operands, G times over, each
product's left operand mixed with the last accumulator scaled by 1e-30
(`a_i = a + bf16(acc[:, :K] * 1e-30)`, as the script's `bench_k`), and
writes the f32 accumulator. For each K it prints the time of one launch,
the TFLOP/s for the true K and for K padded to the mma depth of 16, and
the device time of `torch.matmul` on one (M, K) @ (K, N) product as the
library yardstick. K = 27 is the YOLO stem conv's contraction (3 x 3 x 3), K = 8
is below the mma depth. Needs one CUDA device; prints the card's name and
power limit.

`kpad_chain` is the entry: CPU tensors run the plain version
(`kpad_chain_torch`), CUDA tensors the kernel, or raise.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from poet_tpu_torch.ops.cuda_build import KPAD_LIB, device_guard, stream_of
from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

KS = (128, 112, 96, 80, 64, 40, 32, 16, 27, 8)
BF16_TC_FLOP_PER_S = 989e12        # H100 SXM, dense
MMA_DEPTH = 16


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


def _check(a, b, R, G):
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

    def __call__(self, a: torch.Tensor, b: torch.Tensor, R: int, G: int = 1) -> torch.Tensor:
        M, N, K = _check(a, b, R, G)
        lib = KPAD_LIB.build()
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
        with device_guard(a):
            rc = lib.poet_probe_kpad(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, R, G,
                                     stream_of(a))
        KPAD_LIB.check(rc, "probe_kpad")
        self.launches += 1
        return out


KPAD_CHAIN = KPadChain()


def kpad_chain(a: torch.Tensor, b: torch.Tensor, R: int, G: int = 1) -> torch.Tensor:
    """The chained product: CPU -> the plain version (G does not change the
    result), CUDA -> the kernel, which repeats the chain G times."""
    if a.device.type == "cpu":
        if R < 1 or G < 1:
            raise ValueError(f"R and G must be >= 1, got {R}, {G}")
        return kpad_chain_torch(a, b, R)
    return KPAD_CHAIN(a, b, R, G)


def flops(M: int, N: int, K: int, R: int, G: int) -> float:
    """2 M N K R G: the products' operations at depth K."""
    return 2.0 * M * N * K * R * G


def operands(K: int, M: int, N: int, seed: int = 0, device="cuda"):
    """a (M, K) and b (K, N) bf16 from a seeded normal draw."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((M, K), generator=g).to(device=device, dtype=torch.bfloat16)
    b = torch.randn((K, N), generator=g).to(device=device, dtype=torch.bfloat16)
    return a, b


def bench_k(K: int, M: int = 960, N: int = 512, R: int = 64, G: int = 256,
            iters: int = 10) -> dict:
    """One K of the sweep on the card: kernel ms, TFLOP/s (true K and K
    padded to 16) and torch.matmul's ms for one (M, K) @ (K, N) product (on
    the device, replayed from a CUDA graph: launched from the host, the
    product takes less time than its launch)."""
    a, b = operands(K, M, N)
    ms = cuda_ms(lambda: KPAD_CHAIN(a, b, R, G), iters=iters)
    kp = -(-K // MMA_DEPTH) * MMA_DEPTH
    matmul_ms = graph_ms(lambda: torch.matmul(a, b))
    return {"K": K, "ms": ms, "tflops": flops(M, N, K, R, G) / ms * 1e-9,
            "tflops_pad16": flops(M, N, kp, R, G) / ms * 1e-9, "matmul_ms": matmul_ms,
            "bound_ms": flops(M, N, K, R, G) / BF16_TC_FLOP_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, default=960)
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--R", type=int, default=64)
    ap.add_argument("--G", type=int, default=256)
    ap.add_argument("--ks", default=",".join(map(str, KS)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kpad: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; M={args.M} N={args.N} R={args.R} G={args.G} bf16 -> f32, chained "
          f"mma.sync m16n8k16 on resident operands")
    ks = [int(k) for k in args.ks.split(",")]
    base = None
    for K in ks:
        a, b = operands(K, args.M, args.N)
        ref, got = kpad_chain_torch(a, b, 1), KPAD_CHAIN(a, b, 1, 1)
        err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
        r = bench_k(K, args.M, args.N, args.R, args.G)
        base = base or r
        print(f"K={K:4d}: {r['ms']:9.4f} ms  true {r['tflops']:7.2f} TFLOP/s  "
              f"padded-to-16 {r['tflops_pad16']:7.2f} TFLOP/s  "
              f"t(K)/t(K={base['K']}) {r['ms'] / base['ms']:.3f} (K-proportional "
              f"{K / base['K']:.3f})  torch.matmul one product {r['matmul_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms  R=1 rel err vs plain {err:.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
