"""Where the deformable-attention forward kernel's time goes, by ablation.

    python3 -m poet_tpu_torch.tools.bench_v3_variants [--shapes rcnn|yolo]
        [--variants base,unroll,qt256,treey,bf16y,noy,nox] [--iters 20]

The Hopper counterpart of `scripts/bench_v3_variants.py`. Its kernels
(`csrc/ms_deform_attn_fwd_variants.cu`) take the per-point body of the
forward kernel from the header both include (`csrc/ms_deform_attn_point.cuh`)
and the direct route's layout (`csrc/ms_deform_attn_fwd.cu`, bf16, 8
channels per thread), with one template parameter per variant, mapping the
TPU ablations onto the gather design:

  base    the forward kernel's arithmetic (its direct route's output, bit
          for bit);
  unroll  L = P = 4 as constants, loops unrolled;
  qt256   two queries per thread;
  treey   one partial sum per level, added pairwise at the end;
  bf16y   the corner sums in packed bf16 (`__hfma2`): approximate;
  noy     no bilinear weights: each in-map corner weighted by the attention
          weight alone;
  nox     no gather: every corner reads its level's token 0.

It prints ms per layer call for each variant at B=16, H=16, D=16, L=P=4,
bf16, Q = S, over the rcnn pyramid (30,40),(15,20),(8,10),(4,5) (S=1600) or
`--shapes yolo` (60,80),(30,40),(15,20),(8,10) (S=6380), with kernel 1's
direct route's time in the same call. Needs one CUDA device.

`ms_deform_attn_variant` is the entry: CPU tensors run the variant's plain
definition (`plain_variant`), CUDA tensors the kernel, or raise.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Sequence, Tuple

import torch

from poet_tpu_torch.ops.cuda_build import VARIANTS_LIB, device_guard, level_hw, stream_of
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch, nonfinite_points
from poet_tpu_torch.ops.deform_attn_cuda import _check_inputs

VARIANTS = ("base", "unroll", "qt256", "treey", "bf16y", "noy", "nox")
EXACT = ("base", "unroll", "qt256", "treey")     # the forward kernel's function
SHAPES = {"rcnn": ((30, 40), (15, 20), (8, 10), (4, 5)),
          "yolo": ((60, 80), (30, 40), (15, 20), (8, 10))}


def _corners(value, spatial_shapes, locs, attn):
    """Every corner of every point in the kernel's order (level, point, then
    (y0, x0), (y0, x1), (y1, x0), (y1, x1)): yields (value at the corner
    (B, Q, H, D) f32, or at the level's token 0, bilinear weight (B, Q, H)
    f32, attention weight (B, Q, H), in-map mask (B, Q, H))."""
    B, S, H, D = value.shape
    Q, P = locs.shape[1], locs.shape[4]
    v = value.float()
    h_idx = torch.arange(H, device=value.device).view(1, 1, H)
    b_idx = torch.arange(B, device=value.device).view(B, 1, 1)
    start = 0
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        for p in range(P):
            x = locs[:, :, :, l, p, 0] * Wl - 0.5
            y = locs[:, :, :, l, p, 1] * Hl - 0.5
            a = attn[:, :, :, l, p].float()
            point = (x > -1) & (x < Wl) & (y > -1) & (y < Hl)   # False for NaN
            x, y = torch.where(point, x, 0.0), torch.where(point, y, 0.0)
            x0f, y0f = torch.floor(x), torch.floor(y)
            tx, ty = x - x0f, y - y0f
            x0, y0 = x0f.long(), y0f.long()
            for dy, wy in ((0, (1 - ty) * a), (1, ty * a)):
                for dx, wx in ((0, 1 - tx), (1, tx)):
                    xi, yi = x0 + dx, y0 + dy
                    ok = point & (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
                    tok = start + yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
                    yield (v[b_idx, tok, h_idx], v[:, start][:, None].expand(B, Q, H, D),
                           wx * wy, a, ok)
        start += Hl * Wl


def plain_variant(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                  locs: torch.Tensor, attn: torch.Tensor, variant: str) -> torch.Tensor:
    """The function each variant computes, in plain PyTorch:
      base, unroll, qt256, treey: the forward kernel's (`ms_deform_attn_torch`);
      noy:  sum over in-map corners of attention weight x value;
      nox:  sum over in-map corners of bilinear weight x the level's token 0;
      bf16y: the forward kernel's terms, each weight rounded to bf16, summed
             in bf16 one corner at a time in the kernel's order (a fused
             multiply-add, rounded once to bf16; here through f32).
    (B, Q, H * D) in the value's dtype. Every variant makes the row of a
    point with a non-finite coordinate NaN, as the kernel does (the C1 rule
    of `ops/deform_attn.py`)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant in EXACT:
        return ms_deform_attn_torch(value, spatial_shapes, locs, attn)
    B, _, H, D = value.shape
    Q = locs.shape[1]
    nan_rows = nonfinite_points(spatial_shapes, locs).flatten(-2).any(-1)[..., None]
    if variant == "bf16y":
        acc = torch.zeros((B, Q, H, D), dtype=torch.bfloat16, device=value.device)
        for v_c, _, w, _, ok in _corners(value, spatial_shapes, locs, attn):
            w16 = torch.where(ok, w, 0.0).to(torch.bfloat16).float()
            acc = (w16[..., None] * v_c + acc.float()).to(torch.bfloat16)
        acc = torch.where(nan_rows, float("nan"), acc)
        return acc.reshape(B, Q, H * D).to(value.dtype)
    acc = torch.zeros((B, Q, H, D), dtype=torch.float32, device=value.device)
    for v_c, v_0, w, a, ok in _corners(value, spatial_shapes, locs, attn):
        if variant == "noy":
            acc += torch.where(ok, a, 0.0)[..., None] * v_c
        else:                                                     # nox
            acc += torch.where(ok, w, 0.0)[..., None] * v_0
    acc = torch.where(nan_rows, float("nan"), acc)
    return acc.reshape(B, Q, H * D).to(value.dtype)


def _check_variant(locs, variant):
    """What every device takes: a known variant, L = P = 4 for unroll."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "unroll" and tuple(locs.shape[3:5]) != (4, 4):
        raise ValueError(f"'unroll' fixes L = P = 4, got (L, P) = {tuple(locs.shape[3:5])}")


class MSDeformAttnVariant:
    """Launches a variant kernel (`csrc/ms_deform_attn_fwd_variants.cu`);
    `launches` counts its launches, over every variant."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value, spatial_shapes, locs, attn, variant: str) -> torch.Tensor:
        _check_variant(locs, variant)
        if value.dtype != torch.bfloat16:
            raise TypeError(f"the variant kernels take a bfloat16 value, got {value.dtype}")
        if value.shape[-1] % 8 or value.data_ptr() % 16:
            raise ValueError(f"the variant kernels take D % 8 == 0 and a 16-byte aligned "
                             f"value, got D={value.shape[-1]}")
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, locs, attn)
        lib = VARIANTS_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_fwd_variant(
                value.data_ptr(), locs.data_ptr(), attn.data_ptr(), out.data_ptr(),
                VARIANTS.index(variant), B, S, Q, H, D, L, P, level_hw(spatial_shapes),
                stream_of(value))
        VARIANTS_LIB.check(rc, f"ms_deform_attn_fwd_variant {variant}")
        self.launches += 1
        return out


MS_DEFORM_ATTN_VARIANT = MSDeformAttnVariant()


def ms_deform_attn_variant(value, spatial_shapes, locs, attn, variant: str) -> torch.Tensor:
    """A variant's output: CPU -> its plain definition, CUDA -> its kernel."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_variant(locs, variant)
    if value.device.type == "cpu":
        return plain_variant(value, spatial_shapes, locs, attn, variant)
    return MS_DEFORM_ATTN_VARIANT(value, spatial_shapes, locs, attn, variant)


def inputs(spatial_shapes, B=16, H=16, D=16, P=4, seed=0, device="cuda"):
    """The script's inputs, made on the device: value ~ N(0, 1) in bf16,
    locations ~ U[0, 1), attention weights normalized over (L, P)."""
    g = torch.Generator(device=device).manual_seed(seed)
    L = len(spatial_shapes)
    S = sum(h * w for h, w in spatial_shapes)
    value = torch.randn((B, S, H, D), generator=g, device=device).bfloat16()
    locs = torch.rand((B, S, H, L, P, 2), generator=g, device=device)
    attn = torch.rand((B, S, H, L, P), generator=g, device=device)
    attn = attn / attn.sum(dim=(-2, -1), keepdim=True)
    return value, locs, attn


def time_variants(value, spatial_shapes, locs, attn, names=VARIANTS, iters: int = 20) -> dict:
    """Kernel 1 and each named variant on the card, in one call:
    {"kernel1_ms": ms, name: {"out": the variant's output, "ms": ms per
    layer call, "bit_equal_kernel1": bool}}."""
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD
    from poet_tpu_torch.tools.timing import cuda_ms

    args = (value, spatial_shapes, locs, attn)
    with torch.inference_mode():
        k1 = MS_DEFORM_ATTN_FWD(*args)
        res = {"kernel1_ms": cuda_ms(lambda: MS_DEFORM_ATTN_FWD(*args), iters=iters)}
        for name in names:
            out = MS_DEFORM_ATTN_VARIANT(*args, name)
            res[name] = {"out": out,
                         "ms": cuda_ms(lambda: MS_DEFORM_ATTN_VARIANT(*args, name), iters=iters),
                         "bit_equal_kernel1": torch.equal(out, k1)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", choices=tuple(SHAPES), default="rcnn")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_v3_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    shapes = SHAPES[args.shapes]
    value, locs, attn = inputs(shapes)
    print(f"{card}; {args.shapes} pyramid {shapes} (S={value.shape[1]} = Q), B=16 H=16 D=16 "
          f"L=P=4, bf16")
    res = time_variants(value, shapes, locs, attn, args.variants.split(","), args.iters)
    print(f"kernel 1 (csrc/ms_deform_attn_fwd.cu): {res.pop('kernel1_ms'):.4f} ms/layer-call")
    for name, r in res.items():
        same = " (bit-equal to kernel 1)" if r["bit_equal_kernel1"] else ""
        print(f"variant={name}: {r['ms']:.4f} ms/layer-call{same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
