"""Where the deformable-attention forward kernel's time goes, by ablation.

    python3 poet_tpu_torch/tools/bench_v3_variants.py [--root DIR]
        [--shapes rcnn|yolo] [--variants base,unroll,qt256,treey,bf16y,noy,nox]
        [--iters 20] [--floors]

The Hopper counterpart of `scripts/bench_v3_variants.py`. Its kernels
(`csrc/ms_deform_attn_fwd_variants.cu`) take the per-point body of the
forward kernel from the header both include (`csrc/ms_deform_attn_point.cuh`)
and the layout of its slab route (`csrc/ms_deform_attn_fwd.cu`, which
`plan_forward` gives the encoder: a CTA per (b, h) on its (S, D) value slab,
staged here by TMA, one (q, 8-channel slice) a thread), with one template
parameter per variant, mapping the TPU ablations onto that design:

  base    the forward kernel's arithmetic (kernel 1's output, bit for bit);
  unroll  L = P = 4 as constants, loops unrolled;
  qt256   two queries per thread;
  treey   one partial sum per level, added pairwise at the end;
  bf16y   the corner sums in packed bf16 (`__hfma2`): approximate;
  noy     no bilinear weights: each in-map corner weighted by the attention
          weight alone;
  nox     every corner reads its level's token 0 in shared memory (a
          broadcast): the arithmetic and the loop without the corner reads.

It prints ms per layer call for each variant at B=16, H=16, D=16, L=P=4,
bf16, Q = S, over the rcnn pyramid (30,40),(15,20),(8,10),(4,5) (S=1600) or
`--shapes yolo` (60,80),(30,40),(15,20),(8,10) (S=6380), with, in the same
call, kernel 1's direct and slab routes and `base` staged by kernel 1's
16-byte cp.async instead of TMA (where the package has that staging).

`--root` times the package under DIR (default: this checkout; another
checkout, such as a parent commit unpacked beside it, for parent, change,
change, parent in one call). Run it as a script path: `-m` imports this
checkout's package whatever `--root` says. The card's name and power limit
come first. Needs one CUDA device.

`--floors` prints, instead of times, `floor_counts` at the chosen pyramid,
the first points of each level moved next to the cell edges where the
rounding matters (`with_edge_points`): the sampling points whose pixel
coordinate loc * size - 0.5 floors differently as one rounding (a
contracted FMA) and as two (the plain version's), and the points where
`noy`'s kernel took its corners from another cell than its plain
definition (ROADMAP C8).

`ms_deform_attn_variant` is the entry: CPU tensors run the variant's plain
definition (`plain_variant`), CUDA tensors the kernel, or raise (a slab
over the shared memory a block may use among what it refuses).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import math
import os
import subprocess
import sys
from typing import Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


if __name__ == "__main__":      # a script path: the package under --root first
    _pre = argparse.ArgumentParser(add_help=False)
    _pre.add_argument("--root", default=REPO)
    sys.path.insert(0, os.path.abspath(_pre.parse_known_args()[0].root))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from poet_tpu_torch.ops.cuda_build import (  # noqa: E402
    VARIANTS_LIB,
    device_guard,
    level_hw,
    stream_of,
)
from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch, nonfinite_points  # noqa: E402
from poet_tpu_torch.ops.deform_attn_cuda import SMEM_OPTIN_MAX, _check_inputs  # noqa: E402

VARIANTS = ("base", "unroll", "qt256", "treey", "bf16y", "noy", "nox")
EXACT = ("base", "unroll", "qt256", "treey")     # the forward kernel's function
SHAPES = {"rcnn": ((30, 40), (15, 20), (8, 10), (4, 5)),
          "yolo": ((60, 80), (30, 40), (15, 20), (8, 10))}
STAGINGS = ("tma", "cp.async")
MAX_BOX = 256          # a TMA box's extent in one dimension: tokens, and D
BOX_ALIGN = 128        # bytes: a box's shared-memory destination


def plan_slab(S: int, D: int, itemsize: int = 2) -> dict:
    """The staged slab of one (b, h) (`csrc/ms_deform_attn_fwd_variants.cu:
    plan_slab`): boxes of `box_tokens` <= 256 tokens, as few as that allows,
    each rounded up so that every box lands 128-byte aligned; the tail box's
    tokens past S fill padding. `smem`: the bytes a CTA asks for (128 of
    alignment slack, the slab, the mbarrier)."""
    row = D * itemsize
    align = BOX_ALIGN // math.gcd(BOX_ALIGN, row)      # tokens a box is rounded to
    per_box = -(-S // -(-S // MAX_BOX))
    box = -(-per_box // align) * align
    n_boxes = -(-S // box)
    slab = n_boxes * box * row
    return {"box_tokens": box, "n_boxes": n_boxes, "slab_bytes": slab,
            "smem": BOX_ALIGN + slab + 16}


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
            x = locs[:, :, :, l, p, 0] * Wl - 0.5         # two roundings, as the kernels
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
    `launches` counts its launches, over every variant and staging (a call
    captured into a CUDA graph launches nothing: `tools/timing.py:graph_ms`
    counts its replays)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, value, spatial_shapes, locs, attn, variant: str,
                 staging: str = "tma") -> torch.Tensor:
        _check_variant(locs, variant)
        if staging not in STAGINGS:
            raise ValueError(f"staging {staging!r} not in {STAGINGS}")
        if value.dtype != torch.bfloat16:
            raise TypeError(f"the variant kernels take a bfloat16 value, got {value.dtype}")
        if value.shape[-1] % 8 or value.data_ptr() % 16:
            raise ValueError(f"the variant kernels take D % 8 == 0 and a 16-byte aligned "
                             f"value, got D={value.shape[-1]}")
        S, D = value.shape[1], value.shape[-1]
        slab = plan_slab(S, D)
        if D > MAX_BOX or slab["smem"] > SMEM_OPTIN_MAX:
            raise ValueError(f"the variant kernels stage a (b, h)'s value slab: S={S} D={D} "
                             f"takes {slab['smem']} B of shared memory (at most "
                             f"{SMEM_OPTIN_MAX}) and D <= {MAX_BOX}; over the budget")
        B, S, Q, H, D, L, P = _check_inputs(value, spatial_shapes, locs, attn)
        lib = VARIANTS_LIB.build()
        out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
        with device_guard(value):
            rc = lib.poet_ms_deform_attn_fwd_variant(
                value.data_ptr(), locs.data_ptr(), attn.data_ptr(), out.data_ptr(),
                VARIANTS.index(variant), B, S, Q, H, D, L, P, level_hw(spatial_shapes),
                STAGINGS.index(staging), stream_of(value))
        VARIANTS_LIB.check(rc, f"ms_deform_attn_fwd_variant {variant}")
        if not torch.cuda.is_current_stream_capturing():   # a capture launches nothing
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


def edge_coords(size: int) -> list:
    """f32 normalized coordinates on an axis of `size` cells whose pixel
    coordinate loc * size - 0.5 floors differently as one rounding and as
    two. Two roundings give fl(loc * size) - 0.5 (the subtraction is exact),
    one rounding fl(loc * size - 0.5): the two grids differ only where the
    difference falls into a finer binade than the product, next to the cell
    edge at 0 and at each power of two; a few f32 steps either side of
    (k + 0.5) / size hold such coordinates."""
    out = []
    for k in [0] + [2 ** m for m in range(size.bit_length()) if 2 ** m < size]:
        loc = np.float32((k + 0.5) / size)
        below = above = loc
        for _ in range(16):
            below, above = np.nextafter(below, np.float32(0)), np.nextafter(above, np.float32(1))
            for x in (below, above):
                once = np.float32(np.float64(x) * size - 0.5)
                twice = np.float32(x * np.float32(size)) - np.float32(0.5)
                if np.floor(once) != np.floor(twice):
                    out.append(float(x))
    return out


def with_edge_points(locs, spatial_shapes):
    """`locs` (B, Q, H, L, P, 2) with, on each level, the first points of the
    flattened (B, Q, H, P) grid (from query 0 on) moved onto `edge_coords` of
    that level's width (x) and height (y): points C8's rounding parts."""
    locs = locs.clone()
    B, Q, H, L, P, _ = locs.shape
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        for c, size in ((0, Wl), (1, Hl)):
            edges = torch.tensor(edge_coords(size), dtype=locs.dtype, device=locs.device)
            level = locs[:, :, :, l, :, c].permute(1, 0, 2, 3).reshape(-1)   # queries first
            level[:len(edges)] = edges
            locs[:, :, :, l, :, c] = level.view(Q, B, H, P).permute(1, 0, 2, 3)
    return locs


def floor_counts(value, spatial_shapes, locs, package=None) -> dict:
    """C8's counts on the card at these inputs (bf16 value, (B, Q, H, L, P, 2)
    locations): "one_rounding": the points whose floor of loc * size - 0.5
    differs, in x or y, between one rounding (the product exact in f64, then
    the subtraction rounded once: a contracted FMA) and two (the plain
    version's: the f32 product, then the f32 subtraction); "kernel": the
    points where `noy`'s kernel, run with the attention weight 1 on that
    point alone, departs from its plain definition by more than the output's
    bf16 rounding, i.e. summed the corners of another cell. `package`: the
    module whose MS_DEFORM_ATTN_VARIANT runs (default: this one)."""
    variant = (package or sys.modules[__name__]).MS_DEFORM_ATTN_VARIANT
    B, Q, H, L, P, _ = locs.shape
    D = value.shape[-1]
    one_rounding = torch.zeros((B, Q, H, L, P), dtype=torch.bool, device=locs.device)
    for l, (Hl, Wl) in enumerate(spatial_shapes):
        for c, size in ((0, Wl), (1, Hl)):
            x = locs[:, :, :, l, :, c]
            once = (x.double() * size - 0.5).float()
            one_rounding[:, :, :, l] |= torch.floor(once) != torch.floor(x * size - 0.5)
    v = value.float()
    kernel = 0
    with torch.inference_mode():
        sums = torch.zeros((B, Q, H, D), dtype=torch.float32, device=value.device)
        ones = torch.ones(locs.shape[:-1], dtype=torch.float32, device=locs.device)
        for i, (v_c, _, _, _, ok) in enumerate(_corners(v, spatial_shapes, locs, ones)):
            sums += torch.where(ok, 1.0, 0.0)[..., None] * v_c
            if i % 4 < 3:
                continue
            l, p = divmod(i // 4, P)          # the point's four corners are summed
            attn = torch.zeros_like(ones)
            attn[:, :, :, l, p] = 1.0
            got = variant(value, spatial_shapes, locs, attn, "noy").float().view(B, Q, H, D)
            tol = 2e-5 + 2.0 ** -8 * sums.abs()
            kernel += int(((got - sums).abs() > tol).any(-1).sum())
            sums.zero_()
    return {"one_rounding": int(one_rounding.sum()), "kernel": kernel}


def time_variants(value, spatial_shapes, locs, attn, names=VARIANTS, iters: int = 20,
                  package=None) -> dict:
    """Kernel 1's two routes and each named variant on the card, in one
    call: {"kernel1_ms": the direct route's ms, "kernel1_slab_ms": the slab
    route's (None where its slab does not fit), "base_cp_async_ms": base
    staged by cp.async, "staging_tma_ms" / "staging_cp_async_ms": base at
    one query a (b, h), the slab's staging alone, device time from CUDA-graph
    replays (each None where the package has one staging), name: {"out":
    the variant's output, "ms":
    ms per layer call, "bit_equal_kernel1": bool}}. `package`: the module
    whose MS_DEFORM_ATTN_VARIANT is timed (default: this one)."""
    from poet_tpu_torch.ops.deform_attn_cuda import (MS_DEFORM_ATTN_FWD,
                                                     MS_DEFORM_ATTN_FWD_SLAB)
    from poet_tpu_torch.tools.timing import cuda_ms, graph_ms

    variant = (package or sys.modules[__name__]).MS_DEFORM_ATTN_VARIANT
    staged = "staging" in inspect.signature(variant.__call__).parameters
    args = (value, spatial_shapes, locs, attn)
    S, D = value.shape[1], value.shape[3]
    with torch.inference_mode():
        k1 = MS_DEFORM_ATTN_FWD(*args)
        res = {"kernel1_ms": cuda_ms(lambda: MS_DEFORM_ATTN_FWD(*args), iters=iters),
               "kernel1_slab_ms": None, "base_cp_async_ms": None, "staging_tma_ms": None,
               "staging_cp_async_ms": None}
        if S * D * value.element_size() <= SMEM_OPTIN_MAX:
            res["kernel1_slab_ms"] = cuda_ms(lambda: MS_DEFORM_ATTN_FWD_SLAB(*args), iters=iters)
        if staged and "base" in names:
            out = variant(*args, "base", staging="cp.async")
            if not torch.equal(out, k1):
                raise AssertionError("base staged by cp.async is not bit-equal to kernel 1")
            res["base_cp_async_ms"] = cuda_ms(lambda: variant(*args, "base", staging="cp.async"),
                                              iters=iters)
            one = (value, spatial_shapes, locs[:, :1].contiguous(), attn[:, :1].contiguous())
            for st in STAGINGS:
                res[f"staging_{st.replace('.', '_')}_ms"] = graph_ms(
                    lambda: variant(*one, "base", staging=st), iters=iters, counted=variant)
        for name in names:
            out = variant(*args, name)
            res[name] = {"out": out, "ms": cuda_ms(lambda: variant(*args, name), iters=iters),
                         "bit_equal_kernel1": torch.equal(out, k1)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--shapes", choices=tuple(SHAPES), default="rcnn")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--floors", action="store_true")
    args = ap.parse_args(argv)
    bv = importlib.import_module("poet_tpu_torch.tools.bench_v3_variants")  # the package under test
    if not torch.cuda.is_available():
        print("bench_v3_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    shapes = SHAPES[args.shapes]
    value, locs, attn = inputs(shapes)
    if args.floors:
        locs = with_edge_points(locs, shapes)
    print(f"package: {os.path.dirname(os.path.dirname(bv.__file__))}; {args.shapes} pyramid "
          f"{shapes} (S={value.shape[1]} = Q), B=16 H=16 D=16 L=P=4, bf16", flush=True)
    if args.floors:
        counts = floor_counts(value, shapes, locs, package=bv)
        print(f"points floored differently by one rounding and two: {counts['one_rounding']}; "
              f"points where noy's kernel left its plain definition: {counts['kernel']}",
              flush=True)
        return 0
    res = time_variants(value, shapes, locs, attn, args.variants.split(","), args.iters,
                        package=bv)
    for key in ("kernel1_ms", "kernel1_slab_ms", "base_cp_async_ms", "staging_tma_ms",
                "staging_cp_async_ms"):
        x = res.pop(key)
        print(f"{key}: " + ("not run" if x is None else f"{x:.4f} ms/layer-call"), flush=True)
    for name, r in res.items():
        same = " (bit-equal to kernel 1)" if r["bit_equal_kernel1"] else ""
        print(f"variant={name}: {r['ms']:.4f} ms/layer-call{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
