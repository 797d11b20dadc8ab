#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--only N,N,...]

(--only runs phases 1, 2 and the listed ones, and prints no kernel report.)
Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels (deformable attention on its gather and dense routes,
     RoIAlign, the stem conv, the min distance) from poet_tpu_torch/csrc with
     nvcc, one process per source, in parallel;
  3. the forward kernel against its plain PyTorch version on the card:
     flagship encoder (Q=S=1600) and decoder (Q=10) shapes at B=16, edge
     level geometries, out-of-map and dummy-query locations; f32 and bf16;
     times; and autograd through the entry on CUDA tensors;
  4. the serving slice: the port's PoseServer at the paper config, bf16,
     batch 16, 480x640, seeded weights, the flagship numpy batch; outputs
     finite, rotations orthonormal with det +1, exactly 10 forward launches
     (5 encoder + 5 decoder layers) and no adjoint or RoIAlign launch per
     request; p50 ms and img/s;
  5. f32 end to end: the same seeded model at B=2 on the card (kernel) against
     the port on the CPU (plain version), TF32 off;
  6. the two adjoint kernels (d_value scatter, d_loc/d_attn gather) against
     the plain adjoint on the card: phase 3's geometries plus trailing pad
     tokens; f32 and bf16; NaN locations; times of each kernel, of the plain
     adjoint of its own outputs (autograd with respect to those inputs
     alone) and of the whole plain adjoint;
  7. the train slice: 8 steps of the paper config, bf16 over f32 master
     weights, B=16, 480x640, seeded weights, the flagship batch, dropout 0.1,
     AdamW with clipping; exactly 10 forward, 10 d_value and 10 d_loc
     launches and no RoIAlign launch per step, finite losses and grad norm,
     the frozen backbone bit-identical, the encoder moved; step p50 ms,
     img/s, peak memory;
  8. one f32 train step at B=2, 480x640, TF32 off: losses, grad norm and
     every gradient on the card (kernels) against the CPU port (plain);
  9. the RoIAlign kernel against its plain version on the card: the
     detect+pose shape (levels (120,160)..(15,20) x 256, 16 x 1000
     proposals), edge boxes (under 1 px, slivers, outside the image,
     oversized, NaN) and a pyramid ending in a 2x2 level with C=6 (scalar
     loads); f32 and bf16; kernel and plain ms;
 10. detect+pose serving: PoseServer in detector mode at the
     `bench.py:bench_maskrcnn_detect_pose` config (bbox_mode='backbone',
     bf16, batch 16, 480x640, 22 detector classes, 1000 proposals, 100
     detections), seeded weights with well-conditioned detector heads: 8
     requests through `infer`, then 8 through the pipelined `stream`;
     exactly 1 RoIAlign and 10 forward launches per request and no adjoint
     launch; outputs finite, rotations in SO(3), n_boxes <= Q, boxes inside
     the image; valid detections per image, p50/p95, img/s, peak memory;
     then one request through the final NMS's exact fallback (the whole
     batch's per-class suppression, nms_prune_k=0): the pruned path's rows,
     its ms and peak memory;
 11. f32 detect+pose at B=2, the card against the CPU port, TF32 off: the
     selected queries matched row for row (robust to rank flips among
     near-equal scores), and the poses of both on the same detections;
 12. the stem conv kernel against its plain version on the card: the
     YOLOv4-CSP entry convs at the path's shapes (B=16; 3->32 3x3 and 32->64
     3x3/2 at 480x640, 32->64 3x3 at 240x320; mish), the ResNet 7x7/2 stem,
     and edge rows at B=2, 38x52 (asymmetric padding, 1x1, no bias, each
     activation, channel counts that take scalar loads and stores, more
     than 64 output channels); f32 (TF32 off) and bf16; kernel, plain and
     cuDNN ms and the bounds at f32 and at bf16 tensor-core rate;
 13. YOLOv4-CSP detect+pose serving: PoseServer in detector mode at the
     `bench.py:bench_yolov4_detect_pose(encoder_min_stride=1)` config (bf16,
     batch 16, 480x640, the shipped cfg, conf 0.4, class NMS over the top
     512, 20 detections, 6380 tokens), seeded well-conditioned weights: 8
     requests through `infer`, then 8 through `stream`; exactly 3 stem and
     10 forward launches per request and no other; outputs finite,
     rotations in SO(3), n_boxes <= Q, boxes inside the image, at least one
     valid detection per image; p50/p95, img/s, peak memory, NMS iterations;
 14. f32 YOLO detect+pose at B=2, the card against the CPU port, TF32 off:
     the selected queries row for row, the poses on the CPU's detections;
 15. the min-distance (ADD-S) kernel against its plain version on the card:
     the BOP shape (P=64, N=M=15 000), P=N=M=1, N=257 M=1000, M << N,
     M >> N, clouds ~1 m from the origin, exact duplicates (minimum 0), a
     NaN est cloud and a NaN gt point (NaN as in the plain version);
     kernel, plain and torch.cdist ms, the bound of the matrix-unit form
     and the direct form's f32 bound;
 16. evaluation in gt mode: pose_evaluate at the paper config (bf16, B=16,
     480x640, seeded weights) over 8 batches of the `flagship.EvalFixture`
     (1-10 objects per image, the 21 YCB-V classes, 15 000-point clouds),
     then bop_evaluate over it; exactly 10 forward launches per batch, no
     other but sum_c ceil(P_c / 64) min-distance launches in the ADD-S pass
     and none in ADD(-S); finite results, the five metric directories,
     every object matched, one CSV row per pair; the same pairs with pred
     = gt score 100 and the full AUC; ADD-S card (kernel, TF32 on) vs CPU
     port (plain) on every pair; images/s, host-wait share, seconds per pass;
 17. evaluation in backbone mode at phase 10's config, 2 batches, on
     targets made of the detector's own detections: 1 RoIAlign and 10
     forward launches per batch, matched pairs = valid detections;
 18. the merged adjoint kernel against the plain adjoint and against the
     pair of phase 6 (phase 6's geometries, f32 and bf16, NaN locations ->
     0), autograd through the entry with adjoint='merged'; merged, pair and
     plain ms and the bound;
 19. the dense one-hot forward and adjoint kernels ('pallas') against the
     plain versions: phase 6's geometries and the YOLO pyramid (S=6380), f32
     and bf16, NaN locations held to the plain version on the card (the
     point adds nothing, no NaN anywhere), the
     adjoint's outputs bit-identical over two runs, autograd through the
     entry; dense, kernel 1, pair, merged and plain ms; the bounds on the
     tensor cores and in the gather form;
 20. the paths of the new kernels at phase 4's and 7's config: 8 gt-serving
     requests through `infer` with enc/dec_deform_impl='pallas' (10 dense
     forward launches each and no other), 8 train steps with 'pallas' (10
     dense forward + 10 dense adjoint per step and no other) and 8 with the
     merged adjoint (10 forward + 10 merged per step and no other), each
     beside phase 4's or 7's p50 and img/s; one f32 train step of each at
     B=2 on the card against the CPU port, as phase 8.
Phases 4, 7, 10, 13, 16, 17 and 20's paths each set every kernel's launch
count to 0 before they drive their path and read them after. Every kernel's entry in
the report carries its bound: the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate for its type (67 TFLOP/s f32 for the
gathers; for the contractions that the TPU kernels run on their matrix
unit, 989 TFLOP/s bf16 for the stem and the dense one-hot products and 495
TFLOP/s TF32, three products per f32 product, for the min distance's cross
term; each with its f32 bound beside it), for this run's inputs. The last two lines are the kernel report and
{"ok": true, "device": ...}. Exits non-zero without a CUDA device, and
imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain, f32: the same f32 arithmetic in another order (~1e-7 of
# O(1) outputs); bf16: the kernel rounds its f32 sum to bf16 once (half an
# ulp, 2^-8 relative) against the plain version on the same bf16-rounded values
F32_ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -8, 2e-5
# card (kernel, cuDNN, cuBLAS, TF32 off) against CPU, f32, relative to the
# output scale: ResNet-50 + 10 transformer layers summed in other orders
E2E_RTOL = 2e-3
REQUESTS = 8
TRAIN_STEPS = 8
# f32 train step, card (kernels, cuDNN, cuBLAS, TF32 off) against the CPU
# port (plain versions). Losses: the same f32 sums in other orders. Each
# gradient tensor, relative to the CPU's: d_loc jumps where a sampling
# coordinate crosses a cell edge, and the two f32 forwards differ by ~1e-5,
# so a few hundred of the 8.2 M sampling coordinates fall on the other side
# of an edge: relative L2 error per tensor, and max element against the
# tensor's max |CPU value|, plus a floor of GRAD_FLOOR x the step's largest
# gradient entry. (Two card runs agree to ~5e-7: the atomics' order.)
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_L2_RTOL, TRAIN_F32_MAX_RTOL = 2e-3, 1e-2
GRAD_FLOOR = 1e-6
FLAGSHIP_LEVELS = ((30, 40), (15, 20), (8, 10), (4, 5))
FLAGSHIP_HW = (480, 640)
DEVICE = "cuda"
# adjoint kernels vs the plain adjoint, relative to each output's max |ref|:
# the same f32 arithmetic in another order (atomics reorder d_value's sum
# from run to run; grid_sample's backward uses atomics too)
ADJ_RTOL = 1e-5
# d_loc is the derivative of a piecewise bilinear function: it jumps where
# a pixel coordinate crosses a cell edge, and the kernel (loc * W - 0.5) and
# grid_sample ((2 loc - 1 + 1) * W - 1) / 2 round the coordinate differently
# (~1 ulp). Components within this many pixels of an edge are not compared.
BOUNDARY_PX = 1e-4
# (name, B, Q, H, D, levels, loc range, trailing pad tokens)
GEOMETRIES = [
    ("encoder", 16, 1600, 16, 16, FLAGSHIP_LEVELS, 0.0, 1.0, 0),
    ("decoder", 16, 10, 16, 16, FLAGSHIP_LEVELS, -0.2, 1.2, 0),
    ("edge(1,7)(3,1)(1,1)", 2, 5, 2, 8, ((1, 7), (3, 1), (1, 1)), -0.2, 1.2, 0),
    ("edge D=6 (scalar loads)", 2, 9, 3, 6, ((5, 7), (3, 4)), -0.2, 1.2, 0),
    ("far out of map", 2, 9, 2, 8, ((6, 9), (4, 5), (2, 3)), -3.5, 4.5, 0),
]
ADJ_GEOMETRIES = GEOMETRIES + [
    ("S > levels (7 pad tokens)", 2, 9, 4, 8, ((4, 5), (2, 3)), -0.2, 1.2, 7),
]
# the card's published peaks (H100 SXM data sheet): the bounds in the report
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# RoIAlign kernel vs plain, f32, relative to max |feature|: the same f32
# blend summed in another order; bf16 adds one bf16 rounding (2^-8 |ref|)
ROI_F32_RTOL = 1e-5
ROI_STRIDES = (4, 8, 16, 32)
# (name, B, R, C, image (H, W), box kind)
ROI_GEOMETRIES = [
    ("detect+pose", 16, 1000, 256, FLAGSHIP_HW, "proposals"),
    ("edge boxes", 2, 300, 256, FLAGSHIP_HW, "edges"),
    ("2x2 level, C=6 (scalar loads)", 2, 200, 6, (64, 64), "edges"),
]
DETECT_REQUESTS = 8
YOLO_REQUESTS = 8
BF16_TC_FLOP_PER_S = 989e12
TF32_TC_FLOP_PER_S = 495e12
# stem kernel vs plain, f32 (TF32 off), relative to max |ref|: the same f32
# FMAs in another order; bf16 adds one bf16 rounding (2^-8 |ref|)
STEM_F32_RTOL = 1e-5
# (name, B, H, W, C, F, kh, kw, stride, padding, activation, bias)
PAD1 = ((1, 1), (1, 1))
STEM_GEOMETRIES = [
    ("yolo L0", 16, 480, 640, 3, 32, 3, 3, 1, PAD1, "mish", True),
    ("yolo L1", 16, 480, 640, 32, 64, 3, 3, 2, PAD1, "mish", True),
    ("yolo L3", 16, 240, 320, 32, 64, 3, 3, 1, PAD1, "mish", True),
    ("resnet stem", 16, 480, 640, 3, 64, 7, 7, 2, ((3, 3), (3, 3)), "relu", False),
    ("5x3/2 asymmetric", 2, 38, 52, 4, 16, 5, 3, 2, ((2, 1), (1, 2)), None, True),
    ("1x1", 2, 38, 52, 8, 24, 1, 1, 1, ((0, 0), (0, 0)), "relu", True),
    ("no bias, none", 2, 38, 52, 3, 32, 3, 3, 1, PAD1, None, False),
    ("no bias, relu", 2, 38, 52, 3, 32, 3, 3, 1, PAD1, "relu", False),
    ("no bias, mish", 2, 38, 52, 32, 64, 3, 3, 2, PAD1, "mish", False),
    ("no bias, leaky", 2, 38, 52, 32, 64, 3, 3, 1, PAD1, "leaky", False),
    ("C=5 F=12 (scalar loads, stores)", 2, 38, 52, 5, 12, 3, 3, 2, PAD1, "leaky", True),
    ("F=72 (two channel chunks)", 2, 38, 52, 8, 72, 3, 3, 1, PAD1, "mish", True),
]
STEM_PATH = ("yolo L0", "yolo L1", "yolo L3")
# f32 detect+pose card vs CPU: rows match when class, score (1e-4) and box
# (5e-3 px) agree, as in the detector parity tests; poses of matched rows
# within E2E_RTOL of the output scale
DET_SCORE_ATOL, DET_BOX_ATOL_PX = 1e-4, 5e-3
# min-distance kernel vs plain, relative to the case's max |gt|^2: the same
# f32 arithmetic, which nvcc contracts into one multiply and two FMAs where
# the plain version rounds three products and two sums (a few ulps of a
# squared distance, itself <= 4 max|gt|^2 for clouds of one extent)
NN_RTOL = 2e-6
# (name, P, N, M, kind)
NN_CASES = [
    ("BOP shape", 64, 15000, 15000, "centred"),
    ("P=N=M=1", 1, 1, 1, "centred"),
    ("N=257 M=1000", 3, 257, 1000, "centred"),
    ("M << N", 4, 5000, 7, "centred"),
    ("M >> N", 4, 9, 20000, "centred"),
    ("uncentred, ~1 m from the origin", 8, 3000, 3000, "uncentred"),
    ("exact duplicates", 4, 3000, 2000, "duplicates"),
    ("NaN", 4, 1000, 1500, "nan"),
]
NN_LIBRARY_CHUNK = 8
EVAL_B, EVAL_BATCHES = 16, 8
EVAL_BACKBONE_BATCHES = 2
# ADD-S card (kernel) vs CPU port (plain), meters: the transforms and minima
# in f32 in other orders (~1e-8 m), far below the 1e-4 m AUC step
EVAL_ADDS_ATOL = 1e-6
# the card-vs-CPU ADD-S check runs over every 32nd point of each cloud (469
# of 15 000): the CPU's plain search of a full cloud takes seconds per pose
EVAL_THIN = 32


KERNEL_KEYS = ("fwd", "d_value", "d_loc", "roi", "stem", "nn", "merged", "dense_fwd",
               "dense_bwd")
LAUNCH_NAMES = "/".join(KERNEL_KEYS)


def log(msg: str) -> None:
    print(msg, flush=True)


def all_kernels():
    """Every kernel wrapper, in the report's order (KERNEL_KEYS): forward,
    d_value, d_loc, RoIAlign, stem, min distance, merged adjoint, dense
    forward, dense adjoint."""
    from poet_tpu_torch.ops import deform_attn_cuda as gather
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
    from poet_tpu_torch.ops.conv_stem_cuda import CONV_STEM_FWD
    from poet_tpu_torch.ops.nn_cuda import MIN_DIST_SQ
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_FWD

    return [gather.MS_DEFORM_ATTN_FWD, gather.MS_DEFORM_ATTN_DVALUE, gather.MS_DEFORM_ATTN_DLOC,
            ROI_ALIGN_FWD, CONV_STEM_FWD, MIN_DIST_SQ, gather.MS_DEFORM_ATTN_MERGED,
            dense.MS_DEFORM_ATTN_DENSE_FWD, dense.MS_DEFORM_ATTN_DENSE_BWD]


def expected(**counts):
    """A launch vector in all_kernels()'s order: the named counts, 0 elsewhere."""
    if set(counts) - set(KERNEL_KEYS):
        raise KeyError(f"unknown kernels {set(counts) - set(KERNEL_KEYS)}")
    return [counts.get(k, 0) for k in KERNEL_KEYS]


@contextlib.contextmanager
def tf32(allow: bool):
    """TF32 for cuBLAS and cuDNN on or off (cuDNN convs default to TF32)."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def tf32_off():
    """Full f32 for cuBLAS and cuDNN."""
    return tf32(False)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def deform_points_in_map(locs, shapes) -> int:
    """Sampling points whose 2x2 footprint meets their level (the kernels
    skip the rest)."""
    n = 0
    for l, (h, w) in enumerate(shapes):
        x = locs[..., l, :, 0] * w - 0.5
        y = locs[..., l, :, 1] * h - 0.5
        n += int(((x > -1) & (x < w) & (y > -1) & (y < h)).sum())
    return n


def deform_bound(locs, shapes, D, *tensors):
    """Bound of a deformable kernel that reads and writes `tensors` and
    does 4 corners x D channels x 2 operations per point in the map."""
    return bound(nbytes(*tensors), 8.0 * D * deform_points_in_map(locs, shapes))


def deform_inputs(g, B, Q, H, D, shapes, P=4, lo=-0.2, hi=1.2, dtype=None, pad=0):
    import torch

    L = len(shapes)
    S = sum(h * w for h, w in shapes) + pad
    value = torch.randn((B, S, H, D), generator=g, device=DEVICE)
    locs = lo + (hi - lo) * torch.rand((B, Q, H, L, P, 2), generator=g, device=DEVICE)
    attn = torch.rand((B, Q, H, L * P), generator=g, device=DEVICE)
    attn = (attn / attn.sum(-1, keepdim=True)).view(B, Q, H, L, P)
    if Q >= 4:   # dummy-query conventions: boxes -1 and the -10 fill
        locs[:, -1] = -10.0
        locs[:, -2] = -1.0
    return value.to(dtype or torch.float32), locs.contiguous(), attn.contiguous()


def phase_kernel(report):
    import torch

    from poet_tpu_torch.ops.deform_attn import (
        ms_deform_attn_torch,
        ms_deform_attn_torch_backward,
    )
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K
    from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn

    g = torch.Generator(device=DEVICE).manual_seed(0)
    max_err32 = 0.0
    for name, B, Q, H, D, shapes, lo, hi, _ in GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi)
        with torch.inference_mode():
            plain = ms_deform_attn_torch(value, shapes, locs, attn)
            got = K(value, shapes, locs, attn)
            torch.cuda.synchronize()
            err32 = (got - plain).abs().max().item()
            if not err32 <= F32_ATOL:
                raise AssertionError(f"{name} f32: max |kernel - plain| {err32} > {F32_ATOL}")
            v16 = value.bfloat16()
            plain16 = ms_deform_attn_torch(v16.float(), shapes, locs, attn)
            got16 = K(v16, shapes, locs, attn)
            torch.cuda.synchronize()
            if got16.dtype != torch.bfloat16:
                raise AssertionError(f"{name}: bf16 kernel returned {got16.dtype}")
            err16 = (got16.float() - plain16).abs()
            bound = BF16_ATOL + BF16_RTOL * plain16.abs()
            if not bool((err16 <= bound).all()):
                raise AssertionError(f"{name} bf16: max |kernel - plain| {err16.max().item()} "
                                     f"beyond atol {BF16_ATOL} + rtol {BF16_RTOL}")
        max_err32 = max(max_err32, err32)
        line = (f"kernel-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} "
                f"f32 max_abs_err={err32:.3e} (tol {F32_ATOL}) "
                f"bf16 max_abs_err={err16.max().item():.3e} "
                f"(tol {BF16_ATOL} + {BF16_RTOL:.5f}*|ref|)")
        if name in ("encoder", "decoder"):
            with torch.inference_mode():
                t = {}
                for dt, v in (("f32", value), ("bf16", v16)):
                    t[dt] = (cuda_ms(lambda: K(v, shapes, locs, attn)),
                             cuda_ms(lambda: ms_deform_attn_torch(v, shapes, locs, attn)))
            line += (f" | ms kernel/plain: f32 {t['f32'][0]:.4f}/{t['f32'][1]:.4f}, "
                     f"bf16 {t['bf16'][0]:.4f}/{t['bf16'][1]:.4f}")
            report[name] = {"ms": t["bf16"][0], "plain_ms": t["bf16"][1],
                            "f32_ms": t["f32"][0], "f32_plain_ms": t["f32"][1]}
            if name == "encoder":
                report[name]["bound"] = deform_bound(locs, shapes, D, v16, locs, attn, got16)
        log(line)

    # CUDA tensors that require grad go through the entry and its adjoint
    shapes = ((3, 4), (2, 2))
    v, l, a = deform_inputs(g, 1, 6, 2, 8, shapes)
    dout = torch.randn((1, 6, 16), generator=g, device=DEVICE)
    leaves = [t.clone().requires_grad_() for t in (v, l, a)]
    ms_deform_attn(leaves[0], shapes, *leaves[1:]).backward(dout)
    want = ms_deform_attn_torch_backward(v, shapes, l, a, dout)
    for name, t, ref in zip(("d_value", "d_loc", "d_attn"), leaves, want):
        err = (t.grad - ref).abs().max().item()
        if not err <= ADJ_RTOL * max(ref.abs().max().item(), 1.0):
            raise AssertionError(f"autograd through the kernels: {name} max err {err}")
    log("kernel entry with requires_grad: backward through the adjoint kernels "
        "matches the plain adjoint")
    report["max_abs_err"] = max_err32


def off_edges(locs, shapes):
    """(B, Q, H, L, P, 2) bool: the pixel coordinate lies more than
    BOUNDARY_PX from a cell edge (where d_loc is continuous)."""
    import torch

    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float64, device=locs.device)
    pix = locs.double() * wh[:, None, :] - 0.5
    return (pix - pix.round()).abs() > BOUNDARY_PX


def adjoint_err(got, ref, mask=None, bf16=False, roundings=1):
    """Max |got - ref|, and whether it goes beyond ADJ_RTOL * max|ref| (plus
    `roundings` bf16 roundings, 2^-8 relative each, for a bf16 result)."""
    scale = max(ref.abs().max().item(), 1e-30)
    err = (got.float() - ref).abs()
    bound = ADJ_RTOL * scale + (roundings * BF16_RTOL * ref.abs() if bf16 else 0.0)
    bad = err > bound
    if mask is not None:
        err, bad = err[mask], bad[mask]
    return err.max().item() if err.numel() else 0.0, bool(bad.any())


def adjoint_checks(name, got, ref, value, locs, Q, S_lv, pad, mask, bf16, roundings=1):
    """Phase 6's checks of an adjoint's (d_value, d_loc, d_attn) against
    `ref` (the plain adjoint, or another kernel's): dtype and shape, zero
    rows past the levels, zero gradients of the dummy queries, and each
    output within ADJ_RTOL x max|ref| (d_loc off cell edges, a bf16 d_value
    plus `roundings` bf16 roundings: 2 against another kernel's bf16 d_value).
    Returns the max errors by output."""
    import torch

    dt = torch.bfloat16 if bf16 else torch.float32
    if got[0].dtype != dt or tuple(got[0].shape) != tuple(value.shape):
        raise AssertionError(f"{name}: d_value {got[0].dtype} {tuple(got[0].shape)}")
    if pad and not bool((got[0][:, S_lv:] == 0).all()):
        raise AssertionError(f"{name}: d_value rows past the levels are not 0")
    if Q >= 4 and not all(bool((t[:, -2:] == 0).all()) for t in got[1:]):
        raise AssertionError(f"{name}: dummy queries (-1, -10) got a gradient")
    errs = {}
    for k, gt, rf, m, b16 in zip(("d_value", "d_loc", "d_attn"), got, ref, (None, mask, None),
                                 (bf16, False, False)):
        errs[k], bad = adjoint_err(gt, rf, m, b16, roundings)
        if bad:
            raise AssertionError(f"{name} {dt}: {k} max |kernel - ref| {errs[k]:.3e} beyond "
                                 f"{ADJ_RTOL} x {rf.abs().max().item():.3e}"
                                 + (f" + {roundings} x 2^-8 |ref|" if b16 else ""))
    return errs


def plain_adjoint_of(value, shapes, locs, attn, dout, wrt):
    """The plain adjoint with respect to the inputs numbered in `wrt` (0
    value, 1 locations, 2 weights) alone: autograd then skips the other
    branch, so each kernel is timed against the plain version of its own
    outputs."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch

    with torch.enable_grad():
        ins = [t.detach().requires_grad_(i in wrt) for i, t in enumerate((value, locs, attn))]
        out = ms_deform_attn_torch(ins[0], shapes, *ins[1:])
        return torch.autograd.grad(out, [ins[i] for i in wrt], dout)


def phase_adjoint(report):
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DLOC as KL
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DVALUE as KV

    g = torch.Generator(device=DEVICE).manual_seed(1)
    worst = {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}
    for name, B, Q, H, D, shapes, lo, hi, pad in ADJ_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S_lv = sum(h * w for h, w in shapes)
        mask = off_edges(locs, shapes)
        line = f"adjoint-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S_lv + pad}"
        for dt in (torch.float32, torch.bfloat16):
            v, do = value.to(dt), dout.to(dt)
            ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
            got = (KV(v, shapes, locs, attn, do),) + KL(v, shapes, locs, attn, do)
            torch.cuda.synchronize()
            errs = adjoint_checks(name, got, ref, value, locs, Q, S_lv, pad, mask,
                                  dt == torch.bfloat16)
            if dt == torch.float32:
                worst = {k: max(worst[k], errs[k]) for k in worst}
            line += (f" | {'f32' if dt == torch.float32 else 'bf16'} max_abs_err "
                     + " ".join(f"{k} {e:.2e}" for k, e in errs.items()))
        line += f" (d_loc off cell edges: {int(mask.sum())}/{mask.numel()})"
        if name in ("encoder", "decoder"):
            t = {}
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                args = (v, shapes, locs, attn, do)
                ms = {"dvalue": cuda_ms(lambda: KV(*args)),
                      "plain_dvalue": cuda_ms(lambda: plain_adjoint_of(*args, (0,)), iters=5),
                      "dloc": cuda_ms(lambda: KL(*args)),
                      "plain_dloc": cuda_ms(lambda: plain_adjoint_of(*args, (1, 2)), iters=5),
                      "plain": cuda_ms(lambda: plain_bwd(*args), iters=5)}
                t["f32" if dt == torch.float32 else "bf16"] = ms
            line += "".join(f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items())
                            for dt, ms in t.items())
            report[f"adjoint_{name}"] = t
            if name == "encoder":
                v, do = value.bfloat16(), dout.bfloat16()
                report["adjoint_bounds"] = {
                    "dvalue": deform_bound(locs, shapes, D, locs, attn, do, v),
                    "dloc": deform_bound(locs, shapes, D, v, locs, attn, do, locs, attn)}
        log(line)

    # NaN locations: the point gets exactly 0 and adds nothing
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, ((6, 9), (4, 5)))
    dout = torch.randn((2, 5, 16), generator=g, device=DEVICE)
    locs[:, 0, :, 0, 1, 0] = float("nan")
    d_value = KV(value, ((6, 9), (4, 5)), locs, attn, dout)
    d_loc, d_attn = KL(value, ((6, 9), (4, 5)), locs, attn, dout)
    if not (bool(torch.isfinite(d_value).all()) and bool((d_loc[:, 0, :, 0, 1] == 0).all())
            and bool((d_attn[:, 0, :, 0, 1] == 0).all())):
        raise AssertionError("a NaN location leaked into the adjoint")
    report["adjoint_max_abs_err"] = worst
    log(f"adjoint kernels: f32 max |kernel - plain| {worst} over {len(ADJ_GEOMETRIES)} "
        f"geometries (tol {ADJ_RTOL} x max|ref|; bf16 d_value + 2^-8 |ref|); NaN point -> 0")


def rotations_ok(rot: np.ndarray) -> float:
    r = rot.reshape(-1, 3, 3).astype(np.float64)
    orth = np.abs(np.einsum("nji,njk->nik", r, r) - np.eye(3)).max()
    det = np.abs(np.linalg.det(r) - 1.0).max()
    if not (orth < 1e-4 and det < 1e-4):
        raise AssertionError(f"rotations not in SO(3): |R^T R - I| {orth}, |det - 1| {det}")
    return max(orth, det)


def phase_slice(report, impl=None):
    """Phase 4: gt serving on the gather kernels, through the pipelined
    `stream`; with `impl` ('pallas', phase 20) the same requests through
    `infer`, on the kernels the impl selects."""
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 16, (480, 640)
    cfg = flagship_config("bfloat16")
    if impl:
        cfg.model.enc_deform_impl = cfg.model.dec_deform_impl = impl
    route = "dense_fwd" if impl == "pallas" else "fwd"
    server = PoseServer(cfg, init_weights(build_model(cfg), seed=0), batch_size=B,
                        image_size=(H, W), device="cuda")
    images, _, targets = flagship_batch(B, H, W, seed=0)
    boxes = (targets["boxes"], targets["labels"], targets["n_boxes"])
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.fetch(server.infer_async(images, *boxes))
    server.reset_latency_stats()
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    if impl:
        results = [server.infer(images, *boxes) for _ in range(REQUESTS)]
    else:
        results = list(server.stream((images for _ in range(REQUESTS)), lambda prev: boxes))
    counts = [k.launches for k in kernels]
    launches = counts[KERNEL_KEYS.index(route)]
    if counts != expected(**{route: per_layer * REQUESTS}):
        raise AssertionError(f"launches {LAUNCH_NAMES} {counts} for {REQUESTS} requests, "
                             f"expected {per_layer} {route} per request and no other")
    if len(results) != REQUESTS:
        raise AssertionError(f"{len(results)} answers for {REQUESTS} requests")
    for res in results:
        if res["translation"].shape != (B, 10, 3) or res["rotation"].shape != (B, 10, 3, 3):
            raise AssertionError(f"output shapes {res['translation'].shape}, "
                                 f"{res['rotation'].shape}")
        for k in ("translation", "rotation"):
            if not np.isfinite(res[k]).all():
                raise AssertionError(f"non-finite {k}")
        so3 = rotations_ok(res["rotation"])
    stats = server.latency_stats()
    log(f"slice{f' {impl}' if impl else ''}: PoseServer paper config bf16 B={B} {H}x{W}: "
        f"{REQUESTS} requests via {'infer' if impl else 'stream'}, "
        f"{launches} {route} launches ({per_layer}/request), finite, SO(3) err {so3:.2e}, "
        f"p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
        f"{stats['fps']:.2f} img/s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    key = f"_{impl}" if impl else ""
    report["launches" + key] = counts
    report["slice" + key] = stats


def phase_e2e_f32():
    import torch

    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = flagship_config("float32")
    model = init_weights(build_model(cfg), seed=0).eval()
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    tg = {k: torch.from_numpy(targets[k]) for k in ("boxes", "labels", "n_boxes")}
    args = (torch.from_numpy(images), torch.from_numpy(pad_mask), tg)
    with torch.inference_mode():
        n0 = K.launches
        cpu = model(*args)
        if K.launches != n0:
            raise AssertionError("the CPU run launched the CUDA kernel")
        with tf32_off():
            model = model.cuda()
            card = model(args[0].cuda(), args[1].cuda(), {k: v.cuda() for k, v in tg.items()})
        card = {k: v.cpu() for k, v in card.items()}
        if K.launches - n0 != cfg.model.enc_layers + cfg.model.dec_layers:
            raise AssertionError("the card run did not go through the kernel")
    worst = 0.0
    for k in ("translations", "rotations"):
        ref, got = cpu[k].numpy(), card[k].numpy()
        scale = max(float(np.abs(ref).max()), 1.0)
        err = float(np.abs(got - ref).max()) / scale
        if not (np.isfinite(got).all() and err <= E2E_RTOL):
            raise AssertionError(f"e2e f32 {k}: max err / scale {err} > {E2E_RTOL}")
        worst = max(worst, err)
    log(f"e2e f32 card-vs-CPU (B={B}, {H}x{W}, all {cfg.model.dec_layers} layers, TF32 off): "
        f"max |card - cpu| / output scale = {worst:.3e} (tol {E2E_RTOL})")


# the train step's deformable-attention variants: the ModelConfig fields set,
# and the kernels each layer launches once per step
TRAIN_VARIANTS = {
    "pair": ({"merged_adjoint": False}, ("fwd", "d_value", "d_loc")),
    "merged": ({"merged_adjoint": True}, ("fwd", "merged")),
    "pallas": ({"enc_deform_impl": "pallas", "dec_deform_impl": "pallas"},
               ("dense_fwd", "dense_bwd")),
}


def train_config(dtype, variant):
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config(dtype)
    for k, v in TRAIN_VARIANTS[variant][0].items():
        setattr(cfg.model, k, v)
    return cfg


def phase_train(report, variant="pair"):
    """Phase 7 (the pair adjoint) or, with `variant` 'merged' / 'pallas',
    phase 20's train steps."""
    import torch

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = train_config("bfloat16", variant)          # dropout 0.1, AdamW, clip 0.1
    model = init_weights(build_model(cfg), seed=0).to(DEVICE)
    frozen = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("backbone.")}
    w_name = "transformer.encoder.layers.0.linear1.weight"
    w0 = model.state_dict()[w_name].clone()
    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    step = make_train_step(model, cfg, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        fetch_metrics(step(*prepare_batch(cfg, images, pad_mask, targets, DEVICE), gen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    per_step = cfg.model.enc_layers + cfg.model.dec_layers
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    times, history = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = prepare_batch(cfg, images, pad_mask, targets, DEVICE)   # host match + upload
        history.append(fetch_metrics(step(*batch, gen)))               # syncs on the metrics
        times.append(time.perf_counter() - t0)
    launches = [k.launches for k in kernels]
    route = TRAIN_VARIANTS[variant][1]
    if launches != expected(**dict.fromkeys(route, per_step * TRAIN_STEPS)):
        raise AssertionError(f"train {variant}: launches {LAUNCH_NAMES} {launches} for "
                             f"{TRAIN_STEPS} steps, expected {per_step} each of {route} per "
                             f"step and no other")
    if not all(np.isfinite(list(m.values())).all() for m in history):
        raise AssertionError(f"non-finite training metrics: {history}")
    state = model.state_dict()
    if not all(torch.equal(state[k], v) for k, v in frozen.items()):
        raise AssertionError("the frozen backbone changed")
    if torch.equal(state[w_name], w0):
        raise AssertionError(f"{w_name} did not move")
    ms = np.asarray(times) * 1e3
    stats = {"p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
             "img_s": float(B / ms.mean() * 1e3),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"train {variant}: paper config bf16 B={B} {H}x{W}, dropout {cfg.model.dropout}, "
        f"AdamW: {TRAIN_STEPS} steps, launches {LAUNCH_NAMES} {launches} ({per_step} "
        f"each of {'/'.join(route)} per step), loss {history[0]['loss']:.4f} -> "
        f"{history[-1]['loss']:.4f}, grad_norm {history[-1]['grad_norm']:.4f}, backbone bit-identical ({len(frozen)} tensors), "
        f"{w_name} moved; step p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
        f"{stats['img_s']:.2f} img/s, peak mem {stats['peak_gib']:.2f} GiB")
    key = "" if variant == "pair" else f"_{variant}"
    report["train_launches" + key] = launches
    report["train" + key] = stats


def phase_train_f32(variant="pair"):
    """Phase 8 (the pair adjoint) or, with `variant`, phase 20's f32 step."""
    import copy

    import torch

    from poet_tpu_torch.engine.train import global_norm, make_loss_fn, match_targets
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = train_config("float32", variant)
    cfg.model.dropout = 0.0       # the CPU and card generators draw different masks
    model = init_weights(build_model(cfg), seed=0)
    # the paper's zero-init offset kernels put every encoder sampling point
    # on a cell edge (pixel-centre grid + integer offsets), where d_loc is
    # one-sided and f32 rounding picks the side: small seeded kernels move
    # the points off the edges
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("sampling_offsets.weight"):
                p.normal_(0.0, 0.02, generator=g)
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    host = {k: torch.from_numpy(v) for k, v in targets.items()}
    match = match_targets(cfg, host)

    def grads_on(device):
        m = copy.deepcopy(model).to(device).train()
        dev = {k: v.to(device) for k, v in host.items()}
        total, losses = make_loss_fn(m, cfg)(torch.from_numpy(images).to(device),
                                             torch.from_numpy(pad_mask).to(device), dev,
                                             match.to(device), None)
        total.backward()
        grads = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
        losses["loss"] = total
        losses["grad_norm"] = global_norm(list(grads.values()))
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: g.double().cpu() for n, g in grads.items()})

    kernels = all_kernels()
    n0 = [k.launches for k in kernels]
    cpu_losses, cpu_grads = grads_on("cpu")
    if [k.launches for k in kernels] != n0:
        raise AssertionError("the CPU run launched a CUDA kernel")
    with tf32_off():
        card_losses, card_grads = grads_on(DEVICE)
    per_step = cfg.model.enc_layers + cfg.model.dec_layers
    route = TRAIN_VARIANTS[variant][1]
    if [k.launches - n for k, n in zip(kernels, n0)] != expected(
            **dict.fromkeys(route, per_step)):
        raise AssertionError(f"train f32 {variant}: the card step did not go through "
                             f"{route} alone")
    loss_err = max(abs(card_losses[k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu_losses.items() if k != "grad_norm")
    norm_err = abs(card_losses["grad_norm"] / cpu_losses["grad_norm"] - 1.0)
    if not (loss_err <= TRAIN_F32_LOSS_RTOL and norm_err <= TRAIN_F32_L2_RTOL):
        raise AssertionError(f"f32 step card-vs-CPU: losses max rel err {loss_err}, "
                             f"grad norm rel err {norm_err}")
    if set(card_grads) != set(cpu_grads):
        raise AssertionError("card and CPU differ in which parameters got gradients")
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in cpu_grads.values())
    rows = []
    for n, ref in cpu_grads.items():
        diff = card_grads[n] - ref
        l2 = float(diff.norm()) / (float(ref.norm()) + floor)
        mx = float(diff.abs().max()) / (float(ref.abs().max()) + floor)
        rows.append((l2, mx, n))
        if not (l2 <= TRAIN_F32_L2_RTOL and mx <= TRAIN_F32_MAX_RTOL):
            raise AssertionError(f"f32 step card-vs-CPU gradient {n}: relative L2 err {l2:.3e}, "
                                 f"max err / max |cpu| {mx:.3e}")
    l2, _, l2_name = max(rows)
    _, mx, mx_name = max(rows, key=lambda r: r[1])
    log(f"train f32 {variant} card-vs-CPU (B={B}, {H}x{W}, dropout 0, TF32 off, kernels "
        f"{'/'.join(route)}): losses max rel err "
        f"{loss_err:.3e} (tol {TRAIN_F32_LOSS_RTOL}), grad norm {norm_err:.3e}; "
        f"{len(rows)} gradients: worst relative L2 {l2:.3e} ({l2_name}, tol "
        f"{TRAIN_F32_L2_RTOL}), worst max/max {mx:.3e} ({mx_name}, tol {TRAIN_F32_MAX_RTOL})")


def roi_boxes(g, B, R, H, W, kind):
    """(B, R, 4) xyxy boxes on the card. 'proposals': clipped boxes of
    8-600 px and aspect 1:2-2:1, like RPN proposals; 'edges': boxes under
    1 px, slivers (aspect > 15), partly or wholly outside the image,
    oversized, zero-area, and one NaN box per image."""
    import torch

    u = lambda *shape: torch.rand(shape, generator=g, device=DEVICE)
    cx, cy = u(B, R) * W, u(B, R) * H
    size = torch.exp(math.log(8.0) + u(B, R) * math.log(600.0 / 8.0))
    aspect = torch.exp((u(B, R) - 0.5) * math.log(4.0))
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    if kind == "edges":
        k = torch.arange(R, device=DEVICE) % 6
        w = torch.where(k == 0, u(B, R) * 0.9 + 0.05, w)                 # under 1 px
        h = torch.where(k == 0, u(B, R) * 0.9 + 0.05, h)
        w = torch.where(k == 1, W * (0.6 + 0.6 * u(B, R)), w)            # slivers
        h = torch.where(k == 1, 1.0 + u(B, R) * W / 20, h)
        cx = torch.where(k == 2, -0.4 * W + 0.2 * W * u(B, R), cx)       # left of the image
        cy = torch.where(k == 3, 1.3 * H + 0.5 * H * u(B, R), cy)        # below it
        w = torch.where(k == 4, 3.0 * W, w)                              # oversized
        h = torch.where(k == 4, 3.0 * H, h)
        w = torch.where(k == 5, torch.zeros_like(w), w)                  # zero area
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if kind == "proposals":
        boxes = torch.minimum(boxes.clamp(min=0), torch.tensor([W, H, W, H], device=DEVICE))
    else:
        boxes[:, 7] = float("nan")
    return boxes.contiguous()


def roi_bound(shapes, boxes, feats, out):
    """Bound of one RoIAlign call: the distinct feature cells its samples
    read, the boxes and the output; 4 corners x C x 2 operations per pair of
    inside samples, and the 1/4 scale per output value."""
    import torch

    from poet_tpu_torch.ops.detection import roi_geometry

    geo = roi_geometry(shapes, ROI_STRIDES, boxes)
    B, R = boxes.shape[:2]
    C = feats[0].shape[-1]
    lvl = geo.level.long()
    sizes = torch.tensor([h * w for h, w in shapes], device=DEVICE)
    base = torch.cumsum(torch.cat([sizes.new_zeros(1), sizes[:-1] * B]), 0)
    Wl = torch.tensor([w for _, w in shapes], device=DEVICE)[lvl]
    start = base[lvl] + torch.arange(B * R, device=DEVICE) // R * sizes[lvl]
    yin, xin = geo.yw.sum(-1) > 0, geo.xw.sum(-1) > 0                  # (BR, N)
    ys = torch.stack([geo.ylo, geo.ylo + 1], -1).flatten(1).long()
    xs = torch.stack([geo.xlo, geo.xlo + 1], -1).flatten(1).long()
    ym, xm = yin.repeat_interleave(2, 1), xin.repeat_interleave(2, 1)
    touched = torch.zeros(int(sizes.sum()) * B, dtype=torch.bool, device=DEVICE)
    for a in range(0, B * R, 2000):
        sl = slice(a, a + 2000)
        idx = start[sl, None, None] + ys[sl, :, None] * Wl[sl, None, None] + xs[sl, None, :]
        touched[idx[ym[sl, :, None] & xm[sl, None, :]]] = True
    pairs = int((yin.sum(1) * xin.sum(1)).sum())
    n_bytes = int(touched.sum()) * C * feats[0].element_size() + nbytes(boxes, out)
    return bound(n_bytes, 8.0 * C * pairs + out.numel())


def phase_roi(report):
    import torch

    from poet_tpu_torch.ops.detection import multiscale_roi_align_torch as plain
    from poet_tpu_torch.ops.detection import roi_geometry
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_FWD as K

    g = torch.Generator(device=DEVICE).manual_seed(2)
    worst = 0.0
    for name, B, R, C, (H, W), kind in ROI_GEOMETRIES:
        shapes = [(H // s, W // s) for s in ROI_STRIDES]
        feats = [torch.randn((B, h, w, C), generator=g, device=DEVICE) for h, w in shapes]
        boxes = roi_boxes(g, B, R, H, W, kind)
        tol = ROI_F32_RTOL * max(f.abs().max().item() for f in feats)
        with torch.inference_mode():
            ref = plain(feats, ROI_STRIDES, boxes)
            got = K(feats, ROI_STRIDES, boxes)
            torch.cuda.synchronize()
            err32 = (got - ref).abs().max().item()
            if not err32 <= tol:
                raise AssertionError(f"roi {name} f32: max |kernel - plain| {err32} > {tol}")
            f16 = [f.bfloat16() for f in feats]
            ref16 = plain([f.float() for f in f16], ROI_STRIDES, boxes)
            got16 = K(f16, ROI_STRIDES, boxes)
            torch.cuda.synchronize()
            if got16.dtype != torch.bfloat16 or tuple(got16.shape) != (B, R, 7, 7, C):
                raise AssertionError(f"roi {name}: kernel returned {got16.dtype} "
                                     f"{tuple(got16.shape)}")
            err16 = (got16.float() - ref16).abs()
            if not bool((err16 <= tol + BF16_RTOL * ref16.abs()).all()):
                raise AssertionError(f"roi {name} bf16: max |kernel - plain| "
                                     f"{err16.max().item()} beyond {tol} + 2^-8 |ref|")
            if kind == "edges" and not (bool((got[:, 7] == 0).all())
                                        and bool((got16[:, 7] == 0).all())):
                raise AssertionError(f"roi {name}: a NaN box pooled non-zero values")
        worst = max(worst, err32)
        line = (f"roi-vs-plain {name}: B={B} R={R} C={C} levels={shapes} f32 max_abs_err="
                f"{err32:.3e} (tol {tol:.2e}) bf16 max_abs_err={err16.max().item():.3e} "
                f"(tol {tol:.2e} + 2^-8 |ref|)")
        if kind == "proposals":
            with torch.inference_mode():
                geo = roi_geometry(shapes, ROI_STRIDES, boxes)
                t = {dt: (cuda_ms(lambda: K.launch(fs, boxes, geo)),
                          cuda_ms(lambda: K(fs, ROI_STRIDES, boxes)),
                          cuda_ms(lambda: plain(fs, ROI_STRIDES, boxes), iters=5, warmup=1))
                     for dt, fs in (("f32", feats), ("bf16", f16))}
                bms, by = roi_bound(shapes, boxes, f16, got16)
            line += "".join(f" | ms {dt}: kernel {k:.4f}, with its geometry {w:.4f}, plain "
                            f"{p:.4f}" for dt, (k, w, p) in t.items())
            line += f" | bound {bms:.4f} ms ({by})"
            report["roi"] = {"ms": t["bf16"][0], "wrapper_ms": t["bf16"][1],
                             "plain_ms": t["bf16"][2], "f32_ms": t["f32"][0],
                             "f32_plain_ms": t["f32"][2], "bound": (bms, by)}
        log(line)
    # a CUDA input that requires grad is refused: the op has no gradient
    try:
        K([f.requires_grad_() for f in feats], ROI_STRIDES, boxes)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the RoIAlign kernel accepted an input that requires grad")
    report["roi_max_abs_err"] = worst


def check_detect_outputs(res, B, Q):
    """Finite poses, SO(3) rotations, n_boxes <= Q, valid boxes inside the image."""
    if res["translation"].shape != (B, Q, 3) or res["rotation"].shape != (B, Q, 3, 3):
        raise AssertionError(f"output shapes {res['translation'].shape}, "
                             f"{res['rotation'].shape}")
    for k in ("translation", "rotation", "boxes"):
        if not np.isfinite(res[k]).all():
            raise AssertionError(f"non-finite {k}")
    rotations_ok(res["rotation"])
    n = res["n_boxes"]
    if not ((n >= 0) & (n <= Q)).all():
        raise AssertionError(f"n_boxes {n} outside [0, {Q}]")
    valid = np.arange(Q)[None, :] < n[:, None]
    cx, cy, w, h = np.moveaxis(res["boxes"][valid], -1, 0)
    eps = 1e-5
    if not ((cx - w / 2 >= -eps) & (cx + w / 2 <= 1 + eps) & (cy - h / 2 >= -eps)
            & (cy + h / 2 <= 1 + eps) & (w >= 0) & (h >= 0)).all():
        raise AssertionError("a selected box lies outside the image")


def phase_detect(report):
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import detect_pose_batch, detect_pose_config, detect_pose_model
    from poet_tpu_torch.ops.detection import FIXED_POINT

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = detect_pose_config("bfloat16")
    Q = cfg.model.num_queries
    server = PoseServer(cfg, detect_pose_model(cfg), batch_size=B, image_size=(H, W))
    if server.device.type != "cuda":
        raise AssertionError(f"PoseServer defaulted to {server.device}")
    images, _ = detect_pose_batch(B, H, W, seed=0)
    dets = []
    server.model.backbone.register_forward_hook(
        lambda m, args, out: dets.append(int(out[2]["valid"].sum())))
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.fetch(server.infer_async(images))
    server.reset_latency_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers
    kernels = all_kernels()
    expect = expected(fwd=per_layer * DETECT_REQUESTS, roi=DETECT_REQUESTS)

    def run(label, drive):
        for k in kernels:
            k.launches = 0
        FIXED_POINT.reset()
        dets.clear()
        t0 = time.perf_counter()
        results = drive()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        if counts != expect:
            raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {counts} for "
                                 f"{DETECT_REQUESTS} requests, expected {expect}")
        if len(results) != DETECT_REQUESTS:
            raise AssertionError(f"{label}: {len(results)} answers")
        for res in results:
            check_detect_outputs(res, B, Q)
        return results, counts, wall

    res_infer, counts, _ = run("infer", lambda: [server.infer(images)
                                                 for _ in range(DETECT_REQUESTS)])
    stats = server.latency_stats()
    fp = (FIXED_POINT.calls, FIXED_POINT.iterations, FIXED_POINT.max_iterations)
    det_infer = list(dets)
    res_stream, counts_stream, wall = run("stream", lambda: list(server.stream(
        images for _ in range(DETECT_REQUESTS))))
    for a, b in zip(res_infer, res_stream):
        if not all(np.array_equal(a[k], b[k]) for k in ("classes", "n_boxes")):
            raise AssertionError("the pipelined stream answered other detections than infer")
    n_boxes = np.stack([r["n_boxes"] for r in res_infer])
    if n_boxes.sum() == 0:
        raise AssertionError("no valid detection: the checks saw nothing")
    stream_fps = B * DETECT_REQUESTS / wall
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the final NMS's fallback when a certificate fails: the exact per-class
    # suppression of the whole batch, (B, classes, P, P) at once. One request
    # with the pruned path off; it must answer what the pruned path answered.
    detector, prune_k = server.model.backbone, server.model.backbone.nms_prune_k
    detector.nms_prune_k = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FIXED_POINT.reset()
    t0 = time.perf_counter()
    try:
        res_exact = server.infer(images)
    finally:
        detector.nms_prune_k = prune_k
    exact_ms = (time.perf_counter() - t0) * 1e3
    exact_peak = torch.cuda.max_memory_allocated() / 2**30
    check_detect_outputs(res_exact, B, Q)
    for k in ("boxes", "classes", "n_boxes"):
        if not np.array_equal(res_exact[k], res_infer[0][k]):
            raise AssertionError(f"exact-NMS fallback: {k} differs from the pruned path's")
    exact_pose_err = max(float(np.abs(res_exact[k] - res_infer[0][k]).max())
                         for k in ("translation", "rotation"))
    if exact_pose_err > E2E_RTOL:
        raise AssertionError(f"exact-NMS fallback: poses differ by {exact_pose_err}")
    log(f"detect+pose: PoseServer detector mode, paper config bf16 B={B} {H}x{W}, "
        f"{cfg.model.n_classes + 1} classes, {cfg.backbone.post_nms_top_n} proposals: "
        f"{DETECT_REQUESTS} requests via infer + {DETECT_REQUESTS} via stream, launches "
        f"{LAUNCH_NAMES} {counts} per {DETECT_REQUESTS} requests; detector valid "
        f"detections per image {np.mean(det_infer) / B:.2f} (of "
        f"{cfg.backbone.max_detections}), selected queries per image mean "
        f"{n_boxes.mean():.2f} min {n_boxes.min()} max {n_boxes.max()} (of {Q}); finite, "
        f"SO(3), boxes inside the image; NMS fixed points {fp[0]} calls, {fp[1]} "
        f"iterations (one host wait each), longest {fp[2]}; infer p50 "
        f"{stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, {stats['fps']:.2f} img/s; "
        f"stream {stream_fps:.2f} img/s; peak mem {peak:.2f} GiB")
    log(f"detect+pose exact-NMS fallback (nms_prune_k=0, one request): {exact_ms:.3f} ms, "
        f"peak mem {exact_peak:.2f} GiB, NMS fixed points {FIXED_POINT.calls} calls, "
        f"{FIXED_POINT.iterations} iterations ({FIXED_POINT.seconds * 1e3:.3f} ms in the "
        f"loops); boxes, classes, n_boxes equal to the pruned path's, poses within "
        f"{exact_pose_err:.2e}")
    report["detect"] = {"launches": [a + b for a, b in zip(counts, counts_stream)],
                        "p50_ms": stats["p50_ms"],
                        "p95_ms": stats["p95_ms"], "img_s": stats["fps"],
                        "stream_img_s": stream_fps, "peak_gib": peak,
                        "nms_iterations_per_request": fp[1] / DETECT_REQUESTS,
                        "exact_nms_ms": exact_ms, "exact_nms_peak_gib": exact_peak}


def match_rows(card, cpu, b, H, W):
    """Card query for each valid CPU query of image b (same class, score
    within DET_SCORE_ATOL, box within DET_BOX_ATOL_PX)."""
    scale = np.array([W, H, W, H])
    n = int(cpu["n_boxes"][b])
    used, pairs = set(), []
    for j in range(n):
        cand = [i for i in range(n) if i not in used
                and card["pred_classes"][b, i] == cpu["pred_classes"][b, j]
                and abs(card["pred_scores"][b, i] - cpu["pred_scores"][b, j]) < DET_SCORE_ATOL
                and (np.abs(card["pred_boxes"][b, i] - cpu["pred_boxes"][b, j]) * scale
                     ).max() < DET_BOX_ATOL_PX]
        if not cand:
            raise AssertionError(f"detect f32 image {b}: CPU query {j} (class "
                                 f"{cpu['pred_classes'][b, j]}, score "
                                 f"{cpu['pred_scores'][b, j]:.6f}) has no card match")
        used.add(cand[0])
        pairs.append((cand[0], j))
    return pairs


def phase_detect_f32():
    """The selected queries of the card's own detections against the CPU's,
    row for row; the poses on the same detections (the CPU's, fed to both).
    Poses on each side's own detections are not comparable: the reference's
    dyadic box embedding, sin/cos(c * 2^k) for k < hidden/8 = 32, turns a
    box difference of 1e-4 px into O(1) pose differences (PERF.md, Findings)."""
    import torch

    from poet_tpu_torch.flagship import detect_pose_batch, detect_pose_config, detect_pose_model
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_FWD as KR

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = detect_pose_config("float32")
    model = detect_pose_model(cfg)
    images, pad_mask = detect_pose_batch(B, H, W, seed=0)
    args = (torch.from_numpy(images), torch.from_numpy(pad_mask))
    with torch.inference_mode():
        n0 = (K.launches, KR.launches)
        cpu_dets = model.backbone(*args)[2]
        cpu = {k: v.numpy() for k, v in model(*args).items()}
        if (K.launches, KR.launches) != n0:
            raise AssertionError("the CPU run launched a CUDA kernel")
        with tf32_off():
            model = model.cuda()
            cargs = [a.cuda() for a in args]
            card = {k: v.cpu().numpy() for k, v in model(*cargs).items()}
            shared = {k: v.cpu().numpy() for k, v in model(*cargs, detections={
                k: v.cuda() for k, v in cpu_dets.items()}).items()}
        if (K.launches - n0[0], KR.launches - n0[1]) != (
                2 * (cfg.model.enc_layers + cfg.model.dec_layers), 2):
            raise AssertionError("the card runs did not go through the kernels")
    if not np.array_equal(card["n_boxes"], cpu["n_boxes"]) or cpu["n_boxes"].sum() == 0:
        raise AssertionError(f"n_boxes card {card['n_boxes']} vs CPU {cpu['n_boxes']}")
    box_err = 0.0
    for b in range(B):
        pairs = match_rows(card, cpu, b, H, W)
        gi, cj = [p[0] for p in pairs], [p[1] for p in pairs]
        box_err = max(box_err, float(np.abs(card["pred_boxes"][b, gi] - cpu["pred_boxes"][b, cj]
                                            ).max()) * max(H, W))
    for k in ("pred_classes", "n_boxes", "query_valid"):
        if not np.array_equal(shared[k], cpu[k]):
            raise AssertionError(f"detect f32 on shared detections: {k} differs")
    worst = 0.0
    for k in ("translations", "rotations"):
        ref, got = cpu[k], shared[k]
        err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
        if not (np.isfinite(got).all() and err <= E2E_RTOL):
            raise AssertionError(f"detect f32 {k} on shared detections: max err / scale {err}")
        worst = max(worst, err)
    log(f"detect f32 card-vs-CPU (B={B}, {H}x{W}, TF32 off): n_boxes {cpu['n_boxes']} equal, "
        f"every selected query matched (class, score {DET_SCORE_ATOL}, box "
        f"{DET_BOX_ATOL_PX} px; worst box {box_err:.2e} px); poses on the CPU's "
        f"detections, all {cfg.model.dec_layers} layers: max |card - cpu| / scale = "
        f"{worst:.3e} (tol {E2E_RTOL})")


def stem_inputs(g, B, H, W, C, Fo, kh, kw, with_bias):
    import torch

    x = torch.randn((B, H, W, C), generator=g, device=DEVICE)
    w = torch.randn((kh, kw, C, Fo), generator=g, device=DEVICE) / math.sqrt(kh * kw * C)
    b = torch.randn((Fo,), generator=g, device=DEVICE) if with_bias else None
    return x, w, b


def stem_library(x, w, b, stride, padding, act):
    """cuDNN's conv (channels-last, the kernel's dtype) and the activation:
    two PyTorch calls, timed as one unit; the yardstick, not on the path."""
    import torch
    import torch.nn.functional as F

    from poet_tpu_torch.ops.conv_stem_cuda import ACTIVATIONS

    xn = x.permute(0, 3, 1, 2)                                  # NCHW view, channels-last
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bn = None if b is None else b.to(x.dtype)
    (pt, _), (pl, _) = padding
    act = F.mish if act == "mish" else ACTIVATIONS[act]
    return lambda: act(F.conv2d(xn, wn, bn, stride=stride, padding=(pt, pl)))


def stem_bounds(x16, w16, b, out16, Fo, K):
    """(bf16 bound, f32 bound): bytes each read/written once over 3.35 TB/s
    against 2 K F flops per output pixel over 989 (bf16 tensor cores) or 67
    (f32) TFLOP/s."""
    flops = 2.0 * out16.numel() * K
    n_bytes = nbytes(x16, w16, out16) + (0 if b is None else nbytes(b))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    out = []
    for rate in (BF16_TC_FLOP_PER_S, F32_FLOP_PER_S):
        t_ops = flops / rate
        out.append((max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"))
    return out, flops, n_bytes


def phase_stem(report):
    import torch

    from poet_tpu_torch.ops.conv_stem_cuda import CONV_STEM_FWD as K
    from poet_tpu_torch.ops.conv_stem_cuda import conv_stem_torch as plain

    g = torch.Generator(device=DEVICE).manual_seed(3)
    worst, worst_abs, per_layer = 0.0, 0.0, {}
    for name, B, H, W, C, Fo, kh, kw, s, pad, act, with_bias in STEM_GEOMETRIES:
        x, w, b = stem_inputs(g, B, H, W, C, Fo, kh, kw, with_bias)
        kwargs = dict(stride=s, padding=pad, activation=act)
        with torch.inference_mode(), tf32_off():
            ref = plain(x, w, b, **kwargs)
            got = K(x, w, b, **kwargs)
            torch.cuda.synchronize()
            tol = STEM_F32_RTOL * ref.abs().max().item()
            err32 = (got - ref).abs().max().item()
            if tuple(got.shape) != tuple(ref.shape) or not err32 <= tol:
                raise AssertionError(f"stem {name} f32: shape {tuple(got.shape)} vs "
                                     f"{tuple(ref.shape)}, max |kernel - plain| {err32} > {tol}")
            x16, w16 = x.bfloat16(), w.bfloat16()
            ref16 = plain(x16, w16, b, out_dtype=torch.float32, **kwargs)
            got16 = K(x16, w16, b, **kwargs)
            torch.cuda.synchronize()
            if got16.dtype != torch.bfloat16:
                raise AssertionError(f"stem {name}: bf16 kernel returned {got16.dtype}")
            tol16 = STEM_F32_RTOL * ref16.abs().max().item()
            err16 = (got16.float() - ref16).abs()
            if not bool((err16 <= tol16 + BF16_RTOL * ref16.abs()).all()):
                raise AssertionError(f"stem {name} bf16: max |kernel - plain| "
                                     f"{err16.max().item()} beyond {tol16} + 2^-8 |ref|")
        worst = max(worst, err32 / max(ref.abs().max().item(), 1e-30))
        worst_abs = max(worst_abs, err32)
        line = (f"stem-vs-plain {name}: B={B} {H}x{W} C={C} F={Fo} {kh}x{kw}/{s} pad={pad} "
                f"act={act} bias={with_bias} f32 max_abs_err={err32:.3e} (tol {tol:.2e}) "
                f"bf16 max_abs_err={err16.max().item():.3e} (tol {tol16:.2e} + 2^-8 |ref|)")
        if B == 16:
            with torch.inference_mode():
                lib = stem_library(x16, w16, b, s, pad, act)
                t = {"ms": cuda_ms(lambda: K(x16, w16, b, **kwargs)),
                     "library_ms": cuda_ms(lib)}
                with tf32_off():
                    t["plain_ms"] = cuda_ms(lambda: plain(x16, w16, b, **kwargs), iters=5)
                    t["f32_ms"] = cuda_ms(lambda: K(x, w, b, **kwargs))
            (b16, b32), flops, n_bytes = stem_bounds(x16, w16, b, got16, Fo, kh * kw * C)
            t.update(bound=b16, f32_bound=b32, gflop=flops / 1e9, mbytes=n_bytes / 1e6)
            line += (f" | bf16 ms kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, cuDNN conv + "
                     f"act {t['library_ms']:.4f}; f32 kernel {t['f32_ms']:.4f} | {flops / 1e9:.2f} "
                     f"GFLOP, {n_bytes / 1e6:.1f} MB: bound {b16[0]:.4f} ms ({b16[1]}, bf16 "
                     f"tensor cores), {b32[0]:.4f} ms ({b32[1]}, f32 FMA)")
            per_layer[name] = t
        log(line)
    # an input that requires grad is refused: the op has no gradient
    x, w, b = stem_inputs(g, 1, 16, 16, 3, 8, 3, 3, True)
    try:
        K(x, w.requires_grad_(), b, stride=1, padding=PAD1)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the stem kernel accepted an input that requires grad")
    report["stem"] = per_layer
    report["stem_max_err"] = (worst_abs, worst)


def phase_yolo(report):
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import (
        yolo_detect_pose_batch,
        yolo_detect_pose_config,
        yolo_detect_pose_model,
    )
    from poet_tpu_torch.ops.detection import FIXED_POINT

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = yolo_detect_pose_config("bfloat16")
    Q = cfg.model.num_queries
    server = PoseServer(cfg, yolo_detect_pose_model(cfg), batch_size=B, image_size=(H, W))
    if server.device.type != "cuda":
        raise AssertionError(f"PoseServer defaulted to {server.device}")
    images, _ = yolo_detect_pose_batch(B, H, W, seed=0)
    dets, tokens = [], []

    def seen(module, args, out):
        feats = out[0]
        dets.append(out[2]["valid"].sum(1).tolist())
        h, w = feats[-1].shape[1:3]                  # + the one extra stride-2 level
        tokens.append(sum(f.shape[1] * f.shape[2] for f in feats) + -(-h // 2) * -(-w // 2))

    server.model.backbone.register_forward_hook(seen)
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.fetch(server.infer_async(images))
    server.reset_latency_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers
    kernels = all_kernels()
    expect = expected(fwd=per_layer * YOLO_REQUESTS, stem=3 * YOLO_REQUESTS)

    def run(label, drive):
        for k in kernels:
            k.launches = 0
        FIXED_POINT.reset()
        dets.clear()
        t0 = time.perf_counter()
        results = drive()
        wall = time.perf_counter() - t0
        counts = [k.launches for k in kernels]
        if counts != expect:
            raise AssertionError(f"yolo {label}: launches {LAUNCH_NAMES} {counts} "
                                 f"for {YOLO_REQUESTS} requests, expected {expect}")
        if len(results) != YOLO_REQUESTS:
            raise AssertionError(f"yolo {label}: {len(results)} answers")
        for res in results:
            check_detect_outputs(res, B, Q)
        per_image = np.asarray(dets)
        if per_image.shape != (YOLO_REQUESTS, B) or per_image.min() < 1:
            raise AssertionError(f"yolo {label}: an image without a valid detection: "
                                 f"{per_image.tolist()}")
        return results, counts, wall, per_image

    res_infer, counts, _, det_infer = run("infer", lambda: [server.infer(images)
                                                             for _ in range(YOLO_REQUESTS)])
    stats = server.latency_stats()
    fp = (FIXED_POINT.calls, FIXED_POINT.iterations, FIXED_POINT.max_iterations,
          FIXED_POINT.seconds)
    res_stream, counts_stream, wall, _ = run("stream", lambda: list(server.stream(
        images for _ in range(YOLO_REQUESTS))))
    for a, b in zip(res_infer, res_stream):
        if not all(np.array_equal(a[k], b[k]) for k in ("classes", "n_boxes")):
            raise AssertionError("yolo: the pipelined stream answered other detections than infer")
    n_boxes = np.stack([r["n_boxes"] for r in res_infer])
    stream_fps = B * YOLO_REQUESTS / wall
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"yolo detect+pose: PoseServer detector mode, YOLOv4-CSP paper config bf16 B={B} "
        f"{H}x{W}, {tokens[-1]} tokens, conf "
        f"{cfg.backbone.conf_thresh}, {cfg.backbone.max_detections} detections: "
        f"{YOLO_REQUESTS} requests via infer + {YOLO_REQUESTS} via stream, launches "
        f"{LAUNCH_NAMES} {counts} per {YOLO_REQUESTS} requests; valid detections "
        f"per image (first request) {det_infer[0].tolist()}, over all: min {det_infer.min()} "
        f"mean {det_infer.mean():.2f} max {det_infer.max()} (of "
        f"{cfg.backbone.max_detections}); selected queries per image mean {n_boxes.mean():.2f} "
        f"min {n_boxes.min()} max {n_boxes.max()} (of {Q}); finite, SO(3), boxes inside the "
        f"image; NMS fixed points {fp[0]} calls, {fp[1]} iterations, longest {fp[2]}, "
        f"{fp[3] * 1e3 / YOLO_REQUESTS:.3f} ms per request in the loops; infer p50 "
        f"{stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, {stats['fps']:.2f} img/s; "
        f"stream {stream_fps:.2f} img/s; peak mem {peak:.2f} GiB")
    report["yolo"] = {"launches": [a + b for a, b in zip(counts, counts_stream)],
                      "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
                      "img_s": stats["fps"], "stream_img_s": stream_fps, "peak_gib": peak,
                      "nms_iterations_per_request": fp[1] / YOLO_REQUESTS,
                      "valid_detections_mean": float(det_infer.mean())}


def phase_yolo_f32():
    """Phase 11's check on the YOLO path: the card's selected queries against
    the CPU's row for row, the poses of both on the CPU's detections."""
    import torch

    from poet_tpu_torch.flagship import (
        yolo_detect_pose_batch,
        yolo_detect_pose_config,
        yolo_detect_pose_model,
    )

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = yolo_detect_pose_config("float32")
    model = yolo_detect_pose_model(cfg)
    images, pad_mask = yolo_detect_pose_batch(B, H, W, seed=0)
    args = (torch.from_numpy(images), torch.from_numpy(pad_mask))
    kernels = all_kernels()
    with torch.inference_mode():
        n0 = [k.launches for k in kernels]
        cpu_dets = model.backbone(*args)[2]
        cpu = {k: v.numpy() for k, v in model(*args).items()}
        if [k.launches for k in kernels] != n0:
            raise AssertionError("the CPU run launched a CUDA kernel")
        with tf32_off():
            model = model.cuda()
            cargs = [a.cuda() for a in args]
            card = {k: v.cpu().numpy() for k, v in model(*cargs).items()}
            shared = {k: v.cpu().numpy() for k, v in model(*cargs, detections={
                k: v.cuda() for k, v in cpu_dets.items()}).items()}
        per = cfg.model.enc_layers + cfg.model.dec_layers
        if [k.launches - n for k, n in zip(kernels, n0)] != expected(fwd=2 * per, stem=2 * 3):
            raise AssertionError("the card runs did not go through the forward and stem kernels")
    if not np.array_equal(card["n_boxes"], cpu["n_boxes"]) or cpu["n_boxes"].min() == 0:
        raise AssertionError(f"n_boxes card {card['n_boxes']} vs CPU {cpu['n_boxes']}")
    box_err = 0.0
    for b in range(B):
        pairs = match_rows(card, cpu, b, H, W)
        gi, cj = [p[0] for p in pairs], [p[1] for p in pairs]
        box_err = max(box_err, float(np.abs(card["pred_boxes"][b, gi] - cpu["pred_boxes"][b, cj]
                                            ).max()) * max(H, W))
    for k in ("pred_classes", "n_boxes", "query_valid"):
        if not np.array_equal(shared[k], cpu[k]):
            raise AssertionError(f"yolo f32 on shared detections: {k} differs")
    worst = 0.0
    for k in ("translations", "rotations"):
        ref, got = cpu[k], shared[k]
        err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
        if not (np.isfinite(got).all() and err <= E2E_RTOL):
            raise AssertionError(f"yolo f32 {k} on shared detections: max err / scale {err}")
        worst = max(worst, err)
    log(f"yolo f32 card-vs-CPU (B={B}, {H}x{W}, TF32 off): n_boxes {cpu['n_boxes']} equal, "
        f"every selected query matched (class, score {DET_SCORE_ATOL}, box {DET_BOX_ATOL_PX} px; "
        f"worst box {box_err:.2e} px); poses on the CPU's detections, all "
        f"{cfg.model.dec_layers} layers: max |card - cpu| / scale = {worst:.3e} (tol {E2E_RTOL})")


def nn_inputs(g, P, N, M, kind):
    """(gt (P, N, 3), est (P, M, 3)) on the card: model-sized clouds (~0.1 m)
    centred on the origin; 'uncentred' moves both ~1 m away (what the
    evaluator's centring on the gt translation avoids); 'duplicates' makes
    every other gt point an exact copy of an est point; 'nan' puts a NaN in
    one est cloud and in one gt point."""
    import torch

    gt = 0.05 * torch.randn((P, N, 3), generator=g, device=DEVICE)
    est = 0.05 * torch.randn((P, M, 3), generator=g, device=DEVICE)
    if kind == "uncentred":
        shift = torch.tensor([0.3, -0.2, 1.0], device=DEVICE)
        gt, est = gt + shift, est + shift + 0.01
    elif kind == "duplicates":
        idx = torch.randint(0, M, (P, N), generator=g, device=DEVICE)
        copies = torch.gather(est, 1, idx[..., None].expand(P, N, 3))
        gt = torch.where((torch.arange(N, device=DEVICE) % 2 == 0)[None, :, None], copies, gt)
    elif kind == "nan":
        est[1, M // 2, 2] = float("nan")
        gt[2, N // 3, 0] = float("nan")
    return gt.contiguous(), est.contiguous()


def nn_bounds(gt, est, out):
    """(bound, f32 bound) of the min distance, each (ms, binds). The bound:
    the bytes (inputs read once, the output written once) over 3.35 TB/s
    against the operations of the matrix-unit form that the TPU kernel
    runs, |g|^2 + |e|^2 - 2 g.e: the cross term's 3 multiply-adds per pair
    on the tensor cores at f32 accuracy (3xTF32, three TF32 products per f32
    product: 18 flops per pair over 495 TFLOP/s), overlapped with its
    epilogue on the f32 pipes (one FMA and one add: 3 flops per pair over 67
    TFLOP/s); the min is counted in neither form. The f32 bound: the direct
    difference form that the kernel runs (3 subtractions, 1 multiply, 2
    FMAs: 8 flops per pair over 67 TFLOP/s)."""
    pairs = gt.shape[0] * gt.shape[1] * est.shape[1]
    n_bytes = nbytes(gt, est, out)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(18.0 * pairs / TF32_TC_FLOP_PER_S, 3.0 * pairs / F32_FLOP_PER_S)
    matrix = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return matrix, bound(n_bytes, 8.0 * pairs)


def nn_library(gt, est, chunk=NN_LIBRARY_CHUNK):
    """torch.cdist's min over est, squared: one PyTorch call per chunk of
    poses, so that each (chunk, N, M) distance block fits (7.2 GB at the BOP
    shape); the yardstick, not on the path."""
    import torch

    return torch.cat([torch.cdist(gt[s:s + chunk], est[s:s + chunk]).amin(-1).square()
                      for s in range(0, gt.shape[0], chunk)])


def phase_nn(report):
    import torch

    from poet_tpu_torch.ops.nn_cuda import MIN_DIST_SQ as K
    from poet_tpu_torch.ops.nn_cuda import min_dist_sq_plain as plain

    g = torch.Generator(device=DEVICE).manual_seed(4)
    worst, worst_rel = 0.0, 0.0
    for name, P, N, M, kind in NN_CASES:
        gt, est = nn_inputs(g, P, N, M, kind)
        ref = plain(gt, est)
        got = K(gt, est)
        torch.cuda.synchronize()
        if tuple(got.shape) != (P, N) or got.dtype != torch.float32:
            raise AssertionError(f"min_dist {name}: kernel returned {got.dtype} {tuple(got.shape)}")
        nan = torch.isnan(ref)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"min_dist {name}: NaN where the plain version has "
                                 f"{int(nan.sum())} NaN, the kernel {int(torch.isnan(got).sum())}")
        scale = float(torch.nan_to_num(gt, nan=0.0).square().sum(-1).max())
        err = float((got - ref)[~nan].abs().max()) if bool((~nan).any()) else 0.0
        if not err <= NN_RTOL * scale:
            raise AssertionError(f"min_dist {name}: max |kernel - plain| {err} > {NN_RTOL} x "
                                 f"max|gt|^2 {scale}")
        line = (f"min_dist-vs-plain {name}: P={P} N={N} M={M} max_abs_err={err:.3e} (tol "
                f"{NN_RTOL} x max|gt|^2 = {NN_RTOL * scale:.3e})")
        if kind == "duplicates":
            dup = got[:, 0::2]
            if not bool((dup == 0).all()):
                raise AssertionError(f"min_dist {name}: a duplicated point's minimum is "
                                     f"{float(dup.abs().max())}, not 0")
            line += f"; {dup.numel()} duplicated points at exactly 0"
        if kind == "nan":
            if not (bool(torch.isnan(got[1]).all()) and int(torch.isnan(got).sum()) == N + 1):
                raise AssertionError(f"min_dist {name}: the NaN est cloud did not make its "
                                     f"whole row NaN, or NaN spread elsewhere")
            line += ("; the NaN est cloud's row and the NaN gt point are NaN, as in the plain "
                     "version")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / scale)
        if name == "BOP shape":
            with tf32_off():
                t = {"ms": cuda_ms(lambda: K(gt, est)),
                     "plain_ms": cuda_ms(lambda: plain(gt, est), iters=2, warmup=1),
                     "library_ms": cuda_ms(lambda: nn_library(gt, est), iters=3, warmup=1)}
                lib_err = float((nn_library(gt, est) - ref).abs().max())
            t["bound"], t["f32_bound"] = nn_bounds(gt, est, got)
            line += (f" | ms kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, cdist (chunks of "
                     f"{NN_LIBRARY_CHUNK} poses, TF32 off) {t['library_ms']:.4f} (max |cdist - "
                     f"plain| {lib_err:.3e}) | {P * N * M:.3e} pairs, bound {t['bound'][0]:.4f} "
                     f"ms ({t['bound'][1]}, the matrix-unit form), "
                     f"{t['bound'][0] / t['ms'] * 100:.1f}% of it; the direct form's f32 bound "
                     f"{t['f32_bound'][0]:.4f} ms ({t['f32_bound'][1]}), "
                     f"{t['f32_bound'][0] / t['ms'] * 100:.1f}% of it")
            report["nn"] = t
        log(line)
    try:
        K(gt.cpu(), est.cpu())
    except ValueError:
        pass
    else:
        raise AssertionError("the min-distance kernel took CPU tensors")
    report["nn_max_err"] = (worst, worst_rel)


METRIC_PASSES = {"evaluate_pose_add": "ADD", "evaluate_pose_adi": "ADD-S",
                 "evaluate_pose_adds": "ADD(-S)",
                 "calculate_class_avg_translation_error": "average translation error",
                 "calculate_class_avg_rotation_error": "average rotation error"}
METRIC_FILES = ("add/add", "adi/adds", "adds/adds", "avg_t_error/avg_t_error",
                "avg_rot_error/avg_rot_error")


class EvalProbe:
    """Times the eval loop from outside, by host clock: the waits for the
    loader's next batch, the pinned uploads, the eval forwards (enqueue and
    match), inside them the match (`engine/train.py:match_poses`, whose
    identity certificate reads a bool and so waits for the forward on the
    card), the pair extraction, and each metric pass of the evaluator with
    the min-distance launches it made. Installed around one
    `pose_evaluate` call and removed after it."""

    STAGES = ("loader", "upload", "forward", "matcher", "extract")

    def __init__(self, evaluator, loader):
        from poet_tpu_torch.engine import evaluate, train
        from poet_tpu_torch.ops.nn_cuda import MIN_DIST_SQ

        self.train, self.evaluate, self.kernel = train, evaluate, MIN_DIST_SQ
        self.evaluator, self.loader = evaluator, loader
        self.host = dict.fromkeys(self.STAGES, 0.0)
        self.loop_end = None
        self.passes = {}

    def _timed(self, fn, stage):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host[stage] += time.perf_counter() - t0
        return wrapper

    def _epoch(self, epoch):
        it = self.loader_epoch(epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.host["loader"] += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def _pass(self, name, fn):
        def wrapper(*args, **kwargs):
            if self.loop_end is None:
                self.loop_end = time.perf_counter()
            n0, t0 = self.kernel.launches, time.perf_counter()
            out = fn(*args, **kwargs)
            self.passes[name] = (time.perf_counter() - t0, self.kernel.launches - n0)
            return out
        return wrapper

    def __enter__(self):
        train, evaluate = self.train, self.evaluate
        self.saved = (train.match_poses, evaluate._matched_pairs_to_host, evaluate._upload,
                      evaluate.make_eval_forward)
        train.match_poses = self._timed(train.match_poses, "matcher")
        evaluate._matched_pairs_to_host = self._timed(evaluate._matched_pairs_to_host, "extract")
        evaluate._upload = self._timed(evaluate._upload, "upload")
        make = evaluate.make_eval_forward
        evaluate.make_eval_forward = lambda m, c: self._timed(make(m, c), "forward")
        self.loader_epoch = self.loader.epoch
        self.loader.epoch = self._epoch
        for name in METRIC_PASSES:
            setattr(self.evaluator, name, self._pass(name, getattr(self.evaluator, name)))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        train, evaluate = self.train, self.evaluate
        (train.match_poses, evaluate._matched_pairs_to_host, evaluate._upload,
         evaluate.make_eval_forward) = self.saved
        del self.loader.epoch
        for name in METRIC_PASSES:
            delattr(self.evaluator, name)


def adi_launches(evaluator):
    """The min-distance launches one ADD-S pass makes: sum over classes of
    ceil(P_c / POSE_CHUNK)."""
    from poet_tpu_torch.evaluation.pose_evaluator import POSE_CHUNK

    return sum(-(-int(n) // POSE_CHUNK) for n in evaluator.num.values())


def check_metric_files(out_dir, evaluator, results):
    """The five metric directories with their .log and .json, finite
    summaries, and every recorded pose's ADD and ADD-S errors finite."""
    for stem in METRIC_FILES:
        for ext in (".log", ".json"):
            if not os.path.isfile(os.path.join(out_dir, stem + ext)):
                raise AssertionError(f"missing {stem}{ext} under {out_dir}")
    if not all(math.isfinite(v) for v in results["accuracy"].values()):
        raise AssertionError(f"non-finite ADD(-S) summary {results['accuracy']}")
    errs = np.concatenate([v for v in evaluator._err_cache.values()])
    if not np.isfinite(errs).all():
        raise AssertionError("a non-finite ADD or ADD-S error")


def phase_eval(report):
    import tempfile

    import torch
    from scipy.integrate import simpson

    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine.evaluate import bop_evaluate, pose_evaluate
    from poet_tpu_torch.evaluation.pose_evaluator import _AUC_MAX, _DX, adi_errors
    from poet_tpu_torch.flagship import EvalFixture, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B = EVAL_B
    cfg = flagship_config("bfloat16")
    Q = cfg.model.num_queries
    model = init_weights(build_model(cfg), seed=0)
    data = EvalFixture(B * EVAL_BATCHES)
    evaluator = data.evaluator()
    loader = PoseDataLoader(data, B, Q, shuffle=False, drop_last=False)
    tmp = tempfile.mkdtemp(prefix="poet_eval_")
    # warm-up (cuDNN/cuBLAS init): one batch through the whole path
    warm = EvalFixture(B, seed=1)
    pose_evaluate(model, warm.evaluator(), PoseDataLoader(warm, B, Q, shuffle=False), cfg,
                  "warmup", output_dir=tmp)
    if next(model.parameters()).device.type != DEVICE:
        raise AssertionError("pose_evaluate did not run the model on the card")

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    with EvalProbe(evaluator, loader) as probe:
        results = pose_evaluate(model, evaluator, loader, cfg, "test", output_dir=tmp)
    counts = [k.launches for k in kernels]
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers
    n_adi = adi_launches(evaluator)
    expect = expected(fwd=per_layer * EVAL_BATCHES, nn=n_adi)
    if counts != expect:
        raise AssertionError(f"eval: launches {LAUNCH_NAMES} {counts} for "
                             f"{EVAL_BATCHES} batches, expected {expect}")
    per_pass = {name: n for name, (_, n) in probe.passes.items()}
    if (per_pass["evaluate_pose_adi"], per_pass["evaluate_pose_adds"]) != (n_adi, 0):
        raise AssertionError(f"eval: min-distance launches by pass {per_pass}, expected "
                             f"{n_adi} in ADD-S and 0 in ADD(-S)")
    out_dir = os.path.join(tmp, "eval_test_gt")
    check_metric_files(out_dir, evaluator, results)
    n_pairs = int(sum(evaluator.num.values()))
    want_pairs = sum(min(len(t["labels"]), Q) for t in data.targets)
    if n_pairs != want_pairs:
        raise AssertionError(f"eval: {n_pairs} matched pairs, expected every one of the "
                             f"{want_pairs} objects")
    loop = probe.loop_end - probe.start
    stats = {"img_s": B * EVAL_BATCHES / loop, "loop_s": loop,
             "host_wait_share": probe.host["matcher"] / loop, "loop_host_s": probe.host,
             "pairs": n_pairs,
             "pass_s": {METRIC_PASSES[k]: v[0] for k, v in probe.passes.items()}}

    # the BOP export over the same fixture: one CSV row per matched pair
    for k in kernels:
        k.launches = 0
    csv = bop_evaluate(model, loader, cfg, "test", output_dir=tmp)
    bop_counts = [k.launches for k in kernels]
    if bop_counts != expected(fwd=per_layer * EVAL_BATCHES):
        raise AssertionError(f"bop_evaluate: launches {bop_counts}")
    with open(csv) as f:
        rows = f.read().split("\n")
    if rows[0] != "scene_id,im_id,obj_id,score,R,t,time" or len(rows) - 1 != n_pairs:
        raise AssertionError(f"bop_evaluate: header {rows[0]!r}, {len(rows) - 1} rows for "
                             f"{n_pairs} pairs")

    # known answer: the same pairs with pred = gt score 100 at every
    # threshold and the AUC of the curve [0, 1, 1, ...] (errors 0 < 0 fails)
    exact = data.evaluator()
    for idx, cls in enumerate(exact.classes, start=1):
        for pose in evaluator.poses_gt[cls]:
            exact.record(idx, pose[:, :3], pose[:, 3], pose[:, :3], pose[:, 3])
    grid = np.arange(0, _AUC_MAX, _DX)
    auc = simpson((grid > 0).astype(np.float64), dx=_DX) / _AUC_MAX * 100
    ka_dir = os.path.join(tmp, "known_answer") + "/"
    for name in ("evaluate_pose_add", "evaluate_pose_adi", "evaluate_pose_adds"):
        res = getattr(exact, name)(ka_dir)
        for cls in exact.classes:
            acc = res[cls].get("accuracy")
            if acc is None:
                continue
            if (any(acc[k] != 100.0 for k in ("0.02", "0.05", "0.10"))
                    or abs(acc["auc"] - auc) > 1e-9):
                raise AssertionError(f"known answer {name} {cls}: {acc}, expected 100 and "
                                     f"AUC {auc}")

    # the card (kernel) against the CPU port (plain) on every recorded pair,
    # over every EVAL_THIN-th point of each cloud, with TF32 on: the clouds'
    # transform must not follow the process-wide flag
    worst = 0.0
    with tf32(True):
        for cls in evaluator.classes:
            if not evaluator.poses_pred[cls]:
                continue
            pts = np.asarray(evaluator.models[cls]["pts"])[::EVAL_THIN]
            pred = np.asarray(evaluator.poses_pred[cls], np.float64)
            gt = np.asarray(evaluator.poses_gt[cls], np.float64)
            card = adi_errors(pts, pred, gt, device=DEVICE)
            cpu = adi_errors(pts, pred, gt, device="cpu")
            worst = max(worst, float(np.abs(card - cpu).max()))
    if not worst <= EVAL_ADDS_ATOL:
        raise AssertionError(f"eval ADD-S card vs CPU: max |card - cpu| {worst} m > "
                             f"{EVAL_ADDS_ATOL} m")
    passes = ", ".join(f"{METRIC_PASSES[k]} {v[0]:.3f} s ({v[1]} nn)"
                       for k, v in probe.passes.items())
    log(f"eval: pose_evaluate paper config bf16 B={B} {data.H}x{data.W}, {EVAL_BATCHES} "
        f"batches, {n_pairs} matched pairs over {sum(n > 0 for n in evaluator.num.values())} "
        f"classes ({len(evaluator.models[evaluator.classes[0]]['pts'])}-point clouds): launches "
        f"{LAUNCH_NAMES} {counts}; forward loop {loop:.3f} s, "
        f"{stats['img_s']:.2f} img/s; in it (host clock) waiting for the loader "
        f"{probe.host['loader']:.3f} s, pinned uploads {probe.host['upload']:.3f} s, eval "
        f"forwards {probe.host['forward']:.3f} s of which the matcher's wait "
        f"{probe.host['matcher']:.3f} s ({stats['host_wait_share'] * 100:.1f}% of the loop), "
        f"pair extraction {probe.host['extract']:.3f} s; "
        f"passes: {passes}; ADD(-S) mean accuracy {results['accuracy']}; bop_evaluate "
        f"{len(rows) - 1} CSV rows; known answer (pred = gt): 100 at every threshold, AUC "
        f"{auc:.6f}; ADD-S card vs CPU on every pair ({len(pts)} points per cloud, TF32 "
        f"on): max "
        f"|card - cpu| {worst:.3e} m (tol {EVAL_ADDS_ATOL} m)")
    report["eval"] = stats
    report["eval_launches"] = counts


def phase_eval_backbone(report):
    """pose_evaluate in bbox_mode='backbone' at phase 10's config, on targets
    made of the detector's own top-Q detections of the same images (same
    boxes and classes: every valid detection matches)."""
    import tempfile

    import torch

    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine.evaluate import pose_evaluate
    from poet_tpu_torch.flagship import EvalFixture, detect_pose_config, detect_pose_model

    B, n_batches = EVAL_B, EVAL_BACKBONE_BATCHES
    cfg = detect_pose_config("bfloat16")
    Q = cfg.model.num_queries
    model = detect_pose_model(cfg).to(DEVICE).to(memory_format=torch.channels_last)
    drawn = EvalFixture(B * n_batches)
    targets = []
    with torch.inference_mode():
        for s in range(0, len(drawn), B):
            images = torch.from_numpy(np.stack([drawn.image(i) for i in range(s, s + B)]))
            images = images.to(DEVICE)
            dets = model.backbone(images, torch.zeros(images.shape[:3], dtype=torch.bool,
                                                      device=DEVICE))[2]
            boxes, labels, _, n_boxes, _ = model._select_detections(dets, Q, images.shape[1:3])
            for b in range(B):
                n = int(n_boxes[b])
                t = dict(drawn.targets[s + b])
                t["boxes"] = boxes[b, :n].float().cpu().numpy()
                t["labels"] = labels[b, :n].cpu().numpy()
                for k in ("relative_position", "relative_rotation", "intrinsics"):
                    t[k] = np.resize(t[k], (n,) + t[k].shape[1:])
                targets.append(t)
    data = EvalFixture(B * n_batches, targets=targets)
    want_pairs = sum(len(t["labels"]) for t in targets)
    if want_pairs == 0:
        raise AssertionError("eval backbone: the detector found nothing to match")
    evaluator = data.evaluator()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    results = pose_evaluate(model, evaluator, PoseDataLoader(data, B, Q, shuffle=False), cfg,
                            "test", output_dir=tempfile.mkdtemp(prefix="poet_eval_bb_"))
    wall = time.perf_counter() - t0
    counts = [k.launches for k in kernels]
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers
    expect = expected(fwd=per_layer * n_batches, roi=n_batches, nn=adi_launches(evaluator))
    if counts != expect:
        raise AssertionError(f"eval backbone: launches {LAUNCH_NAMES} {counts}, "
                             f"expected {expect}")
    n_pairs = int(sum(evaluator.num.values()))
    if n_pairs != want_pairs:
        raise AssertionError(f"eval backbone: {n_pairs} matched pairs, expected the "
                             f"{want_pairs} valid detections (clamped to Q={Q})")
    log(f"eval backbone: pose_evaluate detect+pose config bf16 B={B} {data.H}x{data.W}, "
        f"{n_batches} batches, targets from the detector's own detections: {n_pairs} matched "
        f"pairs = valid detections clamped to Q; launches {LAUNCH_NAMES} {counts}; "
        f"ADD(-S) mean accuracy {results['accuracy']}; {wall:.3f} s with the metric passes")
    report["eval_backbone_launches"] = counts


def phase_merged(report):
    """Phase 18: the merged adjoint kernel against the plain adjoint and
    against the pair (d_value scatter + d_loc/d_attn gather), on phase 6's
    geometries, f32 and bf16; NaN locations; times and the bound."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DLOC as KL
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DVALUE as KV
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_MERGED as KM
    from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn

    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst = {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}
    for name, B, Q, H, D, shapes, lo, hi, pad in ADJ_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S_lv = sum(h * w for h, w in shapes)
        mask = off_edges(locs, shapes)
        line = f"merged-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S_lv + pad}"
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            v, do = value.to(dt), dout.to(dt)
            ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
            got = KM(v, shapes, locs, attn, do)
            pair = (KV(v, shapes, locs, attn, do),) + KL(v, shapes, locs, attn, do)
            torch.cuda.synchronize()
            errs = adjoint_checks(name, got, ref, value, locs, Q, S_lv, pad, mask, bf16)
            # against the pair: the same coordinates, sums in other orders
            pair_errs = adjoint_checks(name + " vs the pair", got,
                                       [t.float() for t in pair], value, locs, Q, S_lv, pad,
                                       None, bf16, roundings=2)
            if not bf16:
                worst = {k: max(worst[k], errs[k]) for k in worst}
            line += (f" | {'bf16' if bf16 else 'f32'} max_abs_err "
                     + " ".join(f"{k} {e:.2e}" for k, e in errs.items())
                     + " (vs the pair " + " ".join(f"{e:.2e}" for e in pair_errs.values())
                     + ")")
        if name in ("encoder", "decoder"):
            t = {}
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                args = (v, shapes, locs, attn, do)
                t["bf16" if dt == torch.bfloat16 else "f32"] = {
                    "merged": cuda_ms(lambda: KM(*args)),
                    "pair": cuda_ms(lambda: (KV(*args), KL(*args))),
                    "plain": cuda_ms(lambda: plain_bwd(*args), iters=5)}
            line += "".join(f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items())
                            for dt, ms in t.items())
            report[f"merged_{name}"] = t
            if name == "encoder":
                v, do = value.bfloat16(), dout.bfloat16()
                d_value, d_loc, d_attn = KM(v, shapes, locs, attn, do)
                # dot and scatter: 4 corners x D channels x 4 operations per point
                report["merged_bound"] = bound(
                    nbytes(v, locs, attn, do, d_value, d_loc, d_attn),
                    16.0 * D * deform_points_in_map(locs, shapes))
                line += (f" | bound {report['merged_bound'][0]:.4f} ms "
                         f"({report['merged_bound'][1]})")
        log(line)

    # NaN locations: the point gets exactly 0 and adds nothing, as in the pair
    shapes = ((6, 9), (4, 5))
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, shapes)
    dout = torch.randn((2, 5, 16), generator=g, device=DEVICE)
    locs[:, 0, :, 0, 1, 0] = float("nan")
    d_value, d_loc, d_attn = KM(value, shapes, locs, attn, dout)
    if not (bool(torch.isfinite(d_value).all()) and bool((d_loc[:, 0, :, 0, 1] == 0).all())
            and bool((d_attn[:, 0, :, 0, 1] == 0).all())):
        raise AssertionError("a NaN location leaked into the merged adjoint")
    # autograd through the entry with adjoint='merged'
    shapes = ((3, 4), (2, 2))
    v, l, a = deform_inputs(g, 1, 6, 2, 8, shapes)
    dout = torch.randn((1, 6, 16), generator=g, device=DEVICE)
    leaves = [t.clone().requires_grad_() for t in (v, l, a)]
    n0 = KM.launches
    ms_deform_attn(leaves[0], shapes, *leaves[1:], adjoint="merged").backward(dout)
    if KM.launches != n0 + 1:
        raise AssertionError("adjoint='merged' did not launch the merged kernel")
    want = plain_bwd(v, shapes, l, a, dout)
    for name, t, ref in zip(("d_value", "d_loc", "d_attn"), leaves, want):
        err = (t.grad - ref).abs().max().item()
        if not err <= ADJ_RTOL * max(ref.abs().max().item(), 1.0):
            raise AssertionError(f"autograd through the merged adjoint: {name} max err {err}")
    report["merged_max_abs_err"] = worst
    log(f"merged adjoint: f32 max |kernel - plain| {worst} over {len(ADJ_GEOMETRIES)} "
        f"geometries (tol {ADJ_RTOL} x max|ref|; bf16 d_value + 2^-8 |ref|); agrees with the "
        f"pair; NaN point -> 0; the entry's adjoint='merged' launches it")


# the YOLOv4-CSP full pyramid at 480x640 (strides 8/16/32 + one extra level)
YOLO_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))
DENSE_GEOMETRIES = ADJ_GEOMETRIES + [
    ("yolo pyramid", 2, 6380, 16, 16, YOLO_LEVELS, 0.0, 1.0, 0),
]


def dense_bounds(value, locs, attn, tensors, shapes, products, gather_ops):
    """(bound, f32 bound), each (ms, binds), of a dense one-hot kernel over
    `value` that reads and writes `tensors`: its bytes against `products`
    dense (B H Q S_pad D) products on the bf16 tensor cores (2 flops per
    multiply-add), and, beside it, against the gather form's `gather_ops` per
    in-map point and channel on the f32 pipes (rows 1-3's bound)."""
    from poet_tpu_torch.ops.deform_attn_dense_cuda import padded_tokens

    B, _, H, D = value.shape
    Q = locs.shape[1]
    t_bytes = nbytes(*tensors) / HBM_BYTES_PER_S
    t_tc = products * 2.0 * B * H * Q * padded_tokens(shapes) * D / BF16_TC_FLOP_PER_S
    tc = (max(t_bytes, t_tc) * 1e3, "bytes" if t_bytes >= t_tc else "operations")
    return tc, bound(nbytes(*tensors), gather_ops * D * deform_points_in_map(locs, shapes))


def nan_agrees(name, got, ref, tol):
    """NaN exactly where `ref` has it, and within `tol` (an absolute bound
    on |got - ref|, a number or a tensor like ref) elsewhere."""
    import torch

    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name}: NaN at {int(torch.isnan(got).sum())} places, the plain "
                             f"version at {int(nan.sum())}")
    err = (got.float() - ref).abs()
    if bool((err[~nan] > (tol[~nan] if torch.is_tensor(tol) else tol)).any()):
        raise AssertionError(f"{name}: off NaN, max |kernel - plain| {err[~nan].max().item()}")
    return int(nan.sum())


def phase_dense(report):
    """Phase 19: the dense one-hot forward and adjoint against the plain
    versions (phase 6's geometries and the YOLO pyramid, f32 and bf16), NaN
    locations held to the plain version, the adjoint's outputs bit-identical
    over two runs; times against kernel 1, the pair, the merged adjoint and
    the plain versions; the bounds."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DLOC as KL
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_DVALUE as KV
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K1
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_MERGED as KM
    from poet_tpu_torch.ops.deform_attn_dense_cuda import MS_DEFORM_ATTN_DENSE_BWD as DB
    from poet_tpu_torch.ops.deform_attn_dense_cuda import MS_DEFORM_ATTN_DENSE_FWD as DF
    from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense

    g = torch.Generator(device=DEVICE).manual_seed(6)
    worst_fwd, worst = 0.0, {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}
    for name, B, Q, H, D, shapes, lo, hi, pad in DENSE_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S_lv = sum(h * w for h, w in shapes)
        mask = off_edges(locs, shapes)
        line = f"dense-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S_lv + pad}"
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            v, do = value.to(dt), dout.to(dt)
            with torch.inference_mode():
                ref = plain(v.float(), shapes, locs, attn)
                out = DF(v, shapes, locs, attn)
                torch.cuda.synchronize()
            if out.dtype != dt:
                raise AssertionError(f"dense {name}: forward returned {out.dtype}")
            err = (out.float() - ref).abs()
            tol = BF16_ATOL + BF16_RTOL * ref.abs() if bf16 else F32_ATOL
            if not bool((err <= tol).all()):
                raise AssertionError(f"dense {name} {dt}: forward max |kernel - plain| "
                                     f"{err.max().item():.3e}")
            got = DB(v, shapes, locs, attn, do)
            again = DB(v, shapes, locs, attn, do)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"dense {name} {dt}: the adjoint differs between two runs")
            errs = adjoint_checks(name, got, plain_bwd(v.float(), shapes, locs, attn,
                                                      do.float()),
                                  value, locs, Q, S_lv, pad, mask, bf16)
            if not bf16:
                worst_fwd = max(worst_fwd, err.max().item())
                worst = {k: max(worst[k], errs[k]) for k in worst}
            line += (f" | {'bf16' if bf16 else 'f32'} forward {err.max().item():.2e}, "
                     + " ".join(f"{k} {e:.2e}" for k, e in errs.items()))
        line += " (adjoint bit-identical over two runs)"
        if name in ("encoder", "decoder", "yolo pyramid"):
            t = {}
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                args = (v, shapes, locs, attn)
                with torch.inference_mode():
                    ms = {"dense_fwd": cuda_ms(lambda: DF(*args)),
                          "kernel1": cuda_ms(lambda: K1(*args)),
                          "plain_fwd": cuda_ms(lambda: plain(*args), iters=5)}
                if name != "yolo pyramid":
                    ms.update(dense_bwd=cuda_ms(lambda: DB(*args, do)),
                              pair=cuda_ms(lambda: (KV(*args, do), KL(*args, do))),
                              merged=cuda_ms(lambda: KM(*args, do)),
                              plain_bwd=cuda_ms(lambda: plain_bwd(*args, do), iters=5))
                t["bf16" if dt == torch.bfloat16 else "f32"] = ms
            line += "".join(f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items())
                            for dt, ms in t.items())
            v, do = value.bfloat16(), dout.bfloat16()
            out, grads = DF(v, shapes, locs, attn), DB(v, shapes, locs, attn, do)
            t["fwd_bounds"] = dense_bounds(v, locs, attn, (v, locs, attn, out), shapes, 1, 8)
            # the TPU kernel's two products (W^T dout for d_value, dout Vpad^T
            # for the corner dots) against the gather form's dot + scatter
            t["bwd_bounds"] = dense_bounds(v, locs, attn, (v, locs, attn, do) + grads, shapes,
                                           2, 16)
            line += (f" | bounds (tensor cores; f32 gather form) forward "
                     f"{t['fwd_bounds'][0][0]:.4f} ({t['fwd_bounds'][0][1]}); "
                     f"{t['fwd_bounds'][1][0]:.4f} ({t['fwd_bounds'][1][1]}), adjoint "
                     f"{t['bwd_bounds'][0][0]:.4f} ({t['bwd_bounds'][0][1]}); "
                     f"{t['bwd_bounds'][1][0]:.4f} ({t['bwd_bounds'][1][1]})")
            report[f"dense_{name}"] = t
        log(line)

    # NaN locations, held to the plain version on the card (F.grid_sample sends
    # a non-finite coordinate out of range: the point adds nothing): NaN where
    # it has NaN, within tolerance elsewhere
    shapes = ((6, 9), (4, 5), (1, 1))
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, shapes)
    dout = torch.randn((2, 5, 16), generator=g, device=DEVICE)
    locs[:, 0, :, 0, 1, 0] = float("nan")        # x of one level-0 point
    locs[:, 1, :, 1, 2, :] = float("nan")        # both coordinates of a level-1 point
    locs[1, 2, 0, 2, 0, 1] = float("nan")        # y of a point on the 1x1 level
    with torch.inference_mode():
        ref, out = plain(value, shapes, locs, attn), DF(value, shapes, locs, attn)
    n_nan = [nan_agrees("dense forward, NaN", out, ref, F32_ATOL)]
    ref = plain_bwd(value, shapes, locs, attn, dout)
    got = DB(value, shapes, locs, attn, dout)
    torch.cuda.synchronize()
    mask = off_edges(locs, shapes) | torch.isnan(locs)
    for k, a, b in zip(("d_value", "d_loc", "d_attn"), got, ref):
        tol = ADJ_RTOL * torch.nan_to_num(b, nan=0.0).abs().max().item()
        if k == "d_loc":
            a, b = a[mask], b[mask]
        n_nan.append(nan_agrees(f"dense adjoint, NaN: {k}", a, b, tol))
    # autograd through the entry
    shapes = ((3, 4), (2, 2))
    v, l, a = deform_inputs(g, 1, 6, 2, 8, shapes)
    dout = torch.randn((1, 6, 16), generator=g, device=DEVICE)
    leaves = [t.clone().requires_grad_() for t in (v, l, a)]
    n0 = (DF.launches, DB.launches)
    ms_deform_attn_dense(leaves[0], shapes, *leaves[1:]).backward(dout)
    if (DF.launches, DB.launches) != (n0[0] + 1, n0[1] + 1):
        raise AssertionError("the dense entry did not launch its two kernels")
    want = plain_bwd(v, shapes, l, a, dout)
    for name, t, ref in zip(("d_value", "d_loc", "d_attn"), leaves, want):
        err = (t.grad - ref).abs().max().item()
        if not err <= ADJ_RTOL * max(ref.abs().max().item(), 1.0):
            raise AssertionError(f"autograd through the dense kernels: {name} max err {err}")
    report["dense_max_abs_err"] = {"forward": worst_fwd, **worst}
    log(f"dense kernels: f32 max |kernel - plain| forward {worst_fwd:.3e} (tol {F32_ATOL}), "
        f"adjoint {worst} over {len(DENSE_GEOMETRIES)} geometries (tol {ADJ_RTOL} x max|ref|; "
        f"bf16 + 2^-8 |ref|); NaN locations: NaN in the same places as the plain version "
        f"(forward, d_value, d_loc, d_attn: {n_nan}), agreeing elsewhere; autograd through "
        f"ms_deform_attn_dense matches the plain adjoint")


def phase_paths(report):
    """Phase 20: the train step with the dense kernels ('pallas') and with
    the merged adjoint, gt serving with 'pallas', and one f32 train step of
    each new configuration on the card against the CPU port."""
    phase_slice(report, impl="pallas")
    phase_train(report, "pallas")
    phase_train(report, "merged")
    phase_train_f32("pallas")
    phase_train_f32("merged")
    for key, ref in (("slice_pallas", "slice"), ("train_pallas", "train"),
                     ("train_merged", "train")):
        if ref not in report:                        # a partial run without phases 4, 7
            continue
        new, old = report[key], report[ref]
        fps = "fps" if "fps" in new else "img_s"
        log(f"paths: {key} p50 {new['p50_ms']:.3f} ms, {new[fps]:.2f} img/s beside {ref} "
            f"(phase {4 if ref == 'slice' else 7}) p50 {old['p50_ms']:.3f} ms, "
            f"{old[fps]:.2f} img/s")


def build_kernels():
    from poet_tpu_torch.ops.deform_attn_cuda import LIBRARIES, build_all

    t0 = time.perf_counter()
    build_all()
    log(f"build: {len(LIBRARIES)} sources with nvcc sm_90a in parallel, "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in LIBRARIES:
        log(f"  {lib.library_path().name} {lib.build_seconds:.2f} s")
        for ln in lib.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"    ptxas {ln.strip()}")


def main(argv) -> int:
    only = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(n) for n in argv[1].split(",")}
    elif argv:
        print("usage: chip_smoke.py [--only N,N,...]  (phase numbers 3-20; 1-2 always run)",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "poet_tpu_torch")):
        print("chip_smoke: poet_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t_start = time.perf_counter()
    build_kernels()

    report = {}
    phases = {3: lambda: phase_kernel(report), 4: lambda: phase_slice(report),
              5: phase_e2e_f32, 6: lambda: phase_adjoint(report),
              7: lambda: phase_train(report), 8: phase_train_f32,
              9: lambda: phase_roi(report), 10: lambda: phase_detect(report),
              11: phase_detect_f32, 12: lambda: phase_stem(report),
              13: lambda: phase_yolo(report), 14: phase_yolo_f32,
              15: lambda: phase_nn(report), 16: lambda: phase_eval(report),
              17: lambda: phase_eval_backbone(report), 18: lambda: phase_merged(report),
              19: lambda: phase_dense(report), 20: lambda: phase_paths(report)}
    spans = []
    for first, last in ((3, 8), (9, 11), (12, 14), (15, 17), (18, 20)):
        t0 = time.perf_counter()
        for n in range(first, last + 1):
            if only is None or n in only:
                phases[n]()
        spans.append(f"phases {first}-{last} in {time.perf_counter() - t0:.1f} s")
    log(f"{', '.join(spans)}; the whole script {time.perf_counter() - t_start:.1f} s on {card}")
    if only is not None:
        log(f"partial run (phases 1, 2 and {sorted(only)}): no kernel report")
        return 0

    enc, adj = report["encoder"], report["adjoint_encoder"]["bf16"]
    paths = {"serve": report["launches"], "train": report["train_launches"],
             "detect": report["detect"]["launches"], "yolo": report["yolo"]["launches"],
             "eval": report["eval_launches"], "eval_backbone": report["eval_backbone_launches"],
             "serve_pallas": report["launches_pallas"],
             "train_pallas": report["train_launches_pallas"],
             "train_merged": report["train_launches_merged"]}
    roi, nn = report["roi"], report["nn"]
    errs, bounds = report["adjoint_max_abs_err"], report["adjoint_bounds"]
    src, tpu = "poet_tpu_torch/csrc/", "poet_tpu/ops/deform_attn_pallas_v3.py:"
    merged = report["merged_encoder"]["bf16"]
    dense_enc = report["dense_encoder"]
    dense = dense_enc["bf16"]
    dense_src = src + "ms_deform_attn_dense.cu"
    dense_tpu = "poet_tpu/ops/deform_attn_pallas.py:"

    def launched(i):
        """A kernel's launches on each path, and their sum."""
        by = {name: counts[i] for name, counts in paths.items()}
        return {"launches": sum(by.values()), "launches_by_path": by}

    def timed(ms, plain_ms, bnd):
        # no single PyTorch call computes these functions: the plain versions
        # chain F.grid_sample per level (deformable attention) or gathers
        # (RoIAlign), and torchvision's roi_align is not installed
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    # the stem entry: the sums over the three launches of a YOLO request
    stem = [report["stem"][name] for name in STEM_PATH]
    stem_total = {k: sum(t[k] for t in stem) for k in ("ms", "plain_ms", "library_ms", "f32_ms")}
    print(json.dumps({"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda", "source": src + "ms_deform_attn_fwd.cu",
         "replaces": tpu + "221", **launched(0),
         "max_abs_err": report["max_abs_err"],
         **timed(enc["ms"], enc["plain_ms"], enc["bound"])},
        {"name": "ms_deform_attn_bwd_dvalue", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "434", **launched(1),
         "max_abs_err": errs["d_value"],
         **timed(adj["dvalue"], adj["plain_dvalue"], bounds["dvalue"]),
         "plain_adjoint_ms": adj["plain"]},
        {"name": "ms_deform_attn_bwd_dloc", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "470", **launched(2),
         "max_abs_err": max(errs["d_loc"], errs["d_attn"]),
         **timed(adj["dloc"], adj["plain_dloc"], bounds["dloc"]),
         "plain_adjoint_ms": adj["plain"]},
        {"name": "roi_align_fwd", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": "poet_tpu/ops/roi_align_pallas.py:77", **launched(3),
         "max_abs_err": report["roi_max_abs_err"],
         **timed(roi["ms"], roi["plain_ms"], roi["bound"]), "wrapper_ms": roi["wrapper_ms"]},
        {"name": "conv_stem_fwd", "route": "cuda", "source": src + "conv_stem_fwd.cu",
         "replaces": "poet_tpu/ops/conv_stem_pallas.py:66", **launched(4),
         # f32 (TF32 off) over every phase-12 case; relative: to each case's max |plain|
         "max_abs_err": report["stem_max_err"][0], "max_rel_err": report["stem_max_err"][1],
         "ms": stem_total["ms"], "plain_ms": stem_total["plain_ms"],
         "bound_ms": sum(t["bound"][0] for t in stem),
         "bound_by": max(("bytes", "operations"), key=lambda kind: sum(
             t["bound"][0] for t in stem if t["bound"][1] == kind)),
         "library_ms": stem_total["library_ms"],
         "library_is": "cuDNN F.conv2d + the activation, two calls",
         "f32_bound_ms": sum(t["f32_bound"][0] for t in stem), "f32_ms": stem_total["f32_ms"],
         "ms_are": "sums over a YOLO request's three launches (L0, L1, L3), bf16",
         "per_layer": {name: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "f32_ms")}
                       | {"bound_ms": t["bound"][0], "f32_bound_ms": t["f32_bound"][0]}
                       for name, t in zip(STEM_PATH, stem)}},
        {"name": "min_dist_sq_fwd", "route": "cuda", "source": src + "min_dist_sq_fwd.cu",
         "replaces": "poet_tpu/ops/nn_pallas.py:35", **launched(5),
         # f32 over every phase-15 case; relative: to each case's max |gt|^2
         "max_abs_err": report["nn_max_err"][0], "max_rel_err": report["nn_max_err"][1],
         "ms": nn["ms"], "plain_ms": nn["plain_ms"], "bound_ms": nn["bound"][0],
         "bound_by": nn["bound"][1], "library_ms": nn["library_ms"],
         "bound_is": "|g|^2 + |e|^2 - 2 g.e: the cross term 3xTF32 on the tensor cores, "
                     "the epilogue 3 f32 flops per pair",
         "f32_bound_ms": nn["f32_bound"][0],
         "library_is": f"torch.cdist(gt, est).amin(-1).square(), chunks of {NN_LIBRARY_CHUNK} "
                       f"poses, TF32 off",
         "ms_are": "P=64, N=M=15000 (the BOP cloud size), f32"},
        {"name": "ms_deform_attn_bwd_merged", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "341", **launched(6),
         "max_abs_err": max(report["merged_max_abs_err"].values()),
         **timed(merged["merged"], merged["plain"], report["merged_bound"]),
         "pair_ms": merged["pair"],
         "ms_are": "the encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4), bf16"},
        {"name": "ms_deform_attn_dense_fwd", "route": "cuda", "source": dense_src,
         "replaces": dense_tpu + "143", **launched(7),
         "max_abs_err": report["dense_max_abs_err"]["forward"],
         **timed(dense["dense_fwd"], dense["plain_fwd"], dense_enc["fwd_bounds"][0]),
         "kernel1_ms": dense["kernel1"], "f32_bound_ms": dense_enc["fwd_bounds"][1][0],
         "bound_is": "bytes against one dense (Q x S_pad) @ (S_pad x D) product per (b, h) "
                     "on the bf16 tensor cores; f32_bound_ms: the gather form's on the f32 pipes",
         "ms_are": "the encoder shape, bf16"},
        {"name": "ms_deform_attn_dense_bwd", "route": "cuda", "source": dense_src,
         "replaces": dense_tpu + "225", **launched(8),
         "max_abs_err": max(v for k, v in report["dense_max_abs_err"].items()
                            if k != "forward"),
         **timed(dense["dense_bwd"], dense["plain_bwd"], dense_enc["bwd_bounds"][0]),
         "pair_ms": dense["pair"], "merged_ms": dense["merged"],
         "f32_bound_ms": dense_enc["bwd_bounds"][1][0],
         "bound_is": "bytes against the TPU kernel's two dense products per (b, h) on the bf16 "
                     "tensor cores; f32_bound_ms: the gather form's dot + scatter",
         "ms_are": "the encoder shape, bf16"},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
