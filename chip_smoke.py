#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py [--only N,N,...]

(--only runs phases 1, 2 and the listed ones, and prints no kernel report.)
Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels (deformable attention on its gather and dense routes,
     RoIAlign, the stem conv, the min distance, the v2 forward and the three
     probes) from poet_tpu_torch/csrc with nvcc, one process per source, in
     parallel;
  3. both routes of the forward kernel (direct: corners from the L2; slab:
     a block per (b, h) on its value slab in shared memory) against the plain
     PyTorch version and against each other (the same bits): flagship
     encoder (Q=S=1600) and decoder (Q=10) shapes at B=16, edge level
     geometries, out-of-map and dummy-query locations, trailing pad tokens,
     the YOLO pyramid (S=6380, B=16; its f32 slab over the budget must be
     refused); f32 and bf16; device ms per route from CUDA-graph replays and
     plain ms; the direct/slab crossover over Q at S=1600; NaN locations
     (the C1 rule: the point's output row NaN, every other row == the point
     in the map at weight 0, on each route); autograd
     through the entry on every pair of routes the rules give (launches per
     route checked);
  4. the serving slice: the port's PoseServer at the paper config, bf16,
     batch 16, 480x640, seeded weights, the flagship numpy batch; outputs
     finite, rotations orthonormal with det +1, exactly the route rule's
     launches per request (5 slab forward for the encoder, 5 direct forward
     for the decoder) and no adjoint or RoIAlign launch; p50 ms and img/s;
  5. f32 end to end: the same seeded model at B=2 on the card (kernel) against
     the port on the CPU (plain version), TF32 off;
  6. the pair's adjoint kernels against the plain adjoint on the card: d_value
     on both routes (the atomic scatter; the slab route, a block per (b, h,
     channel group) on an f32 slab in shared memory, written once in the
     value dtype) and the d_loc/d_attn gather on both routes, a lane per
     sampling point over all D channels (direct: a block per (b, h, 256
     points) reading the corners from device memory; slab: a block per
     (b, h) on its value slab in shared memory), each against the plain
     adjoint and the two routes against
     each other; phase 3's geometries plus trailing pad tokens; f32 and
     bf16; NaN locations (C1: NaN d_loc in both coordinates and d_attn on
     both d_loc routes, nothing to d_value); device ms of each route from
     CUDA-graph replays and each d_loc route's bound, of the plain adjoint
     of its own outputs (autograd with respect to those inputs alone) and
     of the whole plain adjoint; at the encoder in bf16 the slab route over
     channel groups and threads per block (the figures behind plan_dvalue);
     every route at the encoder shape at a model's sampling locations (each
     query at its pixel centre, the grid initialisation's offsets), f32 and
     bf16, against the plain adjoint and each other, with device ms;
  7. the train slice: 8 steps of the paper config (the merged adjoint, the
     default), bf16 over f32 master weights, B=16, 480x640, seeded weights,
     the flagship batch, dropout 0.1, AdamW with clipping; exactly the route
     rule's launches per step (5 slab + 5 direct forward, 10 merged adjoint
     on its slab route) and no other, finite losses and grad norm, the frozen
     backbone bit-identical, the encoder moved; step p50 ms, img/s, peak
     memory;
  8. one f32 train step (the default config) at B=2, 480x640, TF32 off:
     losses, grad norm and every gradient on the card (kernels) against the
     CPU port (plain);
  9. both routes of the RoIAlign kernel (tiles: a block per box stages its
     distinct footprint cells in shared memory chunk by chunk and blends
     separably; gather: corners from the L2) against the plain version on
     the card: the detect+pose shape (levels (120,160)..(15,20) x 256, 16 x
     1000 proposals), edge boxes (under 1 px, slivers, outside the image,
     oversized, NaN) and a pyramid ending in a 2x2 level with C=6 (scalar
     loads); f32 and bf16; each route's ms alone and with its geometry,
     plain ms, the tiles route over chunks and threads (the same bits for
     each: the figures behind plan_roi), the bytes it stages and the bound;
 10. detect+pose serving: PoseServer in detector mode at the
     `bench.py:bench_maskrcnn_detect_pose` config (bbox_mode='backbone',
     bf16, batch 16, 480x640, 22 detector classes, 1000 proposals, 100
     detections), seeded weights with well-conditioned detector heads: 8
     requests through `infer`, then 8 through the pipelined `stream`;
     exactly 1 RoIAlign and 10 forward launches per request and no adjoint
     launch (the RoIAlign launch on the route plan_roi gives: tiles);
     outputs finite, rotations in SO(3), n_boxes <= Q, boxes inside
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
     cuDNN ms, the kernel's time over cuDNN + act's per layer (the figure
     comparable across calls) and the bounds at f32 and at bf16
     tensor-core rate;
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
     M >> N, clouds ~1 m from the origin, exact duplicates (minimum 0),
     near-duplicates within 1e-4 m and gt points midway between two est
     points (a wrong winner would show), a NaN est cloud and a NaN gt point
     (NaN as in the plain version);
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
 18. every route of the merged adjoint (slab, the value slab staged or read
     from device memory; banded, staged, unstaged and cut at every row or
     two by a narrow budget; atomic) against the plain adjoint, against the
     atomic route, against each other (the slab and banded routes' d_loc /
     d_attn the same bits) and against the pair of phase 6 (phase 6's
     geometries and the YOLO pyramid at B=16 as encoder, Q=6380, also at
     grid_locations, and decoder, Q=10, where the slab wrappers must refuse;
     f32 and bf16; pad rows exactly 0; NaN locations -> NaN d_loc / d_attn
     and nothing to d_value on every route), autograd through the entry with
     adjoint='merged' on the rule's route; device ms per route from CUDA-graph
     replays, pair and plain ms, and the bound; at the YOLO pyramid the pair's d_value on
     the rule's atomic scatter and on the slab splits that fit (8 and 4
     channels a block) against the plain adjoint, with device ms;
 19. the dense one-hot forward and adjoint kernels ('pallas') against the
     plain versions: phase 6's geometries and the YOLO pyramid (S=6380), f32
     and bf16, and at the encoder, the decoder and the YOLO pyramid also at a
     model's locations (model_locations), NaN locations held to the plain
     version on the card (the C1 rule: NaN output row, d_attn and d_loc,
     nothing to d_value), the adjoint's outputs bit-identical over two runs,
     autograd through the entry; dense device ms from CUDA-graph replays at
     both kinds of locations, the adjoint's two kinds of block alone; the
     adjoint's d_loc / d_attn blocks on both routes (the value slab staged
     in shared memory in a second launch, or read from device memory in the
     d_value blocks' launch; the pair's plan_dloc picks)
     at the encoder, f32 and bf16, uniform and a model's locations, against
     the plain adjoint and each other, each alone and in the whole launch,
     with device ms and the gather's bound; kernel 1, pair (on its rules'
     routes), merged and plain ms; the bounds on the tensor cores and in the
     gather form;
 20. the paths away from the defaults at phase 4's and 7's config: 8
     gt-serving requests through `infer` with enc/dec_deform_impl='pallas'
     (10 dense forward launches each and no other), 8 train steps with
     'pallas' (10 dense forward + 10 dense adjoint per step and no other) and
     8 with the pair adjoint (merged_adjoint=False: the forward's routes +
     10 d_value by its rule (5 scatter in the encoder, 5 slab in the
     decoder) + 10 d_loc by plan_dloc (5 slab in the encoder, 5 direct in
     the decoder) per step and no other), each beside phase 4's or
     7's p50 and img/s; one f32 train step of each at B=2 on the card against
     the CPU port, as phase 8;
 21. the v2 forward (`ms_deform_attn_v2`, on no model path): TMA stages the
     zero-bordered slab of a (b, h) into each of its CTAs, by multicast
     where two CTAs form a cluster; against the plain version on phase 3's
     geometries, the YOLO pyramid at B=16 (f32 in four double-buffered
     bands, bf16 in one) and the encoder at B=4 (a multicast cluster of
     two), small shapes at a band budget of one to three rows (many bands;
     more queries than one CTA holds), NaN locations; what TMA cannot describe (D=6:
     rows off 16 bytes; a base off 16 bytes) staged by the CTAs' threads;
     the entry on CUDA tensors and its refusal of inputs that require grad;
     each case's plan (staging, bands, buffers, cluster, passes) and the
     bytes a (b, h) stages beside the design before it (the plans'
     arithmetic); v2, kernel 1's direct and slab routes and plain ms; the
     bound and v2's share of it, the bound of the TPU kernel's products on
     the tensor cores beside it;
 22. the probes at reduced sizes: the chained mma.sync products against the
     plain chain at R = 1, 2 for every K of the sweep, then ms and TFLOP/s
     per K at R=64 G=66 with torch.matmul of one product; every variant of
     the forward kernel against its plain definition at the encoder shape
     and at the YOLO pyramid (B=16, Q=S=6380; base bit-equal to kernel 1)
     with ms per variant, the first points of each level moved next to the
     cell edges where loc * size - 0.5 floors differently as one rounding
     and as two (ROADMAP C8), and at both shapes the count of such points
     and of the points where noy's kernel left its plain definition (run
     with the attention on one point at a time), which must be 0; the four gather cases
     exactly equal to the plain version, device ms from a CUDA-graph replay
     and ms per host launch beside torch.gather's, the host's microseconds
     of each step of one gather call, and an index out of range that must
     raise.
 23. the CLI path (`poet_tpu_torch.cli`, in process, JAX's flag names) on PNG
     files: a PoET-format dataset of 48 train and 16 test 480x640 PNGs
     written by this script's zlib encoder (all five row filters, several
     IDAT chunks; a seeded smooth field plus noise), YCB-V classes and
     symmetries, models_eval PLY clouds; every file decoded back byte for
     byte, the decoder's images/s on one thread and on four; training at the
     paper config (bf16, gt mode, B=16, --rgb_augmentation --grayscale) for
     one epoch (3 steps), then --resume for a second: finite losses, log.txt
     epochs 0 and 1, the resumed parameters and AdamW state equal to the
     saved ones bit for bit, step p50 (host clock) and the loader wait per
     step, forward and merged-adjoint launches per step; --eval and
     --eval_bop from the checkpoint (metric files, one CSV row per object,
     min-distance launches); --inference on the test PNGs with Mask R-CNN
     and --backbone_weights of `flagship.detector_state_dict` (a
     results.json row per image, RoIAlign tiles launches); and the NaN gate:
     a resume from a checkpoint whose sampling-offsets bias holds a NaN
     stops with exit 1 and JAX's message before the rolling checkpoint is
     overwritten (C1, end to end). Each CLI path's launches are held to the
     route rules and reported as cli_train, cli_eval and cli_inference.
 24. the model's options at the paper config (bf16, B=16, 480x640, seeded):
     gt serving with the aleatoric heads and the learned query embedding,
     reference points and position embedding (8 requests; the forward's
     launches by the route rules and no other; finite poses in SO(3),
     variances (B, Q, 3) finite and > 0); 5 train steps with the same
     options and the bf16 AdamW first moment (the merged adjoint's launches,
     the backbone bit-identical, the learned tables, the reference-point
     projection and the aleatoric heads moved, the moment bf16 on the card);
     3 calibrate steps (the backward still runs through the frozen
     transformer: the same launches; every tensor but the aleatoric heads
     bit-identical on the card); step p50/p95 and device busy ms of a traced
     step (torch.profiler); one f32 step of the learned embeddings at B=2 on
     the card against the CPU port, as phase 8 (serve_variants,
     train_variants, train_calibrate in the report);
 25. training on detections (bbox_mode='backbone'): 3 steps with Mask R-CNN
     (phase 10's config) and 3 with YOLOv4-CSP (phase 13's), bf16, B=16,
     480x640, dropout 0.1, AdamW, on targets made of one detect forward of
     the same batch; the step matches the forward's queries (the matched
     count of each step printed, > 0), 1 RoIAlign (tiles) or 3 stem
     launches and the forward and merged-adjoint launches per step, the
     detector bit-identical; step p50/p95 and device busy ms, the merged
     adjoint's launches per route (the rule's: slab for Mask R-CNN, banded
     for YOLO) and its device ms in the traced step
     (train_detections_maskrcnn, train_detections_yolov4);
 26. data and data parallel: the JPEG route this machine builds
     (`native.jpeg_route()`: libjpeg, else nvJPEG) on the committed fixtures
     (tests/data/jpeg/: 4:4:4, 4:2:0, 4:2:2, gray, progressive, restart
     markers, odd sizes) against their reference pixels (exact on libjpeg,
     within JPEG_NVJPEG_MAX_DIFF on nvJPEG), a CMYK file refused, and
     images/s of the 480x640 fixture on 1 and 4 threads; 'synt' compositing
     of 8 480x640 RGBA PNGs (encode_png) over the fixtures' reference PNGs
     (the items' digest the CPU port gives, SYNT_DIGEST) and over their
     JPEGs (within the route's tolerance of those), ms per item; then data
     parallel at the paper config, 480x640, B=8 a process: 2 processes on
     the one card in a gloo group over CUDA tensors (NCCL puts no two
     processes on one device; `chip_smoke.py --dp-worker`; rank 0 holds the
     seeded weights, the other takes them by `replicate`), 2 f32 SGD steps
     with and without ZeRO-1 against one process taking the same shards with
     the global matched count (DP_SAME_TOL) and, by losses, grad norm and
     parameters, against one process's step on the 16 images (phase 8's
     tolerances), bf16 AdamW steps with and without ZeRO-1 (step p50, device
     busy ms, optimizer state MiB a process, the launches of the route
     rules), then a one-process NCCL group in this process (its steps, the
     metric sync on the card, the preemption vote, the pair gather, a rank-0
     checkpoint), beside one process's bf16 step at B=8: a rehearsal on one
     card, not a multi-card figure (train_data_parallel: rank 0's launches);
 27. multi-device layouts (`parallel/mesh.py:create_layout`, `parallel/tp.py`):
     (a) the forward and the merged adjoint at the shapes a layout gives
     them (TP=2: H=8, Q=S=1600; SP=2: H=16, Q=800, S=1600, and the YOLO
     pyramid's Q=3190 of S=6380, on the banded route in bf16), f32 and bf16,
     through the entry on the routes the rules give, against their plain
     versions, with device ms beside the unsharded shape's (H=16, Q=S) from
     the same call; (b) 2 processes in a gloo group on the one card
     (`chip_smoke.py --tp-worker`) under the layouts (1,1,2) and (1,2,1) at
     the paper config, 480x640, B=8 (one data slot): 2 f32 SGD steps, the
     gradients and parameters gathered whole, against one process on the
     same images (LAYOUT_TOL), the gap from one process by gradient tensor
     (relative L2 / max, the TP_GAP_TOP largest); C9's measurements of
     (1,1,2) (c9_checks): per decoder layer the valid pairs' angles to their
     targets (smallest sin^2, clamp counts), the gaps of the rotations, of
     their gradient and of each layer's output, the corner flips per
     deformable-attention call, each loss term's gradient gap, on the
     midpoint targets and on conditioned ones (every pair 20-160 degrees
     from its target), with the sampling locations pinned to one process's
     and not, beside one process in TP's order of sums (tp_order: held at
     CONDITIONED_TOL) and a one-ulp control; then bf16 AdamW steps (p50, device busy ms
     and the launches of the route rules per process; a rehearsal, not a
     multi-card figure: train_layout_1x1x2, train_layout_1x2x1, rank 0's
     launches); (c) `PoseServer(devices=("cuda:0", "cuda:0"))` at phase 4's
     config against the one-device server (f32 within SERVE_DEVICES_RTOL of
     scale; bf16 p50 of each; serve_devices: each shard's forward launches).
 28. the export twin (`engine/serving.py:export_model`, `ExportedPoseServer`):
     four artifacts at full width, bf16, B=16, 480x640, each traced on the
     CPU and served through `ExportedPoseServer(device="cuda")` beside a live
     `PoseServer` of the same weights: tracker mode at phase 4's weights and
     inputs, tracker mode with 'pallas' (phase 20's serving config), Mask
     R-CNN detector mode at phase 10's and YOLOv4-CSP at phase 13's; then
     tracker mode at f32 (B=2, TF32 off). Per artifact: export and load
     seconds, module.pt2's MB, 8 requests through each server's `infer`
     (p50/p95 of both); the artifact's launches per request equal to the
     live server's and to the route rules (10 forward: 5 slab + 5 direct,
     +1 RoIAlign tiles for Mask R-CNN, +3 stem for YOLO, 10 dense for
     'pallas'); boxes, classes and n_boxes equal to the live server's, the
     poses within E2E_RTOL of scale (f32: EXPORT_F32_RTOL). Nothing is
     caught (serve_exported, serve_pallas_exported, detect_exported,
     yolo_exported in the report).
 29. the last functions of poet_tpu: (a) one Mask R-CNN detect+pose request
     at phase 10's config with the final NMS capped at NMS_CAP candidates
     (`nms_candidates`; its launches, finite answers; detect_capped in the
     report), and the capped selection on that request's candidates, boxes
     snapped to whole pixels, on the card against the CPU port (the same
     indices), beside the exact selection; (b) `ops/detection.py:roi_align`
     on the card against the CPU port (aligned or not, sampling ratio 1
     and 2, f32) and the single-image `multiscale_roi_align` view (one
     kernel launch); (c) YOLOv4-CSP in gt mode, bf16, B=16, 480x640: 8
     requests through PoseServer and train steps, with no decode and no NMS
     fixed point and the route rules' launches (serve_yolo_gt,
     train_yolo_gt), then p50 against the parent commit's path (the decode
     and NMS run, unread) in turns (parent, change, change, parent, twice),
     and the fixed-point iterations the parent's path runs a request.
 30. resume from poet_tpu's orbax checkpoint: libzstd's path and version;
     the committed fixture (tests/data/orbax_resume: one poet_tpu SGD step
     of the YOLOv4-CSP mini cfg under a hidden-32 1+1-layer transformer, gt
     mode) read by `utils/orbax_format.py:read_pytree` (ms, median of 5,
     warm file cache), every leaf's SHA-256 against its digests.json; the
     port's config from the checkpoint's config.json, the model and the
     optimizer resumed (`load_resume`, `Optimizer.load_optax_state`) on the
     card and on the CPU, one f32 step each (B=2, 128x128, TF32 off): the
     losses within 1e-5 relative and every parameter within 1e-3 of lr; the
     card step's launches held to the route rules (its stem convs and its
     forward and merged-adjoint launches: train_orbax_resume).
Phases 4, 7, 10, 13, 16, 17, 20, 23, 24, 25, 26, 27, 28, 29 and 30's paths each
set every kernel's launch count to 0 before they drive their path and read them after, and hold them
to the wrappers' route rules (`path_launches`, `roi_launches`; the v2
kernel, the probes, the merged adjoint's atomic route and RoIAlign's gather
route: 0 on every path; the first two add their phase's own launches). Every kernel's entry in
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
# the YOLOv4-CSP full pyramid at 480x640 (strides 8/16/32 + one extra level)
YOLO_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))
# phases 3 and 18: every route of the forward and of the merged adjoint on
# phase 3's and 6's geometries and the YOLO pyramid at the path's batch
ROUTE_GEOMETRIES = ADJ_GEOMETRIES + [
    ("yolo pyramid", 16, 6380, 16, 16, YOLO_LEVELS, 0.0, 1.0, 0),
    ("yolo decoder", 16, 10, 16, 16, YOLO_LEVELS, -0.2, 1.2, 0),
]
ROUTES_TIMED = ("encoder", "decoder", "yolo pyramid", "yolo decoder")
# phase 3's crossover sweep: queries per (b, h) at the encoder's S = 1600
CROSSOVER_Q = (10, 25, 50, 100, 200, 400, 800, 1600)
# phase 3's autograd through the entry, one case per pair of routes:
# (name, B, Q, levels, dtype)
AUTOGRAD_CASES = [
    ("encoder bf16", 2, 1600, FLAGSHIP_LEVELS, "bfloat16"),
    ("encoder f32", 2, 1600, FLAGSHIP_LEVELS, "float32"),
    ("decoder bf16", 2, 10, FLAGSHIP_LEVELS, "bfloat16"),
    ("yolo pyramid bf16", 1, 6380, YOLO_LEVELS, "bfloat16"),
    ("small", 1, 6, ((3, 4), (2, 2)), "float32"),
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
    ("near-duplicates (within 1e-4 m)", 4, 3000, 2000, "near"),
    ("ties (two est points equidistant)", 4, 1000, 3000, "ties"),
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


KERNEL_KEYS = ("fwd", "d_value", "d_loc", "roi", "stem", "epilogue", "nn", "merged",
               "dense_fwd", "dense_bwd", "v2", "kpad", "variants", "gather", "fwd_slab",
               "merged_slab", "d_value_slab", "roi_tiles", "d_loc_slab", "dense_dloc_slab",
               "merged_banded")
LAUNCH_NAMES = "/".join(KERNEL_KEYS)


def log(msg: str) -> None:
    print(msg, flush=True)


def all_kernels():
    """Every kernel wrapper, in the report's order (KERNEL_KEYS): the
    forward's direct route, d_value, d_loc, RoIAlign, stem, the darknet
    body's epilogue, min distance, the merged adjoint's atomic route, dense
    forward, dense adjoint, v2 forward,
    the three probes (kpad, the forward's variants, the dynamic gather), then
    the forward's and the merged adjoint's slab routes, the pair's d_value
    slab route, RoIAlign's tiles route, the pair's d_loc slab route, the
    dense adjoint's staged d_loc / d_attn kernel and the merged adjoint's
    banded route."""
    from poet_tpu_torch.ops import deform_attn_cuda as gather
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense
    from poet_tpu_torch.ops.conv_stem_cuda import CONV_STEM_FWD
    from poet_tpu_torch.ops.darknet_epilogue_cuda import DARKNET_EPILOGUE
    from poet_tpu_torch.ops.deform_attn_v2_cuda import MS_DEFORM_ATTN_V2
    from poet_tpu_torch.ops.nn_cuda import MIN_DIST_SQ
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_FWD, ROI_ALIGN_TILES
    from poet_tpu_torch.tools.bench_kpad import KPAD_CHAIN
    from poet_tpu_torch.tools.bench_v3_variants import MS_DEFORM_ATTN_VARIANT
    from poet_tpu_torch.tools.dyn_gather import TAKE_ALONG_AXIS

    return [gather.MS_DEFORM_ATTN_FWD, gather.MS_DEFORM_ATTN_DVALUE, gather.MS_DEFORM_ATTN_DLOC,
            ROI_ALIGN_FWD, CONV_STEM_FWD, DARKNET_EPILOGUE, MIN_DIST_SQ,
            gather.MS_DEFORM_ATTN_MERGED,
            dense.MS_DEFORM_ATTN_DENSE_FWD, dense.MS_DEFORM_ATTN_DENSE_BWD, MS_DEFORM_ATTN_V2,
            KPAD_CHAIN, MS_DEFORM_ATTN_VARIANT, TAKE_ALONG_AXIS, gather.MS_DEFORM_ATTN_FWD_SLAB,
            gather.MS_DEFORM_ATTN_MERGED_SLAB, gather.MS_DEFORM_ATTN_DVALUE_SLAB, ROI_ALIGN_TILES,
            gather.MS_DEFORM_ATTN_DLOC_SLAB, dense.MS_DEFORM_ATTN_DENSE_DLOC,
            gather.MS_DEFORM_ATTN_MERGED_BANDED]


def expected(**counts):
    """A launch vector in all_kernels()'s order: the named counts, 0 elsewhere."""
    if set(counts) - set(KERNEL_KEYS):
        raise KeyError(f"unknown kernels {set(counts) - set(KERNEL_KEYS)}")
    return [counts.get(k, 0) for k in KERNEL_KEYS]


# the merged adjoint's routes (plan_merged) -> their KERNEL_KEYS
MERGED_KEYS = {"slab": "merged_slab", "banded": "merged_banded", "atomic": "merged"}
# the convs of the shipped YOLOv4-CSP cfgs whose FrozenBN and activation go
# through the epilogue kernel (models/yolov4.py:_use_epilogue): every BN conv
# after the three stem convs, per forward of the darknet body
YOLO_EPILOGUE = 109
# phase 31: the epilogue kernel at the shapes of those 109 convs, at the
# detect cell's frames a request (checked and timed) and the train cell's
# images a step (timed), 480x640, on the shipped cfg
EPILOGUE_B, EPILOGUE_TRAIN_B = 32, 64
YOLO_SHIPPED_CFG = os.path.join(ROOT, "configs", "ycbv_yolov4-csp.cfg")
# the token counts of the two pyramids at 480x640: Mask R-CNN's ResNet-FPN
# levels (gt mode and detect+pose) and YOLOv4-CSP's full pyramid
FLAGSHIP_S, YOLO_S = 1600, 6380


def path_launches(cfg, S, n, train=False, n_seq=1):
    """The deformable-attention launches by kernel that n forwards (train:
    n forward and backward passes) of the model at `cfg` over S encoder
    tokens make, by the wrappers' written route rules
    (ops/deform_attn_cuda.py: plan_forward, plan_merged, plan_dvalue,
    plan_dloc): the encoder at Q = S (under a 'seq' axis of n_seq processes
    its share, ceil(S / n_seq)), the decoder at Q = num_queries, each layer
    once."""
    import torch

    from poet_tpu_torch.ops.deform_attn_cuda import (plan_dloc, plan_dvalue, plan_forward,
                                                     plan_merged)

    m = cfg.model
    dtype, D, L = getattr(torch, m.dtype), m.hidden_dim // m.nheads, m.num_feature_levels
    counts = {}
    for impl, Q, P, layers in ((m.enc_deform_impl, -(-S // n_seq), m.enc_n_points,
                                m.enc_layers),
                               (m.dec_deform_impl, m.num_queries, m.dec_n_points, m.dec_layers)):
        if impl == "pallas":
            keys = ("dense_fwd", "dense_bwd") if train else ("dense_fwd",)
            if train and plan_dloc(S, D, dtype, Q, L, P).route == "slab":
                keys += ("dense_dloc_slab",)
        else:
            fwd = plan_forward(S, D, dtype, Q, L, P).route
            keys = ("fwd_slab" if fwd == "slab" else "fwd",)
            if train and m.merged_adjoint:
                keys += (MERGED_KEYS[plan_merged(S, D, dtype, Q, L, P).route],)
            elif train:
                keys += ("d_value_slab" if plan_dvalue(S, D, dtype, Q, L, P).route == "slab"
                         else "d_value",
                         "d_loc_slab" if plan_dloc(S, D, dtype, Q, L, P).route == "slab"
                         else "d_loc")
        for k in keys:
            counts[k] = counts.get(k, 0) + layers * n
    return counts


# the detector's FPN channels (RoIAlign's C on the detect+pose path)
DETECT_C = 256


def roi_launches(cfg, n):
    """The RoIAlign launches of n detect+pose forwards at `cfg`: one per
    forward, on the route ops/roi_align_cuda.py:plan_roi gives."""
    import torch

    from poet_tpu_torch.ops.roi_align_cuda import plan_roi

    tiles = plan_roi(DETECT_C, getattr(torch, cfg.model.dtype)).route == "tiles"
    return {"roi_tiles" if tiles else "roi": n}


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


def cuda_ms(fn, **kwargs) -> float:
    """ms per call of `fn`: `poet_tpu_torch.tools.timing.cuda_ms`, imported
    once main() has put the repo on the path."""
    from poet_tpu_torch.tools.timing import cuda_ms as timed

    return timed(fn, **kwargs)


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


def value_bytes_read(value, locs, shapes) -> int:
    """Bytes of `value` (B, S, H, D) a gather at `locs` must read: each
    (b, token, h) row of D channels under an in-map corner of a point in the
    map, once: at most the whole tensor, which a run with few queries (the
    decoder) does not read."""
    import torch

    B, S, H, _ = value.shape
    b = torch.arange(B, device=locs.device).view(B, 1, 1, 1)
    h = torch.arange(H, device=locs.device).view(1, 1, H, 1)
    rows, start = [], 0
    for l, (hl, wl) in enumerate(shapes):
        x = locs[..., l, :, 0] * wl - 0.5                   # (B, Q, H, P)
        y = locs[..., l, :, 1] * hl - 0.5
        hit = (x > -1) & (x < wl) & (y > -1) & (y < hl)
        x0 = torch.floor(torch.where(hit, x, 0.0)).long()
        y0 = torch.floor(torch.where(hit, y, 0.0)).long()
        for cy, cx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
            ok = hit & (cx >= 0) & (cx < wl) & (cy >= 0) & (cy < hl)
            rows.append(((b * S + start + cy * wl + cx) * H + h)[ok])
        start += hl * wl
    return int(torch.unique(torch.cat(rows)).numel()) * value.shape[3] * value.element_size()


def deform_bound(locs, shapes, D, *tensors, value=None):
    """Bound of a deformable kernel that reads and writes `tensors`, gathers
    from `value` at `locs` (value_bytes_read), and does 4 corners x D
    channels x 2 operations per point in the map."""
    n = nbytes(*tensors) + (0 if value is None else value_bytes_read(value, locs, shapes))
    return bound(n, 8.0 * D * deform_points_in_map(locs, shapes))


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


def grid_locations(g, B, H, shapes, P=4, noise_px=0.25):
    """(B, Q, H, L, P, 2) encoder sampling locations as a model places them:
    each of the Q = sum(H_l W_l) queries at its own token's pixel centre,
    head h's points at 1..P pixels along the direction 2 pi h / H on every
    level (Deformable DETR's grid initialisation), plus N(0, noise_px)
    pixels. Neighbouring queries sample neighbouring tokens."""
    import torch

    refs = []
    for h, w in shapes:
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        refs.append(torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1).reshape(-1, 2))
    ref = torch.cat(refs).to(DEVICE)
    theta = torch.arange(H, device=DEVICE) * (2 * math.pi / H)
    d = torch.stack([theta.cos(), theta.sin()], -1)
    d = d / d.abs().max(-1, keepdim=True).values
    off = d[:, None, :] * torch.arange(1, P + 1, device=DEVICE)[None, :, None]    # (H, P, 2)
    L, Q = len(shapes), ref.shape[0]
    noise = noise_px * torch.randn((B, Q, H, L, P, 2), generator=g, device=DEVICE)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=DEVICE)
    locs = ref[None, :, None, None, None] + (off[None, None, :, None] + noise) / wh[:, None]
    return locs.contiguous()


def model_locations(g, B, Q, H, shapes):
    """Q of grid_locations' queries, evenly spaced over its Q = sum(H_l W_l)
    (all of them when Q is that many): a decoder's few queries sampling as
    the encoder's do."""
    import torch

    grid = grid_locations(g, B, H, shapes)
    idx = torch.linspace(0, grid.shape[1] - 1, Q, device=grid.device).round().long()
    return grid[:, idx].contiguous()


def route_outputs(kernels, fits, *args):
    """{route: output} of each route whose slab fits; the others must refuse."""
    outs = {}
    for route, kernel in kernels.items():
        if fits[route]:
            outs[route] = kernel(*args)
        else:
            try:
                kernel(*args)
            except ValueError:
                continue
            raise AssertionError(f"the {route} wrapper took a slab over the budget")
    return outs


def entry_autograd(g, name, B, Q, shapes, dtype, H=16):
    """ms_deform_attn on CUDA leaves that require grad, forward and merged
    adjoint: the routes the rules give (one launch each, no other), the
    output and the three gradients against the plain versions. Returns the
    two routes."""
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd

    D, P = 16, 4
    dt = getattr(torch, dtype)
    bf16 = dt == torch.bfloat16
    value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=-0.1, hi=1.1)
    value = value.to(dt)
    dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE).to(dt)
    S = value.shape[1]
    fwd = dac.plan_forward(S, D, dt, Q, len(shapes), P).route
    bwd = dac.plan_merged(S, D, dt, Q, len(shapes), P).route
    want = expected(**{"fwd_slab" if fwd == "slab" else "fwd": 1, MERGED_KEYS[bwd]: 1})
    kernels = all_kernels()
    n0 = [k.launches for k in kernels]
    leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
    out = dac.ms_deform_attn(leaves[0], shapes, *leaves[1:], adjoint="merged")
    out.backward(dout)
    torch.cuda.synchronize()
    got = [k.launches - n for k, n in zip(kernels, n0)]
    if got != want:
        raise AssertionError(f"autograd {name}: launches {LAUNCH_NAMES} {got}, the rules give "
                             f"{want} (forward {fwd}, merged {bwd})")
    ref = plain(value.float(), shapes, locs, attn)
    err = (out.detach().float() - ref).abs()
    if not bool((err <= (BF16_ATOL + BF16_RTOL * ref.abs() if bf16 else F32_ATOL)).all()):
        raise AssertionError(f"autograd {name}: forward max err {err.max().item()}")
    adjoint_checks(f"autograd {name}", [t.grad for t in leaves],
                   plain_bwd(value.float(), shapes, locs, attn, dout.float()), value, locs, Q,
                   S, 0, off_edges(locs, shapes), bf16)
    return fwd, bwd


def phase_kernel(report):
    """Phase 3: both routes of the forward kernel (direct, slab) against the
    plain version and against each other (the same bits), on phase 3's and
    6's geometries and the YOLO pyramid, f32 and bf16; NaN locations; ms per
    route where the path runs it; the direct/slab crossover; autograd through
    the entry on every pair of routes."""
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from poet_tpu_torch.tools.timing import graph_ms

    routes = {"direct": dac.MS_DEFORM_ATTN_FWD, "slab": dac.MS_DEFORM_ATTN_FWD_SLAB}
    g = torch.Generator(device=DEVICE).manual_seed(0)
    max_err32 = 0.0
    for name, B, Q, H, D, shapes, lo, hi, pad in ROUTE_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        S, L, P = value.shape[1], len(shapes), locs.shape[4]
        line = f"forward routes {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S}"
        t = {}
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            key = "bf16" if bf16 else "f32"
            v = value.to(dt)
            rule = dac.plan_forward(S, D, dt, Q, L, P).route
            fits = {"direct": True, "slab": S * D * v.element_size() <= dac.SMEM_OPTIN_MAX}
            with torch.inference_mode():
                plain = ms_deform_attn_torch(v.float(), shapes, locs, attn)
                outs = route_outputs(routes, fits, v, shapes, locs, attn)
                torch.cuda.synchronize()
            if rule not in outs:
                raise AssertionError(f"{name} {key}: the rule picks {rule}, which refuses")
            errs = {}
            for route, out in outs.items():
                if out.dtype != dt:
                    raise AssertionError(f"{name}: {route} returned {out.dtype}")
                err = (out.float() - plain).abs()
                tol = BF16_ATOL + BF16_RTOL * plain.abs() if bf16 else F32_ATOL
                if not bool((err <= tol).all()):
                    raise AssertionError(f"{name} {key} {route}: max |kernel - plain| "
                                         f"{err.max().item():.3e}")
                errs[route] = err.max().item()
                if not bf16:
                    max_err32 = max(max_err32, errs[route])
            if "slab" in outs and not torch.equal(outs["slab"], outs["direct"]):
                raise AssertionError(f"{name} {key}: the slab route's output differs from the "
                                     f"direct route's")
            line += (f" | {key}: rule {rule}, max_abs_err "
                     + ", ".join(f"{r} {e:.2e}" for r, e in errs.items())
                     + (", slab == direct" if "slab" in outs else ", slab refused (over budget)"))
            if name in ROUTES_TIMED:
                with torch.inference_mode():   # the kernels' device time, from graph replays
                    ms = {r: graph_ms(lambda: routes[r](v, shapes, locs, attn),
                                      counted=routes[r]) for r in outs}
                    ms["plain"] = cuda_ms(lambda: ms_deform_attn_torch(v, shapes, locs, attn),
                                          iters=5)
                ms["rule"] = rule
                ms["bound"] = deform_bound(locs, shapes, D, locs, attn, outs["direct"], value=v)
                t[key] = ms
                line += " | ms " + ", ".join(f"{r} {ms[r]:.4f}" for r in (*outs, "plain"))
        if t:
            report[f"fwd_{name}"] = t
        log(line)

    # where staging pays: both routes at the encoder's levels, B=16, bf16
    cross = {}
    with torch.inference_mode():
        for Q in CROSSOVER_Q:
            value, locs, attn = deform_inputs(g, 16, Q, 16, 16, FLAGSHIP_LEVELS, lo=0.0, hi=1.0)
            args = (value.bfloat16(), FLAGSHIP_LEVELS, locs, attn)
            cross[Q] = {"reads": dac.corner_reads_per_token(FLAGSHIP_S, Q, 4, 4),
                        "direct": graph_ms(lambda: routes["direct"](*args),
                                           counted=routes["direct"]),
                        "slab": graph_ms(lambda: routes["slab"](*args), counted=routes["slab"]),
                        "rule": dac.plan_forward(FLAGSHIP_S, 16, torch.bfloat16, Q, 4, 4).route}
    report["fwd_crossover"] = cross
    log("forward crossover (B=16 H=16 D=16 S=1600 bf16; Q: corner reads per token, device ms "
        "direct / slab, the rule's route): " + ", ".join(
            f"{Q}: {c['reads']:.1f}, {c['direct']:.4f} / {c['slab']:.4f} {c['rule']}"
            for Q, c in cross.items()))

    # NaN locations (the C1 rule, csrc/ms_deform_attn_point.cuh): the point
    # reads nothing on either route and its (b, q, h) output row is NaN; every
    # other row equals that of the same point in the map at attention weight 0
    shapes = ((6, 9), (4, 5), (1, 1))
    value, locs, attn = deform_inputs(g, 2, 40, 2, 8, shapes)
    nan = torch.zeros(locs.shape[:-1], dtype=torch.bool, device=DEVICE)
    nan[:, 0, :, 0, 1] = nan[:, 3, :, 1, 2] = nan[1, 5, 0, 2, 0] = True
    locs_nan = locs.clone()
    locs_nan[:, 0, :, 0, 1, 0] = float("nan")
    locs_nan[:, 3, :, 1, 2, :] = float("nan")
    locs_nan[1, 5, 0, 2, 0, 1] = float("nan")
    twin_locs = torch.where(nan[..., None], 0.5, locs)
    twin_attn = torch.where(nan, 0.0, attn)
    rows = nan.flatten(-2).any(-1)[..., None].expand(-1, -1, -1, 8).reshape(2, 40, 16)
    with torch.inference_mode():
        for dt in (torch.float32, torch.bfloat16):
            v = value.to(dt)
            for route, kernel in routes.items():
                got = kernel(v, shapes, locs_nan, attn)
                twin = kernel(v, shapes, twin_locs, twin_attn)
                if not (torch.equal(torch.isnan(got), rows)
                        and torch.equal(got[~rows], twin[~rows])):
                    raise AssertionError(f"the {route} forward breaks the NaN-location rule")
    log(f"NaN locations: both routes give the point's row NaN ({int(rows.sum()) // 8} rows) "
        f"and every other row == the point in the map at weight 0 (f32 and bf16)")

    # CUDA tensors that require grad go through the entry and its adjoint,
    # each pair of routes the rules give
    pairs = {name: entry_autograd(g, name, *case) for name, *case in AUTOGRAD_CASES}
    log("entry with requires_grad: forward and merged adjoint on the rules' routes match the "
        "plain versions: " + ", ".join(f"{n} {f}/{b}" for n, (f, b) in pairs.items()))
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


def check_nan_point(name, got, ref, point):
    """The C1 rule's gradients: (d_loc, d_attn) NaN at `point` (an index of
    the (B, Q, H, L, P) grid; both d_loc coordinates) and nowhere else, and
    within ADJ_RTOL x max|ref| of `ref` (the same point off the map)
    elsewhere."""
    import torch

    for what, a, b in zip(("d_loc", "d_attn"), got, ref):
        want = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        want[point] = True
        if not torch.equal(torch.isnan(a), want):
            raise AssertionError(f"{name}: {what} is NaN at {int(torch.isnan(a).sum())} entries, "
                                 f"the rule at {int(want.sum())}")
        tol = ADJ_RTOL * max(b[~want].abs().max().item(), 1.0)
        if not (a[~want] - b[~want]).abs().max().item() <= tol:
            raise AssertionError(f"{name}: {what} off the NaN point differs from the point "
                                 f"off the map")


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


DVALUE_SWEEP_GROUPS = (4, 8, 16)
# phase 6's d_value crossover: queries per (b, h) at the encoder's S = 1600
DVALUE_CROSSOVER_Q = (10, 25, 50, 100, 200, 400, 800, 1600)
DVALUE_SWEEP_THREADS = (256, 512, 1024)


def dloc_checks(name, got, ref, value, locs, Q, mask):
    """Phase 6's and 19's checks of a d_loc / d_attn pair against `ref` (the
    plain adjoint's, or another route's): zero gradients of the dummy
    queries, each within ADJ_RTOL x max|ref| (d_loc off cell edges). Returns
    the max errors by output."""
    if Q >= 4 and not all(bool((t[:, -2:] == 0).all()) for t in got):
        raise AssertionError(f"{name}: dummy queries (-1, -10) got a gradient")
    errs = {}
    for k, gt, rf, m in zip(("d_loc", "d_attn"), got, ref, (mask, None)):
        errs[k], bad = adjoint_err(gt, rf, m)
        if bad:
            raise AssertionError(f"{name} {value.dtype}: {k} max |kernel - ref| {errs[k]:.3e} "
                                 f"beyond {ADJ_RTOL} x {rf.abs().max().item():.3e}")
    return errs


def phase_adjoint(report):
    """Phase 6: the pair's kernels against the plain adjoint: d_value on both
    routes (the atomic scatter; the slab route with the rule's channel
    group) and the d_loc/d_attn gather on both routes (direct, slab), each
    pair of routes against each other, on phase 3's geometries plus pad
    tokens, f32 and bf16; NaN locations; device ms of each route, the plain
    adjoint of its own outputs and the whole plain adjoint at the encoder and
    decoder shapes, and each d_loc route's bound; at the encoder in bf16 the
    d_value slab route over channel groups and threads per block (the
    figures behind plan_dvalue); every route at a model's sampling
    locations."""
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.tools.timing import graph_ms

    KV, KVS, KL = dac.MS_DEFORM_ATTN_DVALUE, dac.MS_DEFORM_ATTN_DVALUE_SLAB, dac.MS_DEFORM_ATTN_DLOC
    KLS = dac.MS_DEFORM_ATTN_DLOC_SLAB
    g = torch.Generator(device=DEVICE).manual_seed(1)
    worst = {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}
    worst_slab, worst_dloc_slab = 0.0, 0.0
    for name, B, Q, H, D, shapes, lo, hi, pad in ADJ_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S_lv = sum(h * w for h, w in shapes)
        S, L, P = value.shape[1], len(shapes), locs.shape[4]
        mask = off_edges(locs, shapes)
        line = f"adjoint-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S_lv + pad}"
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            v, do = value.to(dt), dout.to(dt)
            slab_group = dac.dvalue_slab_shape(S, D, Q, L, P).group
            ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
            d_loc_attn = KL(v, shapes, locs, attn, do)
            d_loc_slab = KLS(v, shapes, locs, attn, do)     # every geometry's slab fits
            got = (KV(v, shapes, locs, attn, do),) + d_loc_attn
            slab = (KVS(v, shapes, locs, attn, do),) + d_loc_attn
            torch.cuda.synchronize()
            errs = adjoint_checks(name, got, ref, value, locs, Q, S_lv, pad, mask, bf16)
            slab_err = adjoint_checks(f"{name} d_value slab (group {slab_group})", slab, ref,
                                      value, locs, Q, S_lv, pad, mask, bf16)["d_value"]
            adjoint_checks(f"{name} d_value slab vs scatter", slab,
                           [x.float() for x in got], value, locs, Q, S_lv, pad, None, bf16,
                           roundings=2)
            dloc_err = dloc_checks(f"{name} d_loc slab", d_loc_slab, ref[1:], v, locs, Q, mask)
            dloc_checks(f"{name} d_loc slab vs direct", d_loc_slab, d_loc_attn, v, locs, Q, mask)
            if not bf16:
                worst = {k: max(worst[k], errs[k]) for k in worst}
                worst_slab = max(worst_slab, slab_err)
                worst_dloc_slab = max([worst_dloc_slab, *dloc_err.values()])
            line += (f" | {'bf16' if bf16 else 'f32'} max_abs_err "
                     + " ".join(f"{k} {e:.2e}" for k, e in errs.items())
                     + f" d_value slab (group {slab_group}) {slab_err:.2e}"
                     + "".join(f" {k} slab {e:.2e}" for k, e in dloc_err.items()))
        line += f" (d_loc off cell edges: {int(mask.sum())}/{mask.numel()})"
        if name in ("encoder", "decoder"):
            t = {}
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                args = (v, shapes, locs, attn, do)
                plan = dac.plan_dvalue(S, D, dt, Q, L, P)
                # device ms of each route from graph replays (the scatter's
                # zeroed buffer and cast included); the plain versions per
                # call launched from the host
                ms = {"dvalue": graph_ms(lambda: KV(*args), counted=KV),
                      "dvalue_slab": graph_ms(lambda: KVS(*args), counted=KVS),
                      "plain_dvalue": cuda_ms(lambda: plain_adjoint_of(*args, (0,)), iters=5),
                      "dloc": graph_ms(lambda: KL(*args), counted=KL),
                      "dloc_slab": graph_ms(lambda: KLS(*args), counted=KLS),
                      "plain_dloc": cuda_ms(lambda: plain_adjoint_of(*args, (1, 2)), iters=5),
                      "plain": cuda_ms(lambda: plain_bwd(*args), iters=5)}
                shape = dac.dvalue_slab_shape(S, D, Q, L, P)
                ms["rule"] = {"route": plan.route, "group": shape.group,
                              "threads": shape.threads,
                              "dloc": dac.plan_dloc(S, D, dt, Q, L, P).route}
                ms["dloc_bound"] = deform_bound(locs, shapes, D, locs, attn, do, locs, attn,
                                                value=v)
                ms["value_read"] = (value_bytes_read(v, locs, shapes), nbytes(v))
                t["f32" if dt == torch.float32 else "bf16"] = ms
            line += "".join(f" | ms {dt}: " + ", ".join(
                                f"{k} {x:.4f}" for k, x in ms.items()
                                if k not in ("rule", "dloc_bound", "value_read"))
                            + f" (rule: {ms['rule']['route']}; slab group "
                              f"{ms['rule']['group']}, {ms['rule']['threads']} threads; "
                              f"d_loc {ms['rule']['dloc']}; d_loc bound "
                              f"{ms['dloc_bound'][0]:.4f} ({ms['dloc_bound'][1]}), value rows "
                              f"read {ms['value_read'][0]} of {ms['value_read'][1]} B)"
                            for dt, ms in t.items())
            report[f"adjoint_{name}"] = t
            v, do = value.bfloat16(), dout.bfloat16()
            report[f"dvalue_bound_{name}"] = deform_bound(locs, shapes, D, locs, attn, do, v)
            if name == "encoder":
                v, do = value.bfloat16(), dout.bfloat16()
                report["adjoint_bounds"] = {
                    "dvalue": deform_bound(locs, shapes, D, locs, attn, do, v),
                    "dloc": deform_bound(locs, shapes, D, locs, attn, do, locs, attn, value=v)}
                args = (v, shapes, locs, attn, do)
                sweep = {f"{gr}x{th}": graph_ms(lambda: KVS(*args, group=gr, threads=th),
                                                counted=KVS)
                         for gr in DVALUE_SWEEP_GROUPS for th in DVALUE_SWEEP_THREADS}
                report["dvalue_sweep"] = sweep
                line += (" | d_value slab bf16 ms by channels x threads per block: "
                         + ", ".join(f"{k} {x:.4f}" for k, x in sweep.items()))
        log(line)

    # the encoder shape at a model's sampling locations (grid_locations):
    # both d_value routes against the plain adjoint, with device ms
    B, H, D, shapes = 16, 16, 16, FLAGSHIP_LEVELS
    value, _, attn = deform_inputs(g, B, FLAGSHIP_S, H, D, shapes)
    locs = grid_locations(g, B, H, shapes)
    locs[:, -1] = -10.0                              # the dummy-query conventions
    locs[:, -2] = -1.0
    dout = torch.randn((B, FLAGSHIP_S, H * D), generator=g, device=DEVICE)
    t, line = {}, "adjoint-vs-plain encoder at grid-init locations:"
    mask = off_edges(locs, shapes)
    for dt in (torch.float32, torch.bfloat16):
        key = "bf16" if dt == torch.bfloat16 else "f32"
        args = (value.to(dt), shapes, locs, attn, dout.to(dt))
        ref = plain_bwd(args[0].float(), shapes, locs, attn, args[4].float())
        d_loc_attn = KL(*args)
        for r, kernel in (("scatter", KV), ("slab", KVS)):
            e = adjoint_checks(f"grid-init d_value {r}", (kernel(*args),) + d_loc_attn, ref,
                               value, locs, FLAGSHIP_S, FLAGSHIP_S, 0, mask,
                               dt == torch.bfloat16)["d_value"]
            line += f" | {key} d_value {r} max_abs_err {e:.2e}"
        d_loc_slab = KLS(*args)
        for r, got in (("direct", d_loc_attn), ("slab", d_loc_slab)):
            e = dloc_checks(f"grid-init d_loc {r}", got, ref[1:], args[0], locs, FLAGSHIP_S,
                            mask)
            line += f" | {key} d_loc {r} max_abs_err " + " ".join(
                f"{k} {x:.2e}" for k, x in e.items())
        dloc_checks("grid-init d_loc slab vs direct", d_loc_slab, d_loc_attn, args[0], locs,
                    FLAGSHIP_S, mask)
        t[key] = {"dvalue": graph_ms(lambda: KV(*args), counted=KV),
                  "dvalue_slab": graph_ms(lambda: KVS(*args), counted=KVS),
                  "dloc": graph_ms(lambda: KL(*args), counted=KL),
                  "dloc_slab": graph_ms(lambda: KLS(*args), counted=KLS)}
        line += f" | ms {key}: " + ", ".join(f"{k} {x:.4f}" for k, x in t[key].items())
    # the crossover over Q (the first Q queries, a model's locations) at S = 1600, bf16
    args = (value.bfloat16(), shapes, locs, attn, dout.bfloat16())
    t["crossover"] = {}
    for Q in DVALUE_CROSSOVER_Q:
        sub = (args[0], shapes) + tuple(x[:, :Q].contiguous() for x in args[2:])
        t["crossover"][Q] = {
            "reads_per_token": dac.corner_reads_per_token(FLAGSHIP_S, Q, len(shapes), 4),
            "dvalue": graph_ms(lambda: KV(*sub), counted=KV),
            "dvalue_slab": graph_ms(lambda: KVS(*sub, group=16, threads=512), counted=KVS)}
    line += " | bf16 crossover over Q (reads per token; scatter, slab ms): " + ", ".join(
        f"{Q} ({c['reads_per_token']:g}; {c['dvalue']:.4f}, {c['dvalue_slab']:.4f})"
        for Q, c in t["crossover"].items())
    report["adjoint_grid"] = t
    log(line)

    # NaN locations (the C1 rule): the point adds nothing to d_value, on both
    # routes, and gets NaN in d_attn and in both d_loc coordinates; every other
    # entry is that of the same point off the map
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, ((6, 9), (4, 5)))
    dout = torch.randn((2, 5, 16), generator=g, device=DEVICE)
    locs[:, 0, :, 0, 1, 0] = float("nan")
    args = (value, ((6, 9), (4, 5)), locs, attn, dout)
    clean = locs.clone()
    clean[:, 0, :, 0, 1] = -10.0                     # the same point off the map
    for kernel in (KV, KVS):
        d_value = kernel(*args)
        off_map = kernel(value, ((6, 9), (4, 5)), clean, attn, dout)
        _, bad = adjoint_err(d_value, off_map.float())
        if bad or not bool(torch.isfinite(d_value).all()):
            raise AssertionError(f"a NaN location leaked into d_value ({type(kernel).__name__})")
    for route, kernel in (("direct", KL), ("slab", KLS)):
        check_nan_point(f"d_loc/d_attn gather ({route})", kernel(*args),
                        kernel(value, ((6, 9), (4, 5)), clean, attn, dout),
                        (slice(None), 0, slice(None), 0, 1))
    report["adjoint_max_abs_err"] = worst
    report["dvalue_slab_max_abs_err"] = worst_slab
    report["dloc_slab_max_abs_err"] = worst_dloc_slab
    log(f"adjoint kernels: f32 max |kernel - plain| {worst}, d_value slab {worst_slab:.3e}, "
        f"d_loc/d_attn slab {worst_dloc_slab:.3e}, over {len(ADJ_GEOMETRIES)} geometries (tol "
        f"{ADJ_RTOL} x max|ref|; bf16 d_value + 2^-8 |ref|); NaN point: NaN d_loc (both "
        f"coordinates) and d_attn on both d_loc routes, d_value as with the point off the map "
        f"(both routes)")


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
    routes = path_launches(cfg, FLAGSHIP_S, 1)
    if counts != expected(**path_launches(cfg, FLAGSHIP_S, REQUESTS)):
        raise AssertionError(f"launches {LAUNCH_NAMES} {counts} for {REQUESTS} requests, "
                             f"expected {routes} per request and no other")
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
        f"launches {routes} per request ({per_layer} layers), finite, SO(3) err {so3:.2e}, "
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
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = flagship_config("float32")
    model = init_weights(build_model(cfg), seed=0).eval()
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    tg = {k: torch.from_numpy(targets[k]) for k in ("boxes", "labels", "n_boxes")}
    args = (torch.from_numpy(images), torch.from_numpy(pad_mask), tg)
    kernels = all_kernels()
    with torch.inference_mode():
        n0 = [k.launches for k in kernels]
        cpu = model(*args)
        if [k.launches for k in kernels] != n0:
            raise AssertionError("the CPU run launched a CUDA kernel")
        with tf32_off():
            model = model.cuda()
            card = model(args[0].cuda(), args[1].cuda(), {k: v.cuda() for k, v in tg.items()})
        card = {k: v.cpu() for k, v in card.items()}
        if [k.launches - n for k, n in zip(kernels, n0)] != expected(
                **path_launches(cfg, FLAGSHIP_S, 1)):
            raise AssertionError("the card run did not go through the forward's routes")
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


# the train step's deformable-attention variants: the ModelConfig fields set
# ('merged' is the default config; the kernels each takes come from
# path_launches)
TRAIN_VARIANTS = {
    "merged": {"merged_adjoint": True},
    "pair": {"merged_adjoint": False},
    "pallas": {"enc_deform_impl": "pallas", "dec_deform_impl": "pallas"},
    # phase 24's f32 check: the three learned embeddings (the aleatoric heads
    # are held at f32 against JAX on the CPU; their rotation loss's log map
    # is ill-conditioned near pi, where the flagship batch's uniform
    # rotations put some pair in most draws)
    "learned": {"query_embedding": "learned", "reference_points": "learned",
                "position_embedding": "learned"},
}
# phase 24: the model's options, all on (position_embedding is a
# BackboneConfig field, the others ModelConfig's)
MODEL_OPTIONS = {"aleatoric": True, "query_embedding": "learned",
                 "reference_points": "learned", "position_embedding": "learned"}


def set_options(cfg, options):
    for k, v in options.items():
        setattr(cfg.backbone if k == "position_embedding" else cfg.model, k, v)
    return cfg


def train_config(dtype, variant):
    from poet_tpu_torch.flagship import flagship_config

    return set_options(flagship_config(dtype), TRAIN_VARIANTS[variant])


def phase_train(report, variant="merged"):
    """Phase 7 (the default config: the merged adjoint) or, with `variant`
    'pair' / 'pallas', phase 20's train steps."""
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
    routes = path_launches(cfg, FLAGSHIP_S, 1, train=True)
    if launches != expected(**path_launches(cfg, FLAGSHIP_S, TRAIN_STEPS, train=True)):
        raise AssertionError(f"train {variant}: launches {LAUNCH_NAMES} {launches} for "
                             f"{TRAIN_STEPS} steps, expected {routes} per step and no other")
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
        f"AdamW: {TRAIN_STEPS} steps, launches {LAUNCH_NAMES} {launches} ({routes} per "
        f"step over {per_step} layers), loss {history[0]['loss']:.4f} -> "
        f"{history[-1]['loss']:.4f}, grad_norm {history[-1]['grad_norm']:.4f}, backbone bit-identical ({len(frozen)} tensors), "
        f"{w_name} moved; step p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
        f"{stats['img_s']:.2f} img/s, peak mem {stats['peak_gib']:.2f} GiB")
    key = "" if variant == "merged" else f"_{variant}"
    report["train_launches" + key] = launches
    report["train" + key] = stats


def phase_train_f32(variant="merged"):
    """Phase 8 (the default config: the merged adjoint) or, with `variant`,
    phase 20's f32 step."""
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
    routes = path_launches(cfg, FLAGSHIP_S, 1, train=True)
    if [k.launches - n for k, n in zip(kernels, n0)] != expected(**routes):
        raise AssertionError(f"train f32 {variant}: the card step did not go through "
                             f"{routes} alone")
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
    log(f"train f32 {variant} card-vs-CPU (B={B}, {H}x{W}, dropout 0, TF32 off, launches "
        f"{routes}): losses max rel err "
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


# phase 9's sweep of the tiles route: (channels per chunk, threads per block)
ROI_SWEEP = {"bf16": ((8, 128), (16, 64), (16, 128), (16, 256), (32, 128)),
             "f32": ((8, 64), (8, 128), (8, 256), (16, 128))}


def roi_staged_bytes(shapes, boxes, C, itemsize):
    """The bytes the tiles route stages: per box its distinct rows times its
    distinct columns (each in-map sample's lower and upper line), C
    channels each."""
    import torch

    from poet_tpu_torch.ops.detection import roi_geometry

    geo = roi_geometry(shapes, ROI_STRIDES, boxes)

    def distinct(lo, w):
        big = torch.iinfo(torch.int32).max
        lines = torch.stack([lo, lo + 1], -1).flatten(1)
        inside = (w.abs().sum(-1) > 0).repeat_interleave(2, 1)
        lines = torch.where(inside, lines, torch.full_like(lines, big)).sort(1).values
        first = (lines[:, 1:] != lines[:, :-1]) & (lines[:, 1:] < big)
        return (lines[:, 0] < big).long() + first.sum(1)

    cells = distinct(geo.ylo, geo.yw) * distinct(geo.xlo, geo.xw)
    return int(cells.sum()) * C * itemsize


def phase_roi(report):
    """Phase 9: both routes of the RoIAlign kernel (tiles: a block per (box,
    channel chunk) on the box's footprint staged in shared memory; gather:
    corners from the L2) against the plain version on ROI_GEOMETRIES, f32
    and bf16, NaN boxes pooling zeros; at the detect+pose shape each route's
    ms alone and the tiles route with its geometry, the plain version's, the
    tiles route over channel chunks (the same bits for every chunk: the
    figures behind plan_roi) and the bound."""
    import torch

    from poet_tpu_torch.ops.detection import multiscale_roi_align_torch as plain
    from poet_tpu_torch.ops.detection import roi_geometry
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_FWD as K
    from poet_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_TILES as KT
    from poet_tpu_torch.ops.roi_align_cuda import plan_roi

    g = torch.Generator(device=DEVICE).manual_seed(2)
    worst = {"gather": 0.0, "tiles": 0.0}
    for name, B, R, C, (H, W), kind in ROI_GEOMETRIES:
        shapes = [(H // s, W // s) for s in ROI_STRIDES]
        feats = [torch.randn((B, h, w, C), generator=g, device=DEVICE) for h, w in shapes]
        boxes = roi_boxes(g, B, R, H, W, kind)
        tol = ROI_F32_RTOL * max(f.abs().max().item() for f in feats)
        f16 = [f.bfloat16() for f in feats]
        line = f"roi-vs-plain {name}: B={B} R={R} C={C} levels={shapes}"
        with torch.inference_mode():
            ref = plain(feats, ROI_STRIDES, boxes)
            ref16 = plain([f.float() for f in f16], ROI_STRIDES, boxes)
            for route, kernel in (("gather", K), ("tiles", KT)):
                got = kernel(feats, ROI_STRIDES, boxes)
                got16 = kernel(f16, ROI_STRIDES, boxes)
                torch.cuda.synchronize()
                err32 = (got - ref).abs().max().item()
                if not err32 <= tol:
                    raise AssertionError(f"roi {name} {route} f32: max |kernel - plain| {err32} "
                                         f"> {tol}")
                if got16.dtype != torch.bfloat16 or tuple(got16.shape) != (B, R, 7, 7, C):
                    raise AssertionError(f"roi {name} {route}: kernel returned {got16.dtype} "
                                         f"{tuple(got16.shape)}")
                err16 = (got16.float() - ref16).abs()
                if not bool((err16 <= tol + BF16_RTOL * ref16.abs()).all()):
                    raise AssertionError(f"roi {name} {route} bf16: max |kernel - plain| "
                                         f"{err16.max().item()} beyond {tol} + 2^-8 |ref|")
                if kind == "edges" and not (bool((got[:, 7] == 0).all())
                                            and bool((got16[:, 7] == 0).all())):
                    raise AssertionError(f"roi {name} {route}: a NaN box pooled non-zero values")
                worst[route] = max(worst[route], err32)
                line += (f" | {route}: f32 max_abs_err={err32:.3e} bf16 max_abs_err="
                         f"{err16.max().item():.3e}")
        line += (f" (tol {tol:.2e}, bf16 + 2^-8 |ref|; tiles chunk bf16 "
                 f"{plan_roi(C, torch.bfloat16).chunk}, f32 {plan_roi(C, torch.float32).chunk})")
        if kind == "proposals":
            with torch.inference_mode():
                geo = roi_geometry(shapes, ROI_STRIDES, boxes)
                t = {dt: {"tiles": cuda_ms(lambda: KT.launch(fs, boxes, geo)),
                          "gather": cuda_ms(lambda: K.launch(fs, boxes, geo)),
                          "tiles_with_geometry": cuda_ms(lambda: KT(fs, ROI_STRIDES, boxes)),
                          "gather_with_geometry": cuda_ms(lambda: K(fs, ROI_STRIDES, boxes)),
                          "plain": cuda_ms(lambda: plain(fs, ROI_STRIDES, boxes), iters=5,
                                           warmup=1)}
                     for dt, fs in (("f32", feats), ("bf16", f16))}
                sweep = {}
                for dt, fs in (("f32", feats), ("bf16", f16)):
                    want = KT.launch(fs, boxes, geo)
                    for chunk, th in ROI_SWEEP[dt]:
                        if not torch.equal(KT.launch(fs, boxes, geo, chunk=chunk, threads=th),
                                           want):
                            raise AssertionError(f"roi tiles {dt}: chunk {chunk}, {th} threads "
                                                 f"changed the bits")
                        sweep[f"{dt} {chunk}x{th}"] = cuda_ms(
                            lambda: KT.launch(fs, boxes, geo, chunk=chunk, threads=th))
                bms, by = roi_bound(shapes, boxes, f16, got16)
                staged = roi_staged_bytes(shapes, boxes, C, 2)
            for dt, ms in t.items():
                line += f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items())
            line += (" | tiles ms by chunk x threads: "
                     + ", ".join(f"{k} {x:.4f}" for k, x in sweep.items())
                     + f" | bound {bms:.4f} ms ({by}) | bf16 staged {staged / 1e9:.3f} GB, "
                       f"{staged / t['bf16']['tiles'] / 1e9:.3f} TB/s over the tiles ms")
            report["roi"] = {**t, "sweep": sweep, "bound": (bms, by), "staged_bytes": staged}
        log(line)
    # a CUDA input that requires grad is refused: the op has no gradient
    for kernel in (K, KT):
        try:
            kernel([f.requires_grad_() for f in feats], ROI_STRIDES, boxes)
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
    kernels = all_kernels()
    expect = expected(**path_launches(cfg, FLAGSHIP_S, DETECT_REQUESTS),
                      **roi_launches(cfg, DETECT_REQUESTS))

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
        f"{FIXED_POINT.iterations} iterations; boxes, classes, n_boxes equal to the pruned "
        f"path's, poses within "
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

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = detect_pose_config("float32")
    model = detect_pose_model(cfg)
    images, pad_mask = detect_pose_batch(B, H, W, seed=0)
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
        if [k.launches - n for k, n in zip(kernels, n0)] != expected(
                **path_launches(cfg, FLAGSHIP_S, 2), **roi_launches(cfg, 2)):
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
            t.update(bound=b16, f32_bound=b32, gflop=flops / 1e9, mbytes=n_bytes / 1e6,
                     library_ratio=t["ms"] / t["library_ms"])
            line += (f" | bf16 ms kernel {t['ms']:.4f}, plain {t['plain_ms']:.4f}, cuDNN conv + "
                     f"act {t['library_ms']:.4f} (kernel / cuDNN + act "
                     f"{t['library_ratio']:.3f}); f32 kernel {t['f32_ms']:.4f} | {flops / 1e9:.2f} "
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


def epilogue_bn(g, C):
    """A FrozenBatchNorm on the card whose buffers are drawn from `g` in the
    ranges of a trained one's."""
    from poet_tpu_torch.models.resnet_fpn import FrozenBatchNorm

    bn = FrozenBatchNorm(C).to(DEVICE)
    for t, (lo, hi) in ((bn.weight, (0.8, 1.2)), (bn.bias, (-1, 1)),
                        (bn.running_mean, (-1, 1)), (bn.running_var, (0.5, 1.5))):
        t.uniform_(lo, hi, generator=g)
    return bn


def epilogue_gap(x, bn, act, got):
    """How far the epilogue kernel's output `got` on x lies from what it must
    match -> (largest gap in ulps of the reference, largest absolute gap,
    the reference's pre-activation). f32: the plain composition
    (FrozenBatchNorm, then the activation), in f32 ulps; bf16: the f32
    composition of the same input with the scale and offset rounded to bf16
    as FrozenBatchNorm rounds them, in bf16 ulps."""
    import torch

    from poet_tpu_torch.ops.darknet_epilogue_cuda import activate

    nchw = x.permute(0, 3, 1, 2)
    if x.dtype == torch.float32:
        pre, bits = bn(nchw), 23
    else:
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        off = bn.bias - bn.running_mean * inv
        pre = (nchw.float() * inv.to(x.dtype).float()[:, None, None]
               + off.to(x.dtype).float()[:, None, None])
        bits = 7
    ref = activate(pre, act).permute(0, 2, 3, 1)
    gap = (got.float() - ref).abs()
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref)[1] - (bits + 1))
    return (gap / ulp).max().item(), gap.max().item(), pre


def phase_epilogue(report):
    """The darknet epilogue kernel (`ops/darknet_epilogue_cuda.py`) at the
    11 distinct (H, W, C) of the shipped cfg's 109 epilogue convs at B=32
    480x640, for mish, leaky and linear, on inputs spanning -30..30 (both
    sides of mish's clamp at 25): f32 within 2 ulp of the plain composition,
    bf16 within 1 bf16 ulp of the f32 composition; then a forward's 109
    calls (bf16, each conv its own input and buffers) timed by graph
    replays against the plain composition and the library's batch_norm +
    activation, at B=32 and B=64; the kernel alone at each distinct shape
    and a copy of the largest map's bytes; the host's microseconds a call."""
    import torch
    import torch.nn.functional as F

    from poet_tpu_torch.models.yolov4 import epilogue_convs, load_cfg_sections
    from poet_tpu_torch.ops.darknet_epilogue_cuda import ACTIVATIONS
    from poet_tpu_torch.ops.darknet_epilogue_cuda import DARKNET_EPILOGUE as K
    from poet_tpu_torch.ops.darknet_epilogue_cuda import activate, darknet_epilogue
    from poet_tpu_torch.tools.timing import graph_ms, host_us

    convs = epilogue_convs([dict(s) for s in load_cfg_sections(YOLO_SHIPPED_CFG)])
    if len(convs) != YOLO_EPILOGUE:
        raise AssertionError(f"{len(convs)} epilogue convs in the shipped cfg, not "
                             f"{YOLO_EPILOGUE}")
    g = torch.Generator(device=DEVICE).manual_seed(27)
    worst = {"f32_ulp": 0.0, "bf16_ulp": 0.0, "f32_abs": 0.0, "bf16_abs": 0.0}
    for H, W, C in sorted({c[:3] for c in convs}):
        bn = epilogue_bn(g, C)
        x = torch.rand((EPILOGUE_B, H, W, C), device=DEVICE, generator=g) * 60 - 30
        line = []
        for act in ACTIVATIONS:
            for dtype, name, tol in ((torch.float32, "f32", 2), (torch.bfloat16, "bf16", 1)):
                xd = x.to(dtype)
                n0 = K.launches
                with torch.inference_mode():
                    got = darknet_epilogue(xd, bn.weight, bn.bias, bn.running_mean,
                                           bn.running_var, bn.eps, act)
                    ulps, err, pre = epilogue_gap(xd, bn, act, got)
                    torch.cuda.synchronize()
                if K.launches != n0 + 1 or got.dtype != dtype or got.shape != xd.shape:
                    raise AssertionError(f"epilogue {(H, W, C)} {act} {name}: "
                                         f"{K.launches - n0} launches, {got.dtype} "
                                         f"{tuple(got.shape)}")
                if not (bool((pre > 25).any()) and bool((pre < -25).any())):
                    raise AssertionError(f"epilogue {(H, W, C)}: the input missed a side of "
                                         f"mish's clamp at 25")
                if not ulps <= tol:
                    raise AssertionError(f"epilogue {(H, W, C)} {act} {name}: {ulps} ulp of "
                                         f"the reference > {tol}")
                worst[f"{name}_ulp"] = max(worst[f"{name}_ulp"], ulps)
                worst[f"{name}_abs"] = max(worst[f"{name}_abs"], err)
                line.append(f"{act} {name} {ulps:.2f} ulp ({err:.2e})")
        log(f"epilogue-vs-plain B={EPILOGUE_B} {H}x{W} C={C}: {', '.join(line)}")
        del x, xd, got, pre
    library_act = {"mish": F.mish, "leaky": lambda y: F.leaky_relu(y, 0.1),
                   "linear": lambda y: y}
    per_batch = {}
    for B in (EPILOGUE_B, EPILOGUE_TRAIN_B):
        calls = []
        for H, W, C, act in convs:
            x = (torch.randn((B, H, W, C), device=DEVICE, generator=g) * 4).bfloat16()
            calls.append((x, epilogue_bn(g, C), act))

        def kernel(calls=calls):
            for x, bn, act in calls:
                K(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, act)

        def plain(calls=calls):
            for x, bn, act in calls:
                activate(bn(x.permute(0, 3, 1, 2)), act)

        def library(calls=calls):
            for x, bn, act in calls:
                library_act[act](F.batch_norm(x.permute(0, 3, 1, 2), bn.running_mean,
                                              bn.running_var, bn.weight, bn.bias, False, 0.0,
                                              bn.eps))

        with torch.inference_mode():
            t = {"ms": graph_ms(kernel, iters=1, replays=10),
                 "plain_ms": graph_ms(plain, iters=1, replays=10),
                 "library_ms": graph_ms(library, iters=1, replays=10),
                 "ms_again": graph_ms(kernel, iters=1, replays=10),
                 "plain_ms_again": graph_ms(plain, iters=1, replays=10)}
            t["bound"] = bound(sum(nbytes(x) * 2 for x, _, _ in calls), 0)
            t["share_of_bound"] = t["bound"][0] / max(t["ms"], t["ms_again"])
            if B == EPILOGUE_B:
                by_shape, largest = {}, max(x.numel() for x, _, _ in calls)
                for x, bn, act in calls:
                    for a in (ACTIVATIONS if x.numel() == largest else (act,)):
                        key = f"{tuple(x.shape[1:])} {a}"
                        if key not in by_shape:
                            ms = graph_ms(lambda x=x, bn=bn, a=a: K(
                                x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                bn.eps, a), iters=10, replays=5)
                            by_shape[key] = {"ms": ms, "TB_s": 2 * nbytes(x) / ms / 1e9}
                x, bn, act = max(calls, key=lambda c: c[0].numel())
                out = torch.empty_like(x)
                copy_ms = graph_ms(lambda: out.copy_(x), iters=10, replays=5)
                t.update(by_shape=by_shape, copy_ms=copy_ms,
                         copy_TB_s=2 * nbytes(x) / copy_ms / 1e9,
                         host_us=host_us(lambda: darknet_epilogue(
                             x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                             act), calls=400),
                         plain_host_us=host_us(lambda: activate(bn(x.permute(0, 3, 1, 2)),
                                                                act), calls=400))
        log(f"epilogue B={B}: a forward's {len(calls)} calls bf16 ms kernel {t['ms']:.4f}, "
            f"{t['ms_again']:.4f}; plain {t['plain_ms']:.4f}, {t['plain_ms_again']:.4f}; "
            f"batch_norm + act {t['library_ms']:.4f}; bound {t['bound'][0]:.4f} "
            f"({t['bound'][1]}: each element read and written once), "
            f"{100 * t['share_of_bound']:.1f}% of it")
        if B == EPILOGUE_B:
            log(f"epilogue B={B} alone by shape: " + "; ".join(
                f"{k} {v['ms']:.4f} ms {v['TB_s']:.3f} TB/s" for k, v in t["by_shape"].items())
                + f"; a copy of the largest map {t['copy_ms']:.4f} ms {t['copy_TB_s']:.3f} "
                  f"TB/s; host us a call {t['host_us']:.1f} through the operator, "
                  f"{t['plain_host_us']:.1f} plain")
        per_batch[B] = t
        del calls
        torch.cuda.empty_cache()
    # an input that requires grad is refused: the op has no gradient
    bn = epilogue_bn(g, 16)
    try:
        K(torch.zeros((1, 2, 2, 16), device=DEVICE, requires_grad=True), bn.weight, bn.bias,
          bn.running_mean, bn.running_var, bn.eps, "mish")
    except RuntimeError:
        pass
    else:
        raise AssertionError("the epilogue kernel accepted an input that requires grad")
    report["epilogue"] = per_batch
    report["epilogue_max_err"] = worst


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
    kernels = all_kernels()
    expect = expected(**path_launches(cfg, YOLO_S, YOLO_REQUESTS), stem=3 * YOLO_REQUESTS,
                      epilogue=YOLO_EPILOGUE * YOLO_REQUESTS)

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
    fp = (FIXED_POINT.calls, FIXED_POINT.iterations, FIXED_POINT.max_iterations)
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
        f"image; NMS fixed points {fp[0]} calls, {fp[1]} iterations, longest {fp[2]}; "
        f"infer p50 "
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
        if [k.launches - n for k, n in zip(kernels, n0)] != expected(
                **path_launches(cfg, YOLO_S, 2), stem=2 * 3, epilogue=2 * YOLO_EPILOGUE):
            raise AssertionError("the card runs did not go through the forward, stem and "
                                 "epilogue kernels")
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
    every other gt point an exact copy of an est point, 'near' puts it within
    1e-4 m of one (a wrong winner would show at NN_RTOL); 'ties' puts every
    other gt point midway between two est points 1e-3 m from it (the first
    2N est points, in pairs); 'nan' puts a NaN in one est cloud and in one
    gt point."""
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
    elif kind == "near":
        idx = torch.randint(0, M, (P, N), generator=g, device=DEVICE)
        near = torch.gather(est, 1, idx[..., None].expand(P, N, 3)) + 1e-4 * (
            2 * torch.rand((P, N, 3), generator=g, device=DEVICE) - 1) / math.sqrt(3)
        gt = torch.where((torch.arange(N, device=DEVICE) % 2 == 0)[None, :, None], near, gt)
    elif kind == "ties":
        half = 1e-3 * torch.nn.functional.normalize(
            torch.randn((P, N // 2, 3), generator=g, device=DEVICE), dim=-1)
        mid = gt[:, 0::2][:, :N // 2]
        est[:, 0:N // 2 * 2:2], est[:, 1:N // 2 * 2:2] = mid + half, mid - half
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
    difference form for every pair, as the earlier SIMT design ran it (3
    subtractions, 1 multiply, 2 FMAs: 8 flops per pair over 67 TFLOP/s); the
    kernel now ranks in the matrix-unit form and takes the direct form for
    the winners only."""
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
    n_adi = adi_launches(evaluator)
    expect = expected(**path_launches(cfg, FLAGSHIP_S, EVAL_BATCHES), nn=n_adi)
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
    if bop_counts != expected(**path_launches(cfg, FLAGSHIP_S, EVAL_BATCHES)):
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
    expect = expected(**path_launches(cfg, FLAGSHIP_S, n_batches),
                      **roi_launches(cfg, n_batches), nn=adi_launches(evaluator))
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


# phase 18's d_value slab splits at the YOLO pyramid, where at most 8
# channels' slab fits and the rule takes the scatter: (channels, threads)
YOLO_DVALUE_SWEEP = ((4, 512), (4, 1024), (8, 512), (8, 1024))


def merged_bound(v, locs, attn, do, grads, shapes):
    """The merged adjoint's bound: its bytes (v's gathered rows,
    value_bytes_read) against a dot and a scatter, 4 corners x D channels x
    4 operations per point in the map."""
    return bound(nbytes(locs, attn, do, *grads) + value_bytes_read(v, locs, shapes),
                 16.0 * v.shape[-1] * deform_points_in_map(locs, shapes))


def banded_name(stage):
    """The banded route's name in phase 18 and the report, by its staging."""
    return f"banded_{'staged' if stage else 'unstaged'}"


def narrow_budget(shapes, D, dtype, stage):
    """The least shared memory in which every row of `shapes` fits as a band
    of its own (with its halo row): the banded route's plan then cuts bands
    inside levels and at their edges."""
    from poet_tpu_torch.ops import deform_attn_cuda as dac

    return max(dac.merged_band_bytes(w, w + (w if y + 1 < h else 0), D, dtype, stage)
               for h, w in shapes for y in range(h))


def merged_rule_name(plan):
    """Phase 18's name of the route plan_merged gives."""
    if plan.route == "banded":
        return banded_name(plan.stage)
    if plan.route == "slab":
        return "slab_staged" if plan.stage else "slab_unstaged"
    return "atomic"


def phase_merged(report):
    """Phase 18: every route of the merged adjoint (the slab route with the
    value slab staged and read from device memory; the banded route staged,
    unstaged, and with a budget that cuts a band at every row or two; the
    atomic route) against the plain adjoint, against the atomic route,
    against each other (every slab and banded route's d_loc and d_attn the
    same bits) and against the pair (d_value and the d_loc/d_attn gather, each on its
    route), on phase 6's geometries and the YOLO pyramid (encoder and
    decoder), f32 and bf16, the YOLO encoder also at a model's sampling
    locations (grid_locations); at the YOLO pyramid the pair's d_value on
    both routes (slab, atomic scatter) against the plain adjoint, with
    device ms; NaN locations; autograd through the entry; ms per route and
    the bound."""
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.tools.timing import graph_ms

    KV, KVS, KM, KMS, KMB = (dac.MS_DEFORM_ATTN_DVALUE, dac.MS_DEFORM_ATTN_DVALUE_SLAB,
                             dac.MS_DEFORM_ATTN_MERGED, dac.MS_DEFORM_ATTN_MERGED_SLAB,
                             dac.MS_DEFORM_ATTN_MERGED_BANDED)
    routes = {"atomic": KM,
              "slab_staged": lambda *args: KMS(*args, stage=True),
              "slab_unstaged": lambda *args: KMS(*args, stage=False)}
    counted = {"atomic": KM, "slab_staged": KMS, "slab_unstaged": KMS}
    for stage in (True, False):
        routes[banded_name(stage)] = (lambda st: lambda *args: KMB(*args, stage=st))(stage)
        counted[banded_name(stage)] = KMB
    g = torch.Generator(device=DEVICE).manual_seed(5)
    worst = {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}

    def check_routes(name, value, locs, attn, dout, Q, S_lv, pad, bf16, timed):
        """Every route at one geometry, dtype and set of locations: the checks
        above; with `timed`, device ms per route (graph replays; the atomic
        route's zeroed buffer and cast included), the pair's and the plain
        adjoint's per host call, and the bound. Returns (log text, times)."""
        dt = torch.bfloat16 if bf16 else torch.float32
        key = "bf16" if bf16 else "f32"
        v, do = value.to(dt), dout.to(dt)
        args = (v, shapes, locs, attn, do)
        S, D, L, P = v.shape[1], v.shape[3], len(shapes), locs.shape[4]
        mask = off_edges(locs, shapes)
        rule = merged_rule_name(dac.plan_merged(S, D, dt, Q, L, P))
        fits = {r: True for r in routes}
        fits["slab_staged"] = dac.merged_slab_bytes(S, D, dt, True) <= dac.SMEM_OPTIN_MAX
        fits["slab_unstaged"] = dac.merged_slab_bytes(S, D, dt, False) <= dac.SMEM_OPTIN_MAX
        rts = dict(routes)
        if not name.startswith("yolo"):   # a band at every row or two
            budget = narrow_budget(shapes, D, dt, True)
            rts["banded_narrow"] = lambda *a: KMB(*a, stage=True, budget=budget)
            fits["banded_narrow"] = True
            n_bands = len(dac.plan_merged_bands(shapes, D, dt, True, budget).bounds) - 1
            if n_bands < 2:
                raise AssertionError(f"{name}: the narrow budget cut {n_bands} band")
        ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
        got = route_outputs(rts, fits, *args)
        pair = (dac.dvalue_adjoint(*args),) + dac.dloc_adjoint(*args)
        torch.cuda.synchronize()
        if rule not in got:
            raise AssertionError(f"{name} {key}: the rule picks {rule}, which refuses")
        errs = {}
        for r, gr in got.items():
            errs[r] = adjoint_checks(f"{name} {r}", gr, ref, value, locs, Q, S_lv, pad, mask,
                                     bf16)
            if r != "atomic":
                adjoint_checks(f"{name} {r} vs atomic", gr, [x.float() for x in got["atomic"]],
                               value, locs, Q, S_lv, pad, None, bf16, roundings=2)
            if not bf16:
                for k in worst:
                    worst[k] = max(worst[k], errs[r][k])
        # every slab and banded route gathers the same values in the same order
        gathers = [r for r in got if r != "atomic"]
        if not all(torch.equal(got[r][i], got[gathers[0]][i]) for r in gathers for i in (1, 2)):
            raise AssertionError(f"{name} {key}: the slab and banded routes' d_loc / d_attn "
                                 f"differ")
        # against the pair: the same coordinates, sums in other orders
        pair_errs = adjoint_checks(name + " vs the pair", got[rule], [x.float() for x in pair],
                                   value, locs, Q, S_lv, pad, None, bf16, roundings=2)
        text = (f" | {key}: rule {rule}; max_abs_err "
                + "; ".join(f"{r} " + " ".join(f"{k} {e:.2e}" for k, e in es.items())
                            for r, es in errs.items())
                + " (rule vs the pair " + " ".join(f"{e:.2e}" for e in pair_errs.values())
                + "); slab and banded d_loc / d_attn equal"
                + "".join(f", {r} refused (over budget)" for r in rts if r not in got))
        if not timed:
            return text, None
        ms = {r: graph_ms(lambda: rts[r](*args), counted=counted[r])
              for r in got if not r.startswith("banded_narrow")}
        ms.update(pair=cuda_ms(lambda: (dac.dvalue_adjoint(*args), dac.dloc_adjoint(*args))),
                  plain=cuda_ms(lambda: plain_bwd(*args), iters=5))
        ms["rule"] = rule
        # the banded route with the wrappers' defaults (the rule's, where it takes it)
        ms["banded"] = banded_name(dac.corner_reads_per_token(S, Q, L, P) >= dac.SLAB_MIN_READS)
        ms["bound"] = merged_bound(v, locs, attn, do, got[rule], shapes)
        return text + " | ms " + ", ".join(f"{r} {ms[r]:.4f}" for r in ms
                                          if r not in ("rule", "banded", "bound")), ms

    for name, B, Q, H, D, shapes, lo, hi, pad in ROUTE_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S, L, P = value.shape[1], len(shapes), locs.shape[4]
        S_lv = sum(h * w for h, w in shapes)
        line = f"merged routes {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S}"
        t = {}
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            key = "bf16" if bf16 else "f32"
            if name == "yolo pyramid":
                # the pair's d_value: the rule's atomic scatter (the 16-channel
                # slab does not fit) and the narrower slab splits that do
                v, do = value.to(dt), dout.to(dt)
                args = (v, shapes, locs, attn, do)
                if dac.plan_dvalue(S, D, dt, Q, L, P).route != "atomic":
                    raise AssertionError(f"{name} {key}: plan_dvalue takes the slab route")
                ref = plain_bwd(v.float(), shapes, locs, attn, do.float())
                pair = (dac.dvalue_adjoint(*args),) + dac.dloc_adjoint(*args)
                dv = {"scatter": graph_ms(lambda: KV(*args), counted=KV),
                      "bound": deform_bound(locs, shapes, D, locs, attn, do, v), "sweep": {}}
                line += f" | {key} d_value ms: scatter (the rule) {dv['scatter']:.4f}, slab"
                for gr, th in YOLO_DVALUE_SWEEP:
                    e = adjoint_checks(f"{name} d_value slab {gr}x{th}",
                                       (KVS(*args, group=gr, threads=th),) + pair[1:], ref,
                                       value, locs, Q, S_lv, pad, off_edges(locs, shapes),
                                       bf16)["d_value"]
                    dv["sweep"][f"{gr}x{th}"] = graph_ms(
                        lambda: KVS(*args, group=gr, threads=th), counted=KVS)
                    line += f" {gr}x{th} {dv['sweep'][f'{gr}x{th}']:.4f} (err {e:.2e})"
                line += f", bound {dv['bound'][0]:.4f}"
                t.setdefault("d_value", {})[key] = dv
            text, ms = check_routes(name, value, locs, attn, dout, Q, S_lv, pad, bf16,
                                    name in ROUTES_TIMED)
            line += text
            if ms is not None:
                t[key] = ms
            if name == "yolo pyramid":
                # a model's sampling locations (neighbouring queries sample
                # neighbouring tokens), the last two queries the dummies
                grid = grid_locations(g, B, H, shapes)
                grid[:, -2:] = torch.tensor([-1.0, -10.0], device=DEVICE)[:, None, None, None,
                                                                         None]
                text, ms = check_routes(name + " at grid locations", value, grid, attn, dout,
                                        Q, S_lv, pad, bf16, True)
                line += " | grid locations" + text
                t[key + "_grid"] = ms
        if t:
            report[f"merged_{name}"] = t
        log(line)

    # NaN locations (the C1 rule): the point adds nothing to d_value and gets
    # NaN in d_attn and both d_loc coordinates, on every route (the banded
    # route also cut at every row); every other entry is that of the same
    # point off the map
    shapes = ((6, 9), (4, 5))
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, shapes)
    dout = torch.randn((2, 5, 16), generator=g, device=DEVICE)
    locs[:, 0, :, 0, 1, 0] = float("nan")
    clean = locs.clone()
    clean[:, 0, :, 0, 1] = -10.0
    nan_routes = dict(routes)
    nan_budget = narrow_budget(shapes, 8, torch.float32, True)
    nan_routes["banded_narrow"] = lambda *a: KMB(*a, stage=True, budget=nan_budget)
    for r, kernel in nan_routes.items():
        d_value, d_loc, d_attn = kernel(value, shapes, locs, attn, dout)
        ref_value, ref_loc, ref_attn = kernel(value, shapes, clean, attn, dout)
        _, bad = adjoint_err(d_value.float(), ref_value.float())
        if bad or not bool(torch.isfinite(d_value).all()):
            raise AssertionError(f"a NaN location leaked into the merged adjoint's d_value ({r})")
        check_nan_point(f"merged adjoint ({r})", (d_loc, d_attn), (ref_loc, ref_attn),
                        (slice(None), 0, slice(None), 0, 1))
    # autograd through the entry with adjoint='merged': the route the rule gives
    shapes = ((3, 4), (2, 2))
    v, l, a = deform_inputs(g, 1, 6, 2, 8, shapes)
    dout = torch.randn((1, 6, 16), generator=g, device=DEVICE)
    leaves = [t.clone().requires_grad_() for t in (v, l, a)]
    plan = dac.plan_merged(v.shape[1], 8, v.dtype, 6, 2, 4)
    kernel = {"slab": KMS, "banded": KMB, "atomic": KM}[plan.route]
    n0 = [k.launches for k in (KM, KMS, KMB)]
    dac.ms_deform_attn(leaves[0], shapes, *leaves[1:], adjoint="merged").backward(dout)
    if [k.launches - n for k, n in zip((KM, KMS, KMB), n0)] != [int(k is kernel)
                                                                for k in (KM, KMS, KMB)]:
        raise AssertionError(f"adjoint='merged' did not launch the {plan.route} route alone")
    want = plain_bwd(v, shapes, l, a, dout)
    for name, t, ref in zip(("d_value", "d_loc", "d_attn"), leaves, want):
        err = (t.grad - ref).abs().max().item()
        if not err <= ADJ_RTOL * max(ref.abs().max().item(), 1.0):
            raise AssertionError(f"autograd through the merged adjoint: {name} max err {err}")
    report["merged_max_abs_err"] = worst
    log(f"merged adjoint: f32 max |kernel - plain| {worst} over {len(ROUTE_GEOMETRIES)} "
        f"geometries and every route that takes them (tol {ADJ_RTOL} x max|ref|; bf16 d_value "
        f"+ 2^-8 |ref|); every slab and banded route's d_loc / d_attn equal; agrees with the "
        f"pair; NaN point -> NaN "
        f"d_loc / d_attn, nothing to d_value, on every route; the entry's adjoint='merged' "
        f"launches the {plan.route} route")


DENSE_GEOMETRIES = ADJ_GEOMETRIES + [
    ("yolo pyramid", 2, 6380, 16, 16, YOLO_LEVELS, 0.0, 1.0, 0),
]


def dense_bounds(value, locs, attn, tensors, shapes, products, gather_ops):
    """(bound, f32 bound), each (ms, binds), of a dense one-hot kernel that
    reads `value`'s rows under the points' corners (value_bytes_read) and
    reads and writes `tensors`: its bytes against `products`
    dense (B H Q S_pad D) products on the bf16 tensor cores (2 flops per
    multiply-add), and, beside it, against the gather form's `gather_ops` per
    in-map point and channel on the f32 pipes (rows 1-3's bound)."""
    from poet_tpu_torch.ops.deform_attn_dense_cuda import padded_tokens

    B, _, H, D = value.shape
    Q = locs.shape[1]
    n_bytes = nbytes(*tensors) + value_bytes_read(value, locs, shapes)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_tc = products * 2.0 * B * H * Q * padded_tokens(shapes) * D / BF16_TC_FLOP_PER_S
    tc = (max(t_bytes, t_tc) * 1e3, "bytes" if t_bytes >= t_tc else "operations")
    return tc, bound(n_bytes, gather_ops * D * deform_points_in_map(locs, shapes))


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


def dense_checks(name, DF, DB, v, shapes, locs, attn, do, adjoint=True):
    """The dense forward against the plain version (f32 or bf16 tolerance);
    the adjoint bit-identical over two runs and against the plain adjoint.
    Returns (forward max error, the adjoint's errors or None)."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd

    bf16 = v.dtype == torch.bfloat16
    with torch.inference_mode():
        ref = plain(v.float(), shapes, locs, attn)
        out = DF(v, shapes, locs, attn)
        torch.cuda.synchronize()
    if out.dtype != v.dtype:
        raise AssertionError(f"dense {name}: forward returned {out.dtype}")
    err = (out.float() - ref).abs()
    tol = BF16_ATOL + BF16_RTOL * ref.abs() if bf16 else F32_ATOL
    if not bool((err <= tol).all()):
        raise AssertionError(f"dense {name} {v.dtype}: forward max |kernel - plain| "
                             f"{err.max().item():.3e}")
    if not adjoint:
        return err.max().item(), None
    got = DB(v, shapes, locs, attn, do)
    again = DB(v, shapes, locs, attn, do)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"dense {name} {v.dtype}: the adjoint differs between two runs")
    S_lv = sum(h * w for h, w in shapes)
    errs = adjoint_checks(name, got, plain_bwd(v.float(), shapes, locs, attn, do.float()),
                          v.float(), locs, locs.shape[1], S_lv, v.shape[1] - S_lv,
                          off_edges(locs, shapes), bf16)
    return err.max().item(), errs


def dense_dloc_routes(DB, value, shapes, uniform, model, attn, dout):
    """Phase 19 at the encoder: the dense adjoint's d_loc / d_attn blocks on
    both routes (the value slab staged, in a launch of their own; or read
    from device memory in the d_value blocks' launch) at f32
    and bf16, at uniform and a model's locations: each against the plain
    adjoint and the two against each other; device ms of each alone
    (part='d_loc') and of the whole launch on each, the rule's route, and
    the gather's bound (as phase 6's d_loc routes)."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.ops.deform_attn_cuda import plan_dloc
    from poet_tpu_torch.tools.timing import graph_ms

    B, S, H, D = value.shape
    Q, L, P = uniform.shape[1], uniform.shape[3], uniform.shape[4]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        key = "bf16" if dt == torch.bfloat16 else "f32"
        v, do = value.to(dt), dout.to(dt)
        out[f"{key}_rule"] = plan_dloc(S, D, dt, Q, L, P).route
        for where, locs in (("", uniform), ("_model", model)):
            args = (v, shapes, locs, attn, do)
            ref = plain_bwd(v.float(), shapes, locs, attn, do.float())[1:]
            mask = off_edges(locs, shapes)
            got = {}
            for route, stage in (("slab", True), ("direct", False)):
                got[route] = DB(*args, part="d_loc", stage=stage)[1:]
                errs = dloc_checks(f"dense d_loc blocks {route}{where}", got[route], ref, v, locs,
                                   Q, mask)
                out[f"{key}_{route}{where}_err"] = max(errs.values())
                out[f"{key}_{route}{where}"] = graph_ms(lambda: DB(*args, part="d_loc",
                                                                   stage=stage))
                out[f"{key}_{route}_whole{where}"] = graph_ms(lambda: DB(*args, stage=stage))
            dloc_checks(f"dense d_loc blocks slab vs direct{where}", got["slab"], got["direct"],
                        v, locs, Q, mask)
        bnd = deform_bound(uniform, shapes, D, uniform, attn, do, uniform, attn, value=v)
        out[f"{key}_bound"], out[f"{key}_bound_by"] = bnd
        out[f"{key}_plain"] = cuda_ms(lambda: plain_adjoint_of(v, shapes, uniform, attn, do,
                                                                (1, 2)), iters=5)
    return out


def phase_dense(report):
    """Phase 19: the dense one-hot forward and adjoint against the plain
    versions (phase 6's geometries and the YOLO pyramid, f32 and bf16), NaN
    locations held to the plain version, the adjoint's outputs bit-identical
    over two runs; at the encoder, the decoder and the YOLO pyramid also at a
    model's locations (model_locations), each kernel's device time from graph
    replays there and at the uniform ones, the adjoint's two kinds of block
    alone; at the encoder the d_loc / d_attn blocks on both routes (staged,
    unstaged) against the plain adjoint and each other, alone and in the
    whole launch, with the gather's bound; against kernel 1, the pair, the
    merged adjoint and the plain versions; the bounds."""
    import torch

    from poet_tpu_torch.tools.timing import graph_ms

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch_backward as plain_bwd
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K1
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_MERGED as KM
    from poet_tpu_torch.ops.deform_attn_dense_cuda import MS_DEFORM_ATTN_DENSE_BWD as DB
    from poet_tpu_torch.ops.deform_attn_dense_cuda import MS_DEFORM_ATTN_DENSE_FWD as DF
    from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense
    from poet_tpu_torch.ops import deform_attn_cuda as dac

    g = torch.Generator(device=DEVICE).manual_seed(6)
    worst_fwd, worst = 0.0, {"d_value": 0.0, "d_loc": 0.0, "d_attn": 0.0}
    for name, B, Q, H, D, shapes, lo, hi, pad in DENSE_GEOMETRIES:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi, pad=pad)
        dout = torch.randn((B, Q, H * D), generator=g, device=DEVICE)
        S_lv = sum(h * w for h, w in shapes)
        line = f"dense-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes} S={S_lv + pad}"
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            err, errs = dense_checks(name, DF, DB, value.to(dt), shapes, locs, attn, dout.to(dt))
            if not bf16:
                worst_fwd = max(worst_fwd, err)
                worst = {k: max(worst[k], errs[k]) for k in worst}
            line += (f" | {'bf16' if bf16 else 'f32'} forward {err:.2e}, "
                     + " ".join(f"{k} {e:.2e}" for k, e in errs.items()))
        line += " (adjoint bit-identical over two runs)"
        if name in ("encoder", "decoder", "yolo pyramid"):
            t = {}
            adjoint = name != "yolo pyramid"
            model = model_locations(g, B, Q, H, shapes)
            model[:, -2:] = torch.tensor([-1.0, -10.0], device=DEVICE)[:, None, None, None,
                                                                      None]   # the dummies
            for dt in (torch.float32, torch.bfloat16):
                v, do = value.to(dt), dout.to(dt)
                err, errs = dense_checks(name + " at a model's locations", DF, DB, v, shapes,
                                         model, attn, do, adjoint)
                line += (f" | model locations {'bf16' if dt == torch.bfloat16 else 'f32'} "
                         f"forward {err:.2e}"
                         + ("" if errs is None else ", " + " ".join(
                             f"{k} {e:.2e}" for k, e in errs.items())))
                ms = {}
                for where, l in (("", locs), ("_model", model)):
                    args = (v, shapes, l, attn)
                    with torch.inference_mode():
                        ms["dense_fwd" + where] = graph_ms(lambda: DF(*args))
                    if adjoint:
                        ms["dense_bwd" + where] = graph_ms(lambda: DB(*args, do))
                        ms["dense_bwd_d_value" + where] = graph_ms(
                            lambda: DB(*args, do, part="d_value"))
                        ms["dense_bwd_d_loc" + where] = graph_ms(
                            lambda: DB(*args, do, part="d_loc"))
                args = (v, shapes, locs, attn)
                with torch.inference_mode():
                    ms.update(kernel1=cuda_ms(lambda: K1(*args)),
                              plain_fwd=cuda_ms(lambda: plain(*args), iters=5))
                if adjoint:
                    ms.update(pair=cuda_ms(lambda: (dac.dvalue_adjoint(*args, do),
                                                    dac.dloc_adjoint(*args, do))),
                              merged=cuda_ms(lambda: KM(*args, do)),
                              plain_bwd=cuda_ms(lambda: plain_bwd(*args, do), iters=5))
                t["bf16" if dt == torch.bfloat16 else "f32"] = ms
            line += "".join(f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items())
                            for dt, ms in t.items())
            v, do = value.bfloat16(), dout.bfloat16()
            out, grads = DF(v, shapes, locs, attn), DB(v, shapes, locs, attn, do)
            t["fwd_bounds"] = dense_bounds(v, locs, attn, (locs, attn, out), shapes, 1, 8)
            # the TPU kernel's two products (W^T dout for d_value, dout Vpad^T
            # for the corner dots) against the gather form's dot + scatter
            t["bwd_bounds"] = dense_bounds(v, locs, attn, (locs, attn, do) + grads, shapes,
                                           2, 16)
            line += (f" | bounds (tensor cores; f32 gather form) forward "
                     f"{t['fwd_bounds'][0][0]:.4f} ({t['fwd_bounds'][0][1]}); "
                     f"{t['fwd_bounds'][1][0]:.4f} ({t['fwd_bounds'][1][1]}), adjoint "
                     f"{t['bwd_bounds'][0][0]:.4f} ({t['bwd_bounds'][0][1]}); "
                     f"{t['bwd_bounds'][1][0]:.4f} ({t['bwd_bounds'][1][1]})")
            if name == "encoder":
                t["dloc_routes"] = dense_dloc_routes(DB, value, shapes, locs, model, attn, dout)
                line += " | d_loc / d_attn blocks by route: " + ", ".join(
                    f"{k} {x:.2e}" if k.endswith("_err") else
                    f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}"
                    for k, x in t["dloc_routes"].items())
            report[f"dense_{name}"] = t
        log(line)

    # NaN locations, held to the plain version on the card, which carries the
    # C1 rule by an explicit mask: NaN where it has NaN (the point's output
    # row, d_attn and both d_loc coordinates), within tolerance elsewhere
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
    mask = off_edges(locs, shapes) | torch.isnan(locs).any(-1, keepdim=True)
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
    the pair adjoint (merged_adjoint=False), gt serving with 'pallas', and
    one f32 train step of each of the two on the card against the CPU port."""
    phase_slice(report, impl="pallas")
    phase_train(report, "pallas")
    phase_train(report, "pair")
    phase_train_f32("pallas")
    phase_train_f32("pair")
    for key, ref in (("slice_pallas", "slice"), ("train_pallas", "train"),
                     ("train_pair", "train")):
        if ref not in report:                        # a partial run without phases 4, 7
            continue
        new, old = report[key], report[ref]
        fps = "fps" if "fps" in new else "img_s"
        log(f"paths: {key} p50 {new['p50_ms']:.3f} ms, {new[fps]:.2f} img/s beside {ref} "
            f"(phase {4 if ref == 'slice' else 7}) p50 {old['p50_ms']:.3f} ms, "
            f"{old[fps]:.2f} img/s")


V2_GEOMETRIES = GEOMETRIES + [
    ("yolo pyramid", 16, 6380, 16, 16, YOLO_LEVELS, 0.0, 1.0, 0),
    # B H = 64: two CTAs a (b, h), the one plan that multicasts over a cluster
    ("encoder B=4", 4, 1600, 16, 16, FLAGSHIP_LEVELS, 0.0, 1.0, 0),
]
# (name, B, Q, H, D, levels, loc range, band budget in widest pitched rows):
# a budget of one row's bytes forces a band per row or two
V2_BAND_CASES = [
    ("many bands, f32 D=8", 2, 37, 2, 8, ((6, 9), (4, 5), (2, 3)), -0.2, 1.2, 1),
    ("many bands, D=6 (scalar loads)", 2, 9, 3, 6, ((5, 7), (3, 4)), -0.2, 1.2, 2),
    ("many bands, more queries than one CTA holds", 1, 2100, 1, 16, ((3, 4), (2, 2)),
     -0.2, 1.2, 3),
]
V2_TIMED = ("encoder", "decoder", "yolo pyramid", "encoder B=4")


def v2_bounds(value, locs, attn, out, shapes):
    """(bound, TPU-form bound), each (ms, binds), of the v2 forward. The
    bound is the function's own, as row 1's: its bytes against 8 D
    operations per in-map point on the f32 pipes. Beside it, the TPU
    formulation's: the bytes against its two one-hot products per (b, h,
    level, point) on the bf16 tensor cores (the y-mix Q x Hp x Wp*D and the
    x-mix reduction Q x Wp*D x D, 2 flops per multiply-add), which the slab
    kernel does not do."""
    B, _, H, D = value.shape
    Q, P = locs.shape[1], locs.shape[4]
    t_bytes = nbytes(value, locs, attn, out) / HBM_BYTES_PER_S
    flops = sum(2.0 * Q * ((h + 2) * (w + 2) * D + (w + 2) * D * D) for h, w in shapes)
    t_tc = flops * B * H * P / BF16_TC_FLOP_PER_S
    tpu_form = (max(t_bytes, t_tc) * 1e3, "bytes" if t_bytes >= t_tc else "operations")
    return deform_bound(locs, shapes, D, locs, attn, out, value=value), tpu_form


def v2_earlier_staged_bytes(B, H, Q, D, shapes, itemsize, sms=132):
    """Bytes a (b, h) staged through the L2 in the design this kernel replaced,
    by that design's plan (its arithmetic, for the log line; nothing runs
    it): its whole padded slab (packed, no pitch) once per block of a query
    chunk (512 threads of D / (16 / itemsize) slices, fewer where the grid
    would not fill the card)."""
    slices = D * itemsize // 16
    qc = max(1, min(Q, 512 // slices))
    blocks_per_bh = -(-sms // max(1, B * H))
    if B * H * -(-Q // qc) < sms and blocks_per_bh > 1:
        qc = max(1, min(qc, Q // blocks_per_bh))
    cells = sum((h + 2) * (w + 2) for h, w in shapes)
    return -(-Q // qc) * cells * D * itemsize


def v2_plan_text(plan) -> str:
    staging = ("TMA multicast" if plan.cluster > 1 else "TMA") if plan.tma else "threads"
    return (f"{staging}, {plan.n_bands} band(s) in {plan.buffers} buffer(s), "
            f"cluster {plan.cluster} x "
            f"{plan.clusters}, {plan.threads} threads x {plan.passes} pass(es)"
            f"{', points kept' if plan.keep else ''}")


def phase_v2(report):
    """Phase 21: the v2 kernel against the plain version on the card: phase
    3's geometries, the YOLO pyramid at B=16 (f32 in four double-buffered
    bands, bf16 in one), the encoder at B=4 (a multicast cluster of two),
    small shapes at a band budget of a row or a few (many bands, several
    CTAs per (b, h)), NaN locations;
    what TMA cannot describe (D x itemsize not a multiple of 16 bytes, a
    base off 16 bytes) staged by the threads; each plan and the bytes a
    (b, h) stages; times against kernel 1's two routes and the plain
    version; the bounds."""
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch as plain
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K1
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD_SLAB as K1S
    from poet_tpu_torch.ops.deform_attn_cuda import SMEM_OPTIN_MAX as K1_SLAB_MAX
    from poet_tpu_torch.ops.deform_attn_v2_cuda import MS_DEFORM_ATTN_V2 as V2
    from poet_tpu_torch.ops.deform_attn_v2_cuda import ms_deform_attn_v2, row_geometry

    g = torch.Generator(device=DEVICE).manual_seed(21)
    worst = 0.0
    V2.launches = 0                                  # this phase's own launches
    cases = [c + (None,) for c in V2_GEOMETRIES] + [c[:8] + (0, c[8]) for c in V2_BAND_CASES]
    by_threads, multicast = [], []
    for name, B, Q, H, D, shapes, lo, hi, _, rows in cases:
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi)
        if name == "yolo pyramid":
            yolo = (value.bfloat16(), shapes, locs, attn)
        line = f"v2-vs-plain {name}: B={B} Q={Q} H={H} D={D} levels={shapes}"
        for dt in (torch.float32, torch.bfloat16):
            v = value.to(dt)
            tag = "f32" if dt == torch.float32 else "bf16"
            budget = (rows * max(r[3] for r in row_geometry(shapes, D, v.element_size()))
                      if rows else None)
            plan = V2.plan(v, shapes, locs, budget)
            with torch.inference_mode():
                ref = plain(v.float(), shapes, locs, attn)
                out = V2(v, shapes, locs, attn, smem_budget=budget)
                torch.cuda.synchronize()
            if out.dtype != dt:
                raise AssertionError(f"v2 {name}: returned {out.dtype} for {dt}")
            err = (out.float() - ref).abs()
            tol = BF16_ATOL + BF16_RTOL * ref.abs() if dt == torch.bfloat16 else F32_ATOL
            if not bool((err <= tol).all()):
                raise AssertionError(f"v2 {name} {dt}: max |kernel - plain| "
                                     f"{err.max().item():.3e}; {v2_plan_text(plan)}")
            if dt == torch.float32:
                worst = max(worst, err.max().item())
            if plan.cluster > 1:
                multicast.append(f"{name} {tag}")
            if not plan.tma:
                by_threads.append(f"{name} {tag}")
            if plan.tma != (D * v.element_size() % 16 == 0):
                raise AssertionError(f"v2 {name} {tag}: D={D} staged by "
                                     f"{'TMA' if plan.tma else 'threads'}")
            line += f" | {tag} {v2_plan_text(plan)}, max_abs_err {err.max().item():.2e}"
        if name in V2_TIMED:
            t, staged = {}, {}
            for dt in (torch.float32, torch.bfloat16):
                v = value.to(dt)
                args = (v, shapes, locs, attn)
                plan = V2.plan(v, shapes, locs)
                tag = "bf16" if dt == torch.bfloat16 else "f32"
                with torch.inference_mode():
                    ms = {"v2": cuda_ms(lambda: V2(*args)), "kernel1": cuda_ms(lambda: K1(*args))}
                    if v.shape[1] * D * v.element_size() <= K1_SLAB_MAX:
                        ms["kernel1_slab"] = cuda_ms(lambda: K1S(*args))
                    ms["plain"] = cuda_ms(lambda: plain(*args), iters=5)
                ms["plan"] = v2_plan_text(plan)
                t[tag] = ms
                # the plans' arithmetic, not a measurement: for the log line only
                staged[tag] = (plan.staged_bytes_per_bh(),
                               v2_earlier_staged_bytes(B, H, Q, D, shapes, v.element_size()))
            line += "".join(
                f" | ms {dt}: " + ", ".join(f"{k} {x:.4f}" for k, x in ms.items()
                                            if isinstance(x, float))
                + f"; staged per (b, h) by the plan {staged[dt][0]} B (the earlier design's "
                  f"plan: {staged[dt][1]} B)" for dt, ms in t.items())
            v = value.bfloat16()
            with torch.inference_mode():
                t["bounds"] = v2_bounds(v, locs, attn, V2(v, shapes, locs, attn), shapes)
            line += (f" | bound {t['bounds'][0][0]:.4f} ({t['bounds'][0][1]}; bf16 v2 at "
                     f"{t['bounds'][0][0] / t['bf16']['v2']:.1%}); the TPU form's products on "
                     f"the bf16 tensor cores {t['bounds'][1][0]:.4f} ({t['bounds'][1][1]})")
            report[f"v2_{name}"] = t
        log(line)

    # NaN locations, held to the plain version on the card (the C1 rule: the
    # point's output row NaN)
    shapes = ((6, 9), (4, 5), (1, 1))
    value, locs, attn = deform_inputs(g, 2, 5, 2, 8, shapes)
    locs[:, 0, :, 0, 1, 0] = float("nan")
    locs[:, 1, :, 1, 2, :] = float("nan")
    locs[1, 2, 0, 2, 0, 1] = float("nan")
    with torch.inference_mode():
        n_nan = nan_agrees("v2, NaN", V2(value, shapes, locs, attn),
                           plain(value, shapes, locs, attn), F32_ATOL)
    # the YOLO pyramid's plan again after smaller ones: its 223 KB of shared
    # memory must still be granted (a later, smaller plan never lowers it)
    with torch.inference_mode():
        ref = plain(yolo[0].float(), *yolo[1:])
        err = (V2(*yolo).float() - ref).abs()
    if not bool((err <= BF16_ATOL + BF16_RTOL * ref.abs()).all()):
        raise AssertionError(f"v2 yolo pyramid again: max |kernel - plain| {err.max().item():.3e}")
    # a value whose base is off 16 bytes: TMA cannot take it, the threads stage it
    flat = torch.empty(value.numel() + 1, device=DEVICE)
    shifted = flat[1:].view(value.shape)
    shifted.copy_(value)
    if V2.plan(shifted, shapes, locs).tma:
        raise AssertionError("v2 planned TMA for a value whose base is not 16-byte aligned")
    with torch.inference_mode():
        err = (V2(shifted, shapes, locs.nan_to_num(0.5), attn)
               - plain(value, shapes, locs.nan_to_num(0.5), attn)).abs().max().item()
    if not err <= F32_ATOL:
        raise AssertionError(f"v2, a base off 16 bytes: max |kernel - plain| {err:.3e}")
    worst = max(worst, err)
    by_threads.append("a base off 16 bytes f32")
    # the entry: CUDA tensors launch the kernel; inputs that require grad raise
    n0 = V2.launches
    with torch.inference_mode():
        ms_deform_attn_v2(value, shapes, locs.nan_to_num(0.5), attn)
    if V2.launches != n0 + 1:
        raise AssertionError("ms_deform_attn_v2 on CUDA tensors did not launch its kernel")
    try:
        ms_deform_attn_v2(value.clone().requires_grad_(), shapes, locs, attn)
    except ValueError:
        pass
    else:
        raise AssertionError("ms_deform_attn_v2 took a value that requires grad")
    if not multicast:
        raise AssertionError("no v2 case ran a cluster of more than one CTA (no multicast)")
    report["v2_max_abs_err"] = worst
    report["v2_launches"] = V2.launches
    log(f"v2 kernel: f32 max |kernel - plain| {worst:.3e} over {len(cases)} geometries (tol "
        f"{F32_ATOL}; bf16 {BF16_ATOL} + 2^-8 |ref|); NaN locations: NaN at {n_nan} places "
        f"as the plain version; staged by TMA multicast over a cluster: {', '.join(multicast)}; "
        f"staged by the threads, as TMA cannot describe the value: {', '.join(by_threads)}; "
        f"the entry launches on CUDA tensors and refuses requires_grad")


# the probes at reduced sizes (the tools run them at full size)
# G = 66: 15 strips of 64 rows x 66 = 990 tasks, 7.5 waves of one CTA an SM
KPAD_M, KPAD_N, KPAD_R, KPAD_G = 960, 512, 64, 66
KPAD_G_WHOLE = 88     # 1320 tasks: 10 whole waves over the 132 SMs (G = 66: 7.5)
KPAD_RTOL = 1e-5      # the chained products vs plain: f32 sums in another order, of scale
GATHER_HOST_ITERS = 200          # back-to-back calls per host-launch time
GATHER_BREAKDOWN_CALLS = 10000   # calls per step of the gather's host breakdown


def phase_probes(report):
    """Phase 22: the three probes' kernels against their plain versions,
    at reduced sizes: the chained wgmma products (both warpgroup designs at
    R = 1 and 2 over every K of the sweep, then a timed K sweep at G = 66
    and G = 88; ptxas serialized no wgmma, the SASS holds HGMMA and
    UTMALDG), every variant of the forward kernel on its TMA-staged slab at
    the encoder shape and the YOLO pyramid (base bit-equal to kernel 1, and
    staged by cp.async too; the SASS holds UTMALDG) with C8's counts first,
    the four gather cases, an index out of range, and the launch count of a
    gather captured in a CUDA graph."""
    import torch

    from poet_tpu_torch.ops.cuda_build import KPAD_LIB, VARIANTS_LIB
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from poet_tpu_torch.tools import bench_kpad as kp
    from poet_tpu_torch.tools import bench_v3_variants as bv
    from poet_tpu_torch.tools import dyn_gather as dg
    from poet_tpu_torch.tools.timing import graph_ms

    for k in (kp.KPAD_CHAIN, bv.MS_DEFORM_ATTN_VARIANT, dg.TAKE_ALONG_AXIS):
        k.launches = 0                               # this phase's own launches
    # the designs are what ran: wgmma products ptxas did not serialize, and
    # the instructions in the machine code
    ptxas = KPAD_LIB.ptxas_log()
    if "probe_kpad_kernel" not in ptxas:
        raise AssertionError("kpad: no ptxas report for probe_kpad_kernel")
    if "serialized" in ptxas:
        raise AssertionError("kpad: ptxas serialized wgmma products: " + " | ".join(
            ln.strip() for ln in ptxas.splitlines() if "serialized" in ln))
    for lib, ops in ((KPAD_LIB, ("HGMMA", "UTMALDG")), (VARIANTS_LIB, ("UTMALDG",))):
        sass = lib.sass()
        missing = [op for op in ops if op not in sass]
        if missing:
            raise AssertionError(f"{lib.source.name}: SASS has no {missing}")
    log("kpad: ptxas reports no serialized wgmma; SASS: probe_kpad HGMMA + UTMALDG, "
        "variants UTMALDG; ptxas " + "; ".join(
            ln.strip() for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln))
    # a. kpad: both designs vs plain at R = 1, 2, then the sweeps
    sweep, sweep88, worst, worst_abs = {}, {}, 0.0, 0.0
    with tf32_off():
        for K in kp.KS:
            a, b = kp.operands(K, KPAD_M, KPAD_N, device=DEVICE)
            for R in (1, 2):
                ref = kp.kpad_chain_torch(a, b, R)
                for wg in kp.WARPGROUPS:
                    got = kp.KPAD_CHAIN(a, b, R, 2, wg)
                    torch.cuda.synchronize()
                    err_abs = (got - ref).abs().max().item()
                    err = err_abs / ref.abs().max().item()
                    if not err <= KPAD_RTOL:
                        raise AssertionError(f"kpad K={K} R={R} warpgroups={wg}: max |kernel - "
                                             f"plain| / max|plain| {err:.3e} > {KPAD_RTOL}")
                    worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
            sweep[K] = kp.bench_k(K, KPAD_M, KPAD_N, KPAD_R, KPAD_G)
            sweep88[K] = kp.bench_k(K, KPAD_M, KPAD_N, KPAD_R, KPAD_G_WHOLE)
        designs = {f"K{K}_{wg}_warpgroups_G{G}": kp.bench_k(K, KPAD_M, KPAD_N, KPAD_R, G,
                                                            warpgroups=wg)["ms"]
                   for K in (128, 27) for G in (KPAD_G, KPAD_G_WHOLE) for wg in kp.WARPGROUPS}
        a, b = kp.operands(128, KPAD_M, KPAD_N, device=DEVICE)
        plain_ms = cuda_ms(lambda: [kp.kpad_chain_torch(a, b, KPAD_R) for _ in range(KPAD_G)],
                           iters=2, warmup=1)
    for G, sw in ((KPAD_G, sweep), (KPAD_G_WHOLE, sweep88)):
        log(f"kpad: M={KPAD_M} N={KPAD_N} R={KPAD_R} G={G} ({sw[128]['waves']:.2f} waves of "
            f"tasks), the design by K (default_warpgroups), ms, TFLOP/s at the true K / K "
            f"padded to 16 and share of the bound: " + ", ".join(
                f"K={K} {r['ms']:.4f} {r['tflops']:.1f}/{r['tflops_pad16']:.1f} "
                f"{100 * r['share']:.1f}%" for K, r in sw.items()))
    log(f"kpad: kernel vs plain at R=1,2 (both designs) max rel err {worst:.2e} (tol "
        f"{KPAD_RTOL}); ms by design: " + ", ".join(
            f"{k} {x:.4f}" for k, x in designs.items())
        + f"; torch.matmul of one product "
        f"{sweep[128]['matmul_ms']:.4f}; plain at K=128 {plain_ms:.3f} ms")
    # the K=128 chain: its products on the bf16 tensor cores against its bytes
    t_ops = sweep[128]["bound_ms"]
    t_bytes = (nbytes(a, b) + KPAD_M * KPAD_N * 4) / HBM_BYTES_PER_S * 1e3
    report["kpad"] = {"sweep": sweep, "sweep_whole_waves": sweep88, "designs_ms": designs,
                      "plain_ms": plain_ms, "max_rel_err": worst, "max_abs_err": worst_abs,
                      "bound": (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")}

    # b. the variants at the encoder shape and the YOLO pyramid, bf16, on the
    # TMA-staged slab, the first points of each level next to the cell edges
    # where one rounding and two part; first C8's counts: those points, and
    # the points where noy's kernel left its plain definition
    g = torch.Generator(device=DEVICE).manual_seed(22)
    yolo = next(geo for geo in ROUTE_GEOMETRIES if geo[0] == "yolo pyramid")
    for name, B, Q, H, D, shapes, lo, hi, _ in (GEOMETRIES[0], yolo):
        value, locs, attn = deform_inputs(g, B, Q, H, D, shapes, lo=lo, hi=hi)
        locs = bv.with_edge_points(locs, shapes)     # points where the two roundings part
        v16 = value.bfloat16()
        args = (v16, shapes, locs, attn)
        floors = bv.floor_counts(v16, shapes, locs)
        log(f"C8 at the {name} (B={B} Q={Q} H={H} L=P=4): points whose floor of "
            f"loc * size - 0.5 one rounding and two part: {floors['one_rounding']}; points "
            f"where noy's kernel left its plain definition: {floors['kernel']}")
        if floors["kernel"]:
            raise AssertionError(f"C8: noy's kernel floored {floors['kernel']} points at the "
                                 f"{name} otherwise than its plain definition")
        var = bv.time_variants(*args)    # base by cp.async too: bit-equal to kernel 1 or raises
        var["floor_counts"] = floors
        with torch.inference_mode():
            for vname in bv.VARIANTS:
                out = var[vname].pop("out")
                # on the bf16 values in f32: the plain result unrounded (bf16y's
                # plain definition sums in bf16 itself), as phase 3 holds kernel 1
                ref = bv.plain_variant(v16.float(), shapes, locs, attn, vname)
                err = (out.float() - ref).abs()
                if vname == "bf16y":   # each step rounds to bf16; the plain one through f32
                    tol = 2.0 ** -7 * ref.abs().max().item()
                else:
                    tol = BF16_ATOL + BF16_RTOL * ref.abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"variant {vname} at the {name}: max |kernel - plain| "
                                         f"{err.max().item():.3e}")
                if vname == "base" and not var[vname]["bit_equal_kernel1"]:
                    raise AssertionError(f"variant base is not bit-equal to kernel 1 at the {name}")
                var[vname]["max_abs_err"] = err.max().item()
                del out, ref, err
            var["plain_ms"] = cuda_ms(lambda: ms_deform_attn_torch(*args), iters=5)
            plain_out = ms_deform_attn_torch(*args)
        var["bound"] = deform_bound(locs, shapes, D, locs, attn, plain_out, value=v16)
        slab = bv.plan_slab(v16.shape[1], D)
        log(f"variants at the {name} (B={B} Q={Q} H={H} D={D} L=P=4, bf16; a (b, h)'s slab "
            f"{slab['slab_bytes']} B in {slab['n_boxes']} TMA boxes of {slab['box_tokens']} "
            f"tokens), ms: " + ", ".join(f"{k} {x['ms']:.4f} (err {x['max_abs_err']:.1e}"
                                         f"{', = kernel 1' if x['bit_equal_kernel1'] else ''})"
                                         for k, x in var.items()
                                         if isinstance(x, dict) and "ms" in x)
            + f"; base staged by cp.async {var['base_cp_async_ms']:.4f} (= kernel 1); staging "
            f"alone (one query a (b, h)) TMA {var['staging_tma_ms']:.4f}, cp.async "
            f"{var['staging_cp_async_ms']:.4f}; kernel 1 "
            f"direct {var['kernel1_ms']:.4f}, slab {var['kernel1_slab_ms']:.4f}; plain "
            f"{var['plain_ms']:.4f}; bound {var['bound'][0]:.4f} ({var['bound'][1]})")
        report["variants" if name == "encoder" else "variants_yolo"] = var
        del value, locs, attn, v16, args, plain_out

    # c. the dynamic gather: the script's four cases, exact; out of range raises
    gat = {}
    for cname, T, R, dt in dg.CASES:
        table, idx = dg.case_inputs(T, R, dt, device=DEVICE)
        got, ref = dg.TAKE_ALONG_AXIS(table, idx), dg.take_along_axis_torch(table, idx)
        if not torch.equal(got, ref):
            raise AssertionError(f"gather {cname}: kernel != plain")
        distinct = torch.unique(idx.long() * table.shape[1]
                                + torch.arange(table.shape[1], device=DEVICE)).numel()
        # device time (replayed from a CUDA graph, the replays' launches
        # counted) and time per call launched from the host, which at these
        # sizes is the launch's
        gat[cname] = dg.time_case(table, idx, iters=GATHER_HOST_ITERS) | {
            "bound": bound(nbytes(idx, got) + distinct * table.element_size(), 0.0)}
    table, idx = dg.case_inputs(512, 64, torch.float32, device=DEVICE)
    idx[3, 7] = 512
    try:
        dg.take_along_axis(table, idx)
    except IndexError:
        pass
    else:
        raise AssertionError("take_along_axis took an index out of range")
    # a call captured into a CUDA graph launches nothing; the replays launch
    idx[3, 7] = 0
    n0 = dg.TAKE_ALONG_AXIS.launches
    graph_ms(lambda: dg.TAKE_ALONG_AXIS(table, idx, False), iters=3, replays=2,
             counted=dg.TAKE_ALONG_AXIS)
    if dg.TAKE_ALONG_AXIS.launches - n0 != 1 + 3 * (2 + 1):
        raise AssertionError(f"gather: {dg.TAKE_ALONG_AXIS.launches - n0} launches counted "
                             f"over a warm-up call and 3 replays of 3 calls, not 10")
    table, idx = dg.case_inputs(4800, 4800, torch.float32, device=DEVICE)
    breakdown = dg.host_breakdown(table, idx, calls=GATHER_BREAKDOWN_CALLS)
    report["gather_host_breakdown"] = breakdown
    log("gather host us per call, each step alone over "
        f"{GATHER_BREAKDOWN_CALLS} calls (the 4800-row case, no range check): "
        + ", ".join(f"{k} {x:.3f}" for k, x in breakdown.items()))
    log("gather: kernel == plain on " + ", ".join(
        f"{k} (device ms kernel {x['ms']:.4f}, plain {x['plain_ms']:.4f}, torch.gather "
        f"{x['library_ms']:.4f}, bound {x['bound'][0]:.4f}; per host launch "
        f"{x['host_ms']:.4f}, {x['plain_host_ms']:.4f}, {x['library_host_ms']:.4f})"
        for k, x in gat.items()) + "; an index out of range raises")
    report["gather"] = gat
    report["probe_launches"] = {"kpad": kp.KPAD_CHAIN.launches,
                                "variants": bv.MS_DEFORM_ATTN_VARIANT.launches,
                                "gather": dg.TAKE_ALONG_AXIS.launches}


# ---------------------------------------------------------------- phase 23
def encode_png(pixels: np.ndarray, depth: int = 8, color: int = None, chunk: int = 0,
               palette=None, trns: bytes = None) -> bytes:
    """A PNG file of `pixels` ((H, W) gray or palette indices, (H, W, 2)
    gray + alpha, (H, W, 3) RGB, (H, W, 4) RGBA; uint8, or uint16 at
    depth 16), row r filtered with filter type r % 5 (None, Sub, Up,
    Average, Paeth: every filter on every fifth row), its IDAT data split
    into chunks of `chunk` bytes (0: one chunk). The card's machine has no
    PIL: phase 23 writes its dataset with this."""
    import struct
    import zlib

    a = np.asarray(pixels)
    if color is None:
        color = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(a.shape[-1], 0)}[a.ndim]
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, w = a.shape[:2]
    if depth == 16:
        rows = a.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth < 8:     # pack the samples, most significant first
        per = 8 // depth
        v = np.zeros((h, -(-w // per) * per), np.uint8)
        v[:, :w] = a.reshape(h, w)
        v = v.reshape(h, -1, per) << (depth * np.arange(per - 1, -1, -1)).astype(np.uint8)
        rows = np.bitwise_or.reduce(v, axis=-1).astype(np.uint8)
    else:
        rows = a.reshape(h, -1).astype(np.uint8)
    bpp = max(1, samples * depth // 8)
    cur = rows.astype(np.int32)
    prev = np.vstack([np.zeros((1, cur.shape[1]), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), prev[:, :-bpp]])
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    preds = (np.zeros_like(cur), left, prev, (left + prev) >> 1, paeth)
    raw = bytearray()
    for r in range(h):
        f = r % 5
        raw.append(f)
        raw += ((cur[r] - preds[f][r]) & 0xFF).astype(np.uint8).tobytes()
    data = zlib.compress(bytes(raw), 6)

    def chunk_of(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [b"\x89PNG\r\n\x1a\n",
           chunk_of(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))]
    if palette is not None:
        out.append(chunk_of(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk_of(b"tRNS", trns))
    step = chunk or len(data)
    out += [chunk_of(b"IDAT", data[i:i + step]) for i in range(0, len(data), step)]
    out.append(chunk_of(b"IEND", b""))
    return b"".join(out)


CLI_TRAIN_IMAGES, CLI_TEST_IMAGES = 48, 16     # 3 train steps of 16 an epoch, 1 eval batch
CLI_SEED = 23
CLI_PAPER = ["--enc_layers", "5", "--dec_layers", "5", "--nheads", "16", "--hidden_dim", "256",
             "--num_queries", "10", "--dtype", "bfloat16", "--batch_size", "16",
             "--eval_batch_size", "16", "--num_workers", "4", "--seed", "0"]


def cli_image(rng, H: int, W: int) -> np.ndarray:
    """(H, W, 3) uint8: a seeded smooth field (a coarse random grid
    interpolated bilinearly) plus noise, so inflate has real work."""
    coarse = rng.uniform(40.0, 215.0, (H // 32 + 2, W // 32 + 2, 3))
    ys, xs = np.linspace(0, coarse.shape[0] - 1, H), np.linspace(0, coarse.shape[1] - 1, W)
    y0, x0 = np.floor(ys).astype(int).clip(0, coarse.shape[0] - 2), \
        np.floor(xs).astype(int).clip(0, coarse.shape[1] - 2)
    ty, tx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - tx) + coarse[y0][:, x0 + 1] * tx
    bottom = coarse[y0 + 1][:, x0] * (1 - tx) + coarse[y0 + 1][:, x0 + 1] * tx
    field = top * (1 - ty) + bottom * ty + rng.normal(0.0, 6.0, (H, W, 3))
    return np.clip(field, 0, 255).astype(np.uint8)


def write_cli_dataset(root: str):
    """A PoET-format dataset under `root`: CLI_TRAIN_IMAGES train and
    CLI_TEST_IMAGES test 480x640 PNGs (encode_png: all five filters, IDAT
    in 64 KiB chunks), 1-5 objects an image with boxes, YCB-V classes,
    poses and intrinsics, the YCB-V classes.json and symmetries.json of
    dataset_files/, and a models_eval PLY cloud per class drawn as
    `flagship.EvalFixture` draws them. Returns ({relative path: pixels},
    {class id: test objects})."""
    import shutil

    from poet_tpu_torch.flagship import EVAL_POINTS, eval_model_clouds

    rng = np.random.default_rng(CLI_SEED)
    H, W = FLAGSHIP_HW
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "models_eval"), exist_ok=True)
    for kind in ("classes", "symmetries"):
        shutil.copy(os.path.join(ROOT, "dataset_files", f"ycbv_{kind}.json"),
                    os.path.join(root, "annotations", f"{kind}.json"))
    with open(os.path.join(root, "annotations", "classes.json")) as f:
        classes = json.load(f)
    models, info = eval_model_clouds(list(classes.values()), EVAL_POINTS, CLI_SEED)
    for cid, name in classes.items():
        pts = (models[name]["pts"] * 1000.0).astype("<f4")        # mm, as BOP ships them
        with open(os.path.join(root, "models_eval", f"obj_{int(cid):06d}.ply"), "wb") as f:
            f.write(b"ply\nformat binary_little_endian 1.0\n"
                    + f"element vertex {len(pts)}\n".encode()
                    + b"property float x\nproperty float y\nproperty float z\nend_header\n")
            f.write(pts.tobytes())
    with open(os.path.join(root, "models_eval", "models_info.json"), "w") as f:
        json.dump({cid: info[name] for cid, name in classes.items()}, f)

    K = [1066.778, 0.0, 312.9869, 0.0, 1067.487, 241.3109, 0.0, 0.0, 1.0]
    pixels, test_objects = {}, {}
    for split, n, folder in (("train", CLI_TRAIN_IMAGES, "train"),
                             ("test", CLI_TEST_IMAGES, "test_all")):
        os.makedirs(os.path.join(root, folder, "000001", "rgb"), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            name = f"000001/rgb/{i:06d}.png"
            arr = cli_image(rng, H, W)
            with open(os.path.join(root, folder, name), "wb") as f:
                f.write(encode_png(arr, chunk=1 << 16))
            pixels[f"{folder}/{name}"] = arr
            images.append({"id": i, "file_name": name, "width": W, "height": H,
                           "intrinsics": K, "type": "real"})
            for _ in range(int(rng.integers(1, 6))):
                w, h = W * rng.uniform(1 / 16, 5 / 16), H * rng.uniform(1 / 12, 5 / 12)
                x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
                q, r = np.linalg.qr(rng.normal(size=(3, 3)))
                q *= np.sign(np.diag(r))
                q[:, 0] *= np.linalg.det(q)
                cid = int(rng.integers(1, len(classes) + 1))
                anns.append({"id": len(anns), "image_id": i, "bbox": [x, y, w, h],
                             "area": w * h, "iscrowd": 0, "category_id": cid,
                             "relative_pose": {
                                 "position": [float(rng.normal(0, 0.15)),
                                              float(rng.normal(0, 0.15)),
                                              float(rng.uniform(0.6, 1.4))],
                                 "rotation": q.reshape(-1).tolist()}})
                if split == "test":
                    test_objects[cid] = test_objects.get(cid, 0) + 1
        cats = [{"supercategory": "background", "id": 0, "name": "background"}] + [
            {"supercategory": v, "id": int(k), "name": v} for k, v in classes.items()]
        with open(os.path.join(root, "annotations", f"{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return pixels, test_objects


class Tee:
    """stdout into the terminal and a buffer (the NaN gate's message)."""

    def __init__(self, stream):
        import io

        self.stream, self.buffer = stream, io.StringIO()

    def write(self, text):
        self.buffer.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


class CliProbe:
    """Host clocks around the CLI's train loop: the wait for each batch from
    the loader, and the interval between the starts of successive train
    steps (the loop's period: enqueue, the one-step-deep metrics read,
    logging), patched into `engine.train.make_train_step` and
    `PoseDataLoader.epoch`, which `cli.main` looks up at each call."""

    def __init__(self):
        self.waits, self.starts = [], []

    def __enter__(self):
        from poet_tpu_torch.data import loader as loader_mod
        from poet_tpu_torch.engine import train as train_mod

        self.saved = (train_mod.make_train_step, loader_mod.PoseDataLoader.epoch)
        make_step, epoch = self.saved
        probe = self

        def timed_make_train_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def timed(*a, **k):
                probe.starts.append(time.perf_counter())
                return step(*a, **k)
            return timed

        def timed_epoch(loader, n):
            it = epoch(loader, n)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if loader.shuffle:                    # the train loader
                    probe.waits.append(time.perf_counter() - t0)
                yield batch

        train_mod.make_train_step = timed_make_train_step
        loader_mod.PoseDataLoader.epoch = timed_epoch
        return self

    def __exit__(self, *exc):
        from poet_tpu_torch.data import loader as loader_mod
        from poet_tpu_torch.engine import train as train_mod

        train_mod.make_train_step, loader_mod.PoseDataLoader.epoch = self.saved


def phase_cli(report):
    """Phase 23: the CLI path, `cli.run` in process with JAX's flag names, at
    the paper config on PNG files (see the module docstring), in a temporary
    directory removed afterwards."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="poet_cli_") as tmp:
        _phase_cli(report, tmp)


def _phase_cli(report, tmp):
    import contextlib
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from poet_tpu_torch import cli
    from poet_tpu_torch.engine.checkpoint import load_checkpoint
    from poet_tpu_torch.evaluation.pose_evaluator import POSE_CHUNK
    from poet_tpu_torch.flagship import detector_state_dict
    from poet_tpu_torch import native
    from poet_tpu_torch.native import decode_image

    kernels = all_kernels()

    def zero():
        for k in kernels:
            k.launches = 0

    def counts():
        return [k.launches for k in kernels]

    def add(*dicts):
        out = {}
        for d in dicts:
            for k, v in d.items():
                out[k] = out.get(k, 0) + v
        return out

    t_phase = time.perf_counter()
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    pixels, test_objects = write_cli_dataset(data)
    t_write = time.perf_counter() - t0
    H, W = FLAGSHIP_HW
    blobs = {}
    for rel in pixels:
        with open(os.path.join(data, rel), "rb") as f:
            blobs[rel] = f.read()
    t0 = time.perf_counter()
    if not native.probe():
        raise AssertionError("cli: the native image library does not build (g++)")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = {rel: decode_image(b) for rel, b in blobs.items()}
    one = len(blobs) / (time.perf_counter() - t0)
    for rel, arr in decoded.items():
        if not np.array_equal(arr, pixels[rel]):
            raise AssertionError(f"cli: {rel} decodes to other pixels than were written")
    with ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode_image, blobs.values()))
        four = len(blobs) / (time.perf_counter() - t0)
    mb = sum(len(b) for b in blobs.values()) / len(blobs) / 2 ** 20
    log(f"cli dataset: {CLI_TRAIN_IMAGES} train + {CLI_TEST_IMAGES} test {H}x{W} PNGs "
        f"({mb:.2f} MiB each) written in {t_write:.1f} s; the native library built in "
        f"{t_build:.2f} s; every one decodes to the written pixels byte for byte; decode "
        f"{one:.1f} images/s on one thread, {four:.1f} on 4")

    cfg = cli.parse_config(["--dataset_path", data] + CLI_PAPER)
    S, steps = FLAGSHIP_S, CLI_TRAIN_IMAGES // 16
    eval_fwd = path_launches(cfg, S, CLI_TEST_IMAGES // 16)
    n_adi = sum(-(-n // POSE_CHUNK) for n in test_objects.values())
    base = ["--dataset_path", data, "--output_dir", out] + CLI_PAPER
    train_args = base + ["--rgb_augmentation", "--grayscale"]

    # train one epoch, then resume for a second: the loop, checkpoints, log.txt
    by_path = {}
    zero()
    with CliProbe() as probe:
        t0 = time.perf_counter()
        cli.run(train_args + ["--epochs", "1"])
        t_train1 = time.perf_counter() - t0
        first = os.path.join(tmp, "checkpoint_epoch0.pth")
        with open(os.path.join(out, "checkpoint.pth"), "rb") as f, open(first, "wb") as g:
            g.write(f.read())
        t0 = time.perf_counter()
        cli.run(train_args + ["--epochs", "2", "--resume", os.path.join(out, "checkpoint.pth")])
        t_train2 = time.perf_counter() - t0
    got = counts()
    # per run: its steps, the epoch-0 eval (run 1) and the final eval, each one
    # batch of forwards and one ADD-S pass
    want = add(path_launches(cfg, S, 2 * steps, train=True),
               *[eval_fwd] * 3, {"nn": 3 * n_adi})
    if got != expected(**want):
        raise AssertionError(f"cli train: launches {LAUNCH_NAMES} {got}, expected "
                             f"{expected(**want)}")
    by_path["cli_train"] = got
    with open(os.path.join(out, "log.txt")) as f:
        lines = [json.loads(ln) for ln in f]
    if [ln["epoch"] for ln in lines] != [0, 1]:
        raise AssertionError(f"cli: log.txt epochs {[ln['epoch'] for ln in lines]}, not [0, 1]")
    for ln in lines:
        if not all(math.isfinite(v) for k, v in ln.items() if k.startswith("train_")):
            raise AssertionError(f"cli: a non-finite train metric in log.txt: {ln}")
    if len(probe.starts) != 2 * steps or len(probe.waits) != 2 * steps:
        raise AssertionError(f"cli: {len(probe.starts)} train steps and {len(probe.waits)} "
                             f"loader waits, not {2 * steps}")
    periods = np.diff(probe.starts[:steps]).tolist() + np.diff(probe.starts[steps:]).tolist()
    i_fwd, i_fwd_direct = (KERNEL_KEYS.index(k) for k in ("fwd_slab", "fwd"))
    eval_fwd_total = 3 * (eval_fwd.get("fwd_slab", 0) + eval_fwd.get("fwd", 0))
    fwd_per_step = (got[i_fwd] + got[i_fwd_direct] - eval_fwd_total) / (2 * steps)
    merged_per_step = sum(got[KERNEL_KEYS.index(k)] for k in MERGED_KEYS.values()) / (2 * steps)

    # the resumed state equals the saved one, bit for bit: a resume with no
    # epoch left to run returns what it restored
    resumed = cli.run(base + ["--epochs", "1", "--resume", first])
    saved, _ = load_checkpoint(first)
    for name, t in resumed["model"].state_dict().items():
        if not torch.equal(t.detach().cpu(), saved["model"][name]):
            raise AssertionError(f"cli: resumed parameter {name} differs from the saved one")
    opt, opt_saved = resumed["optimizer"].state_dict(), saved["optimizer"]
    if (opt["updates"], opt["micro_step"]) != (opt_saved["updates"], opt_saved["micro_step"]):
        raise AssertionError("cli: the resumed optimizer's counts differ from the saved ones")
    for i, st in opt["torch"]["state"].items():
        for k, v in st.items():
            if not torch.equal(v.cpu(), opt_saved["torch"]["state"][i][k].cpu()):
                raise AssertionError(f"cli: resumed AdamW state {i}.{k} differs from the saved")

    # eval and the BOP export from the trained checkpoint
    ckpt = os.path.join(out, "checkpoint.pth")
    zero()
    t0 = time.perf_counter()
    results = cli.run(base + ["--eval", "--resume", ckpt])
    t_eval = time.perf_counter() - t0
    got = counts()
    if got != expected(**add(eval_fwd, {"nn": n_adi})):
        raise AssertionError(f"cli --eval: launches {LAUNCH_NAMES} {got}")
    by_path["cli_eval"] = got
    for stem in METRIC_FILES:
        if not os.path.isfile(os.path.join(out, "eval_test_gt", stem + ".json")):
            raise AssertionError(f"cli --eval wrote no {stem}.json")
    if not all(math.isfinite(v) for v in results["accuracy"].values()):
        raise AssertionError(f"cli --eval: non-finite ADD(-S) {results['accuracy']}")
    zero()
    t0 = time.perf_counter()
    csv_path = cli.run(base + ["--eval_bop", "--resume", ckpt])
    t_bop = time.perf_counter() - t0
    got = counts()
    if got != expected(**eval_fwd):
        raise AssertionError(f"cli --eval_bop: launches {LAUNCH_NAMES} {got}")
    by_path["cli_eval"] = [a + b for a, b in zip(by_path["cli_eval"], got)]
    with open(csv_path) as f:
        csv_rows = f.read().splitlines()
    if csv_rows[0] != "scene_id,im_id,obj_id,score,R,t,time" or \
            len(csv_rows) - 1 != sum(test_objects.values()):
        raise AssertionError(f"cli --eval_bop: {len(csv_rows) - 1} CSV rows for "
                             f"{sum(test_objects.values())} objects")

    # inference on the test PNGs with the Mask R-CNN detector's weights
    det = os.path.join(tmp, "detector.pth")
    torch.save({k: torch.from_numpy(v) for k, v in detector_state_dict(22).items()}, det)
    inf_out = os.path.join(tmp, "inference")
    zero()
    t0 = time.perf_counter()
    res = cli.run(base + ["--inference", "--inference_path",
                          os.path.join(data, "test_all", "000001", "rgb"),
                          "--inference_output", inf_out, "--backbone_weights", det])
    t_inf = time.perf_counter() - t0
    got = counts()
    icfg = cli.parse_config(["--dataset_path", data, "--inference"] + CLI_PAPER)
    want = add(path_launches(icfg, S, CLI_TEST_IMAGES), roi_launches(icfg, CLI_TEST_IMAGES))
    if got != expected(**want):
        raise AssertionError(f"cli --inference: launches {LAUNCH_NAMES} {got}, expected "
                             f"{expected(**want)}")
    by_path["cli_inference"] = got
    with open(os.path.join(inf_out, "results.json")) as f:
        rows = json.load(f)
    if len(rows) != CLI_TEST_IMAGES:
        raise AssertionError(f"cli --inference: results.json has {len(rows)} rows")
    n_det = sum(len(r) for r in rows.values())
    for r in rows.values():
        for d in r.values():
            if not all(math.isfinite(x) for x in d["t"] + sum(d["rot"], []) + d["box"]):
                raise AssertionError("cli --inference: a non-finite pose or box")

    # the NaN gate: a sampling-offsets bias with a NaN (C1, end to end)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    payload["model"]["transformer.encoder.layers.0.self_attn.sampling_offsets.bias"][0] = \
        float("nan")
    bad = os.path.join(tmp, "nan.pth")
    torch.save(payload, bad)
    with open(ckpt, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    tee = Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            cli.run(base + ["--epochs", "3", "--resume", bad])
    except SystemExit as e:
        code = e.code
    else:
        raise AssertionError("cli: training from a NaN sampling offset did not stop")
    with open(ckpt, "rb") as f:
        after = hashlib.sha256(f.read()).hexdigest()
    if code != 1 or "Loss is nan, stopping training" not in tee.buffer.getvalue():
        raise AssertionError(f"cli: the NaN gate exited with {code!r} and not JAX's message")
    if after != before:
        raise AssertionError("cli: the NaN gate let the rolling checkpoint be overwritten")

    t = {"native_build_s": t_build, "decode_images_per_s": one, "decode_images_per_s_4_threads": four,
         "png_mib": mb, "step_ms_p50": float(np.median(periods)) * 1e3,
         "step_ms": [x * 1e3 for x in periods],
         "loader_wait_ms_per_step": float(np.mean(probe.waits)) * 1e3,
         "loader_wait_ms": [x * 1e3 for x in probe.waits],
         # each epoch's first batch waits for the whole pipeline; the others
         # for what the prefetch has not hidden (3 steps an epoch here)
         "loader_wait_ms_first": float(np.mean(probe.waits[::steps])) * 1e3,
         "loader_wait_ms_others": float(np.mean([w for i, w in enumerate(probe.waits)
                                                 if i % steps])) * 1e3,
         "fwd_per_step": fwd_per_step, "merged_per_step": merged_per_step,
         "train_s": [t_train1, t_train2], "eval_s": t_eval, "bop_s": t_bop,
         "inference_s": t_inf, "inference_ms_per_image": t_inf / CLI_TEST_IMAGES * 1e3,
         "detections": n_det, "min_dist_launches": n_adi}
    report["cli"] = t
    report["cli_launches"] = by_path
    log(f"cli: train (paper config, bf16, B=16, --rgb_augmentation --grayscale) 1 epoch "
        f"{t_train1:.1f} s + resumed epoch {t_train2:.1f} s, finite losses, log.txt epochs 0, 1; "
        f"step p50 {t['step_ms_p50']:.1f} ms (host clock, steps {', '.join(f'{x:.1f}' for x in t['step_ms'])}), "
        f"loader wait {t['loader_wait_ms_per_step']:.2f} ms per step (an epoch's first step "
        f"{t['loader_wait_ms_first']:.2f}, the others {t['loader_wait_ms_others']:.2f}); "
        f"{fwd_per_step:g} forward + {merged_per_step:g} merged-adjoint launches per step; "
        f"the resumed parameters and AdamW state equal the saved ones bit for bit | --eval "
        f"{t_eval:.1f} s, --eval_bop {t_bop:.1f} s ({len(csv_rows) - 1} rows), {n_adi} min-distance "
        f"launches | --inference {t_inf:.1f} s, {t['inference_ms_per_image']:.1f} ms per image "
        f"(whole call / {CLI_TEST_IMAGES}), {n_det} detections | NaN gate: exit 1, "
        f"\"Loss is nan, stopping training\", rolling checkpoint untouched | launches "
        f"{LAUNCH_NAMES}: " + "; ".join(f"{k} {v}" for k, v in by_path.items())
        + f" | phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phases 24, 25
PATH_B = 16
VARIANT_TRAIN_STEPS = 5
CALIBRATE_STEPS = 3
DETECTION_TRAIN_STEPS = 3


def profiled_busy_ms(fn, steps: int):
    """(device busy ms, {kernel class: ms}) per call of `fn` over `steps`
    calls traced by torch.profiler: the union of kernel and copy intervals
    of the exported Chrome trace, and each class's own sum
    (`tools/profile_train.py:device_time_by_class`)."""
    import tempfile

    import torch

    from poet_tpu_torch.tools.profile_train import device_time_by_class

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="poet_trace_") as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    busy, by_class = device_time_by_class(events, steps)
    if busy <= 0.0:
        raise AssertionError("the profiler saw no device time")
    return busy, by_class


def drive_train(label, cfg, model, batch, steps, expect, frozen=None, moved=()):
    """`steps` train steps of `model` (on the card) on `batch` (host arrays)
    after one warm-up step: every count 0 before, the launches after held to
    `expect` (per step); then one traced step for the device busy ms (its
    launches counted in too). `frozen`: {name: tensor} that must not change;
    `moved`: names that must. Returns (stats, launches, metrics history)."""
    import torch

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )

    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    step = make_train_step(model, cfg, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    before = {k: v.clone() for k, v in model.state_dict().items() if k in moved}
    fetch_metrics(step(*prepare_batch(cfg, *batch, DEVICE), gen))      # warm-up
    torch.cuda.synchronize()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    times, history = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        history.append(fetch_metrics(step(*prepare_batch(cfg, *batch, DEVICE), gen)))
        times.append(time.perf_counter() - t0)
    busy, by_class = profiled_busy_ms(lambda: history.append(fetch_metrics(
        step(*prepare_batch(cfg, *batch, DEVICE), gen))), 1)
    launches = [k.launches for k in kernels]
    want = expected(**{k: v * (steps + 1) for k, v in expect.items()})
    if launches != want:
        raise AssertionError(f"{label}: launches {LAUNCH_NAMES} {launches} for {steps + 1} "
                             f"steps, expected {expect} per step and no other")
    if not all(np.isfinite(list(m.values())).all() for m in history):
        raise AssertionError(f"{label}: non-finite training metrics: {history}")
    state = model.state_dict()
    changed = [k for k, v in (frozen or {}).items() if not torch.equal(state[k], v)]
    if changed:
        raise AssertionError(f"{label}: frozen tensors changed: {changed[:5]}")
    still = [k for k, v in before.items() if torch.equal(state[k], v)]
    if still:
        raise AssertionError(f"{label}: trained tensors did not move: {still}")
    ms = np.asarray(times) * 1e3
    stats = {"p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
             "busy_ms": busy, "img_s": float(batch[0].shape[0] / ms.mean() * 1e3),
             "device_ms_by_class": by_class}
    return stats, launches, history, opt


def top_classes(stats, n=6) -> str:
    """The traced step's n largest kernel classes, device ms."""
    top = sorted(stats["device_ms_by_class"].items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.3f}" for k, v in top)


def phase_variants(report):
    """Phase 24: the model's options at the paper config: gt serving with
    the aleatoric heads and the three learned embeddings, train steps with
    them and the bf16 AdamW moment, calibrate steps, and an f32 step of the
    learned embeddings on the card against the CPU port."""
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = PATH_B, FLAGSHIP_HW
    cfg = set_options(flagship_config("bfloat16"), MODEL_OPTIONS)
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    boxes = (targets["boxes"], targets["labels"], targets["n_boxes"])

    # ---- gt serving with the options
    server = PoseServer(cfg, init_weights(build_model(cfg), seed=0), batch_size=B,
                        image_size=(H, W), device=DEVICE)
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.fetch(server.infer_async(images, *boxes))
    server.reset_latency_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    results = [server.infer(images, *boxes) for _ in range(REQUESTS)]
    counts = [k.launches for k in kernels]
    if counts != expected(**path_launches(cfg, FLAGSHIP_S, REQUESTS)):
        raise AssertionError(f"variants serve: launches {LAUNCH_NAMES} {counts}, expected "
                             f"{path_launches(cfg, FLAGSHIP_S, 1)} per request")
    for res in results:
        for k in ("translation", "rotation", "translation_var", "rotation_var"):
            if not np.isfinite(res[k]).all():
                raise AssertionError(f"variants serve: non-finite {k}")
        for k in ("translation_var", "rotation_var"):
            if res[k].shape != (B, cfg.model.num_queries, 3) or not (res[k] > 0).all():
                raise AssertionError(f"variants serve: {k} {res[k].shape}, min {res[k].min()}")
        rotations_ok(res["rotation"])
    serve = server.latency_stats()
    var_range = [float(min(r[k].min() for r in results)) for k in ("translation_var",
                                                                   "rotation_var")]
    del server
    log(f"variants serve: PoseServer paper config bf16 B={B} {H}x{W} with {MODEL_OPTIONS}: "
        f"{REQUESTS} requests, launches {LAUNCH_NAMES} {counts}; finite, SO(3), variances "
        f"(B, Q, 3) > 0 (least translation {var_range[0]:.3e}, rotation {var_range[1]:.3e}); "
        f"p50 {serve['p50_ms']:.3f} ms, p95 {serve['p95_ms']:.3f} ms, {serve['fps']:.2f} img/s")

    # ---- train steps: the default config (this call's baseline), the
    # options, the options with the bf16 first moment
    learned = ("query_embed.weight", "transformer.reference_points.weight",
               "position_embedding.row_embed.weight", "translation_head_aleatoric.4.layers.2.bias")
    train = {}
    for name, options, mu_bf16 in (("default", {}, False), ("options", MODEL_OPTIONS, False),
                                   ("options_mu_bf16", MODEL_OPTIONS, True)):
        tcfg = set_options(flagship_config("bfloat16"), options)
        tcfg.optim.mu_bf16 = mu_bf16
        model = init_weights(build_model(tcfg), seed=0).to(DEVICE)
        frozen = {k: v.clone() for k, v in model.state_dict().items()
                  if k.startswith("backbone.")}
        per_step = path_launches(tcfg, FLAGSHIP_S, 1, train=True)
        stats, train_counts, history, opt = drive_train(
            f"variants train {name}", tcfg, model, (images, pad_mask, targets),
            VARIANT_TRAIN_STEPS, per_step, frozen=frozen, moved=learned if options else ())
        mu = {st["exp_avg"].dtype for st in opt.torch_opt.state.values()}
        if mu != {torch.bfloat16 if mu_bf16 else torch.float32}:
            raise AssertionError(f"variants train {name}: first moments {mu}")
        log(f"variants train {name}: paper config bf16 B={B} {H}x{W}, "
            f"{options or 'no options'}, AdamW first moment {mu.pop()} on the card: "
            f"{VARIANT_TRAIN_STEPS} + 1 traced steps, launches {LAUNCH_NAMES} {train_counts} "
            f"({per_step} per step), loss {history[0]['loss']:.4f} -> "
            f"{history[-1]['loss']:.4f}, backbone bit-identical"
            f"{', ' + ', '.join(learned) + ' moved' if options else ''}; step p50 "
            f"{stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, device busy "
            f"{stats['busy_ms']:.3f} ms a step ({top_classes(stats)}), "
            f"{stats['img_s']:.2f} img/s")
        train[name] = stats
        del model, opt
    log(f"variants train: device busy ms a step, options - default "
        f"{train['options']['busy_ms'] - train['default']['busy_ms']:.3f}, mu_bf16 - AdamW "
        f"{train['options_mu_bf16']['busy_ms'] - train['options']['busy_ms']:.3f} (one call)")

    # ---- calibrate: only the aleatoric heads train; the norm takes every gradient
    ccfg = set_options(flagship_config("bfloat16"), MODEL_OPTIONS)
    ccfg.model.calibrate = True
    model = init_weights(build_model(ccfg), seed=0).to(DEVICE)
    frozen = {k: v.clone() for k, v in model.state_dict().items() if "_head_aleatoric." not in k}
    heads = tuple(k for k in model.state_dict() if "_head_aleatoric." in k
                  and k.endswith(".weight"))
    calib, calib_counts, history, opt = drive_train(
        "calibrate", ccfg, model, (images, pad_mask, targets), CALIBRATE_STEPS, per_step,
        frozen=frozen, moved=heads)
    log(f"calibrate: paper config bf16 B={B} {H}x{W}, {MODEL_OPTIONS}: {CALIBRATE_STEPS} + 1 "
        f"traced steps, launches {LAUNCH_NAMES} {calib_counts} (the backward through the "
        f"frozen transformer: {per_step} per step), {len(frozen)} frozen tensors bit-identical "
        f"on the card, {len(heads)} aleatoric head weights moved, {len(opt.params)} of "
        f"{len(opt.clip_params)} gradients trained; grad_norm {history[-1]['grad_norm']:.4f}; "
        f"step p50 {calib['p50_ms']:.3f} ms, p95 {calib['p95_ms']:.3f} ms, device busy "
        f"{calib['busy_ms']:.3f} ms a step ({top_classes(calib)})")
    del model, opt

    phase_train_f32("learned")
    report["model_options"] = {"serve": serve, "train": train, "calibrate": calib}
    report["serve_variants_launches"] = counts
    report["train_variants_launches"] = train_counts      # options with mu_bf16
    report["train_calibrate_launches"] = calib_counts


def detection_targets(model, images, seed):
    """Targets made of the model's own top-Q detections of `images` (host
    arrays): boxes, classes and counts of one detect forward on the card,
    seeded poses."""
    import torch

    Q = model.cfg.num_queries
    B, H, W = images.shape[:3]
    with torch.inference_mode():
        img = torch.from_numpy(images).to(DEVICE)
        dets = model.backbone(img, torch.zeros((B, H, W), dtype=torch.bool, device=DEVICE))[2]
        boxes, labels, _, n_boxes, valid = model._select_detections(dets, Q, (H, W))
        boxes = torch.where(valid[..., None], boxes.float(), -1.0)
        labels = torch.where(valid, labels, -1)
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(B * Q, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return {"boxes": boxes.cpu().numpy(), "labels": labels.cpu().numpy().astype(np.int32),
            "n_boxes": n_boxes.cpu().numpy().astype(np.int32),
            "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
            "relative_rotation": q.reshape(B, Q, 3, 3).astype(np.float32)}


def phase_train_detections(report):
    """Phase 25: train steps on detections (bbox_mode='backbone') with Mask
    R-CNN (phase 10's config) and YOLOv4-CSP (phase 13's), the targets the
    detector's own detections of the same batch: the step matches the
    forward's queries on the card (host waits for the match), the detector
    stays frozen."""
    import torch

    from poet_tpu_torch.engine import train as train_mod
    from poet_tpu_torch.flagship import (
        detect_pose_batch,
        detect_pose_config,
        detect_pose_model,
        yolo_detect_pose_config,
        yolo_detect_pose_model,
    )

    B, (H, W) = PATH_B, FLAGSHIP_HW
    matched = []
    real_match = train_mod.match_outputs

    def counting_match(*args, **kwargs):
        m = real_match(*args, **kwargs)
        matched.append(m.valid.sum())
        return m

    out = {}
    train_mod.match_outputs = counting_match
    try:
        for name, cfg, make_model, S, extra in (
                ("maskrcnn", detect_pose_config("bfloat16"), detect_pose_model, FLAGSHIP_S,
                 lambda c, n: roi_launches(c, n)),
                ("yolov4", yolo_detect_pose_config("bfloat16"), yolo_detect_pose_model, YOLO_S,
                 lambda c, n: {"stem": 3 * n, "epilogue": YOLO_EPILOGUE * n})):
            model = make_model(cfg).to(DEVICE)
            images, pad_mask = detect_pose_batch(B, H, W, seed=0)
            targets = detection_targets(model, images, seed=25)
            if targets["n_boxes"].sum() == 0:
                raise AssertionError(f"train on detections {name}: the detector found nothing")
            frozen = {k: v.clone() for k, v in model.state_dict().items()
                      if k.startswith("backbone.")}
            per_step = {**path_launches(cfg, S, 1, train=True), **extra(cfg, 1)}
            matched.clear()
            stats, counts, history, _ = drive_train(
                f"train on detections {name}", cfg, model, (images, pad_mask, targets),
                DETECTION_TRAIN_STEPS, per_step, frozen=frozen,
                moved=("transformer.encoder.layers.0.linear1.weight",))
            per = [int(m) for m in matched]
            if min(per) == 0:
                raise AssertionError(f"train on detections {name}: a step matched nothing: {per}")
            stats["matched"] = per[-1]
            stats["targets"] = int(targets["n_boxes"].sum())
            # the merged adjoint by route (drive_train held them to the rule's)
            # and its device ms in the traced step
            stats["merged_launches"] = {k: counts[KERNEL_KEYS.index(k)]
                                        for k in MERGED_KEYS.values()}
            stats["merged_device_ms"] = sum(v for c, v in stats["device_ms_by_class"].items()
                                            if c.startswith("merged adjoint"))
            log(f"train on detections {name}: merged adjoint launches by route "
                f"{stats['merged_launches']} for {DETECTION_TRAIN_STEPS} + 1 steps (the rule's "
                f"{ {k: v for k, v in per_step.items() if k in MERGED_KEYS.values()} } a step), "
                f"{stats['merged_device_ms']:.3f} device ms of the traced step")
            log(f"train on detections {name}: paper config bf16 B={B} {H}x{W}, dropout "
                f"{cfg.model.dropout}, AdamW: targets {stats['targets']} (the detector's own "
                f"top-Q detections), matched {per} per step (warm-up first; the match in the "
                f"step, on the card), {DETECTION_TRAIN_STEPS} + 1 traced steps, launches "
                f"{LAUNCH_NAMES} {counts} ({per_step} per step), loss {history[0]['loss']:.4f} "
                f"-> {history[-1]['loss']:.4f}, detector bit-identical ({len(frozen)} tensors); "
                f"step p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, device busy "
                f"{stats['busy_ms']:.3f} ms a step ({top_classes(stats)}), "
                f"{stats['img_s']:.2f} img/s")
            out[name] = stats
            report[f"train_detections_{name}_launches"] = counts
            del model
    finally:
        train_mod.match_outputs = real_match
    report["train_detections"] = out


# ---------------------------------------------------------------- phase 26
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
JPEG_NAMES = ("baseline_444_37x53", "baseline_420_37x53", "baseline_422_53x37",
              "baseline_420_120x160", "gray_37x53", "progressive_420_48x64",
              "restart_420_64x48")
# the nvJPEG route against the fixtures' reference pixels (PIL's, = libjpeg's):
# nvJPEG's IDCT is not libjpeg's ISLOW (the upsampling and colour conversion
# are libjpeg's, native/jpeg_color.h). The largest difference over the
# fixtures, measured on the card (NVIDIA H100 80GB HBM3, 700.00 W, CUDA
# 12.8's nvJPEG 12.4): 3 units, mean 0.013-0.038 by fixture; with nvJPEG's
# own upsampling and conversion (NVJPEG_OUTPUT_RGBI) it was 37, mean 6.2
JPEG_NVJPEG_MAX_DIFF = 3
JPEG_RATE_IMAGES = 64                 # decodes of the 480x640 fixture per rate
SYNT_IMAGES, SYNT_SEEDS = 8, 3         # 480x640 RGBA renders, items drawn per image
# sha256 of every composited 'synt' item (uint8) over the fixtures' reference
# PNGs as backgrounds, SYNT_SEEDS x SYNT_IMAGES, written by the port on the CPU
SYNT_DIGEST = "0e1a45d847622ef381244652cd5677bae0d8abb1a8a3a6f9d76fac079327bb5e"
DP_B, DP_RANKS, DP_TIMED_STEPS = 8, 2, 3
# the group's f32 steps against one process taking the same shards with the
# global matched count (the same kernels at the same batch, the gradients
# summed in the same order; cuDNN's weight gradients may use atomics): the
# losses of both steps; the grad norm of both (the second step starts from
# weights an ulp apart, where a sampling point near a cell edge may cross
# it: 7.9e-6 seen); the first step's gradients, relative L2 and max; the
# parameters after two steps in units of lr (1e-3 of lr is an ulp of an
# O(1) weight)
DP_SAME_TOL = (1e-6, 1e-4, 1e-5, 1e-4, 1e-3)
DP_TIMEOUT_S = 600


def synt_dataset(root: str):
    """A 'train_synt' split of SYNT_IMAGES 480x640 RGBA PNGs (encode_png) under
    `root`: a seeded field (cli_image), alpha 0 in the left quarter, 255 in
    the next, a ramp in the rest; 1-3 objects an image. Two background
    directories beside it, `bg_png` (the fixtures' reference PNGs) and
    `bg_jpg` (their JPEGs), the same stems."""
    import shutil

    rng = np.random.default_rng(26)
    H, W = FLAGSHIP_HW
    os.makedirs(os.path.join(root, "train", "000001", "rgb"))
    os.makedirs(os.path.join(root, "annotations"))
    images, anns = [], []
    alpha = np.empty((H, W), np.uint8)
    alpha[:, :W // 4], alpha[:, W // 4:W // 2] = 0, 255
    alpha[:, W // 2:] = np.linspace(1, 254, W - W // 2).astype(np.uint8)[None]
    for i in range(SYNT_IMAGES):
        name = f"000001/rgb/{i:06d}.png"
        rgba = np.concatenate([cli_image(rng, H, W), alpha[..., None]], axis=2)
        with open(os.path.join(root, "train", name), "wb") as f:
            f.write(encode_png(rgba, chunk=1 << 16))
        images.append({"id": i, "file_name": name, "width": W, "height": H, "type": "synt",
                       "intrinsics": [1066.778, 0.0, 312.9869, 0.0, 1067.487, 241.3109,
                                      0.0, 0.0, 1.0]})
        for _ in range(int(rng.integers(1, 4))):
            q, r = np.linalg.qr(rng.normal(size=(3, 3)))
            q *= np.sign(np.diag(r))
            q[:, 0] *= np.linalg.det(q)
            anns.append({"id": len(anns), "image_id": i, "iscrowd": 0,
                         "bbox": [float(rng.uniform(0, 500)), float(rng.uniform(0, 380)),
                                  float(rng.uniform(40, 140)), float(rng.uniform(40, 100))],
                         "category_id": int(rng.integers(1, 22)),
                         "relative_pose": {"position": [float(rng.normal(0, 0.1)),
                                                        float(rng.normal(0, 0.1)), 1.0],
                                           "rotation": q.reshape(-1).tolist()}})
    with open(os.path.join(root, "annotations", "train_synt.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": []}, f)
    for kind in ("png", "jpg"):
        os.makedirs(os.path.join(root, f"bg_{kind}"))
        for name in JPEG_NAMES:
            shutil.copy(os.path.join(JPEG_FIXTURES, f"{name}.{kind}"),
                        os.path.join(root, f"bg_{kind}", f"{name}.{kind}"))


def synt_items(root: str, kind: str):
    """Every composited item of the split over `bg_{kind}` (backgrounds in
    sorted order, whatever the file system's listing order), item i of
    seed s drawn with default_rng((s, i)): (H, W, 3) uint8 images, host ms
    per item."""
    from poet_tpu_torch.cli import parse_config
    from poet_tpu_torch.data.dataset import build_dataset

    cfg = parse_config(["--dataset_path", root, "--synt_background",
                        os.path.join(root, f"bg_{kind}"), "--train_set", "train_synt"])
    ds = build_dataset("train_synt", cfg)
    ds.synthetic_background.sort()
    out, t0 = [], time.perf_counter()
    for s in range(SYNT_SEEDS):
        for i in range(len(ds)):
            img, _ = ds.__getitem__(i, rng=np.random.default_rng((s, i)))
            out.append(np.rint(np.asarray(img) * 255.0).astype(np.uint8))
    return out, (time.perf_counter() - t0) / len(out) * 1e3


def digest(images) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in images:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def phase_data_jpeg(report):
    """The JPEG route this machine built, against the committed fixtures;
    images/s of the 480x640 fixture on 1 and 4 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from poet_tpu_torch import native

    t0 = time.perf_counter()
    route = native.jpeg_route()
    t_build = time.perf_counter() - t0
    if route is None:
        native.decode_image(b"\xff\xd8\xff")              # raises with the builds' errors
    version = native._load_jpeg()[1].jpeg_lib_version()
    diffs = {}
    for name in JPEG_NAMES:
        with open(os.path.join(JPEG_FIXTURES, name + ".png"), "rb") as f:
            want = native.decode_image(f.read()).astype(np.int16)
        with open(os.path.join(JPEG_FIXTURES, name + ".jpg"), "rb") as f:
            blob = f.read()
        got = native.decode_image(blob)
        rgba = native.decode_image(blob, 4)
        if got.shape != want.shape or not np.array_equal(rgba[..., :3], got) or \
                not (rgba[..., 3] == 255).all():
            raise AssertionError(f"jpeg {name}: shape {got.shape} or RGBA unlike RGB + 255")
        d = np.abs(got.astype(np.int16) - want)
        diffs[name] = (int(d.max()), float(d.mean()))
    worst = max(m for m, _ in diffs.values())
    limit = 0 if route == "libjpeg" else JPEG_NVJPEG_MAX_DIFF
    if worst > limit:
        raise AssertionError(f"jpeg {route}: the fixtures decode up to {worst} units from "
                             f"their reference pixels (limit {limit}): {diffs}")
    try:
        with open(os.path.join(JPEG_FIXTURES, "cmyk_16x16.jpg"), "rb") as f:
            native.decode_image(f.read())
    except ValueError:
        pass
    else:
        raise AssertionError(f"jpeg {route}: a CMYK JPEG decoded (JAX's decoder refuses it)")
    with open(os.path.join(JPEG_FIXTURES, "background_480x640.jpg"), "rb") as f:
        blob = f.read()
    if native.decode_image(blob).shape != (480, 640, 3):
        raise AssertionError("jpeg: the 480x640 fixture decodes to another shape")
    rates = {}
    for threads in (1, 4):
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(native.decode_image, [blob] * threads))       # warm-up
            t0 = time.perf_counter()
            list(pool.map(native.decode_image, [blob] * JPEG_RATE_IMAGES))
            rates[threads] = JPEG_RATE_IMAGES / (time.perf_counter() - t0)
    report["jpeg"] = {"route": route, "lib_version": version, "build_s": t_build,
                      "max_diff": worst, "diff_by_fixture": diffs,
                      "images_per_s": rates[1], "images_per_s_4_threads": rates[4]}
    log(f"jpeg: route {route} (library version {version}, built in {t_build:.2f} s); "
        f"{len(JPEG_NAMES)} fixtures (4:4:4, 4:2:0, 4:2:2, gray, progressive, restart markers, "
        f"odd sizes) within {worst} units of their reference pixels (limit {limit}; max, mean "
        "by fixture: " + ", ".join(f"{k} {m} {a:.3f}" for k, (m, a) in diffs.items())
        + f"), CMYK refused; 480x640 decode {rates[1]:.1f} images/s on one thread, "
        f"{rates[4]:.1f} on 4")


def phase_data_synt(report, tmp):
    """'synt' compositing: the items over PNG backgrounds against the
    digest the CPU port gives, over the JPEG backgrounds against those."""
    root = os.path.join(tmp, "synt")
    synt_dataset(root)
    png_items, png_ms = synt_items(root, "png")
    jpg_items, jpg_ms = synt_items(root, "jpg")
    got = digest(png_items)
    if got != SYNT_DIGEST:
        raise AssertionError(f"synt: the items over PNG backgrounds hash to {got}, not "
                             f"{SYNT_DIGEST}")
    worst = max(int(np.abs(a.astype(np.int16) - b).max()) for a, b in zip(jpg_items, png_items))
    limit = 0 if report["jpeg"]["route"] == "libjpeg" else 2 * JPEG_NVJPEG_MAX_DIFF + 1
    if worst > limit:
        raise AssertionError(f"synt: over the JPEG backgrounds the items lie {worst} units "
                             f"from those over the PNGs (limit {limit})")
    report["synt"] = {"ms_per_image_png_bg": png_ms, "ms_per_image_jpg_bg": jpg_ms,
                      "jpg_vs_png_max_diff": worst}
    log(f"synt: {len(png_items)} composited 480x640 items ({SYNT_IMAGES} RGBA renders x "
        f"{SYNT_SEEDS} seeds) over the fixtures' PNGs hash to the CPU port's digest; over "
        f"their JPEGs ({report['jpeg']['route']}) within {worst} units (limit {limit}); "
        f"{png_ms:.2f} ms per item (PNG backgrounds), {jpg_ms:.2f} ms (JPEG), one thread")


def dp_config(dtype: str, zero: bool):
    """Phase 26's configs: the paper config; f32 with SGD and dropout 0 for the
    check, bf16 with AdamW and dropout 0.1 for the rehearsal timing."""
    cfg = train_config(dtype, "merged")
    cfg.runtime.zero_opt_state = zero
    if dtype == "float32":
        cfg.model.dropout, cfg.optim.sgd = 0.0, True
    return cfg


def dp_model(cfg, state=None):
    """The paper model of `cfg` on the CPU holding `state` (phase 26's seeded
    weights; None: torch's default init, for a process that takes rank 0's);
    at f32 its offset kernels moved off the cell edges, as phase 8's."""
    import torch

    from poet_tpu_torch.models import build_model

    model = build_model(cfg)
    if state is not None:
        model.load_state_dict(state)
    if cfg.model.dtype == "float32":
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("sampling_offsets.weight"):
                    p.normal_(0.0, 0.02, generator=g)
    return model


def dp_batches(rows: slice, rotations=None):
    """`rows` of each of two global batches of DP_B x DP_RANKS images; with
    `rotations` (a .npz of the global batches' target rotations) those
    targets."""
    from poet_tpu_torch.flagship import flagship_batch

    out = []
    for s, seed in enumerate((0, 1)):
        images, pad_mask, t = flagship_batch(DP_B * DP_RANKS, *FLAGSHIP_HW, seed=seed)
        if rotations is not None:
            with np.load(rotations) as z:
                t = dict(t, relative_rotation=z[f"batch{s}"])
        out.append((images[rows], pad_mask[rows], {k: v[rows] for k, v in t.items()}))
    return out


def rank_rows(rank: int) -> slice:
    return slice(rank * DP_B, (rank + 1) * DP_B)


def predicted_rotations(model, batch) -> np.ndarray:
    """(n_layers, B, Q, 3, 3) f64: every decoder layer's predicted rotations
    of the batch, from an f32 eval forward of a copy of `model` on the card,
    TF32 off (the forward both target sets are built from)."""
    import copy

    import torch

    images, pad_mask, targets = batch
    with torch.no_grad(), tf32_off():
        m = copy.deepcopy(model).to(DEVICE).eval()
        rot = m(torch.from_numpy(images).to(DEVICE), torch.from_numpy(pad_mask).to(DEVICE),
                {k: torch.from_numpy(v).to(DEVICE) for k, v in targets.items()})["rotations"]
    return rot.double().cpu().numpy()


def midpoint_rotations(rot: np.ndarray, targets) -> np.ndarray:
    """The batch's target rotations with each valid query's the geodesic
    midpoint of the first and last decoder layers' predictions `rot`
    (`predicted_rotations`): those two layers' pairs lie at most 90 degrees
    from the target, the middle layers' are left where their heads put them
    (tests/test_torch_variants.py, tests/test_torch_ddp.py do the same)."""
    from scipy.spatial.transform import Rotation

    first, last = rot[0], rot[-1]
    half = Rotation.from_rotvec(Rotation.from_matrix(
        np.swapaxes(first, -1, -2).reshape(-1, 3, 3) @ last.reshape(-1, 3, 3)).as_rotvec() / 2)
    mid = (first.reshape(-1, 3, 3) @ half.as_matrix()).reshape(first.shape)
    valid = np.arange(first.shape[1])[None, :] < targets["n_boxes"][:, None]
    return np.where(valid[..., None, None], mid, targets["relative_rotation"]).astype(np.float32)


# phase 27's per-tensor gradient gaps printed, largest first
TP_GAP_TOP = 10


# phase 27's C9 measurements (ROADMAP C9: TP's gradients against one
# process's). The conditioned targets' file and seed (dp_setup); the layout
# measured, and where one process's sampling outputs go for its pinned run;
# its tolerances against one process taking TP's order of sums (tp_order) on
# the conditioned targets, phase 26's same-shards ones (losses 1e-6, grad
# norm 1e-4, gradients 1e-5 relative L2 / 1e-4 of max, parameters 1e-3 lr):
# pinned on every tensor, unpinned on the first step outside the layers
# where a sampling coordinate's corner parts between the two runs
CONDITIONED_FILE, CONDITIONED_SEED = "dp_conditioned.npz", 27
C9_LAYOUT, PINNED_FILE = (1, 1, 2), "pinned_sampling.pt"
CONDITIONED_TOL = DP_SAME_TOL
# the rotation loss's clamp: 0.5 (tr - 1) within this of -1 or 1
ARCCOS_CLAMP = 1e-6
SAMPLING_OUTPUTS = r"\.(sampling_offsets|attention_weights)$"


def corner_index(locs, shapes):
    """floor(fl(fl(loc * size) - 0.5)) of every sampling coordinate, int32
    (B, Q, H, L, P, 2): the corner `csrc/ms_deform_attn_point.cuh:
    pixel_coord` rounds twice to (eager torch rounds the product and the
    difference each)."""
    import torch

    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=locs.device)
    return torch.floor(locs.detach().float() * size[:, None, :] - 0.5).to(torch.int32)


@contextlib.contextmanager
def layout_probes(model):
    """Records of the model's first forward and backward, filled while the
    context is open: 'rotations' (n_layers, B, Q, 3, 3) and 'd_rotations'
    (the loss's gradient of them, a tensor hook), f64 on the CPU;
    'corners', per deformable-attention call in order (the encoder layers,
    then the decoder's), `corner_index` of its sampling locations with the
    heads gathered whole over 'model'; 'layers', each encoder and decoder
    layer's output, f32 on the CPU. A collective over 'model' under a TP
    layout (every process must open it)."""
    import torch

    import poet_tpu_torch.models.transformer as tmod
    from poet_tpu_torch.parallel import tp

    layout = getattr(model, "layout", None)
    n_calls = len(model.transformer.encoder.layers) + len(model.transformer.decoder.layers)
    rec = {"corners": [], "layers": {}}
    handles, cores = [], {"ms_deform_attn": tmod.ms_deform_attn,
                          "ms_deform_attn_dense": tmod.ms_deform_attn_dense}

    def on_grad(g):
        rec.setdefault("d_rotations", g.detach().double().cpu())

    def on_model(module, args, out):
        if "rotations" not in rec:
            r = out["rotations"]
            rec["rotations"] = r.detach().double().cpu()
            if r.requires_grad:
                r.register_hook(on_grad)

    def on_layer(name):
        def record(module, args, out):
            rec["layers"].setdefault(name, out.detach().float().cpu())
        return record

    def counted(core):
        def call(value, shapes, locs, *args, **kwargs):
            if len(rec["corners"]) < n_calls:
                c = corner_index(locs, shapes)
                if layout is not None and layout.n_model > 1:
                    c = torch.cat(tp._all_gather(c.contiguous(), layout.model_group,
                                                 layout.n_model), dim=2)
                rec["corners"].append(c.cpu())
            return core(value, shapes, locs, *args, **kwargs)
        return call

    handles.append(model.register_forward_hook(on_model))
    for stack in ("encoder", "decoder"):
        for i, layer in enumerate(getattr(model.transformer, stack).layers):
            handles.append(layer.register_forward_hook(on_layer(f"{stack}.{i}")))
    for name, core in cores.items():
        setattr(tmod, name, counted(core))
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()
        for name, core in cores.items():
            setattr(tmod, name, core)


@contextlib.contextmanager
def sampling_pin(model, saved=None):
    """Forward hooks on the deformable attention's `sampling_offsets` and
    `attention_weights` (SAMPLING_OUTPUTS). Without `saved`: yields
    {module name: [each call's output, on the CPU]}. With `saved` (such a
    record from one process): each call's output becomes `out + (s -
    out).detach()`, s the record's call sliced to this process's heads
    (their block of the output's columns under 'model'), so the forward
    takes one process's sampling locations and weights and the gradient
    passes straight through."""
    import re

    import torch

    layout = getattr(model, "layout", None)
    rec, calls, handles = {}, {}, []

    def hook(name):
        def swap(module, args, out):
            i = calls[name] = calls.get(name, -1) + 1
            if saved is None:
                rec.setdefault(name, []).append(out.detach().cpu())
                return None
            s = saved[name][i]
            if layout is not None and layout.n_model > 1:
                s = s.chunk(layout.n_model, dim=-1)[layout.model_index]
            s = s.to(out.device)
            if s.shape != out.shape:
                raise AssertionError(f"pinned {name} call {i}: {tuple(s.shape)} for "
                                     f"{tuple(out.shape)}")
            return out + (s - out).detach()
        return swap

    for name, module in model.named_modules():
        if re.search(SAMPLING_OUTPUTS, name):
            handles.append(module.register_forward_hook(hook(name)))
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


def nudged(model, seed=CONDITIONED_SEED):
    """`model` with every trained tensor moved one f32 ulp up or down at
    random (from `seed`), in place: a forward perturbed by roundings, in one
    process, against which a layout's other order of the same sums is read."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad:
                up = torch.rand(p.shape, generator=g) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf)))
    return model


@contextlib.contextmanager
def tp_order(model, n):
    """One process (no layout) taking a TP layout's order of sums over `n`
    model processes: each column-parallel projection (`tp.param_spec`
    Spec(0): value_proj, sampling_offsets, attention_weights, linear1; the
    MHA's q, k and v products, through `models/transformer.py`'s F) as `n`
    products on the shards' weights, concatenated; each row-parallel one
    (output_proj, linear2, the MHA's out_proj) as `n` partial products on the
    shards' columns, summed in model order, then the bias. Every operand is a
    contiguous shard of the parameter (`tp.shard_tensor`, differentiable),
    as a process holds it. C9's control: what TP's arithmetic alone does to
    one process's result, without its collectives or its sharded state."""
    import types

    import torch
    import torch.nn.functional as F

    import poet_tpu_torch.models.transformer as tmod
    from poet_tpu_torch.models.layers import Dense
    from poet_tpu_torch.parallel import tp

    def column(name):
        def hook(module, args, out):
            x, dt = args[0].to(module.compute_dtype), module.compute_dtype
            w = [tp.shard_tensor(module.weight, tp.param_spec(f"{name}.weight"), i, n)
                 for i in range(n)]
            b = [tp.shard_tensor(module.bias, tp.param_spec(f"{name}.bias"), i, n)
                 for i in range(n)]
            return torch.cat([F.linear(x, wi.to(dt), bi.to(dt)) for wi, bi in zip(w, b)], -1)
        return hook

    def row(name):
        def hook(module, args, out):
            dt = module.compute_dtype
            xs = args[0].to(dt).chunk(n, dim=-1)
            y = None
            for i, x in enumerate(xs):
                w = tp.shard_tensor(module.weight, tp.param_spec(f"{name}.weight"), i, n)
                part = F.linear(x.contiguous(), w.to(dt))
                y = part if y is None else y + part
            return y + module.bias.to(dt)
        return hook

    def in_proj(x, w, b=None):
        return torch.cat([F.linear(x, wi, bi) for wi, bi in zip(w.chunk(n), b.chunk(n))], -1)

    handles = []
    for name, module in model.named_modules():
        spec = tp.param_spec(f"{name}.weight")
        if isinstance(module, Dense) and spec.dim is not None:
            handles.append(module.register_forward_hook((column if spec.dim == 0 else row)(name)))
    functional = tmod.F
    tmod.F = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F) if not k.startswith("__")})
    tmod.F.linear = in_proj
    try:
        yield
    finally:
        tmod.F = functional
        for h in handles:
            h.remove()


def term_grads(cfg, model, batch):
    """The first step's gradient of each loss term alone, on `batch` (host
    arrays), f32 on the CPU by name, a sharded tensor gathered whole:
    'translation' (every decoder layer's translation loss) and 'rotation
    {l}' per decoder layer; one forward, one backward per term, TF32 off (a
    collective over 'model' under a TP layout)."""
    import torch

    from poet_tpu_torch.engine.train import make_loss_fn, prepare_batch
    from poet_tpu_torch.parallel.tp import gather_tensor

    model = model.to(DEVICE).to(memory_format=torch.channels_last).train()
    layout = getattr(model, "layout", None)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    n_dec = cfg.model.dec_layers
    out = {}
    with tf32_off():
        _, losses = make_loss_fn(model, cfg)(*prepare_batch(cfg, *batch, DEVICE), None)
        terms = {"translation": sum(v for k, v in losses.items() if k.startswith("loss_trans"))}
        terms.update({f"rotation {l}": losses["loss_rot" + ("" if l == n_dec - 1 else f"_{l}")]
                      for l in range(n_dec)})
        for t, loss in terms.items():
            grads = torch.autograd.grad(loss, [p for _, p in named], retain_graph=True,
                                        allow_unused=True)
            out[t] = {n: gather_tensor(torch.zeros_like(p) if g is None else g, n,
                                       layout).float()
                      for (n, p), g in zip(named, grads)}
    return out


def rel_l2(got, want, floor=0.0) -> float:
    """|got - want| / (|want| + floor), in f64."""
    return float((got.double() - want.double()).norm()) / (float(want.double().norm()) + floor)


def pair_report(rotations, targets, d_rotations=None):
    """Per decoder layer, over the valid pairs (gt mode: query q against
    target q) of the first step's forward `rotations` (n_layers, B, Q, 3,
    3): the angles (degrees), the smallest sin^2 of the angle and that
    pair's angle, and the pairs on the rotation loss's clamp."""
    from poet_tpu_torch.flagship import pair_angles

    rot = rotations.numpy()
    valid = np.arange(rot.shape[2])[None, :] < targets["n_boxes"][:, None]
    theta = pair_angles(rot, targets["relative_rotation"])[:, valid]          # (L, pairs)
    cos = np.cos(theta)
    out = []
    for l, t in enumerate(theta):
        s2 = np.sin(t) ** 2
        i = int(np.argmin(s2))
        out.append({"n": int(t.size), "deg": np.degrees(t).round(2).tolist(),
                    "min_sin2": float(s2[i]), "min_sin2_deg": float(np.degrees(t[i])),
                    "clamped": int((np.abs(cos[l]) >= 1.0 - ARCCOS_CLAMP).sum())})
    return out


def layout_gaps(got, want, targets, n_enc):
    """C9's per-layer comparison of two `layout_probes` records (a layout's
    against one process's): each decoder layer's relative L2 gap of the
    predicted rotations and of the loss's gradient of them over the valid
    pairs, each encoder and decoder layer's output gap, and, per
    deformable-attention call, the sampling points whose corner index
    differs in either coordinate (flips)."""
    valid = np.arange(got["rotations"].shape[2])[None, :] < targets["n_boxes"][:, None]
    rows = {}
    for key in ("rotations", "d_rotations"):
        rows[key] = [rel_l2(g[valid], w[valid]) for g, w in zip(got[key], want[key])]
    rows["layers"] = {n: rel_l2(got["layers"][n], w) for n, w in want["layers"].items()}
    rows["flips"] = {}
    for i, (g, w) in enumerate(zip(got["corners"], want["corners"])):
        name = f"encoder.{i}" if i < n_enc else f"decoder.{i - n_enc}"
        rows["flips"][name] = int((g != w).any(-1).sum())
    return rows


def term_gaps(got, want):
    """{term: (the largest relative L2 gap over the tensors with a nonzero
    gradient, floored at GRAD_FLOOR of the term's largest element, that
    tensor)} of two `term_grads` results."""
    out = {}
    for t, w in want.items():
        floor = GRAD_FLOOR * max(float(v.abs().max()) for v in w.values())
        gaps = [(rel_l2(got[t][n], v, floor), n) for n, v in w.items() if v.abs().max() > 0]
        out[t] = max(gaps)
    return out


def flipped_layer(name: str, flips) -> bool:
    """Whether parameter `name` belongs to an encoder or decoder layer where
    `flips` (layout_gaps') counted a corner flip."""
    return any(c and f".{layer.split('.')[0]}.layers.{layer.split('.')[1]}." in name
               for layer, c in flips.items())


def dp_f32_steps(cfg, model, batches):
    """Two f32 steps on the card, TF32 off: (metrics per step, the first
    update's gradients by name, the parameters after the second, on the CPU;
    a sharded model's gathered whole, a collective over 'model')."""
    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.parallel.tp import gather_tensor

    model = model.to(DEVICE)
    layout = getattr(model, "layout", None)
    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads, update = {}, opt.step

    def step_and_record():
        if not grads:
            grads.update({n: gather_tensor(g, n, layout).double()
                          for n, g in zip(names, opt.grads())})
        return update()

    opt.step = step_and_record
    step = make_train_step(model, cfg, opt)
    with tf32_off():
        metrics = [fetch_metrics(step(*prepare_batch(cfg, *b, DEVICE), None)) for b in batches]
    params = {n: gather_tensor(p, n, layout).double() for n, p in model.named_parameters()
              if p.requires_grad}
    return metrics, grads, params


def dp_shard_steps(cfg, model, shards):
    """One process taking each of two f32 steps as the data-parallel group
    does, without its collectives: each shard (a process's DP_B images)
    through the loss with the matched count of all of them, the gradients
    summed (autograd accumulates), the losses summed, then the clip and the
    update; TF32 off. Returns dp_f32_steps's triple."""
    import torch

    from poet_tpu_torch.engine.train import (
        global_norm,
        make_loss_fn,
        make_optimizer,
        prepare_batch,
    )

    model = model.to(DEVICE).to(memory_format=torch.channels_last).train()
    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    metrics, grads = [], {}
    with tf32_off():
        for step in range(len(shards[0])):
            prepared = [prepare_batch(cfg, *shard[step], DEVICE) for shard in shards]
            count = sum(p[3].num_matched for p in prepared)
            loss_fn = make_loss_fn(model, cfg, count=lambda match: count)
            opt.zero_grad()
            sums = {}
            for p in prepared:
                total, losses = loss_fn(*p, None)
                total.backward()
                for k, v in dict(losses, loss=total).items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
            if not grads:
                grads = {n: g.detach().double().cpu() for n, g in zip(names, opt.grads())}
            sums["grad_norm"] = global_norm(opt.grads())
            metrics.append({k: float(v) for k, v in sums.items()})
            opt.step()
    params = {n: p.detach().double().cpu() for n, p in model.named_parameters()
              if p.requires_grad}
    return metrics, grads, params


def dp_compare(got, want, lr):
    """The largest relative errors of a data-parallel run's (metrics, grads,
    params) against a reference's: losses, grad norm, each gradient's L2 and
    max (and which tensor), the parameters in units of lr."""
    (gm, gg, gp), (wm, wg, wp) = got, want
    errs = {"loss": 0.0, "grad_norm": 0.0, "grad_l2": 0.0, "grad_max": 0.0, "param": 0.0}
    for g, w in zip(gm, wm):
        errs["loss"] = max([errs["loss"]] + [abs(g[k] - v) / max(abs(v), 1e-12)
                                             for k, v in w.items() if k != "grad_norm"])
        errs["grad_norm"] = max(errs["grad_norm"], abs(g["grad_norm"] / w["grad_norm"] - 1))
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in wg.values())
    for n, ref in wg.items():
        d = gg[n] - ref
        l2 = float(d.norm()) / (float(ref.norm()) + floor)
        mx = float(d.abs().max()) / (float(ref.abs().max()) + floor)
        if l2 > errs["grad_l2"]:
            errs["grad_l2"], errs["grad_l2_at"] = l2, n
        if mx > errs["grad_max"]:
            errs["grad_max"], errs["grad_max_at"] = mx, n
    errs["param"] = max(float((gp[n] - v).abs().max()) for n, v in wp.items()) / lr
    return errs


def dp_hold(label, errs, tol, grads=True):
    """Raise where an error of dp_compare passes its tolerance
    (loss, grad_norm, grad_l2, grad_max, param); `grads=False` holds the
    metrics and parameters only."""
    keys = ("loss", "grad_norm", "grad_l2", "grad_max", "param")
    over = [k for k, t in zip(keys, tol) if (grads or k not in ("grad_l2", "grad_max"))
            and errs[k] > t]
    if over:
        raise AssertionError(f"data parallel {label}: {over} over {dict(zip(keys, tol))}: "
                             f"{errs}")


def dp_bf16_steps(cfg, model, rank, rows=None, n_seq=1):
    """The rehearsal timing: 2 warm-up and DP_TIMED_STEPS timed bf16 steps
    (host clock, ended by fetching the metrics), then one traced step;
    the launches of the timed and traced steps held to the route rules.
    `rows`: the process's images of each global batch (default: the rank's
    data slot); the generator is seeded by the first image's slot, so every
    process of one data slot draws the same dropout masks; `n_seq`: the
    processes the encoder's tokens are split over."""
    import torch

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.parallel.zero import opt_state_bytes_per_device

    model = model.to(DEVICE)
    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    step = make_train_step(model, cfg, opt)
    rows = rows or rank_rows(rank)
    gen = torch.Generator(device=DEVICE).manual_seed(rows.start // DP_B)
    batch = dp_batches(rows)[0]
    fetch_metrics(step(*prepare_batch(cfg, *batch, DEVICE), gen))        # warm-up
    torch.cuda.synchronize()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    times, history = [], []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        history.append(fetch_metrics(step(*prepare_batch(cfg, *batch, DEVICE), gen)))
        times.append(time.perf_counter() - t0)
    busy, _ = profiled_busy_ms(lambda: history.append(fetch_metrics(
        step(*prepare_batch(cfg, *batch, DEVICE), gen))), 1)
    launches = [k.launches for k in kernels]
    want = expected(**path_launches(cfg, FLAGSHIP_S, DP_TIMED_STEPS + 1, train=True,
                                    n_seq=n_seq))
    if launches != want:
        raise AssertionError(f"data parallel: launches {launches}, expected {want}")
    if not all(np.isfinite(list(m.values())).all() for m in history):
        raise AssertionError(f"data parallel: non-finite metrics {history}")
    return {"p50_ms": float(np.median(times)) * 1e3, "step_ms": [t * 1e3 for t in times],
            "busy_ms": busy, "launches": launches, "loss": [m["loss"] for m in history],
            "opt_state_mib": opt_state_bytes_per_device(opt) / 2 ** 20}


def dp_worker(rank: int, world: int, port: int, out: str) -> int:
    """One process of phase 26's gloo group of `world` over CUDA tensors on
    the one card: rank 0 holds the seeded weights (`dp_weights.pt`), the
    others torch's default init until `replicate`; then the f32 check's two
    steps with and without ZeRO-1 and the bf16 timing of each."""
    import copy
    import datetime

    import torch
    import torch.distributed as dist

    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.parallel.zero import ZeroOptimizer

    torch.cuda.set_device(0)
    # a peer that fails ends the others' collectives within the timeout
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S // 4))
    seeded = torch.load(os.path.join(out, "dp_weights.pt"), weights_only=True)
    models = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dp_config(dtype, False)
        models[dtype] = mesh.replicate(dp_model(cfg, seeded if rank == 0 else None))
        want = dp_model(cfg, seeded).state_dict()
        if any(not torch.equal(v, want[k]) for k, v in models[dtype].state_dict().items()):
            raise AssertionError(f"rank {rank}: replicate did not give rank 0's weights")
    result = {}
    batches = dp_batches(rank_rows(rank), os.path.join(out, "dp_rotations.npz"))
    for zero in (False, True):
        result[f"f32_zero{int(zero)}"] = dp_f32_steps(
            dp_config("float32", zero), copy.deepcopy(models["float32"]), batches)
    for zero in (False, True):
        cfg = dp_config("bfloat16", zero)
        if isinstance(make_optimizer(cfg, copy.deepcopy(models["bfloat16"]), 1000),
                      ZeroOptimizer) != zero:
            raise AssertionError(f"data parallel: zero={zero} built the other optimizer")
        result[f"bf16_zero{int(zero)}"] = dp_bf16_steps(cfg, copy.deepcopy(models["bfloat16"]),
                                                        rank)
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(result, os.path.join(out, "dp_gloo.pt"))
    dist.destroy_process_group()
    return 0


def dp_nccl(model, out):
    """A one-process NCCL group in this process: bf16 steps through the
    group's collectives (sums over one process), the metric sync on the
    card, the preemption vote, the pair gather and a rank-0 checkpoint; the
    group is destroyed after."""
    import socket

    import torch
    import torch.distributed as dist

    from poet_tpu_torch.engine.checkpoint import save_checkpoint
    from poet_tpu_torch.engine.evaluate import gather_pairs_across_hosts
    from poet_tpu_torch.engine.metrics import SmoothedValue
    from poet_tpu_torch.parallel import mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        cfg = dp_config("bfloat16", False)
        stats = dp_bf16_steps(cfg, model, 0)
        v = SmoothedValue()
        v.update(2.0, n=3)
        if mesh.collective_device().type != "cuda":
            raise AssertionError("nccl: the metric sync would reduce on the CPU")
        v.synchronize_between_processes()
        if (v.count, v.total) != (3, 6.0):
            raise AssertionError(f"nccl: the metric sync gave {(v.count, v.total)}")
        if mesh.any_process(False) or not mesh.any_process(True):
            raise AssertionError("nccl: the preemption vote is wrong")
        if gather_pairs_across_hosts([{"image_id": 7}]) != [{"image_id": 7}]:
            raise AssertionError("nccl: the pair gather changed the pairs")
        if not os.path.isfile(save_checkpoint(out, "dp_nccl.pth", model, None, 0, 1, cfg)):
            raise AssertionError("nccl: rank 0 wrote no checkpoint")
    finally:
        dist.destroy_process_group()
    return stats


def run_dp_workers(world: int, out: str, flag="--dp-worker", result="dp_gloo.pt"):
    """`world` processes of dp_worker (`flag` --tp-worker: tp_worker); each
    joined within DP_TIMEOUT_S and killed after it. Returns rank 0's results
    (`result` in `out`)."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               flag, str(r), str(world), str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs, late = [], False
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                late = True
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if late:
        raise AssertionError(f"data parallel (gloo): a process did not finish in "
                             f"{DP_TIMEOUT_S} s:\n" + "\n".join(o[-3000:] for o in outs))
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"data parallel (gloo) rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    return torch.load(os.path.join(out, result), weights_only=False)


def dp_setup(out):
    """Phases 26 and 27's inputs in `out`: the seeded paper-config weights
    (dp_weights.pt) and the two global batches' target rotations, midpoints
    (dp_rotations.npz) and conditioned (CONDITIONED_FILE: every decoder
    layer's valid pair 20-160 degrees from its target,
    `flagship.conditioned_rotations` from CONDITIONED_SEED), both from one
    f32 forward (`predicted_rotations`). Returns (f32 config, bf16 config,
    the weights, the f32 model holding them)."""
    import torch

    from poet_tpu_torch.flagship import conditioned_rotations, flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    os.makedirs(out)
    cfg32, cfg16 = dp_config("float32", False), dp_config("bfloat16", False)
    seeded = init_weights(build_model(cfg32), seed=0).state_dict()
    torch.save(seeded, os.path.join(out, "dp_weights.pt"))
    model32 = dp_model(cfg32, seeded)
    one = [flagship_batch(DP_B * DP_RANKS, *FLAGSHIP_HW, seed=seed) for seed in (0, 1)]
    rot = [predicted_rotations(model32, b) for b in one]
    np.savez(os.path.join(out, "dp_rotations.npz"),
             **{f"batch{s}": midpoint_rotations(r, b[2]) for s, (r, b) in enumerate(zip(rot, one))})
    np.savez(os.path.join(out, CONDITIONED_FILE),
             **{f"batch{s}": conditioned_rotations(r, b[2], CONDITIONED_SEED + s)
                for s, (r, b) in enumerate(zip(rot, one))})
    return cfg32, cfg16, seeded, model32


def phase_data_parallel(report, tmp):
    """Two processes on the one card in a gloo group (NCCL puts no two
    processes on one device), then a one-process NCCL group; one process's
    f32 steps on the same 16 images and its bf16 step at the same per-process
    batch beside them."""
    import copy

    import torch

    out = os.path.join(tmp, "dp")
    cfg32, cfg16, seeded, model32 = dp_setup(out)
    one = dp_batches(slice(None), os.path.join(out, "dp_rotations.npz"))
    want = dp_f32_steps(cfg32, copy.deepcopy(model32), one)
    shards = [dp_batches(rank_rows(r), os.path.join(out, "dp_rotations.npz"))
              for r in range(DP_RANKS)]
    same = dp_shard_steps(cfg32, copy.deepcopy(model32), shards)
    del model32
    model16 = dp_model(cfg16, seeded)
    single, _, _, _ = drive_train("single process B=8", cfg16,
                                  copy.deepcopy(model16).to(DEVICE),
                                  dp_batches(rank_rows(0))[0], DP_TIMED_STEPS,
                                  path_launches(cfg16, FLAGSHIP_S, 1, train=True))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gloo = run_dp_workers(DP_RANKS, out)
    t_gloo = time.perf_counter() - t0
    errs, errs16 = {}, {}
    for z in (0, 1):
        got = gloo[f"f32_zero{z}"]
        errs[z] = dp_compare(got, same, cfg32.optim.lr)
        dp_hold(f"f32 zero={bool(z)} against one process's shard steps", errs[z], DP_SAME_TOL)
        errs16[z] = dp_compare(got, want, cfg32.optim.lr)
        dp_hold(f"f32 zero={bool(z)} against one process's 16-image steps", errs16[z],
                (TRAIN_F32_LOSS_RTOL, TRAIN_F32_L2_RTOL, None, None, 1e-3), grads=False)
    t0 = time.perf_counter()
    nccl = dp_nccl(model16, out)
    t_nccl = time.perf_counter() - t0
    r = {"single": single, "gloo": gloo["bf16_zero0"], "gloo_zero": gloo["bf16_zero1"],
         "nccl": nccl, "f32_errors": errs, "f32_errors_16": errs16,
         "gloo_call_s": t_gloo,
         "nccl_call_s": t_nccl}
    report["data_parallel"] = r
    report["dp_launches"] = gloo["bf16_zero0"]["launches"]
    e0, e1, g0 = errs[0], errs[1], errs16[0]
    log(f"data parallel (paper config, {FLAGSHIP_HW[0]}x{FLAGSHIP_HW[1]}, B={DP_B} a process): "
        f"{DP_RANKS} processes in a gloo group on the one card, f32 SGD 2 steps (TF32 off) "
        f"against one process taking the same shards with the global matched count: losses "
        f"{e0['loss']:.2e}, grad norm {e0['grad_norm']:.2e}, gradients relative L2 "
        f"{e0['grad_l2']:.2e} / max {e0['grad_max']:.2e}, parameters {e0['param']:.2e} lr; "
        f"with ZeRO-1 {e1['loss']:.2e}, {e1['grad_norm']:.2e}, {e1['grad_l2']:.2e} / "
        f"{e1['grad_max']:.2e}, {e1['param']:.2e} lr (tolerances {DP_SAME_TOL}); against one "
        f"process's step on the {DP_B * DP_RANKS} images at once: losses {g0['loss']:.2e}, grad "
        f"norm {g0['grad_norm']:.2e}, parameters {g0['param']:.2e} lr (phase 8's "
        f"{TRAIN_F32_LOSS_RTOL}, {TRAIN_F32_L2_RTOL}, 1e-3 lr), gradients L2 "
        f"{g0['grad_l2']:.2e} ({g0.get('grad_l2_at')}) / max {g0['grad_max']:.2e} (reported: "
        f"B=8 and B=16 round differently, and d_loc jumps where a point crosses a cell "
        f"edge) | bf16 AdamW step p50 (host clock) / device busy ms, "
        f"a rehearsal on one card and not a multi-card figure: one process "
        f"{single['p50_ms']:.1f} / {single['busy_ms']:.2f}; gloo x{DP_RANKS} "
        f"{r['gloo']['p50_ms']:.1f} / {r['gloo']['busy_ms']:.2f} (optimizer state "
        f"{r['gloo']['opt_state_mib']:.1f} MiB a process); with ZeRO-1 "
        f"{r['gloo_zero']['p50_ms']:.1f} / {r['gloo_zero']['busy_ms']:.2f} "
        f"({r['gloo_zero']['opt_state_mib']:.1f} MiB); one-process NCCL group "
        f"{r['nccl']['p50_ms']:.1f} / {r['nccl']['busy_ms']:.2f}, metric sync on the card, "
        f"rank-0 checkpoint | launches per process {LAUNCH_NAMES} {r['gloo']['launches']} "
        f"over {DP_TIMED_STEPS + 1} steps | gloo workers {t_gloo:.1f} s, NCCL group "
        f"{t_nccl:.1f} s")


def phase_data(report):
    """Phase 26: data and data parallel (see the module docstring), in a
    temporary directory removed afterwards."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="poet_data_") as tmp:
        phase_data_jpeg(report)
        phase_data_synt(report, tmp)
        phase_data_parallel(report, tmp)
    log(f"phase 26 in {time.perf_counter() - t0:.1f} s")


# phase 27: the kernels at the shapes a layout gives them, B = PATH_B: TP=2
# halves the heads (H = 8, Q = S = 1600); SP=2 halves the encoder's queries
# (H = 16, Q = 800 of S = 1600; the YOLO pyramid's Q = 3190 of S = 6380, on
# the merged adjoint's banded route in bf16)
SHARDED_CASES = (("tp2 encoder", 8, None, FLAGSHIP_LEVELS),
                 ("sp2 encoder", 16, FLAGSHIP_S // 2, FLAGSHIP_LEVELS),
                 ("sp2 yolo", 16, YOLO_S // 2, YOLO_LEVELS))
TP_LAYOUTS = ((1, 1, 2), (1, 2, 1))
# a layout's f32 steps against one process on the same images: the losses
# and parameters at phase 26's same-shards tolerances (DP_SAME_TOL); the
# grad norm and the gradients at phase 8's card-vs-CPU ones (the grad norm
# at the gradients' L2 one). Measured cause of the gap (C9; NVIDIA H100 80GB
# HBM3, 700.00 W): TP sums a row-parallel product in halves and then over
# 'model', and cuBLAS takes the column-parallel ones at half the width, so
# every layer's output parts from one process's by 3e-7..8e-7 relative;
# one process taking that order (tp_order) reproduces TP's forward bit for
# bit and its gradients within 1.2e-6. The gradients amplify it: on the
# midpoint targets decoder layer 3 holds a pair 179.81 degrees from its
# target, where the arccos's gradient -1/sin(theta) moves the loss's
# gradient of that layer's rotations by 5.3e-3 (rotation_head.3: 8.45e-4);
# on targets 20-160 degrees away the encoder's sampling offsets, input
# projections and level embedding, sums over 12 800 tokens that cancel,
# part by up to 1.2e-4 with the sampling locations pinned, 3.1e-4 where 1-2
# points cross a cell edge
LAYOUT_TOL = (DP_SAME_TOL[0], TRAIN_F32_L2_RTOL, TRAIN_F32_L2_RTOL, TRAIN_F32_MAX_RTOL,
              DP_SAME_TOL[4])
SERVE_DEVICES = ("cuda:0", "cuda:0")
# two servers' f32 answers on the card, one device against two shards: the
# same kernels at batch 16 and 8 (cuBLAS and cuDNN may take other
# algorithms), relative to the output scale
SERVE_DEVICES_RTOL = 1e-4


def layout_name(lay) -> str:
    return "x".join(map(str, lay))


def phase_sharded_kernels(report):
    """Phase 27a: the forward and the merged adjoint at SHARDED_CASES,
    through the entry on the routes the rules give, f32 and bf16, against
    their plain versions (entry_autograd); device ms of each route's kernel
    from graph replays at the sharded shape and at the unsharded one (H =
    16, Q = S) in the same call; the sharded shape's bounds."""
    import torch

    from poet_tpu_torch.ops import deform_attn_cuda as dac
    from poet_tpu_torch.tools.timing import graph_ms

    forward = {"direct": dac.MS_DEFORM_ATTN_FWD, "slab": dac.MS_DEFORM_ATTN_FWD_SLAB}
    merged = {"atomic": dac.MS_DEFORM_ATTN_MERGED, "slab": dac.MS_DEFORM_ATTN_MERGED_SLAB,
              "banded": dac.MS_DEFORM_ATTN_MERGED_BANDED}
    g = torch.Generator(device=DEVICE).manual_seed(27)
    D, P, out = 16, 4, {}
    for name, H, Q, shapes in SHARDED_CASES:
        S = sum(h * w for h, w in shapes)
        Q = Q or S
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            routes = entry_autograd(g, f"{name} {dtype}", PATH_B, Q, shapes, dtype, H=H)
            row = {"routes": routes}
            for label, (h, q) in (("sharded", (H, Q)), ("unsharded", (16, S))):
                value, locs, attn = deform_inputs(g, PATH_B, q, h, D, shapes, lo=-0.1, hi=1.1)
                value = value.to(dt)
                dout = torch.randn((PATH_B, q, h * D), generator=g, device=DEVICE).to(dt)
                F = forward[dac.plan_forward(S, D, dt, q, len(shapes), P).route]
                M = merged[dac.plan_merged(S, D, dt, q, len(shapes), P).route]
                row[label] = {
                    "forward_ms": graph_ms(lambda: F(value, shapes, locs, attn), counted=F),
                    "merged_ms": graph_ms(lambda: M(value, shapes, locs, attn, dout),
                                          counted=M)}
                if label == "sharded":
                    o = F(value, shapes, locs, attn)
                    grads = M(value, shapes, locs, attn, dout)
                    row["forward_bound"] = deform_bound(locs, shapes, D, locs, attn, o,
                                                        value=value)
                    row["merged_bound"] = merged_bound(value, locs, attn, dout, grads, shapes)
                    del o, grads
                del value, locs, attn, dout
            torch.cuda.empty_cache()
            out[f"{name} {dtype}"] = row
            sh, un = row["sharded"], row["unsharded"]
            log(f"sharded kernels {name} (B={PATH_B} H={H} Q={Q} S={S}) {dtype}: forward "
                f"{routes[0]} route, merged adjoint {routes[1]} route, held to their plain "
                f"versions through the entry; device ms forward {sh['forward_ms']:.4f} "
                f"(bound {row['forward_bound'][0]:.4f}, {row['forward_bound'][1]}) against "
                f"{un['forward_ms']:.4f} unsharded (H=16 Q=S), merged adjoint "
                f"{sh['merged_ms']:.4f} (bound {row['merged_bound'][0]:.4f}) against "
                f"{un['merged_ms']:.4f}")
    report["sharded_kernels"] = out


def tp_worker(rank: int, world: int, port: int, out: str) -> int:
    """One process of phase 27's gloo group of `world` over CUDA tensors on
    the one card: under each of TP_LAYOUTS (one data slot: both processes
    take the first DP_B images of each global batch) the f32 check's two
    SGD steps, gradients and parameters gathered whole, then the bf16
    AdamW timing."""
    import datetime

    import torch
    import torch.distributed as dist

    from poet_tpu_torch.parallel import mesh, tp

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S // 4))
    seeded = torch.load(os.path.join(out, "dp_weights.pt"), weights_only=True)
    batches = dp_batches(rank_rows(0), os.path.join(out, "dp_rotations.npz"))
    result = {}
    for lay in TP_LAYOUTS:
        cfg32, cfg16 = dp_config("float32", False), dp_config("bfloat16", False)
        layout = mesh.create_layout(*lay, nheads=cfg32.model.nheads,
                                    dim_feedforward=cfg32.model.dim_feedforward)

        def sharded():
            return tp.shard_module(dp_model(cfg32, seeded), layout)

        model = sharded()
        probed = lay == C9_LAYOUT
        with layout_probes(model) if probed else contextlib.nullcontext() as probe:
            result[f"f32 {layout_name(lay)}"] = dp_f32_steps(cfg32, model, batches)
        del model
        if probed:
            # C9: the midpoint run's records, the conditioned targets with
            # and without one process's sampling locations, each term alone
            cond = dp_batches(rank_rows(0), os.path.join(out, CONDITIONED_FILE))
            result["c9 midpoint"] = {"probe": probe,
                                     "terms": term_grads(cfg32, sharded(), batches[0])}
            model = sharded()
            with layout_probes(model) as probe:
                result["c9 conditioned"] = {"steps": dp_f32_steps(cfg32, model, cond),
                                            "probe": probe,
                                            "terms": term_grads(cfg32, sharded(), cond[0])}
            model = sharded()
            with layout_probes(model) as probe, \
                    sampling_pin(model, torch.load(os.path.join(out, PINNED_FILE),
                                                   weights_only=True)):
                result["c9 pinned"] = {"steps": dp_f32_steps(cfg32, model, cond)}
            result["c9 pinned"]["probe"] = probe
            del model
            torch.cuda.empty_cache()
        model = tp.shard_module(dp_model(cfg16, seeded), layout)
        result[f"bf16 {layout_name(lay)}"] = dp_bf16_steps(cfg16, model, rank, rank_rows(0),
                                                           layout.n_seq)
        del model
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(result, os.path.join(out, "tp_gloo.pt"))
    dist.destroy_process_group()
    return 0


def phase_serve_devices(report):
    """Phase 27c: PoseServer(devices=SERVE_DEVICES) at phase 4's config (the
    paper config, B=16, 480x640): f32 (TF32 off) against the one-device
    server within SERVE_DEVICES_RTOL of scale, bf16 reported; bf16 p50 of
    each over REQUESTS requests and the launches of the split one (each
    shard its forward's)."""
    import copy

    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = PATH_B, FLAGSHIP_HW
    images, _, t = flagship_batch(B, H, W, seed=0)
    boxes = (t["boxes"], t["labels"], t["n_boxes"])
    answers, stats, counts = {}, {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = flagship_config(dtype)
        model = init_weights(build_model(cfg), seed=0)
        servers = {"one": PoseServer(cfg, copy.deepcopy(model), batch_size=B, image_size=(H, W),
                                     device=DEVICE),
                   "split": PoseServer(cfg, model, batch_size=B, image_size=(H, W),
                                       devices=SERVE_DEVICES)}
        with tf32_off() if dtype == "float32" else contextlib.nullcontext():
            for key, server in servers.items():
                for _ in range(2):                                    # warm-up
                    server.infer(images, *boxes)
                server.reset_latency_stats()
                kernels = all_kernels()
                for k in kernels:
                    k.launches = 0
                answers[dtype, key] = [server.infer(images, *boxes) for _ in range(REQUESTS)][-1]
                if dtype == "bfloat16" and key == "split":
                    counts = [k.launches for k in kernels]
                stats[dtype, key] = server.latency_stats()
        del servers, model
        torch.cuda.empty_cache()
    want = expected(**path_launches(flagship_config("bfloat16"), FLAGSHIP_S,
                                    REQUESTS * len(SERVE_DEVICES)))
    if counts != want:
        raise AssertionError(f"serving over {SERVE_DEVICES}: launches {LAUNCH_NAMES} {counts}, "
                             f"expected {want}")
    errs = {}
    for dtype in ("float32", "bfloat16"):
        one, split = answers[dtype, "one"], answers[dtype, "split"]
        for k in ("translation", "rotation"):
            if not np.isfinite(split[k]).all() or split[k].shape != one[k].shape:
                raise AssertionError(f"serving over {SERVE_DEVICES} {dtype}: {k} not finite "
                                     f"or of shape {split[k].shape}")
        errs[dtype] = max(float(np.abs(split[k] - one[k]).max())
                          / max(float(np.abs(one[k]).max()), 1.0)
                          for k in ("translation", "rotation"))
    if errs["float32"] > SERVE_DEVICES_RTOL:
        raise AssertionError(f"serving over {SERVE_DEVICES} f32: {errs['float32']:.2e} of scale "
                             f"from the one-device server (limit {SERVE_DEVICES_RTOL})")
    report["serve_devices"] = {"errors": errs, "p50_ms": {k[1]: v["p50_ms"] for k, v in
                                                           stats.items() if k[0] == "bfloat16"}}
    report["serve_devices_launches"] = counts
    log(f"serving over {SERVE_DEVICES} (paper config, B={B} {H}x{W}, {B // len(SERVE_DEVICES)} "
        f"a replica): f32 (TF32 off) {errs['float32']:.2e} of scale from the one-device "
        f"server (limit {SERVE_DEVICES_RTOL}), bf16 {errs['bfloat16']:.2e} (reported); bf16 "
        f"p50 {stats['bfloat16', 'split']['p50_ms']:.1f} ms against "
        f"{stats['bfloat16', 'one']['p50_ms']:.1f} on one replica, {REQUESTS} requests; "
        f"launches {LAUNCH_NAMES} {counts} (each shard its forward's)")


def per_tensor_gaps(got, want):
    """[(relative L2, relative max, name)] of each first-step gradient
    tensor, largest L2 first; dp_compare's floor (GRAD_FLOOR of the largest
    element) under each denominator."""
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in want.values())
    return sorted(((float((got[n] - v).norm()) / (float(v.norm()) + floor),
                    float((got[n] - v).abs().max()) / (float(v.abs().max()) + floor), n)
                   for n, v in want.items()), reverse=True)


def c9_checks(cfg, want, got, mid_targets, cond_targets):
    """Phase 27's C9 lines and holds. `want`: this process's records
    (phase_multi_device: one process on the midpoint and the conditioned
    targets, the one-ulp control, one process in TP's order of sums with and
    without the pin); `got`: the workers' ("c9 ..." entries of tp_worker);
    the first batch's targets of each set. Prints, for each target set, the
    pairs' angles per decoder layer (every angle of the midpoint run), the
    per-layer gaps of C9_LAYOUT from one process (rotations, their
    gradient, layer outputs, corner flips per deformable-attention call)
    and each loss term's gradient gap; then, on the conditioned targets,
    each run's per-tensor gaps from one process and C9_LAYOUT's from one
    process in its order of sums. Holds the conditioned pairs in their
    band, C9_LAYOUT against one process in its order of sums at
    CONDITIONED_TOL (pinned: every tensor; unpinned: the first step outside
    the layers where the two runs' corners part), and the conditioned runs
    against one process at LAYOUT_TOL, as the midpoint run. Returns the
    numbers for the report."""
    from poet_tpu_torch.flagship import CONDITIONED_BAND_DEG

    lay = layout_name(C9_LAYOUT)
    n_enc = cfg.model.enc_layers
    out = {}
    for key, tg in (("midpoint", mid_targets), ("conditioned", cond_targets)):
        w, g = want[key], got[f"c9 {key}"]
        pairs = {"one process": pair_report(w["probe"]["rotations"], tg),
                 lay: pair_report(g["probe"]["rotations"], tg)}
        gaps = layout_gaps(g["probe"], w["probe"], tg, n_enc)
        terms = term_gaps(g["terms"], w["terms"])
        out[key] = {"pairs": pairs, "gaps": gaps, "terms": terms}
        log(f"C9 {key} targets, the first step's forward: per decoder layer, valid pairs / "
            f"smallest sin^2 of the angle to the target (that angle, degrees) / pairs on the "
            f"arccos clamp (0.5 (tr - 1) within {ARCCOS_CLAMP} of +-1): " + "; ".join(
                f"{run}: " + ", ".join(f"L{l} {p['n']} / {p['min_sin2']:.3e} "
                                       f"({p['min_sin2_deg']:.3f}) / {p['clamped']}"
                                       for l, p in enumerate(rows))
                for run, rows in pairs.items()))
        if key == "midpoint":
            log("C9 midpoint targets, every valid pair's angle to its target (degrees, one "
                "process, first step): " + "; ".join(
                    f"L{l} {p['deg']}" for l, p in enumerate(pairs["one process"])))
        log(f"C9 {key} targets, ({lay}) against one process, first step: per decoder layer, "
            f"relative L2 gap of the predicted rotations / of the loss's gradient of them "
            f"(valid pairs): " + gap_text(gaps)
            + " | each loss term's gradient alone, largest relative L2 gap (tensor): "
            + ", ".join(f"{t} {x:.2e} ({n})" for t, (x, n) in terms.items()))
    lo, hi = CONDITIONED_BAND_DEG
    for run, rows in out["conditioned"]["pairs"].items():
        worst = [(min(p["deg"]), max(p["deg"])) for p in rows]
        if any(a < lo or b > hi for a, b in worst):
            raise AssertionError(f"C9 conditioned targets ({run}): a pair outside {lo}-{hi} "
                                 f"degrees, per layer (min, max) {worst}")

    # the conditioned runs by tensor: against one process, and C9_LAYOUT
    # against one process in its order of sums
    lr, ref = cfg.optim.lr, want["conditioned"]["steps"]
    runs = {f"({lay}) pinned": got["c9 pinned"], f"({lay})": got["c9 conditioned"],
            "TP's order pinned": want["tp order pinned"], "TP's order": want["tp order"],
            "one-ulp control": want["control"]}
    errs = {}
    for label, run in runs.items():
        errs[label] = dp_compare(run["steps"], ref, lr)
        top = per_tensor_gaps(run["steps"][1], ref[1])[:TP_GAP_TOP]
        log(f"C9 conditioned targets, {label} against one process (pinned: the sampling "
            f"offsets and weights of one process's run): {dp_text(errs[label])} | by tensor "
            f"(relative L2 / max, the {TP_GAP_TOP} largest): "
            + ", ".join(f"{n} {a:.2e} / {b:.2e}" for a, b, n in top))
    for label, run in (("pinned", "tp order pinned"), ("unpinned", "tp order")):
        log(f"C9 conditioned targets, one process in TP's order of sums, {label}, against one "
            f"process, first step: " + gap_text(layout_gaps(
                want[run]["probe"], want["conditioned"]["probe"], cond_targets, n_enc)))
    control = layout_gaps(want["control"]["probe"], want["conditioned"]["probe"],
                          cond_targets, n_enc)
    log(f"C9 one-ulp control (every trained tensor one ulp up or down at random, pinned) "
        f"against one process, first step: " + gap_text(control))
    same = {}
    for label, mine, theirs in (("pinned", "c9 pinned", "tp order pinned"),
                                ("unpinned", "c9 conditioned", "tp order")):
        gaps = layout_gaps(got[mine]["probe"], want[theirs]["probe"], cond_targets, n_enc)
        errs_same = dp_compare(got[mine]["steps"], want[theirs]["steps"], lr)
        tensors = per_tensor_gaps(got[mine]["steps"][1], want[theirs]["steps"][1])
        flips = gaps["flips"]
        held = [(a, b, n) for a, b, n in tensors if not flipped_layer(n, flips)]
        loss1 = max(abs(got[mine]["steps"][0][0][k] - v) / max(abs(v), 1e-12)
                    for k, v in want[theirs]["steps"][0][0].items() if k != "grad_norm")
        same[label] = {"errors": errs_same, "flips": flips, "held": len(held),
                       "top": tensors[:TP_GAP_TOP], "loss_step1": loss1}
        log(f"C9 conditioned targets, ({lay}) {label} against one process in its order of "
            f"sums (tolerances {CONDITIONED_TOL}): {dp_text(errs_same)}; first-step losses "
            f"{loss1:.2e}; {len(held)} of {len(tensors)} tensors outside the layers whose "
            f"corners part: largest L2 {max([a for a, _, _ in held] or [0.0]):.2e} / max "
            f"{max([b for _, b, _ in held] or [0.0]):.2e} | first step: " + gap_text(gaps)
            + f" | by tensor (the {TP_GAP_TOP} largest): "
            + ", ".join(f"{n} {a:.2e} / {b:.2e}" for a, b, n in tensors[:TP_GAP_TOP]))
    out.update({"errors": errs, "tp_order": same,
                "control_layers": control["layers"]})
    for label in (f"({lay}) pinned", f"({lay})"):
        dp_hold(f"layout {lay} conditioned targets {label} against one process", errs[label],
                LAYOUT_TOL)
    dp_hold(f"layout {lay} conditioned targets pinned against one process in its order of sums",
            same["pinned"]["errors"], CONDITIONED_TOL)
    over = [(a, b, n) for a, b, n in per_tensor_gaps(got["c9 conditioned"]["steps"][1],
                                                     want["tp order"]["steps"][1])
            if not flipped_layer(n, same["unpinned"]["flips"])
            and (a > CONDITIONED_TOL[2] or b > CONDITIONED_TOL[3])]
    if same["unpinned"]["loss_step1"] > CONDITIONED_TOL[0] or over:
        raise AssertionError(f"layout {lay} conditioned targets against one process in its "
                             f"order of sums: first-step losses "
                             f"{same['unpinned']['loss_step1']:.2e}; tensors outside the layers "
                             f"whose corners part over {CONDITIONED_TOL[2:4]}: {over[:5]}")
    return out


def gap_text(gaps) -> str:
    """layout_gaps' numbers as one line."""
    return (", ".join(f"L{l} {a:.2e} / {b:.2e}" for l, (a, b) in
                      enumerate(zip(gaps["rotations"], gaps["d_rotations"])))
            + " | layer outputs: " + ", ".join(f"{n} {x:.2e}" for n, x in gaps["layers"].items())
            + " | sampling points whose corner floor(fl(fl(loc*size) - 0.5)) differs, per "
              "deformable-attention call: " + ", ".join(f"{n} {c}" for n, c in
                                                        gaps["flips"].items()))


def dp_text(e) -> str:
    """dp_compare's errors as one phrase."""
    return (f"losses {e['loss']:.2e}, grad norm {e['grad_norm']:.2e}, gradients L2 "
            f"{e['grad_l2']:.2e} ({e.get('grad_l2_at')}) / max {e['grad_max']:.2e} "
            f"({e.get('grad_max_at')}), parameters {e['param']:.2e} lr")


def phase_multi_device(report):
    """Phase 27 (see the module docstring), its files in a temporary
    directory removed afterwards."""
    import copy
    import tempfile

    import torch

    t0 = time.perf_counter()
    phase_sharded_kernels(report)
    with tempfile.TemporaryDirectory(prefix="poet_layout_") as tmp:
        out = os.path.join(tmp, "tp")
        cfg32, cfg16, seeded, model32 = dp_setup(out)
        batches = dp_batches(rank_rows(0), os.path.join(out, "dp_rotations.npz"))
        cond = dp_batches(rank_rows(0), os.path.join(out, CONDITIONED_FILE))
        one = copy.deepcopy(model32)
        with layout_probes(one) as probe:
            want = dp_f32_steps(cfg32, one, batches)
        c9 = {"midpoint": {"probe": probe,
                           "terms": term_grads(cfg32, copy.deepcopy(model32), batches[0])}}
        one = copy.deepcopy(model32)
        with layout_probes(one) as probe, sampling_pin(one) as sampling:
            c9["conditioned"] = {"steps": dp_f32_steps(cfg32, one, cond), "probe": probe,
                                 "terms": term_grads(cfg32, copy.deepcopy(model32), cond[0])}
        torch.save(sampling, os.path.join(out, PINNED_FILE))
        one = nudged(copy.deepcopy(model32))
        with layout_probes(one) as probe, sampling_pin(one, sampling):
            c9["control"] = {"steps": dp_f32_steps(cfg32, one, cond), "probe": probe}
        for pin in (None, sampling):
            one = copy.deepcopy(model32)
            with layout_probes(one) as probe, tp_order(one, C9_LAYOUT[2]), \
                    sampling_pin(one, pin):
                c9["tp order" if pin is None else "tp order pinned"] = {
                    "steps": dp_f32_steps(cfg32, one, cond), "probe": probe}
        del model32, one, sampling
        model16 = dp_model(cfg16, seeded)
        # the bf16 timing's batch: dp_bf16_steps' (the flagship targets)
        single, _, history, _ = drive_train("single process B=8", cfg16,
                                            copy.deepcopy(model16).to(DEVICE),
                                            dp_batches(rank_rows(0))[0], DP_TIMED_STEPS,
                                            path_launches(cfg16, FLAGSHIP_S, 1, train=True))
        del model16
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        got = run_dp_workers(2, out, "--tp-worker", "tp_gloo.pt")
        t_workers = time.perf_counter() - t1
    errs, layouts = {}, {}
    for lay in TP_LAYOUTS:
        name = layout_name(lay)
        errs[name] = dp_compare(got[f"f32 {name}"], want, cfg32.optim.lr)
        layouts[name] = got[f"bf16 {name}"]
        # the bf16 steps' losses against one process's, the same batch and
        # dropout masks: partials rounded to bf16 before their reduce (reported)
        layouts[name]["bf16_loss_gap"] = max(abs(a / b["loss"] - 1) for a, b in
                                             zip(layouts[name]["loss"], history))
    gaps = {name: per_tensor_gaps(got[f"f32 {name}"][1], want[1])[:TP_GAP_TOP]
            for name in errs}
    for name, gap in gaps.items():
        log(f"layout {name}, midpoint targets: gradient gap from one process by tensor "
            f"(relative L2 / max, the {TP_GAP_TOP} largest): "
            + ", ".join(f"{n} {a:.2e} / {b:.2e}" for a, b, n in gap))
    report["layouts"] = {"single": single, "errors": errs, "bf16": layouts,
                         "workers_s": t_workers, "grad_gaps": gaps}
    report["layout_launches"] = {name: r["launches"] for name, r in layouts.items()}
    text = "; ".join(
        f"({name}) losses {e['loss']:.2e}, grad norm {e['grad_norm']:.2e}, gradients L2 "
        f"{e['grad_l2']:.2e} ({e.get('grad_l2_at')}) / max {e['grad_max']:.2e} "
        f"({e.get('grad_max_at')}), parameters {e['param']:.2e} lr; bf16 step p50 "
        f"{layouts[name]['p50_ms']:.1f} ms / busy {layouts[name]['busy_ms']:.2f} ms a "
        f"process, its losses {layouts[name]['bf16_loss_gap']:.2e} from one process's, "
        f"launches {layouts[name]['launches']}"
        for name, e in errs.items())
    log(f"layouts (paper config, {FLAGSHIP_HW[0]}x{FLAGSHIP_HW[1]}, B={DP_B}, 2 processes in a "
        f"gloo group on the one card: a rehearsal, not a multi-card figure), f32 SGD 2 steps "
        f"(TF32 off) against one process on the same images (tolerances {LAYOUT_TOL}): {text} "
        f"| one process bf16 p50 {single['p50_ms']:.1f} ms / busy {single['busy_ms']:.2f} ms "
        f"| launches {LAUNCH_NAMES} over {DP_TIMED_STEPS + 1} steps | workers {t_workers:.1f} s")
    for name, e in errs.items():
        dp_hold(f"layout {name} f32 against one process on the same {DP_B} images", e,
                LAYOUT_TOL)
    report["layouts"]["c9"] = c9_checks(cfg32, c9, got, batches[0][2], cond[0][2])
    phase_serve_devices(report)
    log(f"phase 27 in {time.perf_counter() - t0:.1f} s")


# phase 28: requests per artifact and per live server, each through `infer`
EXPORT_REQUESTS = 8
# the f32 tracker artifact against the live server on the card (TF32 off),
# relative to the output scale: one program, the same kernels and cuDNN
EXPORT_F32_RTOL = 1e-5


def export_case(report, tmp, name, cfg, model, images, targets, per_request, tol):
    """Export `model` at `cfg`, load the artifact through
    `ExportedPoseServer(device=DEVICE)` and serve EXPORT_REQUESTS requests
    through it and through a live `PoseServer` of the same model: the
    artifact's launches per request equal to the live server's and to the
    route rules' (`per_request`); detections equal, poses within `tol` of
    scale; both servers' p50/p95 (the artifact's first, the same count)."""
    import torch

    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer, export_model

    B, (H, W) = images.shape[0], images.shape[1:3]
    path = os.path.join(tmp, name)
    t0 = time.perf_counter()
    export_model(cfg, model, path, batch_size=B, image_size=(H, W))
    export_s = time.perf_counter() - t0
    size_mb = os.path.getsize(os.path.join(path, "module.pt2")) / 2**20
    t0 = time.perf_counter()
    exported = ExportedPoseServer(path, device=DEVICE)
    load_s = time.perf_counter() - t0
    if exported.meta["platforms"] != ["cpu", "cuda"]:
        raise AssertionError(f"{name}: platforms {exported.meta['platforms']}")
    live = PoseServer(cfg, model, batch_size=B, image_size=(H, W), device=DEVICE)
    args = () if targets is None else (targets["boxes"], targets["labels"], targets["n_boxes"])
    for server in (exported, live):
        for _ in range(2):                           # warm-up: cuDNN/cuBLAS init
            server.fetch(server.infer_async(images, *args))
        server.reset_latency_stats()
    kernels = all_kernels()
    expect = expected(**{k: n * EXPORT_REQUESTS for k, n in per_request.items()})
    answers, counts = {}, {}
    for label, server in (("exported", exported), ("live", live)):
        for k in kernels:
            k.launches = 0
        answers[label] = [server.infer(images, *args) for _ in range(EXPORT_REQUESTS)]
        counts[label] = [k.launches for k in kernels]
        if counts[label] != expect:
            raise AssertionError(f"{name} {label}: launches {LAUNCH_NAMES} {counts[label]} for "
                                 f"{EXPORT_REQUESTS} requests, expected {per_request} per "
                                 f"request and no other")
    got, want = answers["exported"][0], answers["live"][0]
    if set(got) != set(want):
        raise AssertionError(f"{name}: the artifact answers {sorted(got)}, the live server "
                             f"{sorted(want)}")
    for res in answers["exported"]:
        for k in ("boxes", "classes", "n_boxes"):
            if not np.array_equal(res[k], want[k]):
                raise AssertionError(f"{name}: the artifact's {k} differ from the live server's")
    err = 0.0
    for k in ("translation", "rotation", "translation_var", "rotation_var"):
        if k in want:
            scale = max(float(np.abs(want[k]).max()), 1.0)
            e = max(float(np.abs(r[k] - want[k]).max()) for r in answers["exported"]) / scale
            if not (np.isfinite(got[k]).all() and e <= tol):
                raise AssertionError(f"{name}: artifact {k} max err / scale {e} > {tol}")
            err = max(err, e)
    rotations_ok(got["rotation"])
    ex, lv = exported.latency_stats(), live.latency_stats()
    # the program's operator calls, its loops' and branches' bodies included,
    # and how many of them are the trace's dtype/device assertions
    calls = [n.target for m in exported.program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule)
             for n in m.graph.nodes if n.op == "call_function"]
    asserts = sum("_assert_tensor_metadata" in str(t) for t in calls)
    log(f"export {name}: {cfg.model.dtype} B={B} {H}x{W} bbox_mode {cfg.model.bbox_mode}: "
        f"export {export_s:.2f} s, load {load_s:.2f} s, module.pt2 {size_mb:.1f} MB, "
        f"{len(calls)} operator calls in the program ({asserts} metadata assertions); "
        f"{EXPORT_REQUESTS} requests each: launches {per_request} per request (the live "
        f"server's); detections equal, poses within {err:.3e} of scale (tol {tol}); "
        f"ExportedPoseServer.infer p50 {ex['p50_ms']:.3f} ms p95 {ex['p95_ms']:.3f} ms, "
        f"PoseServer.infer p50 {lv['p50_ms']:.3f} ms p95 {lv['p95_ms']:.3f} ms")
    report.setdefault("exported", {})[name] = {
        "launches": counts["exported"], "export_s": export_s, "load_s": load_s,
        "artifact_mb": size_mb, "p50_ms": ex["p50_ms"], "p95_ms": ex["p95_ms"],
        "live_p50_ms": lv["p50_ms"], "live_p95_ms": lv["p95_ms"], "pose_err": err,
        "program_calls": len(calls), "program_asserts": asserts}
    del exported, live
    torch.cuda.empty_cache()


def phase_export(report):
    """Phase 28 (see the module docstring), the artifacts in a temporary
    directory removed afterwards."""
    import tempfile

    import torch

    from poet_tpu_torch import flagship
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    t0 = time.perf_counter()
    B, (H, W) = PATH_B, FLAGSHIP_HW
    images, _, targets = flagship.flagship_batch(B, H, W, seed=0)
    with tempfile.TemporaryDirectory(prefix="poet_export_") as tmp:
        for name, impl in (("serve", None), ("serve_pallas", "pallas")):
            cfg = flagship.flagship_config("bfloat16")
            if impl:
                cfg.model.enc_deform_impl = cfg.model.dec_deform_impl = impl
            export_case(report, tmp, name, cfg, init_weights(build_model(cfg), seed=0), images,
                        targets, path_launches(cfg, FLAGSHIP_S, 1), E2E_RTOL)
        cfg = flagship.detect_pose_config("bfloat16")
        export_case(report, tmp, "detect", cfg, flagship.detect_pose_model(cfg),
                    flagship.detect_pose_batch(B, H, W, seed=0)[0], None,
                    {**path_launches(cfg, FLAGSHIP_S, 1), **roi_launches(cfg, 1)}, E2E_RTOL)
        cfg = flagship.yolo_detect_pose_config("bfloat16")
        export_case(report, tmp, "yolo", cfg, flagship.yolo_detect_pose_model(cfg),
                    flagship.yolo_detect_pose_batch(B, H, W, seed=0)[0], None,
                    {**path_launches(cfg, YOLO_S, 1), "stem": 3, "epilogue": YOLO_EPILOGUE},
                    E2E_RTOL)
        cfg = flagship.flagship_config("float32")
        f32_images, _, f32_targets = flagship.flagship_batch(2, H, W, seed=0)
        with tf32_off():
            export_case(report, tmp, "serve_f32", cfg, init_weights(build_model(cfg), seed=0),
                        f32_images, f32_targets, path_launches(cfg, FLAGSHIP_S, 1),
                        EXPORT_F32_RTOL)
    report["exported_launches"] = {f"{name}_exported": report["exported"][name]["launches"]
                                   for name in ("serve", "serve_pallas", "detect", "yolo")}
    log(f"phase 28 in {time.perf_counter() - t0:.1f} s (peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")


# phase 29: the final NMS's candidate cap on the Mask R-CNN request; the
# YOLO gt requests and train steps per timing round, and the rounds' order:
# the parent commit's path (the backbone's decode and NMS run though nothing
# reads them) against this one's, in turns
NMS_CAP = 1000
YOLO_GT_REQUESTS, YOLO_GT_STEPS = 8, 4
YOLO_GT_ROUNDS = ("parent", "change", "change", "parent") * 2
# roi_align card (plain torch) against the CPU, f32, relative to max |feature|:
# the same f32 arithmetic
ROI_SINGLE = (120, 160, 256, 1000)           # (H, W, C) of the stride-4 level, boxes


@contextlib.contextmanager
def counting_calls(obj, *names):
    """{name: calls} of the methods `names` of `obj` while the context is open."""
    calls = {n: 0 for n in names}

    def wrap(n, fn):
        def counted(*args, **kwargs):
            calls[n] += 1
            return fn(*args, **kwargs)
        return counted

    for n in names:
        setattr(obj, n, wrap(n, getattr(obj, n)))
    try:
        yield calls
    finally:
        for n in names:
            delattr(obj, n)


@contextlib.contextmanager
def detections_forced(backbone):
    """The backbone decodes and runs its NMS whatever its caller asks: the
    parent commit's gt/jitter path, for phase 29's timing rounds."""
    forward = backbone.forward
    backbone.forward = lambda images, pad_mask, detections=True: forward(images, pad_mask, True)
    try:
        yield
    finally:
        del backbone.forward


def phase_capped_detect(report):
    """Phase 29a: one Mask R-CNN detect+pose request with the final NMS
    capped at NMS_CAP candidates (the launches of phase 10's path, finite
    answers); the capped selection on the request's own candidates, boxes
    snapped to whole pixels, on the card against the CPU port."""
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import detect_pose_batch, detect_pose_config, detect_pose_model

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = detect_pose_config("bfloat16")
    Q = cfg.model.num_queries
    server = PoseServer(cfg, detect_pose_model(cfg), batch_size=B, image_size=(H, W))
    detector = server.model.backbone
    detector.nms_candidates = NMS_CAP
    images, _ = detect_pose_batch(B, H, W, seed=0)
    server.infer(images)                             # warm-up
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    seen = []
    select = detector.select
    detector.select = lambda *a: seen.append([t.detach().clone() for t in a]) or select(*a)
    try:
        res = server.infer(images)
    finally:
        del detector.select
    counts = [k.launches for k in kernels]
    want = expected(**path_launches(cfg, FLAGSHIP_S, 1), **roi_launches(cfg, 1))
    if counts != want:
        raise AssertionError(f"capped detect: launches {LAUNCH_NAMES} {counts}, expected {want}")
    check_detect_outputs(res, B, Q)
    boxes_pc, masked, labels_pc = seen[0]
    boxes_pc = boxes_pc.round()                      # shared whole-pixel boxes
    card = detector.select(boxes_pc, masked, labels_pc)
    cpu = detector.select(boxes_pc.cpu(), masked.cpu(), labels_pc.cpu())
    valid = cpu[1]
    if not (torch.equal(card[1].cpu(), valid)
            and torch.equal(torch.where(valid, card[0].cpu(), 0), torch.where(valid, cpu[0], 0))):
        raise AssertionError("capped NMS: the card's selection differs from the CPU port's on "
                             "the same whole-pixel candidates")
    detector.nms_candidates = None
    sel, keep = (t.cpu() for t in detector.select(boxes_pc, masked, labels_pc))
    same = (keep == valid).all(-1) & (torch.where(keep, sel, -1)
                                      == torch.where(valid, cpu[0], -1)).all(-1)
    differ = int((~same).sum())
    log(f"capped detect: Mask R-CNN detect+pose bf16 B={B} {H}x{W}, the final NMS capped at "
        f"{NMS_CAP} of {masked.shape[1]} candidates: launches {LAUNCH_NAMES} {counts}, "
        f"{int(res['n_boxes'].sum())} selected queries, finite, SO(3); the capped selection on "
        f"the request's candidates snapped to whole pixels: card == CPU port, "
        f"{int(valid.sum())} detections; images whose capped selection differs from the "
        f"exact one: {differ} of {B}")
    report["capped_detect"] = {"launches": counts, "detections": int(valid.sum()),
                               "images_differing_from_exact": differ}
    del server, detector
    torch.cuda.empty_cache()


def phase_roi_single():
    """Phase 29b: `ops/detection.py:roi_align` (single level, plain torch)
    on the card against the CPU port, aligned and not, sampling ratios 1 and
    2; the single-image `multiscale_roi_align` view (the kernel) against its
    CPU plain version, f32."""
    import torch

    from poet_tpu_torch.ops.detection import multiscale_roi_align, roi_align

    g = torch.Generator(device=DEVICE).manual_seed(29)
    H, W, C, R = ROI_SINGLE
    feats = torch.randn((H, W, C), generator=g, device=DEVICE)
    boxes = roi_boxes(g, 1, R, *FLAGSHIP_HW, "proposals")[0]
    scale = float(feats.abs().max())
    errs = {}
    with tf32_off():
        for aligned in (False, True):
            for ratio in (1, 2):
                got = roi_align(feats, boxes, 7, 0.25, ratio, aligned)
                ref = roi_align(feats.cpu(), boxes.cpu(), 7, 0.25, ratio, aligned)
                errs[f"aligned={aligned} ratio={ratio}"] = float(
                    (got.cpu() - ref).abs().max()) / scale
        levels = [torch.randn((h, w, 16), generator=g, device=DEVICE)
                  for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
        n0 = all_kernels()
        before = [k.launches for k in n0]
        got = multiscale_roi_align(levels, ROI_STRIDES, boxes)
        ref = multiscale_roi_align([f.cpu() for f in levels], ROI_STRIDES, boxes.cpu())
        errs["multiscale view"] = float((got.cpu() - ref).abs().max()) / max(
            float(f.abs().max()) for f in levels)
        launched = sum(k.launches for k in n0) - sum(before)
    bad = {k: e for k, e in errs.items() if not e <= ROI_F32_RTOL}
    if bad or launched != 1:
        raise AssertionError(f"roi_align card vs CPU over {ROI_F32_RTOL} of max |feature|: {bad}; "
                             f"the multiscale view launched {launched} kernels, not 1")
    log(f"roi_align (single level {H}x{W} C={C}, {R} proposals, f32): card vs CPU port, max "
        f"err / max |feature|: " + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
        + f" (tol {ROI_F32_RTOL}); the multiscale view one RoIAlign kernel launch")


def phase_yolo_gt(report):
    """Phase 29c: YOLOv4-CSP in gt mode: requests through PoseServer and
    train steps, neither calling the backbone's decode nor its NMS (no fixed
    point runs), the launches of the path (the stem's three, the
    deformable ones); p50 against the parent commit's path, which decodes
    and runs the NMS it does not read, in turns (YOLO_GT_ROUNDS)."""
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import (
        flagship_batch,
        yolo_detect_pose_config,
        yolo_detect_pose_model,
    )
    from poet_tpu_torch.ops.detection import FIXED_POINT

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = yolo_detect_pose_config("bfloat16")
    cfg.model.bbox_mode = "gt"
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    boxes = (targets["boxes"], targets["labels"], targets["n_boxes"])
    server = PoseServer(cfg, yolo_detect_pose_model(cfg), batch_size=B, image_size=(H, W))
    backbone = server.model.backbone
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.infer(images, *boxes)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    FIXED_POINT.reset()
    with counting_calls(backbone, "decode", "detect") as calls:
        results = [server.infer(images, *boxes) for _ in range(YOLO_GT_REQUESTS)]
    counts = [k.launches for k in kernels]
    want = expected(**path_launches(cfg, YOLO_S, YOLO_GT_REQUESTS), stem=3 * YOLO_GT_REQUESTS,
                    epilogue=YOLO_EPILOGUE * YOLO_GT_REQUESTS)
    if counts != want:
        raise AssertionError(f"yolo gt serve: launches {LAUNCH_NAMES} {counts}, expected {want}")
    if any(calls.values()) or FIXED_POINT.calls or FIXED_POINT.iterations:
        raise AssertionError(f"yolo gt serve: the backbone decoded or ran its NMS: {calls}, "
                             f"{FIXED_POINT.calls} fixed points")
    for res in results:
        for k in ("translation", "rotation"):
            if not np.isfinite(res[k]).all():
                raise AssertionError(f"yolo gt serve: non-finite {k}")
        rotations_ok(res["rotation"])

    def p50s(run, n, backbone):
        out = {}
        for mode in YOLO_GT_ROUNDS:
            with detections_forced(backbone) if mode == "parent" else contextlib.nullcontext():
                run()                                # one untimed
                ms = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    run()
                    ms.append((time.perf_counter() - t0) * 1e3)
            out.setdefault(mode, []).append(float(np.percentile(ms, 50)))
        return out

    FIXED_POINT.reset()
    serve = p50s(lambda: server.infer(images, *boxes), YOLO_GT_REQUESTS, backbone)
    # the parent's rounds alone run fixed points: what the change skips
    parent_requests = (YOLO_GT_REQUESTS + 1) * YOLO_GT_ROUNDS.count("parent")
    skipped = FIXED_POINT.iterations / parent_requests
    del server, backbone
    torch.cuda.empty_cache()

    model = yolo_detect_pose_model(cfg).to(DEVICE)
    FIXED_POINT.reset()
    with counting_calls(model.backbone, "decode", "detect") as calls:
        stats, launches, history, opt = drive_train(
            "yolo gt train", cfg, model, (images, pad_mask, targets), YOLO_GT_STEPS,
            {**path_launches(cfg, YOLO_S, 1, train=True), "stem": 3,
             "epilogue": YOLO_EPILOGUE})
    if any(calls.values()) or FIXED_POINT.calls:
        raise AssertionError(f"yolo gt train: the backbone decoded or ran its NMS: {calls}, "
                             f"{FIXED_POINT.calls} fixed points")
    from poet_tpu_torch.engine.train import fetch_metrics, make_train_step, prepare_batch

    step = make_train_step(model, cfg, opt)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    steps = p50s(lambda: fetch_metrics(step(*prepare_batch(cfg, images, pad_mask, targets,
                                                           DEVICE), gen)), YOLO_GT_STEPS,
                  model.backbone)
    for label, x in (("serve", serve), ("train", steps)):
        log(f"yolo gt {label} p50 ms by round ({', '.join(YOLO_GT_ROUNDS)}; parent: the "
            f"backbone's decode and NMS run as the parent commit runs them): parent "
            f"{x['parent']}, change {x['change']}; medians parent "
            f"{np.median(x['parent']):.3f}, change {np.median(x['change']):.3f}")
    log(f"yolo gt: the parent's path ran {skipped:.1f} NMS fixed-point iterations a request "
        f"(one host wait each): what the change skips")
    log(f"yolo gt: YOLOv4-CSP paper config bf16 B={B} {H}x{W} in gt mode: {YOLO_GT_REQUESTS} "
        f"requests, launches {LAUNCH_NAMES} {counts}; {YOLO_GT_STEPS + 1} train steps, "
        f"launches {launches}, loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}, "
        f"busy {stats['busy_ms']:.2f} ms; no decode, no NMS fixed point; finite, SO(3)")
    report["yolo_gt"] = {"serve_launches": counts, "train_launches": launches,
                         "serve_p50_ms": serve, "train_p50_ms": steps,
                         "parent_nms_iterations_per_request": skipped,
                         "train_busy_ms": stats["busy_ms"]}
    del model, opt, step
    torch.cuda.empty_cache()


def phase_leftovers(report):
    """Phase 29 (see the module docstring)."""
    t0 = time.perf_counter()
    phase_capped_detect(report)
    phase_roi_single()
    phase_yolo_gt(report)
    log(f"phase 29 in {time.perf_counter() - t0:.1f} s")


# phase 30: poet_tpu's orbax checkpoint (tests/data/orbax_resume, written by
# tests/test_torch_orbax_resume.py:write_resume_fixture) resumed for one step
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_resume")
ORBAX_B, ORBAX_HW, ORBAX_SEED = 2, 128, 5
ORBAX_LOSS_RTOL = 1e-5            # ROADMAP C's train-step tolerances: losses
ORBAX_PARAM_LR = 1e-3             # and every parameter within this share of lr


def orbax_batch(cfg, seed=ORBAX_SEED):
    """ORBAX_B ORBAX_HW x ORBAX_HW images and gt targets of the config's
    queries and classes, cut from `flagship.flagship_batch`'s draw."""
    from poet_tpu_torch.flagship import flagship_batch

    Q, ncls = cfg.model.num_queries, cfg.model.n_classes
    images, pad_mask, t = flagship_batch(ORBAX_B, ORBAX_HW, ORBAX_HW, seed)
    n = np.minimum(t["n_boxes"], Q).astype(np.int32)
    valid = np.arange(Q)[None] < n[:, None]
    labels = (t["labels"][:, :Q] - 1) % ncls + 1
    targets = {"boxes": np.where(valid[..., None], t["boxes"][:, :Q], -1.0).astype(np.float32),
               "labels": np.where(valid, labels, -1).astype(np.int32), "n_boxes": n,
               "relative_position": t["relative_position"][:, :Q],
               "relative_rotation": t["relative_rotation"][:, :Q]}
    return images, pad_mask, targets


def orbax_config():
    """The port's config of the fixture, from the checkpoint's own
    config.json (poet_tpu's), its darknet cfg path made absolute."""
    from poet_tpu_torch.config import PoETConfig

    with open(os.path.join(ORBAX_FIXTURE, "checkpoint", "config.json")) as f:
        cfg = PoETConfig.from_json(f.read())
    cfg.backbone.cfg_path = os.path.join(ROOT, cfg.backbone.cfg_path)
    return cfg


def orbax_resumed_step(cfg, device, batch):
    """The model and optimizer resumed from the fixture on `device`, then
    (model, stem and epilogue calls, encoder tokens, a function running one
    step and returning its metrics): the resume itself is outside the step."""
    import torch

    from poet_tpu_torch.engine.checkpoint import load_resume, merge_params
    from poet_tpu_torch.engine.train import (fetch_metrics, make_optimizer, make_train_step,
                                             prepare_batch)
    from poet_tpu_torch.models import build_model

    ckpt = os.path.join(ORBAX_FIXTURE, "checkpoint")
    model = build_model(cfg)
    payload, start = load_resume(ckpt, model=model, cfg=cfg)
    missing, unexpected = merge_params(model, payload["model"])
    if missing or unexpected or start != 1:
        raise AssertionError(f"orbax resume: missing {missing}, unexpected {unexpected}, "
                             f"start epoch {start}")
    model.to(device)
    opt = make_optimizer(cfg, model, steps_per_epoch=1000)
    opt.load_optax_state(payload["optax"], payload["step"])
    step = make_train_step(model, cfg, opt)
    gen = torch.Generator(device=device).manual_seed(0)
    seen = {"stem": 0, "epilogue": 0, "tokens": 0}
    body = model.backbone.body
    stem, epilogue = body._stem, body._epilogue

    def counted_stem(*a, **k):
        seen["stem"] += 1
        return stem(*a, **k)

    def counted_epilogue(*a, **k):
        seen["epilogue"] += 1
        return epilogue(*a, **k)

    def tokens(mod, args, out):                     # a level's map, NCHW
        seen["tokens"] += out.shape[-2] * out.shape[-1]

    def run():
        body._stem, body._epilogue = counted_stem, counted_epilogue
        hooks = [p.register_forward_hook(tokens) for p in model.input_proj]
        try:
            return fetch_metrics(step(*prepare_batch(cfg, *batch, device), gen))
        finally:
            del body._stem, body._epilogue
            for h in hooks:
                h.remove()

    return model, seen, run


def phase_orbax_resume(report):
    """Phase 30: resume from poet_tpu's orbax checkpoint."""
    import torch

    from poet_tpu_torch import native
    from poet_tpu_torch.utils.orbax_format import read_pytree, tree_digests

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"orbax: libzstd {native.zstd_library_path()}, version {native.zstd_version()}")
    ckpt = os.path.join(ORBAX_FIXTURE, "checkpoint")
    read_ms = []
    for _ in range(5):
        t = time.perf_counter()
        tree = read_pytree(ckpt)
        read_ms.append((time.perf_counter() - t) * 1e3)
    with open(os.path.join(ORBAX_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    got = tree_digests(tree)
    bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
    if bad:
        raise AssertionError(f"orbax: {len(bad)} leaves differ from digests.json: {bad[:5]}")
    n_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt) for f in fs)
    log(f"orbax: read {ckpt} ({n_bytes} bytes, {len(got)} array leaves) in "
        f"{float(np.median(read_ms)):.2f} ms (median of 5 on the host; warm file cache), "
        f"every leaf's SHA-256 equal to digests.json; {card}")

    cfg = orbax_config()
    batch = orbax_batch(cfg)
    kernels = all_kernels()
    n0 = [k.launches for k in kernels]
    cpu_model, cpu_seen, cpu_run = orbax_resumed_step(cfg, "cpu", batch)
    cpu_metrics = cpu_run()
    if [k.launches for k in kernels] != n0:
        raise AssertionError("orbax: the CPU step launched a CUDA kernel")
    with tf32_off():
        card_model, card_seen, card_run = orbax_resumed_step(cfg, DEVICE, batch)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t = time.perf_counter()
        card_metrics = card_run()
        step_ms = (time.perf_counter() - t) * 1e3
        launches = [k.launches for k in kernels]
    S = cpu_seen["tokens"]
    want_launches = expected(**path_launches(cfg, S, 1, train=True), stem=cpu_seen["stem"],
                             epilogue=cpu_seen["epilogue"])
    if (launches != want_launches or card_seen["stem"] != cpu_seen["stem"]
            or card_seen["epilogue"] != cpu_seen["epilogue"]):
        raise AssertionError(f"orbax: the resumed card step launched {LAUNCH_NAMES} {launches}, "
                             f"expected {want_launches} (S={S}, {cpu_seen['stem']} stem and "
                             f"{cpu_seen['epilogue']} epilogue convs)")
    if not cpu_seen["stem"]:
        raise AssertionError("orbax: the fixture's darknet ran no stem conv")
    loss_err = max(abs(card_metrics[k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu_metrics.items() if k != "grad_norm")
    lr = cfg.optim.lr
    cpu_p = dict(cpu_model.named_parameters())
    param_err, worst = 0.0, ""
    for name, p in card_model.named_parameters():
        err = float((p.detach().cpu().double() - cpu_p[name].detach().double()).abs().max())
        if err > param_err:
            param_err, worst = err, name
    if not (loss_err <= ORBAX_LOSS_RTOL and param_err <= ORBAX_PARAM_LR * lr):
        raise AssertionError(f"orbax: resumed step card vs CPU: losses max rel err {loss_err:.3e} "
                             f"(tol {ORBAX_LOSS_RTOL}), parameters max err {param_err:.3e} "
                             f"({worst}; tol {ORBAX_PARAM_LR} x lr = {ORBAX_PARAM_LR * lr:.1e})")
    log(f"orbax: one step resumed from poet_tpu's checkpoint (YOLOv4-CSP mini + hidden "
        f"{cfg.model.hidden_dim} {cfg.model.enc_layers}+{cfg.model.dec_layers} layers, gt, f32, "
        f"SGD, B={ORBAX_B}, {ORBAX_HW}x{ORBAX_HW}, S={S}, TF32 off), card vs CPU port: losses "
        f"max rel err {loss_err:.3e} (tol {ORBAX_LOSS_RTOL}), parameters max err "
        f"{param_err:.3e} = {param_err / lr:.2e} x lr ({worst}; tol {ORBAX_PARAM_LR} x lr); "
        f"loss {cpu_metrics['loss']:.5f}; launches {LAUNCH_NAMES} {launches}; "
        f"step {step_ms:.1f} ms (host clock, first call); {card}")
    report["orbax_resume"] = {"launches": launches, "read_ms": float(np.median(read_ms)),
                              "loss_rel_err": loss_err, "param_err_over_lr": param_err / lr}
    del cpu_model, card_model
    torch.cuda.empty_cache()
    log(f"phase 30 in {time.perf_counter() - t0:.1f} s")


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
    if argv[:1] == ["--dp-worker"] and len(argv) == 5:     # phase 26's processes
        sys.path.insert(0, ROOT)
        return dp_worker(int(argv[1]), int(argv[2]), int(argv[3]), argv[4])
    if argv[:1] == ["--tp-worker"] and len(argv) == 5:     # phase 27's processes
        sys.path.insert(0, ROOT)
        return tp_worker(int(argv[1]), int(argv[2]), int(argv[3]), argv[4])
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(n) for n in argv[1].split(",")}
    elif argv:
        print("usage: chip_smoke.py [--only N,N,...]  (phase numbers 3-31; 1-2 always run)",
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
              19: lambda: phase_dense(report), 20: lambda: phase_paths(report),
              21: lambda: phase_v2(report), 22: lambda: phase_probes(report),
              23: lambda: phase_cli(report), 24: lambda: phase_variants(report),
              25: lambda: phase_train_detections(report), 26: lambda: phase_data(report),
              27: lambda: phase_multi_device(report), 28: lambda: phase_export(report),
              29: lambda: phase_leftovers(report), 30: lambda: phase_orbax_resume(report),
              31: lambda: phase_epilogue(report)}
    spans = []
    for first, last in ((3, 8), (9, 11), (12, 14), (15, 17), (18, 20), (21, 22), (23, 23),
                        (24, 25), (26, 26), (27, 27), (28, 28), (29, 29), (30, 30),
                        (31, 31)):
        t0 = time.perf_counter()
        for n in range(first, last + 1):
            if only is None or n in only:
                phases[n]()
        spans.append(f"phases {first}-{last} in {time.perf_counter() - t0:.1f} s")
    log(f"{', '.join(spans)}; the whole script {time.perf_counter() - t_start:.1f} s on {card}")
    if only is not None:
        log(f"partial run (phases 1, 2 and {sorted(only)}): no kernel report")
        return 0

    fwd_enc, fwd_dec = report["fwd_encoder"]["bf16"], report["fwd_decoder"]["bf16"]
    fwd_yolo = report["fwd_yolo pyramid"]["bf16"]
    adj, adj_f32 = report["adjoint_encoder"]["bf16"], report["adjoint_encoder"]["f32"]
    adj_dec, adj_dec_f32 = report["adjoint_decoder"]["bf16"], report["adjoint_decoder"]["f32"]
    d_yolo = report["merged_yolo pyramid"]["d_value"]["bf16"]
    m_enc, m_dec = report["merged_encoder"]["bf16"], report["merged_decoder"]["bf16"]
    m_yolo = report["merged_yolo pyramid"]["bf16"]
    m_yolo_grid = report["merged_yolo pyramid"]["bf16_grid"]
    m_yolo_f32 = report["merged_yolo pyramid"]["f32"]
    m_yolo_dec = report["merged_yolo decoder"]["bf16"]
    paths = {"serve": report["launches"], "train": report["train_launches"],
             "detect": report["detect"]["launches"], "yolo": report["yolo"]["launches"],
             "eval": report["eval_launches"], "eval_backbone": report["eval_backbone_launches"],
             "serve_pallas": report["launches_pallas"],
             "train_pallas": report["train_launches_pallas"],
             "train_pair": report["train_launches_pair"], **report["cli_launches"],
             "serve_variants": report["serve_variants_launches"],
             "train_variants": report["train_variants_launches"],
             "train_calibrate": report["train_calibrate_launches"],
             "train_detections_maskrcnn": report["train_detections_maskrcnn_launches"],
             "train_detections_yolov4": report["train_detections_yolov4_launches"],
             "train_data_parallel": report["dp_launches"],
             **{f"train_layout_{name}": counts
                for name, counts in report["layout_launches"].items()},
             "serve_devices": report["serve_devices_launches"],
             **report["exported_launches"],
             "detect_capped": report["capped_detect"]["launches"],
             "serve_yolo_gt": report["yolo_gt"]["serve_launches"],
             "train_yolo_gt": report["yolo_gt"]["train_launches"],
             "train_orbax_resume": report["orbax_resume"]["launches"]}
    roi, nn = report["roi"], report["nn"]
    errs, bounds = report["adjoint_max_abs_err"], report["adjoint_bounds"]
    src, tpu = "poet_tpu_torch/csrc/", "poet_tpu/ops/deform_attn_pallas_v3.py:"
    dense_enc = report["dense_encoder"]
    dense, dense_dec = dense_enc["bf16"], report["dense_decoder"]["bf16"]
    dense_src = src + "ms_deform_attn_dense.cu"
    dense_tpu = "poet_tpu/ops/deform_attn_pallas.py:"
    v2_enc = report["v2_encoder"]
    v2 = v2_enc["bf16"]
    kpad, var, var_yolo = report["kpad"], report["variants"], report["variants_yolo"]
    gat = report["gather"]["4800-row table"]
    probes = {"v2": report["v2_launches"], **report["probe_launches"]}

    def launched(key):
        """A kernel's launches on each path, and their sum."""
        i = KERNEL_KEYS.index(key)
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
    epi, epi_train = report["epilogue"][EPILOGUE_B], report["epilogue"][EPILOGUE_TRAIN_B]
    kernels = [
        {"name": "ms_deform_attn_fwd", "route": "cuda", "source": src + "ms_deform_attn_fwd.cu",
         "replaces": tpu + "221", **launched("fwd"),
         "max_abs_err": report["max_abs_err"],
         **timed(fwd_dec["direct"], fwd_dec["plain"], fwd_dec["bound"]),
         "encoder_ms": fwd_enc["direct"],
         "ms_are": "the direct route at its path's shape, the decoder (B=16, Q=10, S=1600, "
                   "H=16, D=16, L=P=4), bf16; encoder_ms: the same route at the encoder "
                   "shape, where the rule takes the slab route"},
        {"name": "ms_deform_attn_bwd_dvalue", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "434", **launched("d_value"),
         "max_abs_err": errs["d_value"],
         **timed(adj["dvalue"], adj["plain_dvalue"], bounds["dvalue"]),
         "plain_adjoint_ms": adj["plain"], "slab_ms": adj["dvalue_slab"],
         "grid_init_ms": report["adjoint_grid"]["bf16"]["dvalue"],
         "grid_init_slab_ms": report["adjoint_grid"]["bf16"]["dvalue_slab"],
         "ms_are": "the atomic scatter at the encoder shape (B=16, Q=S=1600, H=16, D=16, "
                   "L=P=4), where the rule takes it, bf16, device time from graph replays, its "
                   "zeroed buffer and cast included; slab_ms: the slab route there, same call; "
                   "grid_init: at a model's sampling locations (grid_locations)"},
        {"name": "ms_deform_attn_bwd_dloc", "route": "cuda",
         "source": src + "ms_deform_attn_point.cuh", "replaces": tpu + "470", **launched("d_loc"),
         "max_abs_err": max(errs["d_loc"], errs["d_attn"]),
         **timed(adj_dec["dloc"], adj_dec["plain_dloc"], adj_dec["dloc_bound"]),
         "plain_adjoint_ms": adj_dec["plain"], "slab_ms": adj_dec["dloc_slab"],
         "f32_ms": adj_dec_f32["dloc"], "encoder_ms": adj["dloc"],
         "encoder_bound_ms": bounds["dloc"][0],
         "grid_init_encoder_ms": report["adjoint_grid"]["bf16"]["dloc"],
         "ms_are": "the direct route at its path's shape, the decoder (B=16, Q=10, S=1600, "
                   "H=16, D=16, L=P=4), bf16, device time from graph replays; slab_ms: the "
                   "slab route there, same call; encoder: Q=S=1600, where the rule takes the "
                   "slab route (uniform locations; grid_init: a model's); bound_ms counts the "
                   "value rows under the run's in-map corners (value_bytes_read), not the "
                   "whole tensor"},
        {"name": "roi_align_fwd", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": "poet_tpu/ops/roi_align_pallas.py:77", **launched("roi"),
         "max_abs_err": report["roi_max_abs_err"]["gather"],
         **timed(roi["bf16"]["gather"], roi["bf16"]["plain"], roi["bound"]),
         "wrapper_ms": roi["bf16"]["gather_with_geometry"], "tiles_ms": roi["bf16"]["tiles"],
         "ms_are": "the gather route at the detect+pose shape (B=16 x 1000 proposals, C=256), "
                   "bf16, where the rule takes the tiles route; tiles_ms: the tiles route "
                   "there, same call"},
        {"name": "conv_stem_fwd", "route": "cuda", "source": src + "conv_stem_fwd.cu",
         "replaces": "poet_tpu/ops/conv_stem_pallas.py:66", **launched("stem"),
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
         # the figure comparable across calls: kernel ms / cuDNN + act ms, same call
         "ms_over_library": stem_total["ms"] / stem_total["library_ms"],
         "per_layer": {name: {k: t[k] for k in ("ms", "plain_ms", "library_ms", "f32_ms",
                                                "library_ratio")}
                       | {"bound_ms": t["bound"][0], "f32_bound_ms": t["f32_bound"][0]}
                       for name, t in zip(STEM_PATH, stem)}},
        {"name": "darknet_epilogue", "route": "cuda", "source": src + "darknet_epilogue.cu",
         "replaces": "poet_tpu/models/yolov4.py:256", **launched("epilogue"),
         # f32 over every phase-31 case (ulps: of the plain composition); bf16:
         # bf16 ulps of the f32 composition
         "max_abs_err": report["epilogue_max_err"]["f32_abs"],
         "max_ulp": report["epilogue_max_err"]["f32_ulp"],
         "bf16_max_ulp": report["epilogue_max_err"]["bf16_ulp"],
         "ms": epi["ms"], "plain_ms": epi["plain_ms"], "bound_ms": epi["bound"][0],
         "bound_by": epi["bound"][1], "library_ms": epi["library_ms"],
         "library_is": "F.batch_norm + F.mish or F.leaky_relu (none for linear), two calls",
         "ms_again": epi["ms_again"], "share_of_bound": epi["share_of_bound"],
         "train_ms": epi_train["ms"], "train_plain_ms": epi_train["plain_ms"],
         "train_bound_ms": epi_train["bound"][0], "host_us": epi["host_us"],
         "plain_host_us": epi["plain_host_us"], "copy_TB_s": epi["copy_TB_s"],
         "TB_s_by_shape": {k: v["TB_s"] for k, v in epi["by_shape"].items()},
         "ms_are": f"sums over a YOLO request's {YOLO_EPILOGUE} calls at B={EPILOGUE_B} "
                   f"480x640 (train_: a step's at B={EPILOGUE_TRAIN_B}), bf16, each conv's own "
                   "input and buffers, device time from graph replays"},
        {"name": "min_dist_sq_fwd", "route": "cuda", "source": src + "min_dist_sq_fwd.cu",
         "replaces": "poet_tpu/ops/nn_pallas.py:35", **launched("nn"),
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
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "341", **launched("merged"),
         "max_abs_err": max(report["merged_max_abs_err"].values()),
         **timed(m_yolo["atomic"], m_yolo["plain"], m_yolo["bound"]),
         "encoder_ms": m_enc["atomic"], "pair_ms": m_enc["pair"],
         "grid_init_ms": m_yolo_grid["atomic"], "decoder_ms": m_yolo_dec["atomic"],
         "ms_are": "the atomic route at the YOLO pyramid (B=16, Q=S=6380, H=16, D=16, L=P=4), "
                   "bf16, uniform locations, device time from graph replays, its zeroed buffer "
                   "and cast included; grid_init: at a model's sampling locations "
                   "(grid_locations); decoder: Q=10 over the same pyramid; encoder_ms, pair_ms: "
                   "the flagship encoder shape (B=16, Q=S=1600)"},
        {"name": "ms_deform_attn_bwd_merged_banded", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "341",
         **launched("merged_banded"), "max_abs_err": max(report["merged_max_abs_err"].values()),
         **timed(m_yolo[m_yolo["banded"]], m_yolo["plain"], m_yolo["bound"]),
         "variant": m_yolo["banded"], "atomic_ms": m_yolo["atomic"],
         "grid_init_ms": m_yolo_grid[m_yolo_grid["banded"]],
         "grid_init_atomic_ms": m_yolo_grid["atomic"],
         "decoder_ms": m_yolo_dec[m_yolo_dec["banded"]], "decoder_atomic_ms": m_yolo_dec["atomic"],
         "f32_ms": m_yolo_f32[m_yolo_f32["banded"]], "f32_atomic_ms": m_yolo_f32["atomic"],
         "variants_ms": {r: {"uniform": m_yolo[r], "grid_init": m_yolo_grid[r]}
                         for r in m_yolo if r.startswith("banded_")},
         "ms_are": "the banded route with the rule's staging (variant) at the YOLO pyramid "
                   "(B=16, Q=S=6380, H=16, D=16, L=P=4), bf16, uniform locations, device time "
                   "from graph replays; atomic_ms: the atomic route there, same call; "
                   "grid_init: at a model's sampling locations (grid_locations); decoder: Q=10 "
                   "over the same pyramid; f32: where the rule takes the atomic route; "
                   "variants_ms: staged and unstaged"},
        {"name": "ms_deform_attn_dense_fwd", "route": "cuda", "source": dense_src,
         "replaces": dense_tpu + "143", **launched("dense_fwd"),
         "max_abs_err": report["dense_max_abs_err"]["forward"],
         **timed(dense["dense_fwd"], dense["plain_fwd"], dense_enc["fwd_bounds"][0]),
         "model_locations_ms": dense["dense_fwd_model"], "decoder_ms": dense_dec["dense_fwd"],
         "decoder_model_locations_ms": dense_dec["dense_fwd_model"],
         "f32_ms": dense_enc["f32"]["dense_fwd"],
         "kernel1_ms": dense["kernel1"], "f32_bound_ms": dense_enc["fwd_bounds"][1][0],
         "bound_is": "bytes against one dense (Q x S_pad) @ (S_pad x D) product per (b, h) "
                     "on the bf16 tensor cores; f32_bound_ms: the gather form's on the f32 pipes",
         "ms_are": "the encoder shape, bf16, uniform random locations, device time from graph "
                   "replays; model_locations: at grid_locations; decoder: B=16, Q=10"},
        {"name": "ms_deform_attn_dense_bwd", "route": "cuda", "source": dense_src,
         "replaces": dense_tpu + "225", **launched("dense_bwd"),
         "max_abs_err": max(v for k, v in report["dense_max_abs_err"].items()
                            if k != "forward"),
         **timed(dense["dense_bwd"], dense["plain_bwd"], dense_enc["bwd_bounds"][0]),
         "model_locations_ms": dense["dense_bwd_model"], "decoder_ms": dense_dec["dense_bwd"],
         "decoder_model_locations_ms": dense_dec["dense_bwd_model"],
         "f32_ms": dense_enc["f32"]["dense_bwd"],
         "d_value_blocks_ms": dense["dense_bwd_d_value"],
         "d_loc_blocks_ms": dense["dense_bwd_d_loc"],
         "d_value_blocks_model_locations_ms": dense["dense_bwd_d_value_model"],
         "d_loc_blocks_model_locations_ms": dense["dense_bwd_d_loc_model"],
         "d_loc_blocks_by_route": dense_enc["dloc_routes"],
         "pair_ms": dense["pair"], "merged_ms": dense["merged"],
         "f32_bound_ms": dense_enc["bwd_bounds"][1][0],
         "bound_is": "bytes against the TPU kernel's two dense products per (b, h) on the bf16 "
                     "tensor cores; f32_bound_ms: the gather form's dot + scatter",
         "ms_are": "the encoder shape, bf16, uniform random locations, device time from graph "
                   "replays; model_locations: at grid_locations; decoder: B=16, Q=10; "
                   "d_value_blocks / d_loc_blocks: each kind of block launched alone; "
                   "d_loc_blocks_by_route: the d_loc / d_attn blocks alone and the whole "
                   "launch with the value slab staged (slab) or read from device memory "
                   "(direct), f32 and bf16, uniform and a model's (_model) locations, the "
                   "rule's route and the gather's bound"},
        {"name": "ms_deform_attn_v2_fwd", "route": "cuda", "source": src + "ms_deform_attn_v2.cu",
         "replaces": "poet_tpu/ops/deform_attn_pallas_v2.py:54", **launched("v2"),
         "phase_launches": probes["v2"], "max_abs_err": report["v2_max_abs_err"],
         **timed(v2["v2"], v2["plain"], v2_enc["bounds"][0]),
         "kernel1_ms": v2["kernel1"], "kernel1_slab_ms": v2["kernel1_slab"],
         "tpu_form_bound_ms": v2_enc["bounds"][1][0], "plan": v2["plan"],
         "f32_ms": v2_enc["f32"]["v2"], "decoder_ms": report["v2_decoder"]["bf16"]["v2"],
         "yolo_ms": report["v2_yolo pyramid"]["bf16"]["v2"],
         "yolo_kernel1_slab_ms": report["v2_yolo pyramid"]["bf16"]["kernel1_slab"],
         "yolo_bound_ms": report["v2_yolo pyramid"]["bounds"][0][0],
         "bound_is": "bytes against 8 D operations per in-map point on the f32 pipes; "
                     "tpu_form_bound_ms: bytes against the TPU kernel's two one-hot products "
                     "per point on the bf16 tensor cores, which this kernel does not do",
         "card": card,
         "ms_are": "the encoder shape, bf16, CUDA events over back-to-back launches; "
                   "kernel1(_slab)_ms: kernel 1's direct (slab) route on the same inputs; "
                   "yolo: the YOLO pyramid at B=16"},
        {"name": "probe_kpad", "route": "cuda", "source": src + "probe_kpad.cu",
         "replaces": "scripts/bench_kpad.py:33", **launched("kpad"),
         "phase_launches": probes["kpad"], "max_abs_err": kpad["max_abs_err"],
         "max_rel_err": kpad["max_rel_err"],
         "ms": kpad["sweep"][128]["ms"], "plain_ms": kpad["plain_ms"],
         "bound_ms": kpad["bound"][0], "bound_by": kpad["bound"][1],
         # no one call chains R dependent products: torch.matmul of one of them
         # beside it, and that time R x G times, for scale
         "library_ms": None, "matmul_ms": kpad["sweep"][128]["matmul_ms"],
         "matmul_is": "torch.matmul of one (M, K) @ (K, N) bf16 product, device time",
         "matmul_x_products_ms": kpad["sweep"][128]["matmul_ms"] * KPAD_R * KPAD_G,
         "tflops_by_k": {K: [r["tflops"], r["tflops_pad16"]] for K, r in kpad["sweep"].items()},
         "ms_by_k": {K: r["ms"] for K, r in kpad["sweep"].items()},
         "whole_waves_ms_by_k": {K: r["ms"] for K, r in kpad["sweep_whole_waves"].items()},
         "whole_waves_bound_ms": kpad["sweep_whole_waves"][128]["bound_ms"],
         "designs_ms": kpad["designs_ms"], "card": card,
         "ms_are": f"K=128, M={KPAD_M} N={KPAD_N} R={KPAD_R} G={KPAD_G} (7.5 waves of tasks), "
                   f"bf16 -> f32, the design by K (four warpgroups to K=64, two above); "
                   f"whole_waves: G={KPAD_G_WHOLE} (10 waves); designs_ms: K=128 and K=27 by "
                   f"warpgroups and G; max_rel_err relative "
                   f"to max |plain|; plain_ms: G plain chains"},
        {"name": "ms_deform_attn_fwd_variants", "route": "cuda",
         "source": src + "ms_deform_attn_fwd_variants.cu",
         "replaces": "scripts/bench_v3_variants.py:44", **launched("variants"),
         "phase_launches": probes["variants"],
         # the exact variants against the plain version; each variant's own beside
         "max_abs_err": max(var[k]["max_abs_err"] for k in ("base", "unroll", "qt256", "treey")),
         "variant_max_abs_err": {k: x["max_abs_err"] for k, x in var.items()
                                 if isinstance(x, dict) and "ms" in x},
         "yolo_variant_max_abs_err": {k: x["max_abs_err"] for k, x in var_yolo.items()
                                      if isinstance(x, dict) and "ms" in x},
         "floor_counts": {"encoder": var["floor_counts"], "yolo": var_yolo["floor_counts"]},
         **timed(var["base"]["ms"], var["plain_ms"], var["bound"]),
         "kernel1_ms": var["kernel1_ms"], "kernel1_slab_ms": var["kernel1_slab_ms"],
         "base_cp_async_ms": var["base_cp_async_ms"], "staging_tma_ms": var["staging_tma_ms"],
         "staging_cp_async_ms": var["staging_cp_async_ms"],
         "variant_ms": {k: x["ms"] for k, x in var.items() if isinstance(x, dict) and "ms" in x},
         "yolo_variant_ms": {k: x["ms"] for k, x in var_yolo.items()
                             if isinstance(x, dict) and "ms" in x},
         "yolo_bound_ms": var_yolo["bound"][0],
         "card": card,
         "ms_are": "variant base on its TMA-staged slab at the encoder shape, bf16, CUDA events; "
                   "kernel1(_slab)_ms: kernel 1's direct (slab) route, base_cp_async_ms: base "
                   "staged by cp.async, same inputs and call; staging_*_ms: base at one query a "
                   "(b, h), the staging alone, device time from graph replays; yolo_*: the YOLO "
                   "pyramid (B=16, Q=S=6380); floor_counts: C8's points floored otherwise by "
                   "one rounding and two, and by noy's kernel and its plain definition"},
        {"name": "take_along_axis", "route": "cuda", "source": src + "take_along_axis.cu",
         "replaces": "scripts/test_dyn_gather.py:12", **launched("gather"),
         "phase_launches": probes["gather"], "max_abs_err": 0.0,
         "ms": gat["ms"], "plain_ms": gat["plain_ms"], "bound_ms": gat["bound"][0],
         "bound_by": gat["bound"][1], "library_ms": gat["library_ms"],
         "library_is": "torch.gather(table, 0, idx)",
         "host_ms": gat["host_ms"], "plain_host_ms": gat["plain_host_ms"],
         "library_host_ms": gat["library_host_ms"],
         "host_breakdown_us": report["gather_host_breakdown"], "card": card,
         "ms_are": "the 4800-row f32 case, (4800, 128) table and index; device time, "
                   "replayed from a CUDA graph (host_ms: per call launched from the host, "
                   "CUDA events over back-to-back calls; host_breakdown_us: each step of one "
                   "call alone on the host's clock over 10 000 calls)"},
        {"name": "ms_deform_attn_fwd_slab", "route": "cuda",
         "source": src + "ms_deform_attn_fwd.cu", "replaces": tpu + "221",
         **launched("fwd_slab"), "max_abs_err": report["max_abs_err"],
         **timed(fwd_enc["slab"], fwd_enc["plain"], fwd_enc["bound"]),
         "direct_ms": fwd_enc["direct"], "yolo_ms": fwd_yolo.get("slab"),
         "yolo_direct_ms": fwd_yolo["direct"], "yolo_bound_ms": fwd_yolo["bound"][0],
         "crossover_ms": {q: [c["direct"], c["slab"]] for q, c in
                          report["fwd_crossover"].items()},
         "ms_are": "the encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4), bf16; direct_ms: "
                   "the direct route there, same call; yolo: B=16, Q=S=6380 (its bound the "
                   "bytes: value rows under the corners, loc, attn, out); crossover_ms: "
                   "[direct, slab] by Q at S=1600"},
        {"name": "ms_deform_attn_bwd_merged_slab", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "341",
         **launched("merged_slab"), "max_abs_err": max(report["merged_max_abs_err"].values()),
         **timed(m_enc[m_enc["rule"]], m_enc["plain"], m_enc["bound"]),
         "atomic_ms": m_enc["atomic"], "pair_ms": m_enc["pair"],
         "unstaged_ms": m_enc.get("slab_unstaged"),
         "decoder_ms": m_dec[m_dec["rule"]], "decoder_atomic_ms": m_dec["atomic"],
         "ms_are": f"the encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4), bf16, the rule's "
                   f"{m_enc['rule']}; atomic_ms: the atomic route there, same call; decoder: "
                   f"Q=10, the rule's {m_dec['rule']}"},
        {"name": "ms_deform_attn_bwd_dvalue_slab", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "434",
         **launched("d_value_slab"), "max_abs_err": report["dvalue_slab_max_abs_err"],
         **timed(adj_dec["dvalue_slab"], adj_dec["plain_dvalue"],
                 report["dvalue_bound_decoder"]),
         "atomic_ms": adj_dec["dvalue"], "f32_ms": adj_dec_f32["dvalue_slab"],
         "f32_atomic_ms": adj_dec_f32["dvalue"], "encoder_ms": adj["dvalue_slab"],
         "encoder_atomic_ms": adj["dvalue"],
         "grid_init_encoder_ms": report["adjoint_grid"]["bf16"]["dvalue_slab"],
         "grid_init_encoder_atomic_ms": report["adjoint_grid"]["bf16"]["dvalue"],
         "crossover_ms": {Q: [c["dvalue"], c["dvalue_slab"]]
                          for Q, c in report["adjoint_grid"]["crossover"].items()},
         "ms_by_group_x_threads": report["dvalue_sweep"],
         "yolo_atomic_ms": d_yolo["scatter"], "yolo_ms_by_group_x_threads": d_yolo["sweep"],
         "ms_are": "the decoder shape (B=16, Q=10, S=1600, H=16, D=16, L=P=4), where the rule "
                   "takes the slab route, bf16, device time from graph replays; atomic_ms: "
                   "the scatter there, same call (its zeroed buffer and cast included); "
                   "encoder: Q=S=1600, uniform locations; grid_init_encoder: the encoder at a "
                   "model's sampling locations (grid_locations), where the rule takes the "
                   "scatter; crossover_ms: [scatter, slab] by Q at S=1600 there; yolo: B=16, "
                   "Q=S=6380, the slab splits that fit"},
        {"name": "ms_deform_attn_bwd_dloc_slab", "route": "cuda",
         "source": src + "ms_deform_attn_point.cuh", "replaces": tpu + "470",
         **launched("d_loc_slab"), "max_abs_err": report["dloc_slab_max_abs_err"],
         **timed(adj["dloc_slab"], adj["plain_dloc"], bounds["dloc"]),
         "plain_adjoint_ms": adj["plain"], "direct_ms": adj["dloc"],
         "f32_ms": adj_f32["dloc_slab"], "f32_direct_ms": adj_f32["dloc"],
         "f32_bound_ms": adj_f32["dloc_bound"][0],
         "grid_init_ms": report["adjoint_grid"]["bf16"]["dloc_slab"],
         "grid_init_direct_ms": report["adjoint_grid"]["bf16"]["dloc"],
         "grid_init_f32_ms": report["adjoint_grid"]["f32"]["dloc_slab"],
         "grid_init_f32_direct_ms": report["adjoint_grid"]["f32"]["dloc"],
         "decoder_ms": adj_dec["dloc_slab"], "decoder_direct_ms": adj_dec["dloc"],
         "ms_are": "the encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4), where the rule "
                   "takes the slab route, bf16, uniform locations, device time from graph "
                   "replays; direct_ms: the direct route there, same call; grid_init: at a "
                   "model's sampling locations (grid_locations); decoder: Q=10, where the "
                   "rule takes the direct route"},
        {"name": "ms_deform_attn_dense_dloc_slab", "route": "cuda",
         "source": src + "ms_deform_attn_point.cuh",
         "replaces": dense_tpu + "225", **launched("dense_dloc_slab"),
         "max_abs_err": max(v for k, v in dense_enc["dloc_routes"].items()
                            if k.startswith("f32_slab") and k.endswith("_err")),
         **timed(dense_enc["dloc_routes"]["bf16_slab"], dense_enc["dloc_routes"]["bf16_plain"],
                 (dense_enc["dloc_routes"]["bf16_bound"],
                  dense_enc["dloc_routes"]["bf16_bound_by"])),
         "model_locations_ms": dense_enc["dloc_routes"]["bf16_slab_model"],
         "f32_ms": dense_enc["dloc_routes"]["f32_slab"],
         "direct_ms": dense_enc["dloc_routes"]["bf16_direct"],
         "ms_are": "the dense adjoint's d_loc / d_attn blocks on the staged slab, a kernel of "
                   "their own, at the encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4), where "
                   "plan_dloc stages, bf16, uniform locations, device time from graph replays; "
                   "direct_ms: the same blocks from device memory inside the d_value blocks' "
                   "launch, same call; plain_ms: the plain adjoint of d_loc and d_attn alone"},
        {"name": "roi_align_tiles", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": "poet_tpu/ops/roi_align_pallas.py:77", **launched("roi_tiles"),
         "max_abs_err": report["roi_max_abs_err"]["tiles"],
         **timed(roi["bf16"]["tiles"], roi["bf16"]["plain"], roi["bound"]),
         "wrapper_ms": roi["bf16"]["tiles_with_geometry"], "gather_ms": roi["bf16"]["gather"],
         "f32_ms": roi["f32"]["tiles"], "f32_gather_ms": roi["f32"]["gather"],
         "ms_by_chunk": roi["sweep"],
         "ms_are": "the detect+pose shape (B=16 x 1000 proposals, C=256, levels (120,160).."
                   "(15,20)), bf16, the kernel alone; wrapper_ms: with its geometry; gather_ms: "
                   "the gather route, same call"},
    ]
    # a time under its bound means a bound that counts work the function
    # does not need
    under = [(k["name"], k["ms"], k["bound_ms"]) for k in kernels if k["ms"] < k["bound_ms"]]
    if under:
        raise AssertionError(f"kernels measured under their bound (name, ms, bound_ms): {under}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
