"""Where a detect+pose request's time goes, stage by stage.

    python3 -m poet_tpu_torch.tools.profile_detect [--config maskrcnn|yolo]
        [--requests 5] [--batch 16] [--trace build/profile/<config>_trace.json]

`--config maskrcnn` (the default) profiles the request `chip_smoke.py`
phase 10 serves: the paper config in bbox_mode='backbone'
(`flagship.detect_pose_config`), bf16, 480x640, seeded weights with
well-conditioned detector heads. Its stages: upload, backbone (ResNet-50 +
FPN, every level), RPN head, proposals (per-level top-k, decode, the NMS
fixed point), RoIAlign, box head (fc6/fc7 + predictor), final selection
(softmax, per-class decode, the certified per-class NMS), PoET (input
projections, transformer, pose heads).

`--config yolo` profiles phase 13's request: the same PoET on YOLOv4-CSP
(`flagship.yolo_detect_pose_config`: the shipped cfg, 6380 tokens). Its
stages: upload, darknet body (115 convs; the three stem-kernel launches
timed one by one with CUDA events), decode + top-k + NMS, PoET.

After two warm-up requests it times `--requests` untraced requests through
`PoseServer.infer`, then runs the same forward stage by stage with a
synchronize around each, and prints each stage's host ms (the NMS's host
waits included) and device ms (CUDA events), the NMS fixed points'
iterations and loop time per request, and checks that the staged forward
gives the server's answer. Last, `torch.profiler` traces `--requests`
requests: device busy ms per request, idle share, device ms by kernel
class. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Tuple

STAGES = ("upload", "backbone", "rpn head", "proposals", "roi align", "box head",
          "final selection", "poet")
YOLO_STAGES = ("upload", "darknet body", "decode + top-k + NMS", "poet")


def _poet_on(model, staged, img, pad_mask):
    """The PoET forward on this pass's backbone outputs: the backbone
    answers with what the stages computed."""
    bb = model.backbone
    forward = bb.forward
    bb.forward = lambda *a, **kw: staged
    try:
        return model(img, pad_mask)
    finally:
        bb.forward = forward


def staged_forward(model, images, pad_mask, timer: Callable) -> Tuple[Dict, Dict]:
    """The detect+pose forward of `model` (a bbox_mode='backbone' PoET) in
    the stages of STAGES, each run as `timer(name, fn)`, through the same
    methods its forward calls; `images` is host numpy. Returns (the model's
    outputs, the detector's detections)."""
    import torch

    from poet_tpu_torch.models.maskrcnn import LEVELS
    from poet_tpu_torch.ops.roi_align_cuda import multiscale_roi_align

    bb = model.backbone
    dev = pad_mask.device
    img = timer("upload", lambda: torch.as_tensor(images).to(device=dev, dtype=torch.float32))
    H, W = img.shape[1:3]
    feats = timer("backbone", lambda: bb.backbone(img))
    levels = [feats[k] for k in LEVELS]
    grids = [tuple(f.shape[1:3]) for f in levels]
    strides = [(H // g[0], W // g[1]) for g in grids]
    logits, deltas = timer("rpn head", lambda: bb.rpn["head"](levels))
    prop_boxes, prop_scores = timer("proposals", lambda: bb.proposals(
        logits, deltas, bb.anchors(grids, strides, dev), (H, W)))
    pooled = timer("roi align", lambda: multiscale_roi_align(
        [f.contiguous() for f in levels[:4]], [s[0] for s in strides[:4]], prop_boxes))
    class_logits, box_deltas = timer("box head", lambda: bb.box_heads(pooled))
    dets = timer("final selection", lambda: bb.detections(
        class_logits, box_deltas, prop_boxes, prop_scores, (H, W)))
    staged = bb.outputs(feats, dets, pad_mask)
    return timer("poet", lambda: _poet_on(model, staged, img, pad_mask)), staged[2]


def yolo_staged_forward(model, images, pad_mask, timer, stem_events=None) -> Tuple[Dict, Dict]:
    """The YOLO detect+pose forward of `model` in the stages of YOLO_STAGES,
    as `staged_forward`. With `stem_events` (a list), each stem-kernel call
    of the body appends (input shape, start event, end event)."""
    import torch

    from poet_tpu_torch.models import yolov4

    bb = model.backbone
    dev = pad_mask.device
    img = timer("upload", lambda: torch.as_tensor(images).to(device=dev, dtype=torch.float32))
    H = img.shape[1]
    conv_stem = yolov4.conv_stem

    def timed_stem(x, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = conv_stem(x, *args, **kwargs)
        end.record()
        stem_events.append((tuple(x.shape), start, end))
        return out

    if stem_events is not None:
        yolov4.conv_stem = timed_stem
    try:
        yolo_in, specs, feats = timer("darknet body", lambda: bb.body(img))
    finally:
        yolov4.conv_stem = conv_stem
    dets = timer("decode + top-k + NMS", lambda: bb.detect(*bb.decode(yolo_in, specs, H)))
    staged = (*bb.outputs(feats, pad_mask, H), dets)
    return timer("poet", lambda: _poet_on(model, staged, img, pad_mask)), dets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("maskrcnn", "yolo"), default="maskrcnn")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trace", default=None,
                    help="default build/profile/detect_trace.json (maskrcnn), "
                         "build/profile/yolo_trace.json (yolo)")
    args = ap.parse_args(argv)
    yolo = args.config == "yolo"
    trace_path = args.trace or os.path.join("build", "profile",
                                       "yolo_trace.json" if yolo else "detect_trace.json")

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_detect: needs a CUDA device", file=sys.stderr)
        return 2
    from poet_tpu_torch import flagship
    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.ops.detection import FIXED_POINT
    from poet_tpu_torch.tools.profile_train import device_time_by_class

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    B, (H, W) = args.batch, (480, 640)
    if yolo:
        cfg = flagship.yolo_detect_pose_config("bfloat16")
        model, batch = flagship.yolo_detect_pose_model(cfg), flagship.yolo_detect_pose_batch
        stages = YOLO_STAGES
    else:
        cfg = flagship.detect_pose_config("bfloat16")
        model, batch = flagship.detect_pose_model(cfg), flagship.detect_pose_batch
        stages = STAGES
    server = PoseServer(cfg, model, batch_size=B, image_size=(H, W))
    images, _ = batch(B, H, W, seed=0)
    for _ in range(2):
        server.infer(images)
    server.reset_latency_stats()
    for _ in range(args.requests):
        server.infer(images)
    stats = server.latency_stats()

    host: Dict[str, List[float]] = {s: [] for s in stages}
    device: Dict[str, List[float]] = {s: [] for s in stages}
    stems: List[Tuple] = []

    def timer(name, fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        host[name].append((time.perf_counter() - t0) * 1e3)
        device[name].append(start.elapsed_time(end))
        return out

    FIXED_POINT.reset()
    with torch.inference_mode():
        for _ in range(args.requests):
            if yolo:
                out, _ = yolo_staged_forward(server.model, images, server._pad_mask, timer,
                                             stems)
            else:
                out, _ = staged_forward(server.model, images, server._pad_mask, timer)
    iters = FIXED_POINT.iterations / args.requests
    nms_ms = FIXED_POINT.seconds * 1e3 / args.requests
    ref = server.infer(images)
    for k, g in (("classes", "pred_classes"), ("n_boxes", "n_boxes")):
        if not np.array_equal(ref[k], out[g].cpu().numpy()):
            raise AssertionError(f"the staged forward's {g} differs from the server's")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.requests):
            server.infer(images)
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    busy, by_class = device_time_by_class(events, args.requests)

    if yolo:
        print(f"YOLOv4-CSP detect+pose request, paper config bf16 B={B} {H}x{W}, "
              f"{cfg.model.n_classes} classes, conf {cfg.backbone.conf_thresh}, "
              f"{cfg.backbone.max_detections} detections, on {card}:")
    else:
        print(f"detect+pose request, paper config bf16 B={B} {H}x{W}, "
              f"{cfg.model.n_classes + 1} classes, {cfg.backbone.post_nms_top_n} proposals, "
              f"on {card}:")
    print(f"  PoseServer.infer untraced: p50 {stats['p50_ms']:.3f} ms, p95 "
          f"{stats['p95_ms']:.3f} ms, {stats['fps']:.2f} img/s over {args.requests} requests")
    print(f"  staged (a synchronize around each stage), median of {args.requests}: "
          f"{'stage':16s} host ms   device ms")
    for s in stages:
        print(f"    {s:20s} {np.median(host[s]):9.3f} {np.median(device[s]):11.3f}")
    print(f"    {'sum':20s} {sum(np.median(host[s]) for s in stages):9.3f} "
          f"{sum(np.median(device[s]) for s in stages):11.3f}")
    if stems:
        per = len(stems) // args.requests
        for i in range(per):
            ms = [start.elapsed_time(end) for _, start, end in stems[i::per]]
            print(f"    darknet body: stem launch {i} on {stems[i][0]}: median "
                  f"{np.median(ms):.4f} ms (CUDA events)")
    print(f"  NMS fixed points per request: {iters:.1f} iterations (one host wait each), "
          f"{nms_ms:.3f} ms of host time inside their loops")
    print(f"  traced: {n_kernels / args.requests:.0f} kernels per request, device busy "
          f"{busy:.3f} ms per request: idle {1 - busy / stats['p50_ms']:.1%} of the untraced "
          f"p50")
    print("  device ms per request by class:")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {cls:28s} {ms:8.3f}")
    print(f"  trace: {trace_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
