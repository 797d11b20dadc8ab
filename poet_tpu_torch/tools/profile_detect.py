"""Where a detect+pose request's time goes, stage by stage.

    python3 -m poet_tpu_torch.tools.profile_detect [--requests 5] [--batch 16]
        [--trace build/profile/detect_trace.json]

The request is the one `chip_smoke.py` phase 10 serves: the paper config in
bbox_mode='backbone' (`flagship.detect_pose_config`), bf16, 480x640,
seeded weights with well-conditioned detector heads. After two warm-up
requests it times `--requests` untraced requests through `PoseServer.infer`,
then runs the same forward stage by stage — upload, backbone (ResNet-50 +
FPN, every level), RPN head, proposals (per-level top-k, decode, the NMS
fixed point), RoIAlign, box head (fc6/fc7 + predictor), final selection
(softmax, per-class decode, the certified per-class NMS), PoET (input
projections, transformer, pose heads) — with a synchronize around each, and
prints each stage's host ms (the NMS's host waits included) and device ms
(CUDA events), the NMS fixed points' iterations and loop time per request,
and checks that the staged forward gives the server's answer. Last,
`torch.profiler` traces `--requests` requests: device busy ms per request,
idle share, device ms by kernel class. Needs one CUDA device.
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

    def poet():
        # the PoET forward on this pass's features: the backbone answers
        # with what the stages computed
        forward = bb.forward
        bb.forward = lambda *a: staged
        try:
            return model(img, pad_mask)
        finally:
            bb.forward = forward

    return timer("poet", poet), staged[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trace", default=os.path.join("build", "profile", "detect_trace.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_detect: needs a CUDA device", file=sys.stderr)
        return 2
    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import detect_pose_batch, detect_pose_config, detect_pose_model
    from poet_tpu_torch.ops.detection import FIXED_POINT
    from poet_tpu_torch.tools.profile_train import device_time_by_class

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    B, (H, W) = args.batch, (480, 640)
    cfg = detect_pose_config("bfloat16")
    server = PoseServer(cfg, detect_pose_model(cfg), batch_size=B, image_size=(H, W))
    images, _ = detect_pose_batch(B, H, W, seed=0)
    for _ in range(2):
        server.infer(images)
    server.reset_latency_stats()
    for _ in range(args.requests):
        server.infer(images)
    stats = server.latency_stats()

    host: Dict[str, List[float]] = {s: [] for s in STAGES}
    device: Dict[str, List[float]] = {s: [] for s in STAGES}

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
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    busy, by_class = device_time_by_class(events, args.requests)

    print(f"detect+pose request, paper config bf16 B={B} {H}x{W}, {cfg.model.n_classes + 1} "
          f"classes, {cfg.backbone.post_nms_top_n} proposals, on {card}:")
    print(f"  PoseServer.infer untraced: p50 {stats['p50_ms']:.3f} ms, p95 "
          f"{stats['p95_ms']:.3f} ms, {stats['fps']:.2f} img/s over {args.requests} requests")
    print(f"  staged (a synchronize around each stage), median of {args.requests}: "
          f"{'stage':16s} host ms   device ms")
    for s in STAGES:
        print(f"    {s:16s} {np.median(host[s]):9.3f} {np.median(device[s]):11.3f}")
    print(f"    {'sum':16s} {sum(np.median(host[s]) for s in STAGES):9.3f} "
          f"{sum(np.median(device[s]) for s in STAGES):11.3f}")
    print(f"  NMS fixed points per request: {iters:.1f} iterations (one host wait each), "
          f"{nms_ms:.3f} ms of host time inside their loops")
    print(f"  traced: {n_kernels / args.requests:.0f} kernels per request, device busy "
          f"{busy:.3f} ms per request: idle {1 - busy / stats['p50_ms']:.1%} of the untraced "
          f"p50")
    print("  device ms per request by class:")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {cls:28s} {ms:8.3f}")
    print(f"  trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
