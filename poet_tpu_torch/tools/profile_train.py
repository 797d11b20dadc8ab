"""Where the flagship train step's device time goes, from `torch.profiler`.

    python3 -m poet_tpu_torch.tools.profile_train [--steps 3] [--batch 16]
        [--trace build/profile/train_step_trace.json]
        [--variants pair,merged,pallas,merged,pair]

The step is the one `chip_smoke.py` phase 7 times: the paper config, bf16
over f32 master weights, 480x640, seeded weights, the flagship batch,
dropout 0.1, AdamW with clipping. After two warm-up steps it times five
steps with the batch already on the card and one `prepare_batch` (host
match + pinned upload), then traces `--steps` whole steps and reads the
kernels out of the exported Chrome trace. It prints the card's name and
power limit, the step's device busy time (the union of kernel and copy
intervals), the idle share against the untraced step time, and device ms
per step by kernel class. Needs one CUDA device.

`--variants` profiles the step once per name, in the order given (repeat a
name to interleave an A/B): 'pair' (the gather kernels with the pair
adjoint), 'merged' (`ModelConfig.merged_adjoint`) and 'pallas'
(`enc_deform_impl = dec_deform_impl = 'pallas'`, the dense kernels). With
more than one, each trace's file name gets the turn and the variant.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Tuple

# first match wins; the pattern is searched in the kernel's name
KERNEL_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("forward kernel", r"ms_deform_attn_fwd_kernel"),
    ("d_value kernel", r"ms_deform_attn_dvalue_kernel"),
    ("d_loc/d_attn kernel", r"ms_deform_attn_dloc_kernel"),
    ("merged adjoint kernel", r"ms_deform_attn_merged_kernel"),
    ("dense forward kernel", r"ms_deform_attn_dense_fwd_kernel"),
    ("dense adjoint kernel", r"ms_deform_attn_dense_bwd_kernel"),
    ("RoIAlign kernel", r"roi_align_fwd_kernel"),
    ("stem kernel", r"conv_stem_fwd_kernel"),
    ("memcpy / memset", r"^Mem(cpy|set)"),
    ("conv (cuDNN)", r"cudnn|conv|fprop|dgrad|wgrad"),
    ("GEMM", r"gemm|xmma|nvjet|cublas"),
    ("multi-tensor (clip, AdamW)", r"multi_tensor_apply"),
    ("LayerNorm / GroupNorm", r"layer_norm|LayerNorm|GammaBeta|group_norm|GroupNorm"),
    ("reductions", r"reduce_kernel"),
    ("elementwise", r"elementwise|fill|where|index|cat|copy"),
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the step's deformable-attention variants: the ModelConfig fields each sets
VARIANTS = {
    "pair": {"merged_adjoint": False},
    "merged": {"merged_adjoint": True},
    "pallas": {"enc_deform_impl": "pallas", "dec_deform_impl": "pallas"},
}


def kernel_class(name: str) -> str:
    for cls, pattern in KERNEL_CLASSES:
        if re.search(pattern, name):
            return cls
    return "other"


def device_time_by_class(events: Iterable[Dict], steps: int) -> Tuple[float, Dict[str, float]]:
    """Chrome-trace events -> (busy ms per step, {class: ms per step}).

    Busy time is the union of the device intervals (streams may overlap);
    the classes sum each interval's own duration."""
    spans: List[Tuple[float, float]] = []
    by_class: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((start, start + dur))
        cls = kernel_class(e.get("name", ""))
        by_class[cls] = by_class.get(cls, 0.0) + dur
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    per_step = 1e-3 / steps                                   # us -> ms per step
    return busy * per_step, {k: v * per_step for k, v in by_class.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="steps in the trace")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trace", default=os.path.join("build", "profile", "train_step_trace.json"))
    ap.add_argument("--variants", default="pair",
                    help=f"comma-separated names from {tuple(VARIANTS)}, profiled in this order")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    if not set(variants) <= set(VARIANTS):
        ap.error(f"--variants {args.variants}: each must be one of {tuple(VARIANTS)}")

    import torch

    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    from poet_tpu_torch.flagship import flagship_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    stem, ext = os.path.splitext(args.trace)
    for turn, variant in enumerate(variants):
        cfg = flagship_config("bfloat16")
        for k, v in VARIANTS[variant].items():
            setattr(cfg.model, k, v)
        trace = args.trace if len(variants) == 1 else f"{stem}_{turn}_{variant}{ext}"
        profile_step(cfg, variant, args.batch, args.steps, trace, card)
    return 0


def profile_step(cfg, variant: str, B: int, steps: int, trace_path: str, card: str) -> None:
    """Time and trace the train step of `cfg`; print where its device time goes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.flagship import flagship_batch
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    H, W = 480, 640
    model = init_weights(build_model(cfg), seed=0).cuda()
    step = make_train_step(model, cfg, make_optimizer(cfg, model, steps_per_epoch=1000))
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, pad_mask, targets = flagship_batch(B, H, W, seed=0)
    for _ in range(2):
        fetch_metrics(step(*prepare_batch(cfg, images, pad_mask, targets, "cuda"), gen))
    batch = prepare_batch(cfg, images, pad_mask, targets, "cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fetch_metrics(step(*batch, gen))
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    prepare_batch(cfg, images, pad_mask, targets, "cuda")
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fetch_metrics(step(*prepare_batch(cfg, images, pad_mask, targets, "cuda"), gen))
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    busy, by_class = device_time_by_class(events, steps)

    p50 = float(np.percentile(times, 50))
    print(f"train step ({variant}), paper config bf16 B={B} {H}x{W}, on {card}:")
    print(f"  untraced, batch on the card: ms {[round(t, 3) for t in times]}, p50 {p50:.3f}")
    print(f"  prepare_batch (host match + pinned upload): {prep_ms:.3f} ms")
    print(f"  traced: {traced_ms:.3f} ms per step over {steps} steps, "
          f"{n_kernels / steps:.0f} kernels per step")
    print(f"  device busy {busy:.3f} ms per step: idle {1 - busy / p50:.1%} of the untraced "
          f"p50 step")
    print("  device ms per step by class:")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"    {cls:28s} {ms:8.3f}")
    print(f"  trace: {trace_path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
