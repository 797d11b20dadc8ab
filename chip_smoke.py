#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the deformable-attention kernel from poet_tpu_torch/csrc with nvcc;
  3. the kernel against its plain PyTorch version on the card: flagship
     encoder (Q=S=1600) and decoder (Q=10) shapes at B=16, edge level
     geometries, out-of-map and dummy-query locations; f32 and bf16; times;
  4. the serving slice: the port's PoseServer at the paper config, bf16,
     batch 16, 480x640, seeded weights, the flagship numpy batch; outputs
     finite, rotations orthonormal with det +1, exactly 10 kernel launches
     (5 encoder + 5 decoder layers) per request; p50 ms and img/s;
  5. f32 end to end: the same seeded model at B=2 on the card (kernel) against
     the port on the CPU (plain version), TF32 off.
The last two lines are the kernel report and {"ok": true, "device": ...}.
Exits non-zero without a CUDA device, and imports no JAX.
"""

from __future__ import annotations

import json
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
FLAGSHIP_LEVELS = ((30, 40), (15, 20), (8, 10), (4, 5))


def log(msg: str) -> None:
    print(msg, flush=True)


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


def deform_inputs(g, B, Q, H, D, shapes, P=4, lo=-0.2, hi=1.2, dtype=None):
    import torch

    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    dev = "cuda"
    value = torch.randn((B, S, H, D), generator=g, device=dev)
    locs = lo + (hi - lo) * torch.rand((B, Q, H, L, P, 2), generator=g, device=dev)
    attn = torch.rand((B, Q, H, L * P), generator=g, device=dev)
    attn = (attn / attn.sum(-1, keepdim=True)).view(B, Q, H, L, P)
    if Q >= 4:   # dummy-query conventions: boxes -1 and the -10 fill
        locs[:, -1] = -10.0
        locs[:, -2] = -1.0
    return value.to(dtype or torch.float32), locs.contiguous(), attn.contiguous()


def phase_kernel(report):
    import torch

    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("encoder", 16, 1600, 16, 16, FLAGSHIP_LEVELS, 0.0, 1.0),
        ("decoder", 16, 10, 16, 16, FLAGSHIP_LEVELS, -0.2, 1.2),
        ("edge(1,7)(3,1)(1,1)", 2, 5, 2, 8, ((1, 7), (3, 1), (1, 1)), -0.2, 1.2),
        ("edge D=6 (scalar loads)", 2, 9, 3, 6, ((5, 7), (3, 4)), -0.2, 1.2),
        ("far out of map", 2, 9, 2, 8, ((6, 9), (4, 5), (2, 3)), -3.5, 4.5),
    ]
    max_err32 = 0.0
    for name, B, Q, H, D, shapes, lo, hi in cases:
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
        log(line)

    # a CUDA tensor that requires grad must raise (forward-only kernel)
    v, l, a = deform_inputs(g, 1, 4, 2, 8, ((3, 4),))
    try:
        K(v.requires_grad_(), ((3, 4),), l, a)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("kernel accepted a tensor that requires grad")
    report["max_abs_err"] = max_err32


def rotations_ok(rot: np.ndarray) -> float:
    r = rot.reshape(-1, 3, 3).astype(np.float64)
    orth = np.abs(np.einsum("nji,njk->nik", r, r) - np.eye(3)).max()
    det = np.abs(np.linalg.det(r) - 1.0).max()
    if not (orth < 1e-4 and det < 1e-4):
        raise AssertionError(f"rotations not in SO(3): |R^T R - I| {orth}, |det - 1| {det}")
    return max(orth, det)


def phase_slice(report):
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 16, (480, 640)
    cfg = flagship_config("bfloat16")
    server = PoseServer(cfg, init_weights(build_model(cfg), seed=0), batch_size=B,
                        image_size=(H, W), device="cuda")
    images, _, targets = flagship_batch(B, H, W, seed=0)
    boxes = (targets["boxes"], targets["labels"], targets["n_boxes"])
    for _ in range(2):                               # warm-up: cuDNN/cuBLAS init
        server.fetch(server.infer_async(images, *boxes))
    server.reset_latency_stats()
    per_layer = cfg.model.enc_layers + cfg.model.dec_layers

    K.launches = 0
    results = list(server.stream((images for _ in range(REQUESTS)), lambda prev: boxes))
    launches = K.launches
    if launches != per_layer * REQUESTS:
        raise AssertionError(f"{launches} kernel launches for {REQUESTS} requests, "
                             f"expected {per_layer} per request")
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
    log(f"slice: PoseServer paper config bf16 B={B} {H}x{W}: {REQUESTS} requests, "
        f"{launches} kernel launches ({per_layer}/request), finite, SO(3) err {so3:.2e}, "
        f"p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
        f"{stats['fps']:.2f} img/s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    report["launches"] = launches
    report["slice"] = stats


def phase_e2e_f32():
    import torch

    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K
    from poet_tpu_torch.utils.init import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, (H, W) = 2, (480, 640)
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


def main() -> int:
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

    from poet_tpu_torch.ops.deform_attn_cuda import MS_DEFORM_ATTN_FWD as K

    K.build()
    ptxas = [ln for ln in K.build_log.splitlines() if "registers" in ln or "spill" in ln]
    log(f"build: {K.library_path().name} in {K.build_seconds:.2f} s (nvcc sm_90a)")
    for ln in ptxas:
        log(f"  ptxas {ln.strip()}")

    report = {}
    t0 = time.perf_counter()
    phase_kernel(report)
    phase_slice(report)
    phase_e2e_f32()
    log(f"phases 3-5 in {time.perf_counter() - t0:.1f} s on {card}")

    enc = report["encoder"]
    print(json.dumps({"kernels": [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "poet_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "poet_tpu/ops/deform_attn_pallas_v3.py:221",
        "launches": report["launches"],
        "max_abs_err": report["max_abs_err"],
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
