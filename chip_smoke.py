#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the deformable-attention kernels from poet_tpu_torch/csrc with
     nvcc, one process per source, in parallel;
  3. the forward kernel against its plain PyTorch version on the card:
     flagship encoder (Q=S=1600) and decoder (Q=10) shapes at B=16, edge
     level geometries, out-of-map and dummy-query locations; f32 and bf16;
     times; and autograd through the entry on CUDA tensors;
  4. the serving slice: the port's PoseServer at the paper config, bf16,
     batch 16, 480x640, seeded weights, the flagship numpy batch; outputs
     finite, rotations orthonormal with det +1, exactly 10 forward launches
     (5 encoder + 5 decoder layers) and no adjoint launch per request; p50 ms
     and img/s;
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
     launches per step, finite losses and grad norm, the frozen backbone
     bit-identical, the encoder moved; step p50 ms, img/s, peak memory;
  8. one f32 train step at B=2, 480x640, TF32 off: losses, grad norm and
     every gradient on the card (kernels) against the CPU port (plain).
Phases 3-8 take under 20 s on an H100 after a ~4 s build. The last two
lines are the kernel report and {"ok": true, "device": ...}. Exits
non-zero without a CUDA device, and imports no JAX.
"""

from __future__ import annotations

import contextlib
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


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def tf32_off():
    """Full f32 for cuBLAS and cuDNN (cuDNN convs default to TF32)."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


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


def adjoint_err(got, ref, mask=None, bf16=False):
    """Max |got - ref|, raising beyond ADJ_RTOL * max|ref| (plus one bf16
    rounding, 2^-8 relative, for a bf16 result)."""
    scale = max(ref.abs().max().item(), 1e-30)
    err = (got.float() - ref).abs()
    bound = ADJ_RTOL * scale + (BF16_RTOL * ref.abs() if bf16 else 0.0)
    bad = err > bound
    if mask is not None:
        err, bad = err[mask], bad[mask]
    return err.max().item() if err.numel() else 0.0, bool(bad.any())


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
            if got[0].dtype != dt or tuple(got[0].shape) != tuple(value.shape):
                raise AssertionError(f"{name}: d_value {got[0].dtype} {tuple(got[0].shape)}")
            if pad and not bool((got[0][:, S_lv:] == 0).all()):
                raise AssertionError(f"{name}: d_value rows past the levels are not 0")
            if Q >= 4 and not all(bool((t[:, -2:] == 0).all()) for t in got[1:]):
                raise AssertionError(f"{name}: dummy queries (-1, -10) got a gradient")
            errs = {}
            for k, gt, rf, m, b16 in zip(worst, got, ref, (None, mask, None),
                                         (dt == torch.bfloat16, False, False)):
                errs[k], bad = adjoint_err(gt, rf, m, b16)
                if bad:
                    raise AssertionError(f"{name} {dt}: {k} max |kernel - plain| {errs[k]:.3e} "
                                         f"beyond {ADJ_RTOL} x {rf.abs().max().item():.3e}"
                                         + (" + 2^-8 |ref|" if b16 else ""))
                if dt == torch.float32:
                    worst[k] = max(worst[k], errs[k])
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


def phase_slice(report):
    import torch

    from poet_tpu_torch.engine.serving import PoseServer
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import KERNELS
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

    for k in KERNELS:
        k.launches = 0
    results = list(server.stream((images for _ in range(REQUESTS)), lambda prev: boxes))
    counts = [k.launches for k in KERNELS]
    launches = counts[0]
    if counts != [per_layer * REQUESTS, 0, 0]:
        raise AssertionError(f"launches fwd/d_value/d_loc {counts} for {REQUESTS} requests, "
                             f"expected {per_layer} forward per request and no adjoint")
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
    report["launches"] = counts
    report["slice"] = stats


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


def phase_train(report):
    import torch

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import KERNELS
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 16, FLAGSHIP_HW
    cfg = flagship_config("bfloat16")                # dropout 0.1, AdamW, clip 0.1
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
    for k in KERNELS:
        k.launches = 0
    times, history = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = prepare_batch(cfg, images, pad_mask, targets, DEVICE)   # host match + upload
        history.append(fetch_metrics(step(*batch, gen)))               # syncs on the metrics
        times.append(time.perf_counter() - t0)
    launches = [k.launches for k in KERNELS]
    if launches != [per_step * TRAIN_STEPS] * 3:
        raise AssertionError(f"launches fwd/d_value/d_loc {launches} for {TRAIN_STEPS} steps, "
                             f"expected {per_step} each per step")
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
    log(f"train: paper config bf16 B={B} {H}x{W}, dropout {cfg.model.dropout}, AdamW: "
        f"{TRAIN_STEPS} steps, launches fwd/d_value/d_loc {launches} ({per_step} each per "
        f"step), loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}, grad_norm "
        f"{history[-1]['grad_norm']:.4f}, backbone bit-identical ({len(frozen)} tensors), "
        f"{w_name} moved; step p50 {stats['p50_ms']:.3f} ms, p95 {stats['p95_ms']:.3f} ms, "
        f"{stats['img_s']:.2f} img/s, peak mem {stats['peak_gib']:.2f} GiB")
    report["train_launches"] = launches
    report["train"] = stats


def phase_train_f32():
    import copy

    import torch

    from poet_tpu_torch.engine.train import global_norm, make_loss_fn, match_targets
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.ops.deform_attn_cuda import KERNELS
    from poet_tpu_torch.utils.init import init_weights

    B, (H, W) = 2, FLAGSHIP_HW
    cfg = flagship_config("float32")
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

    n0 = [k.launches for k in KERNELS]
    cpu_losses, cpu_grads = grads_on("cpu")
    if [k.launches for k in KERNELS] != n0:
        raise AssertionError("the CPU run launched a CUDA kernel")
    with tf32_off():
        card_losses, card_grads = grads_on(DEVICE)
    per_step = cfg.model.enc_layers + cfg.model.dec_layers
    if [k.launches - n for k, n in zip(KERNELS, n0)] != [per_step] * 3:
        raise AssertionError("the card step did not go through the three kernels")
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
    log(f"train f32 card-vs-CPU (B={B}, {H}x{W}, dropout 0, TF32 off): losses max rel err "
        f"{loss_err:.3e} (tol {TRAIN_F32_LOSS_RTOL}), grad norm {norm_err:.3e}; "
        f"{len(rows)} gradients: worst relative L2 {l2:.3e} ({l2_name}, tol "
        f"{TRAIN_F32_L2_RTOL}), worst max/max {mx:.3e} ({mx_name}, tol {TRAIN_F32_MAX_RTOL})")


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

    build_kernels()

    report = {}
    t0 = time.perf_counter()
    phase_kernel(report)
    phase_slice(report)
    phase_e2e_f32()
    phase_adjoint(report)
    phase_train(report)
    phase_train_f32()
    log(f"phases 3-8 in {time.perf_counter() - t0:.1f} s on {card}")

    enc, adj = report["encoder"], report["adjoint_encoder"]["bf16"]
    serve, train = report["launches"], report["train_launches"]
    errs = report["adjoint_max_abs_err"]
    src, tpu = "poet_tpu_torch/csrc/", "poet_tpu/ops/deform_attn_pallas_v3.py:"
    print(json.dumps({"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda", "source": src + "ms_deform_attn_fwd.cu",
         "replaces": tpu + "221", "launches": serve[0] + train[0],
         "launches_by_path": {"serve": serve[0], "train": train[0]},
         "max_abs_err": report["max_abs_err"], "ms": enc["ms"], "plain_ms": enc["plain_ms"]},
        {"name": "ms_deform_attn_bwd_dvalue", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "434",
         "launches": train[1], "launches_by_path": {"serve": serve[1], "train": train[1]},
         "max_abs_err": errs["d_value"], "ms": adj["dvalue"], "plain_ms": adj["plain_dvalue"],
         "plain_adjoint_ms": adj["plain"]},
        {"name": "ms_deform_attn_bwd_dloc", "route": "cuda",
         "source": src + "ms_deform_attn_bwd.cu", "replaces": tpu + "470",
         "launches": train[2], "launches_by_path": {"serve": serve[2], "train": train[2]},
         "max_abs_err": max(errs["d_loc"], errs["d_attn"]), "ms": adj["dloc"],
         "plain_ms": adj["plain_dloc"], "plain_adjoint_ms": adj["plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
