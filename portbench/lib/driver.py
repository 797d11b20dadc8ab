"""One run of one cell: set-up (weights, program, requests, warm-up), the
measured window (traced or not), the device's readings, then the check
against the reference on a sample of the window's answers. Returns the run
record that the metric readers take."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import checks, flops, program, serve, weights
from portbench.lib import trace as tracing


class Spans:
    """Ranges from forward hooks on the module paths that the
    configuration's "spans" names: {name: [start module, "pre"|"post", end
    module, "pre"|"post"]}, each as wall-clock ns (the trace's clock) and as
    a host-clock duration (for host metrics). `ranges` also takes the
    serving loop's own spans."""

    def __init__(self, model, spec: Dict[str, list]):
        self.host: Dict[str, List[float]] = {k: [] for k in spec}
        self.ranges: Dict[str, list] = {k: [] for k in spec}
        self.open: Dict[str, tuple] = {}
        self.handles = []
        for name, (m0, w0, m1, w1) in spec.items():
            self._hook(model.get_submodule(m0), w0, lambda n=name: self.start(n))
            self._hook(model.get_submodule(m1), w1, lambda n=name: self.end(n))

    def _hook(self, module, when, fn):
        if when == "pre":
            self.handles.append(module.register_forward_pre_hook(lambda *a: fn()))
        else:
            self.handles.append(module.register_forward_hook(lambda *a: fn()))

    def start(self, name):
        self.open[name] = (time.perf_counter(), time.time_ns())

    def end(self, name):
        if name not in self.open:
            return
        t0, w0 = self.open.pop(name)
        self.ranges.setdefault(name, []).append((w0, time.time_ns()))
        self.host.setdefault(name, []).append(time.perf_counter() - t0)

    def remove(self):
        for h in self.handles:
            h.remove()


class DeformCalls:
    """The shape of every deformable-attention call (the program's
    `MSDeformAttn` modules, found by class name), for the roofline."""

    def __init__(self, model):
        self.calls = []
        self.handles = [m.register_forward_hook(self.record) for _, m in model.named_modules()
                        if type(m).__name__ == "MSDeformAttn"]

    def record(self, mod, args, out):
        query, _, flat = args[:3]
        B, Q = query.shape[:2]
        S, C = flat.shape[1], flat.shape[2]
        call = (B, S, Q, mod.n_heads, C // mod.n_heads, mod.n_levels, mod.n_points,
                out.element_size())
        self.calls.append(call + (False,))
        if out.requires_grad:           # training: the adjoint runs too
            self.calls.append(call + (True,))

    def remove(self):
        for h in self.handles:
            h.remove()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def breakdown(tr: tracing.Trace) -> dict:
    ops = sorted(tr.by_class().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [list(g) for g in tr.idle_gaps()]}


def run_cell(conf, t: dict, args, device, t_start: float, fault=None) -> dict:
    if t["kind"] == "serve":
        return run_serve(conf, t, args, device, t_start)
    if t["kind"] == "train":
        return run_train(conf, t, args, device, t_start, fault)
    raise ValueError(f"traffic kind {t['kind']!r}")


class Phases(dict):
    """Seconds of each part of the set-up, from process start."""

    def __init__(self, t_start: float, device):
        super().__init__(imports=time.perf_counter() - t_start)
        self.t_start, self.device = t_start, device

    def __call__(self, name: str) -> None:
        sync(self.device)
        self[name] = time.perf_counter() - self.t_start - sum(self.values())


def start_trace(model, conf, device):
    spans = Spans(model, conf.data["spans"])
    deform = DeformCalls(model)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.__enter__()
    return spans, deform, prof, time.time_ns()


def end_trace(record, spans, deform, prof, w0) -> None:
    spans.ranges["window"] = [(w0, time.time_ns())]
    prof.__exit__(None, None, None)
    spans.remove()
    deform.remove()
    tr = tracing.collect(prof, spans.ranges)
    record.update(trace=tr, spans_host=spans.host, deform_calls=deform.calls,
                  breakdown=breakdown(tr))
    record["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_train(conf, t: dict, args, device, t_start: float, fault=None) -> dict:
    """fault: None, or 'half' (the program trains on the first half of each
    batch's rows, a fault the check must catch)."""
    from portbench.lib import train

    phase = Phases(t_start, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = weights.make_weights(conf, args.seed, device)
    phase("weights")
    m = conf.model
    batches = train.make_batches(t, m["n_classes"], m["num_queries"], args.seed, device,
                                 conf, state)
    feed = batches if fault is None else [train.half(b) for b in batches]
    phase("requests")
    tr = train.Trainer(conf, t, state, args.seed, device)
    phase("program")
    p0 = {k: v.detach().clone() for k, v in tr.trained().items()}
    prog = {"loss": []}
    for s in range(t["checked_steps"]):
        prog["loss"].append(tr.fetch(tr.enqueue(feed[s % len(feed)]))["loss"])
        if s == 0:
            grads = tr.first_gradient()
            prog["grad"] = {k: float(v.norm()) for k, v in grads.items()}
            prog["grad_vec"] = {k: v.cpu() for k, v in grads.items()}
            del grads
    prog["change"] = {k: float((v.detach() - p0[k]).norm()) for k, v in tr.trained().items()}
    del p0
    phase("warmup")
    setup_s = time.perf_counter() - t_start

    traced = start_trace(tr.model, conf, device) if args.trace else None
    if traced:
        spans = traced[0]
        spans.handles.append(tr.model.register_forward_hook(
            lambda *a: spans.start("backward")))
    win = train.train_window(tr, feed, args.seconds, t["checked_steps"],
                             ranges=traced[0].ranges if traced else None,
                             after_enqueue=(lambda: traced[0].end("backward")) if traced
                             else None)
    sync(device)
    record = {"kind": "train", "batch": t["batch"], "setup_s": setup_s, "setup_phases": phase,
              "steps": win["steps"], "window_s": win["window"][1] - win["window"][0],
              "host_s": win["host_s"], "images": t["batch"] * len(win["steps"]),
              "flops_per_image": flops.model_flops(conf, *t["image_hw"], train=True)}
    record["device"] = device_info(device, 1)
    if traced:
        end_trace(record, *traced)
    record["attempted"] = len(win["steps"])
    record["failed"] = 0
    del tr
    release(device)
    ref = checks.reference_training(conf, t, state, batches, device)
    record["checks"] = checks.train_readings(prog, ref)
    record["leaf_report"] = checks.leaf_report(prog, ref)
    return record


def run_serve(conf, t: dict, args, device, t_start: float) -> dict:
    B, hw = t["batch"], tuple(t["image_hw"])
    phase = Phases(t_start, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = weights.make_weights(conf, args.seed, device)
    phase("weights")
    cfg, model = program.build(conf, state, device)
    server = program.pose_server(cfg, model, B, hw, device)
    phase("program")
    req = serve.Requests(dict(t, num_queries=conf.model["num_queries"],
                              n_classes=conf.model["n_classes"]), args.seed, device)
    tt = req.t
    phase("requests")
    warm = serve.serve_window(server, req, tt, count=t["warmup_requests"])
    phase("warmup")
    setup_s = time.perf_counter() - t_start

    traced = start_trace(server.model, conf, device) if args.trace else None
    win = serve.serve_window(server, req, tt, seconds=args.seconds, first=warm["next"],
                             ranges=traced[0].ranges if traced else None)
    sync(device)
    record = {"kind": "serve", "mode": t["mode"], "batch": B, "setup_s": setup_s,
              "setup_phases": phase,
              "requests": win["requests"], "window_s": win["window"][1] - win["window"][0],
              "host_s": win["host_s"], "images": B * len(win["requests"]),
              "flops_per_image": flops.model_flops(conf, *hw)}
    record["device"] = device_info(device, 1)
    if traced:
        end_trace(record, *traced)
    record["attempted"] = len(win["requests"])
    record["failed"] = 0

    # the program's state goes before the reference runs on the card
    del server, model
    release(device)
    record["checks"] = check_sample(conf, state, req, win, args.seed, hw, device)
    return record


def check_sample(conf, state, req, win, seed: int, hw, device) -> Dict[str, float]:
    """The reference's verdict on `check_requests` answers of the window,
    drawn from the seed: one request a pool batch, the batches drawn."""
    first = {}
    for k, *_ in win["requests"]:
        first.setdefault(k % len(req.pool), k)
    rng = np.random.default_rng([int(seed), 11])
    pools = sorted(first)
    pick = rng.permutation(len(pools))[:req.t["check_requests"]]
    per = []
    for i in sorted(pick):
        k = first[pools[i]]
        ans = win["outputs"][k]
        ref = checks.reference_answers(conf, state, req.images(k), ans, device)
        per.append(checks.readings(ans, ref, hw))
    return checks.worst(per)
