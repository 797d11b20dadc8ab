"""The serving cells: requests generated from the traffic file and the seed,
offered to `PoseServer` over the measured window, and the record the
metric readers take.

Traffic keys (`portbench/traffic/<name>.json`):
  kind        "serve"
  mode        "detector" (images alone) or "tracker" (images and boxes)
  batch, image_hw
  frames      the images' parameters (`portbench/lib/frames.py`)
  pool        distinct request batches drawn from the seed, served in turn
  arrival     "backlog": a recorded stream, always a frame waiting, served
              `depth` deep (frame k+1 enqueued before frame k is fetched);
              "rate": one frame batch due every 1 / rate_rps seconds, each
              sent when due and when the previous answer is back
  rate_rps, depth, warmup_requests, check_requests
  boxes       tracker mode: {"min_objects", "max_objects", "center", "size",
              "jitter"}: the first frame's boxes are drawn like the paper
              config's batches, each later frame's are the last answer's
              boxes moved by N(0, jitter^2), clipped to the image
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from portbench.lib import frames


class Requests:
    """The pool of request batches and, in tracker mode, each frame's boxes,
    all from the seed."""

    def __init__(self, t: dict, seed: int, device):
        self.t = t
        B, (H, W) = t["batch"], t["image_hw"]
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        self.pool = [frames.make(t["frames"], B, H, W, g, device).cpu().numpy()
                     for _ in range(t["pool"])]
        self.rng = np.random.default_rng([int(seed), 7])
        if t["mode"] == "tracker":
            self._first = self._draw_boxes()

    def images(self, k: int) -> np.ndarray:
        return self.pool[k % len(self.pool)]

    def _draw_boxes(self):
        b = self.t["boxes"]
        B, Q = self.t["batch"], self.t["num_queries"]
        n = self.rng.integers(b["min_objects"], b["max_objects"] + 1, size=B).astype(np.int32)
        boxes = np.full((B, Q, 4), -1.0, np.float32)
        labels = np.full((B, Q), -1, np.int32)
        for i in range(B):
            boxes[i, :n[i], :2] = self.rng.uniform(*b["center"], size=(n[i], 2))
            boxes[i, :n[i], 2:] = self.rng.uniform(*b["size"], size=(n[i], 2))
            labels[i, :n[i]] = self.rng.integers(1, self.t["n_classes"] + 1, size=n[i])
        return boxes, labels, n

    def tracker_inputs(self, prev: Optional[dict]):
        """(boxes, labels, n_boxes) of the next frame from the last answer."""
        if prev is None:
            boxes, labels, n = (x.copy() for x in self._first)
        else:
            boxes = prev["boxes"].astype(np.float32).copy()
            labels, n = prev["classes"].astype(np.int32), prev["n_boxes"].astype(np.int32)
            valid = np.arange(boxes.shape[1])[None, :] < n[:, None]
            step = self.rng.normal(0.0, self.t["boxes"]["jitter"], boxes.shape).astype(np.float32)
            moved = boxes + step * np.array([1, 1, 0.5, 0.5], np.float32)
            lo, hi = self.t["boxes"]["center"][0] * 0.5, 1.0 - self.t["boxes"]["center"][0] * 0.5
            moved[..., :2] = np.clip(moved[..., :2], lo, hi)
            moved[..., 2:] = np.clip(moved[..., 2:], *self.t["boxes"]["size"])
            boxes = np.where(valid[..., None], moved, -1.0).astype(np.float32)
        return boxes, labels, n


def serve_window(server, req: Requests, t: dict, seconds: float = math.inf, first: int = 0,
                 count: Optional[int] = None, ranges: Optional[dict] = None) -> dict:
    """Offer requests first, first+1, ... for `seconds` (or `count` of them,
    the warm-up), by the traffic's arrival rule. Returns {requests: [(k, due,
    sent, done)], outputs: {k: host answer}, window: (t0, t_end), host_s:
    [time in infer_async], next}. The window closes when the last request
    sent in it is answered. `ranges` (traced runs) takes each enqueue's and
    fetch's wall-clock (start, end) ns under "enqueue" and "fetch"."""
    tracker = t["mode"] == "tracker"
    recs, outputs, host_s = [], {}, []
    note = (lambda name, w0: ranges.setdefault(name, []).append((w0, time.time_ns()))) \
        if ranges is not None else (lambda name, w0: None)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = first
    more = (lambda now: k - first < count) if count is not None else (lambda now: now < deadline)
    if t["arrival"] == "backlog":
        pending: List[tuple] = []
        prev = None
        while True:
            now = time.perf_counter()
            if more(now):
                args = req.tracker_inputs(prev) if tracker else ()
                sent, w0 = time.perf_counter(), time.time_ns()
                out = server.infer_async(req.images(k), *args)
                host_s.append(time.perf_counter() - sent)
                note("enqueue", w0)
                pending.append((k, sent, sent, out))
                k += 1
            closing = not more(now)
            if pending and (len(pending) >= t.get("depth", 1) or closing):
                kk, due, sent, out = pending.pop(0)
                w0 = time.time_ns()
                prev = outputs[kk] = server.fetch(out)
                note("fetch", w0)
                recs.append((kk, due, sent, time.perf_counter()))
            if closing and not pending:
                break
    elif t["arrival"] == "rate":
        period = 1.0 / t["rate_rps"]
        prev = None
        while True:
            due = t0 + (k - first) * period
            if not more(due):
                break
            while time.perf_counter() < due:
                time.sleep(min(1e-3, max(0.0, due - time.perf_counter())))
            args = req.tracker_inputs(prev) if tracker else ()
            sent, w0 = time.perf_counter(), time.time_ns()
            out = server.infer_async(req.images(k), *args)
            host_s.append(time.perf_counter() - sent)
            note("enqueue", w0)
            w0 = time.time_ns()
            prev = outputs[k] = server.fetch(out)
            note("fetch", w0)
            recs.append((k, due, sent, time.perf_counter()))
            k += 1
    else:
        raise ValueError(f"arrival {t['arrival']!r}")
    t_end = recs[-1][3] if recs else time.perf_counter()
    return {"requests": recs, "outputs": outputs, "window": (t0, t_end), "host_s": host_s,
            "next": k}
