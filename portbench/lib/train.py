"""The training cells: batches made from the seed, the program's train step
(`engine/train.py`: `make_optimizer`, `make_train_step`, `prepare_batch`,
`fetch_metrics`) driven back to back, each step's metrics read one step
behind as the CLI's loop reads them, and the check of the first steps
against the plain reference.

Traffic keys (`portbench/traffic/<name>.json`):
  kind        "train"
  bbox_mode   the queries' source while training ("gt": the targets' boxes)
  batch, image_hw
  frames      the images' parameters (`portbench/lib/frames.py`)
  pool        distinct batches drawn from the seed, trained on in turn
  objects     {"min", "max", "center", "size"}: 1-10 objects an image with
              normalized cxcywh boxes, YCB-V labels, translations N(0, 1)
              and uniform random rotations, as the paper config's synthetic
              batches are drawn
  checked_steps  the first steps, which the reference follows
  rotation_band  [lo, hi] degrees: each target rotation is drawn (uniform
              candidates from the seed, the first that fits) so that every
              decoder layer's rotation for its query lies lo..hi degrees
              from it, by the plain reference's float32 forward at the
              seed's weights: the rotation loss's arccos is ill-conditioned
              near 0 and 180 degrees, where a rounding of the forward turns
              into a large change of the gradient (and, through the clip's
              global norm, of every leaf's)
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import frames, program


def make_batches(t: dict, n_classes: int, Q: int, seed: int, device, conf=None,
                 state=None) -> List[dict]:
    B, (H, W) = t["batch"], t["image_hw"]
    o = t["objects"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    rng = np.random.default_rng([int(seed), 13])
    out = []
    for _ in range(t["pool"]):
        n = rng.integers(o["min"], o["max"] + 1, size=B).astype(np.int32)
        boxes = np.full((B, Q, 4), -1.0, np.float32)
        labels = np.full((B, Q), -1, np.int32)
        valid = np.arange(Q)[None, :] < n[:, None]
        boxes[..., :2] = np.where(valid[..., None], rng.uniform(*o["center"], (B, Q, 2)), -1.0)
        boxes[..., 2:] = np.where(valid[..., None], rng.uniform(*o["size"], (B, Q, 2)), -1.0)
        labels[:] = np.where(valid, rng.integers(1, n_classes + 1, (B, Q)), -1)
        q, r = np.linalg.qr(rng.normal(size=(B * Q, 3, 3)))
        q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
        q[:, :, 0] *= np.linalg.det(q)[:, None]
        out.append({
            "images": frames.make(t["frames"], B, H, W, g, device).cpu().numpy(),
            "pad_mask": np.zeros((B, H, W), bool),
            "boxes": boxes, "labels": labels, "n_boxes": n,
            "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
            "relative_rotation": q.reshape(B, Q, 3, 3).astype(np.float32)})
    if conf is not None and t.get("rotation_band"):
        for i, b in enumerate(out):
            b["relative_rotation"] = banded_rotations(conf, t, state, b, [int(seed), 17, i],
                                                      device)
    return out


def banded_rotations(conf, t: dict, state, batch: dict, seed, device,
                     candidates: int = 64) -> np.ndarray:
    """Target rotations (B, Q, 3, 3) f32 each lying `rotation_band` degrees
    from every decoder layer's prediction for its query (the reference's
    float32 forward); slots past n_boxes keep the batch's."""
    from portbench.lib.checks import reference_poses

    R = reference_poses(conf, t, state, batch, device).astype(np.float64)  # (L, B, Q, 3, 3)
    B, Q = R.shape[1:3]
    quat = np.random.default_rng(seed).normal(size=(B, Q, candidates, 4))
    w, x, y, z = np.moveaxis(quat / np.linalg.norm(quat, axis=-1, keepdims=True), -1, 0)
    cand = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                    -1).reshape(B, Q, candidates, 3, 3)
    rel = R[:, :, :, None] @ np.swapaxes(cand, -1, -2)[None]
    cos = 0.5 * (np.trace(rel, axis1=-2, axis2=-1) - 1.0)
    theta = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))              # (L, B, Q, K)
    lo, hi = t["rotation_band"]
    ok = ((theta >= lo) & (theta <= hi)).all(0)
    valid = np.arange(Q)[None, :] < batch["n_boxes"][:, None]
    if not ok.any(-1)[valid].all():
        raise ValueError(f"no candidate of {candidates} lies {lo}..{hi} degrees from every layer")
    pick = np.take_along_axis(cand, ok.argmax(-1)[..., None, None, None], 2)[:, :, 0]
    return np.where(valid[..., None, None], pick, batch["relative_rotation"]).astype(np.float32)


TARGET_KEYS = ("boxes", "labels", "n_boxes", "relative_position", "relative_rotation")


def half(batch: dict) -> dict:
    """The first half of a batch's rows (the 'half the batch left out'
    fault: the step's mean is then over the rest)."""
    return {k: v[: len(v) // 2] for k, v in batch.items()}


class Trainer:
    """The program's training step as one object: model, optimizer, step
    function and dropout generator, built once and handed from the checked
    first steps to the window."""

    def __init__(self, conf, t: dict, state, seed: int, device):
        from poet_tpu_torch.engine.train import make_optimizer, make_train_step

        self.cfg, self.model = program.build(conf, state, device,
                                             model_overrides={"bbox_mode": t["bbox_mode"]})
        for k, v in t["optimizer"].items():
            setattr(self.cfg.optim, k, tuple(v) if isinstance(v, list) else v)
        self.opt = make_optimizer(self.cfg, self.model, steps_per_epoch=10 ** 9)
        self.step_fn = make_train_step(self.model, self.cfg, self.opt)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device

    def enqueue(self, batch: dict):
        """prepare_batch (host match, pinned upload) and the step's call:
        the step's metrics, still on the device."""
        from poet_tpu_torch.engine.train import prepare_batch

        b = prepare_batch(self.cfg, batch["images"], batch["pad_mask"],
                          {k: batch[k] for k in TARGET_KEYS}, self.device)
        return self.step_fn(*b, self.gen)

    @staticmethod
    def fetch(metrics) -> Dict[str, float]:
        from poet_tpu_torch.engine.train import fetch_metrics

        return fetch_metrics(metrics)

    def trained(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.opt.param_names, self.opt.params))

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        """After one update: each trained leaf's gradient as the optimizer
        took it (clipped), from AdamW's first moment, (1 - b1) g."""
        b1 = self.opt.torch_opt.param_groups[0]["betas"][0]
        state = self.opt.torch_opt.state
        return {n: (state[p]["exp_avg"].detach().float() / (1.0 - b1) if "exp_avg" in state[p]
                    else torch.zeros_like(p)) for n, p in self.trained().items()}


def train_window(tr: Trainer, batches: List[dict], seconds: float, first: int,
                 ranges=None, after_enqueue=None) -> dict:
    """Steps back to back for `seconds`, each step's metrics fetched after
    the next step is enqueued. A step counts once its metrics are on the
    host; the window closes with the last step enqueued in it."""
    steps, host_s = [], []
    note = (lambda name, w0: ranges.setdefault(name, []).append((w0, time.time_ns()))) \
        if ranges is not None else (lambda name, w0: None)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k, pending = first, None
    while True:
        now = time.perf_counter()
        nxt = None
        if now < deadline:
            sent, w0 = time.perf_counter(), time.time_ns()
            nxt = (k, sent, tr.enqueue(batches[k % len(batches)]))
            host_s.append(time.perf_counter() - sent)
            if after_enqueue:
                after_enqueue()
            note("enqueue", w0)
            k += 1
        if pending is not None:
            w0 = time.time_ns()
            tr.fetch(pending[2])
            note("fetch", w0)
            steps.append((pending[0], pending[1], time.perf_counter()))
        if nxt is None:
            break
        pending = nxt
    return {"steps": steps, "window": (t0, steps[-1][2] if steps else time.perf_counter()),
            "host_s": host_s, "next": k}
