"""Fixed-shape pose serving, tracker and detector modes.

Counterpart of `poet_tpu/engine/serving.py:PoseServer`. Tracker mode
(bbox_mode 'gt'/'jitter'): the caller supplies boxes (e.g. from an EKF
predictor) and PoET refines poses for exactly those boxes. Detector mode
(bbox_mode='backbone'): the detector inside the model (Mask R-CNN or
YOLOv4-CSP, both answering {boxes, scores, labels, valid}) finds the boxes,
and requests carry images only. Shapes are fixed per server (batch
size, image size), the model runs on the card unless the caller passes
another device, and every forward runs under `torch.inference_mode()`.
With bf16 compute the bf16-compute weights are cast once at rest
(`utils/params.py`). A model with the aleatoric heads answers per-axis
variances beside the poses, `translation_var` and `rotation_var` =
exp(log sigma^2) of the last decoder layer, for an EKF tracker, in both
modes and from `stream` too. `devices=[...]` serves one batch across
several devices, the counterpart of JAX's `mesh=` (`poet_tpu/engine/
serving.py:46-83`): one replica per device, each request's batch split into
equal contiguous shards.

Not ported yet (ROADMAP queue A): the portable `export_model` artifact.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.utils.params import cast_params_for_inference


class PoseServer:
    """Pose estimation endpoint for a fixed (batch, H, W) on one device, or
    split across `devices`.

    `model` is a built and initialized PoET module (`models.build_model`
    plus `utils/init.py:init_weights` or `utils/jax_params.py:load_jax_params`);
    the server moves it to `device` (the card unless the caller passes
    another, e.g. "cpu") and owns it from then on. A bbox_mode='backbone'
    model makes a detector-mode server: requests carry images only.

    With `devices` (a list of devices, possibly the same one repeated) the
    server holds one replica of the model per entry, the first the model
    itself on `devices[0]`, and splits each request's batch into equal
    contiguous shards, shard i on replica i: `batch_size` must divide by
    their number (JAX asserts the same of its 'data' axis). Every shard's
    forward is enqueued before any is fetched, and the outputs are joined on
    `devices[0]` in shard order. `device` is then unused.
    """

    def __init__(self, cfg: PoETConfig, model: nn.Module, batch_size: int = 1,
                 image_size=(480, 640), latency_window: int = 1000,
                 device="cuda", devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.detector_mode = cfg.model.bbox_mode == "backbone"
        devices = [torch.device(d) for d in (devices if devices else [device])]
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} does not split over {len(devices)} "
                             "devices")
        self.device = devices[0]
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self._shard = batch_size // len(devices)
        model = model.eval()
        if cfg.model.dtype == "bfloat16":
            cast_params_for_inference(model)
        self.replicas = []
        for i, dev in enumerate(devices):
            replica = (model if i == 0 else copy.deepcopy(model)).to(dev)
            if dev.type == "cuda":
                # cuDNN's fast bf16 convs want NHWC; the NHWC input is already that
                replica = replica.to(memory_format=torch.channels_last)
            self.replicas.append((dev, replica))
        self.model = self.replicas[0][1]
        H, W = self.image_size
        self._pad_masks = [torch.zeros((self._shard, H, W), dtype=torch.bool, device=dev)
                           for dev, _ in self.replicas]
        self._pad_mask = self._pad_masks[0]
        self._latencies = deque(maxlen=latency_window)

    @staticmethod
    def _put(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    def _targets(self, boxes, labels, n_boxes) -> Optional[Dict[str, np.ndarray]]:
        """The request's boxes, labels and counts (host arrays; None in
        detector mode)."""
        B, Q = self.batch_size, self.cfg.model.num_queries
        if self.detector_mode:
            if boxes is not None or labels is not None or n_boxes is not None:
                raise ValueError("detector mode finds its own boxes; pass images only")
            return None
        if boxes is None:
            raise ValueError("tracker mode needs boxes (cxcywh, normalized)")
        boxes = np.asarray(boxes, np.float32)
        if boxes.shape != (B, Q, 4):
            raise ValueError(f"boxes {boxes.shape} != {(B, Q, 4)}")
        return {
            "boxes": boxes,
            "labels": np.asarray(labels if labels is not None else np.ones((B, Q))),
            "n_boxes": np.asarray(n_boxes if n_boxes is not None else np.full(B, Q)),
        }

    def _outputs(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        res = {
            "translation": out["translations"][-1],
            "rotation": out["rotations"][-1],
            "boxes": out["pred_boxes"],
            "classes": out["pred_classes"],
            "n_boxes": out["n_boxes"],
        }
        if self.cfg.model.aleatoric:
            # s = log sigma^2 -> per-axis variances for the EKF consumer
            res["translation_var"] = torch.exp(out["translations_aleatoric"][-1])
            res["rotation_var"] = torch.exp(out["rotations_aleatoric"][-1])
        return res

    def infer_async(self, images: np.ndarray, boxes: Optional[np.ndarray] = None,
                    labels: Optional[np.ndarray] = None,
                    n_boxes: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """Enqueue one frame (batch) and return device tensors; `fetch`
        materializes them on the host. In tracker mode nothing waits for the
        device. In detector mode the NMS fixed points read one bool per
        iteration and the final NMS its certificates: the host waits for the
        device there, inside the forward, so what a caller can overlap with
        the card is the rest of the forward's enqueue and its own host work."""
        B, (H, W) = self.batch_size, self.image_size
        if tuple(images.shape) != (B, H, W, 3):
            raise ValueError(f"images {tuple(images.shape)} != {(B, H, W, 3)}")
        dtypes = {"boxes": torch.float32, "labels": torch.int32, "n_boxes": torch.int32}
        with torch.inference_mode():
            targets = self._targets(boxes, labels, n_boxes)
            outs = []
            for i, (dev, replica) in enumerate(self.replicas):
                rows = slice(i * self._shard, (i + 1) * self._shard)
                shard = None if targets is None else {
                    k: self._put(v[rows], dtypes[k], dev) for k, v in targets.items()}
                img = self._put(images[rows], torch.float32, dev)
                outs.append(self._outputs(replica(img, self._pad_masks[i], shard)))
            if len(outs) == 1:
                return outs[0]
            return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    @staticmethod
    def fetch(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Materialize an `infer_async` result on the host (blocks)."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def infer(self, images: np.ndarray, boxes: Optional[np.ndarray] = None,
              labels: Optional[np.ndarray] = None,
              n_boxes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One synchronous frame (batch). images (B, H, W, 3) float32 in [0, 1]."""
        t0 = time.perf_counter()
        host = self.fetch(self.infer_async(images, boxes, labels, n_boxes))
        self._latencies.append(time.perf_counter() - t0)
        return host

    def stream(self, frames, boxes_fn=None):
        """Streaming driver over (B, H, W, 3) frames, results in frame order.

        Detector mode: pipelined, as in JAX — frame k+1 is enqueued before
        frame k is fetched. The overlap is bounded: frame k+1's NMS host
        reads wait for the card to finish frame k and frame k+1's backbone
        and RPN (see `infer_async`).

        Tracker mode (`boxes_fn` given): serial by necessity.
        `boxes_fn(prev_host_result)` (None for the first frame) returns
        (boxes, labels, n_boxes) for the next frame, so frame k+1 depends on
        frame k's output and nothing overlaps; each frame's latency is
        recorded as in `infer`. The pipelined loop records none."""
        if not self.detector_mode:
            prev_host = None
            for frame in frames:
                b, l, n = boxes_fn(prev_host)
                prev_host = self.infer(frame, boxes=b, labels=l, n_boxes=n)
                yield prev_host
            return
        pending = None
        for frame in frames:
            nxt = self.infer_async(frame)
            if pending is not None:
                yield self.fetch(pending)
            pending = nxt
        if pending is not None:
            yield self.fetch(pending)

    def reset_latency_stats(self) -> None:
        """Forget recorded latencies (e.g. after warm-up requests)."""
        self._latencies.clear()

    def latency_stats(self) -> Dict[str, float]:
        if not self._latencies:
            return {}
        arr = np.asarray(self._latencies) * 1e3
        return {
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "fps": float(self.batch_size / np.mean(arr) * 1e3),
            "frames": len(arr),
        }
