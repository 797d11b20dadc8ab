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
(`utils/params.py`).

Not ported yet (ROADMAP queue A): the portable `export_model` artifact.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.utils.params import cast_params_for_inference


class PoseServer:
    """Pose estimation endpoint for a fixed (batch, H, W) on one device.

    `model` is a built and initialized PoET module (`models.build_model`
    plus `utils/init.py:init_weights` or `utils/jax_params.py:load_jax_params`);
    the server moves it to `device` (the card unless the caller passes
    another, e.g. "cpu") and owns it from then on. A bbox_mode='backbone'
    model makes a detector-mode server: requests carry images only.
    """

    def __init__(self, cfg: PoETConfig, model: nn.Module, batch_size: int = 1,
                 image_size=(480, 640), latency_window: int = 1000,
                 device="cuda"):
        self.cfg = cfg
        self.detector_mode = cfg.model.bbox_mode == "backbone"
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        model = model.to(self.device).eval()
        if cfg.model.dtype == "bfloat16":
            cast_params_for_inference(model)
        if self.device.type == "cuda":
            # cuDNN's fast bf16 convs want NHWC; the NHWC input is already that
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        B, (H, W) = batch_size, self.image_size
        self._pad_mask = torch.zeros((B, H, W), dtype=torch.bool, device=self.device)
        self._latencies = deque(maxlen=latency_window)

    def _put(self, x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device=self.device, dtype=dtype)

    def _targets(self, boxes, labels, n_boxes) -> Optional[Dict[str, torch.Tensor]]:
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
            "boxes": self._put(boxes, torch.float32),
            "labels": self._put(labels if labels is not None else np.ones((B, Q)),
                                torch.int32),
            "n_boxes": self._put(n_boxes if n_boxes is not None else np.full(B, Q),
                                 torch.int32),
        }

    @staticmethod
    def _outputs(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            "translation": out["translations"][-1],
            "rotation": out["rotations"][-1],
            "boxes": out["pred_boxes"],
            "classes": out["pred_classes"],
            "n_boxes": out["n_boxes"],
        }

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
        with torch.inference_mode():
            targets = self._targets(boxes, labels, n_boxes)
            img = self._put(images, torch.float32)
            return self._outputs(self.model(img, self._pad_mask, targets))

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
