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

`export_model` writes the portable artifact, a `torch.export` program of the
fixed-shape forward with its weights, and `ExportedPoseServer` serves it
without importing any model code (see `export_model`).

While a profiler records, a request is a `serve.request` span (`unit` its
number), holding `serve.upload` (its bytes) and `serve.forward`; `fetch` is
a `serve.fetch` span (the bytes it brought back) of the same `unit`
(`utils/tracing.py`).
"""

from __future__ import annotations

import copy
import json
import os
import time
from collections import deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.utils.params import cast_params_for_inference
from poet_tpu_torch.utils.tracing import span


TARGET_DTYPES = {"boxes": torch.float32, "labels": torch.int32, "n_boxes": torch.int32}


class Answer(dict):
    """A request's device tensors (`infer_async`), and `unit`, the server's
    number of the request, which `fetch`'s span carries."""

    __slots__ = ("unit",)

    def __init__(self, tensors: Dict[str, torch.Tensor], unit: int):
        super().__init__(tensors)
        self.unit = unit


def serving_outputs(out: Dict[str, torch.Tensor], aleatoric: bool) -> Dict[str, torch.Tensor]:
    """What a request answers, from the model's forward: the last decoder
    layer's poses, the boxes and classes they belong to, and with the
    aleatoric heads the per-axis variances."""
    res = {
        "translation": out["translations"][-1],
        "rotation": out["rotations"][-1],
        "boxes": out["pred_boxes"],
        "classes": out["pred_classes"],
        "n_boxes": out["n_boxes"],
    }
    if aleatoric:
        # s = log sigma^2 -> per-axis variances for the EKF consumer
        res["translation_var"] = torch.exp(out["translations_aleatoric"][-1])
        res["rotation_var"] = torch.exp(out["rotations_aleatoric"][-1])
    return res


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
        self.num_queries = cfg.model.num_queries
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
        self._requests = 0

    @staticmethod
    def _put(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)

    @staticmethod
    def _upload(images: np.ndarray, targets: Optional[Dict[str, np.ndarray]], device):
        """(images, targets) of a request or shard on `device`: one
        `serve.upload` span."""
        with span("serve.upload") as sp:
            img = PoseServer._put(images, torch.float32, device)
            if targets is not None:
                targets = {k: PoseServer._put(v, TARGET_DTYPES[k], device)
                           for k, v in targets.items()}
            if sp:
                sp.add(bytes=img.nbytes + sum(v.nbytes for v in (targets or {}).values()))
        return img, targets

    def _targets(self, boxes, labels, n_boxes) -> Optional[Dict[str, np.ndarray]]:
        """The request's boxes, labels and counts (host arrays; None in
        detector mode)."""
        B, Q = self.batch_size, self.num_queries
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
        return serving_outputs(out, self.cfg.model.aleatoric)

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
        targets = self._targets(boxes, labels, n_boxes)
        unit = self._requests
        self._requests += 1
        with span("serve.request", unit=unit), torch.inference_mode():
            outs = []
            for i, (dev, replica) in enumerate(self.replicas):
                rows = slice(i * self._shard, (i + 1) * self._shard)
                img, shard = self._upload(images[rows], None if targets is None else {
                    k: v[rows] for k, v in targets.items()}, dev)
                with span("serve.forward"):
                    outs.append(self._outputs(replica(img, self._pad_masks[i], shard)))
            if len(outs) == 1:
                return Answer(outs[0], unit)
            return Answer({k: torch.cat([o[k].to(self.device) for o in outs])
                           for k in outs[0]}, unit)

    @staticmethod
    def fetch(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Materialize an `infer_async` result on the host (blocks)."""
        with span("serve.fetch", unit=getattr(out, "unit", None)) as sp:
            host = {k: v.cpu().numpy() for k, v in out.items()}
            if sp:
                sp.add(bytes=sum(v.nbytes for v in host.values()))
        return host

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


# ---------------------------------------------------------------------------
# Portable export: the "engine file" of the TensorRT deployment analogy.
# ---------------------------------------------------------------------------

PLATFORMS = ("cpu", "cuda")


class _ServingForward(nn.Module):
    """The model's forward reduced to what a request answers (`serving_outputs`)."""

    def __init__(self, model: nn.Module, aleatoric: bool):
        super().__init__()
        self.model, self.aleatoric = model, aleatoric

    def forward(self, images, pad_mask, targets=None):
        return serving_outputs(self.model(images, pad_mask, targets), self.aleatoric)


def export_model(cfg: PoETConfig, model: nn.Module, path: str, batch_size: int = 1,
                 image_size=(480, 640), platforms: Sequence[str] = PLATFORMS) -> str:
    """Serialize the fixed-shape inference program and its weights to `path`,
    the counterpart of `poet_tpu/engine/serving.py:export_model`:
    `module.pt2` (`torch.export.save` of the program, the weights inside)
    and `meta.json` (batch size, image size, bbox_mode, num_queries,
    platforms, dtype, aleatoric). `ExportedPoseServer(path)` runs it
    without importing any model code. Returns `path`.

    The program is PoseServer's forward (eval mode, with bf16 compute the
    bf16 weights cast at rest) traced by `torch.export.export` on a copy of
    `model` on the CPU at the fixed (B, H, W): images and pad mask in, and
    in tracker mode (bbox_mode 'gt'/'jitter') the targets {boxes, labels,
    n_boxes}; in detector mode (bbox_mode 'backbone': Mask R-CNN or
    YOLOv4-CSP) images alone. Every hand-written kernel of the path is a
    custom operator (`torch.ops.poet_tpu_torch.*`: the deformable sampling,
    the dense 'pallas' forward, RoIAlign's blend, the stem conv) and the
    detector's NMS fixed points and certificate are the `while_loop` and
    `cond` operators, so the program holds the kernels' calls and the loops
    whole (a Python loop reading the host would be traced as one unrolled
    path), and is moved to a device when it is loaded.

    `platforms` lists the devices the artifact may be served on, 'cpu'
    and 'cuda'. The departure from JAX: JAX pins 'auto' to the separable
    XLA path because its Pallas kernel lowers only on a TPU; the port pins
    nothing, since each custom operator carries a CPU implementation (the
    plain version) and a CUDA one (the kernel), and one program serves both,
    launching the hand-written kernels on the card. The port has no TPU:
    'tpu' raises ValueError.
    """
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"export platforms {list(platforms)}: the port serves {PLATFORMS}"
                         + (" and has no TPU" if "tpu" in bad else ""))
    B, (H, W) = batch_size, tuple(image_size)
    Q = cfg.model.num_queries
    model = copy.deepcopy(model).cpu().eval()
    if cfg.model.dtype == "bfloat16":
        cast_params_for_inference(model)
    args = (torch.zeros((B, H, W, 3)), torch.zeros((B, H, W), dtype=torch.bool))
    if cfg.model.bbox_mode != "backbone":
        args += ({"boxes": torch.zeros((B, Q, 4)),
                  "labels": torch.ones((B, Q), dtype=torch.int32),
                  "n_boxes": torch.full((B,), Q, dtype=torch.int32)},)
    with torch.no_grad():
        program = torch.export.export(_ServingForward(model, cfg.model.aleatoric), args)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, "module.pt2"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"batch_size": B, "image_size": [H, W], "bbox_mode": cfg.model.bbox_mode,
                   "num_queries": Q, "platforms": list(platforms), "dtype": cfg.model.dtype,
                   "aleatoric": bool(cfg.model.aleatoric)}, f)
    return path


class ExportedPoseServer:
    """Serve an `export_model` artifact on `device` (the card unless the
    caller passes another), importing no model code: `torch.export.load`,
    then `move_to_device_pass` to the device, which must be one of the
    artifact's platforms. Only `poet_tpu_torch.ops` (it registers the custom
    operators the program calls) and this module are needed.

    Serves the live `PoseServer`'s API: `infer`, `infer_async` / `fetch`,
    `stream` and `latency_stats`. Each request's inputs are uploaded once,
    as `PoseServer` does."""

    def __init__(self, path: str, device="cuda", latency_window: int = 1000):
        import poet_tpu_torch.ops  # noqa: F401  (registers the custom operators)
        from torch.export.passes import move_to_device_pass

        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.device = torch.device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"the artifact serves {self.meta['platforms']}, not "
                             f"{self.device.type}")
        program = torch.export.load(os.path.join(path, "module.pt2"))
        self.program = move_to_device_pass(program, self.device)
        self._call = self.program.module()
        self.batch_size = self.meta["batch_size"]
        self.image_size = tuple(self.meta["image_size"])
        self.num_queries = self.meta["num_queries"]
        self.detector_mode = self.meta["bbox_mode"] == "backbone"
        H, W = self.image_size
        self._pad_mask = torch.zeros((self.batch_size, H, W), dtype=torch.bool,
                                     device=self.device)
        self._latencies = deque(maxlen=latency_window)
        self._requests = 0

    def infer_async(self, images: np.ndarray, boxes: Optional[np.ndarray] = None,
                    labels: Optional[np.ndarray] = None,
                    n_boxes: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        """Run one frame (batch) and return device tensors (see
        `PoseServer.infer_async`); `fetch` materializes them. In detector
        mode the program's NMS `while_loop`s and the certificate's `cond`
        read their conditions as the live forward does (one bool per
        iteration, one for the batch), so the host waits there too."""
        B, (H, W) = self.batch_size, self.image_size
        if tuple(images.shape) != (B, H, W, 3):
            raise ValueError(f"images {tuple(images.shape)} != {(B, H, W, 3)}")
        targets = self._targets(boxes, labels, n_boxes)
        unit = self._requests
        self._requests += 1
        with span("serve.request", unit=unit), torch.inference_mode():
            img, targets = PoseServer._upload(images, targets, self.device)
            with span("serve.forward"):
                out = (self._call(img, self._pad_mask) if targets is None
                       else self._call(img, self._pad_mask, targets))
            return Answer(out, unit)

    _targets = PoseServer._targets
    fetch = staticmethod(PoseServer.fetch)
    infer = PoseServer.infer
    stream = PoseServer.stream
    reset_latency_stats = PoseServer.reset_latency_stats
    latency_stats = PoseServer.latency_stats
