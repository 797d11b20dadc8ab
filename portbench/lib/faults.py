"""Faults planted under the timed path, each of which a cell's check has to
read as not correct: the tests (`portbench/tests/`) and the calibration
(`portbench/calibrate.py`) run a cell inside `planted(name)`.

Serving:
  answer        the last decoder layer's translation head adds 1 to every
                answer where it is produced
  prev_frame    each request answered from the previous request's images
                (a stale or reused upload buffer)
  nms_skip      YOLO's class NMS keeps the best `max_detections` candidates
                and suppresses nothing
  nms_iou       YOLO's NMS at IoU 0.9 in place of the configuration's
  class_offset  YOLO's NMS without the per-class offset: boxes of different
                classes suppress each other (no held number catches it on
                the detection cell's traffic: PERF.md)
Training (the driver takes "half" itself: the step trains on the first half
of each batch's rows, its mean over the rest):
  unchanged     the optimizer's update does nothing
"""

from __future__ import annotations

import contextlib

import torch

from portbench.lib import program

class PrevFrame:
    """A PoseServer that answers each request from the previous request's
    images."""

    def __init__(self, server):
        self.server, self.last = server, None

    def __getattr__(self, name):
        return getattr(self.server, name)

    def infer_async(self, images, *args, **kw):
        use = images if self.last is None else self.last
        self.last = images
        return self.server.infer_async(use, *args, **kw)


def _no_nms(boxes, scores, labels, valid, iou_threshold, max_outputs):
    """The candidates arrive in descending score: keep the first ones."""
    k = min(max_outputs, scores.shape[-1])
    idx = torch.arange(k, device=scores.device, dtype=torch.int32)
    return idx.expand(*scores.shape[:-1], k), valid[..., :k]


@contextlib.contextmanager
def planted(name, serving: bool = True):
    """Run the body with fault `name` planted in the program (None: none)."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    build, pose_server = program.build, program.pose_server
    try:
        if name is None:
            pass
        elif serving and name in ("answer", "nms_iou", "class_offset"):
            def broken(*args, **kw):
                cfg, model = build(*args, **kw)
                if name == "answer":
                    model.translation_head[-1].register_forward_hook(lambda m, i, o: o + 1.0)
                elif name == "nms_iou":
                    model.backbone.iou_thresh = 0.9
                else:
                    model.backbone.agnostic_nms = True
                return cfg, model
            patch(program, "build", broken)
        elif serving and name == "prev_frame":
            patch(program, "pose_server", lambda *a, **kw: PrevFrame(pose_server(*a, **kw)))
        elif serving and name == "nms_skip":
            from poet_tpu_torch.models import yolov4
            patch(yolov4, "batched_class_nms", _no_nms)
        elif not serving and name == "unchanged":
            patch(torch.optim.AdamW, "step", lambda self, closure=None: None)
        elif not (not serving and name == "half"):
            raise ValueError(f"no fault {name!r} for {'serving' if serving else 'training'}")
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
