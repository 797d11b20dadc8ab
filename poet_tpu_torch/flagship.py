"""The flagship serving configurations and their synthetic batches.

Numpy-only twins of `__graft_entry__.py:_flagship_setup`, of
`bench.py:bench_maskrcnn_detect_pose` and of `bench.py:
bench_yolov4_detect_pose(encoder_min_stride=1)`: the paper config (5 enc /
5 dec / 16 heads, hidden 256, 10 queries, 4 levels x 4 points,
class-specific heads, 6D rotations, sine embeddings) in gt bbox mode on the
Mask R-CNN feature backbone; in bbox_mode='backbone' on the full Mask
R-CNN detector (torchvision's defaults: 1000 proposals, 100 detections, 22
classes); and in bbox_mode='backbone' on the YOLOv4-CSP detector of the
shipped cfg (strides 8/16/32 plus one extra level: 6380 tokens at
480x640). Each comes with a batch drawn from the same seeded numpy stream
as its JAX twin, and each detector with seeded, well-conditioned weights,
so both packages see the same arrays.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from poet_tpu_torch.config import ModelConfig, PoETConfig


def flagship_config(dtype: str = "bfloat16") -> PoETConfig:
    cfg = PoETConfig()
    cfg.backbone.name = "maskrcnn"
    cfg.model.dtype = dtype
    return cfg


def flagship_batch(B: int, H: int = 480, W: int = 640, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """(images (B,H,W,3) f32 in [0,1], pad_mask (B,H,W) bool, targets), the
    arrays `_flagship_setup(B, H, W, seed)` builds, in the same draw order."""
    rng = np.random.default_rng(seed)
    model_cfg = ModelConfig()
    Q, n_classes = model_cfg.num_queries, model_cfg.n_classes
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    pad_mask = np.zeros((B, H, W), dtype=bool)
    n_boxes = np.minimum(rng.integers(1, Q + 1, size=(B,)), Q).astype(np.int32)
    boxes = rng.uniform(0.2, 0.7, size=(B, Q, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.2, size=(B, Q, 2)).astype(np.float32)
    labels = rng.integers(1, n_classes + 1, size=(B, Q)).astype(np.int32)
    for b in range(B):
        boxes[b, n_boxes[b]:] = -1.0
        labels[b, n_boxes[b]:] = -1
    # random rotations via QR
    a = rng.normal(size=(B * Q, 3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    det = np.linalg.det(q)
    q[:, :, 0] *= det[:, None]
    targets = {
        "boxes": boxes,
        "labels": labels,
        "n_boxes": n_boxes,
        "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
        "relative_rotation": q.reshape(B, Q, 3, 3).astype(np.float32),
    }
    return images, pad_mask, targets


def detect_pose_config(dtype: str = "bfloat16") -> PoETConfig:
    """`bench.py:bench_maskrcnn_detect_pose`'s config: the paper config in
    bbox_mode='backbone' (n_classes 21 -> 22 detector classes)."""
    cfg = flagship_config(dtype)
    cfg.model.bbox_mode = "backbone"
    return cfg


def detect_pose_batch(B: int, H: int = 480, W: int = 640, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (B,H,W,3) f32 in [0,1], all-False pad_mask (B,H,W)), the
    arrays `bench.py:bench_maskrcnn_detect_pose` draws."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    return images, np.zeros((B, H, W), dtype=bool)


def detector_state_dict(num_classes: int = 22, seed: int = 7) -> Dict[str, np.ndarray]:
    """Seeded, well-conditioned torchvision-named Mask R-CNN weights (the
    draws of `tests/test_detector_numeric_parity.py:_rcnn_state_dict`).

    Random weights at the JAX initializers double the ResNet's activation
    variance in every block, so the RPN's deltas and the class logits
    saturate: proposals collapse and no class clears the 0.05 score
    threshold. Here the residual branches are damped (bn3 scale 0.2), the
    box deltas scaled by 0.2 and the class logits by 0.6, so a random image
    gives varied proposals and some valid detections."""
    g = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(name, o, i, k, bias=False, scale=1.0):
        sd[f"{name}.weight"] = (g.normal(size=(o, i, k, k)) * math.sqrt(2.0 / (i * k * k))
                                * scale).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = (g.normal(size=(o,)) * 0.05).astype(np.float32)

    def lin(name, i, o, scale=1.0):
        sd[f"{name}.weight"] = (g.normal(size=(o, i)) * math.sqrt(2.0 / i)
                                * scale).astype(np.float32)
        sd[f"{name}.bias"] = (g.normal(size=(o,)) * 0.05).astype(np.float32)

    def bn(name, c, scale=1.0):
        sd[f"{name}.weight"] = (scale * (1.0 + 0.1 * g.normal(size=(c,)))).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * scale * g.normal(size=(c,))).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * g.normal(size=(c,))).astype(np.float32)
        sd[f"{name}.running_var"] = (0.5 + 0.5 * np.abs(g.normal(size=(c,)))).astype(np.float32)

    conv("backbone.body.conv1", 64, 3, 7)
    bn("backbone.body.bn1", 64)
    widths, ins = [64, 128, 256, 512], [64, 256, 512, 1024]
    for stage, n in enumerate([3, 4, 6, 3]):
        for b in range(n):
            p = f"backbone.body.layer{stage + 1}.{b}"
            w, cin = widths[stage], ins[stage] if b == 0 else widths[stage] * 4
            conv(f"{p}.conv1", w, cin, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3", w * 4, w, 1)
            bn(f"{p}.bn3", w * 4, scale=0.2)
            if b == 0:
                conv(f"{p}.downsample.0", w * 4, cin, 1)
                bn(f"{p}.downsample.1", w * 4)
    for i, cin in enumerate([256, 512, 1024, 2048]):
        conv(f"backbone.fpn.inner_blocks.{i}", 256, cin, 1, bias=True)
        conv(f"backbone.fpn.layer_blocks.{i}", 256, 256, 3, bias=True)
    conv("rpn.head.conv", 256, 256, 3, bias=True)
    conv("rpn.head.cls_logits", 3, 256, 1, bias=True)
    conv("rpn.head.bbox_pred", 12, 256, 1, bias=True, scale=0.2)
    lin("roi_heads.box_head.fc6", 256 * 49, 1024)
    lin("roi_heads.box_head.fc7", 1024, 1024)
    lin("roi_heads.box_predictor.cls_score", 1024, num_classes, scale=0.6)
    lin("roi_heads.box_predictor.bbox_pred", 1024, num_classes * 4, scale=0.2)
    return sd


def detect_pose_model(cfg: PoETConfig, seed: int = 0):
    """The seeded detect+pose model, on the CPU: the JAX initializers for
    PoET (`utils/init.py`) and the well-conditioned detector weights of
    `detector_state_dict`."""
    import torch

    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    model = init_weights(build_model(cfg), seed=seed)
    sd = detector_state_dict(num_classes=cfg.model.n_classes + 1, seed=7)
    model.backbone.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


def yolo_detect_pose_config(dtype: str = "bfloat16") -> PoETConfig:
    """`bench.py:bench_yolov4_detect_pose(encoder_min_stride=1)`'s config:
    the paper config in bbox_mode='backbone' on YOLOv4-CSP with the shipped
    `configs/ycbv_yolov4-csp.cfg` (21 classes), conf 0.4, class-specific
    NMS at IoU 0.5 over the top 512, 20 detections, the u5 decode, every
    CSP-PAN map fed to the transformer."""
    cfg = flagship_config(dtype)
    cfg.backbone.name = "yolov4"
    cfg.backbone.max_detections = 20
    cfg.backbone.encoder_min_stride = 1
    cfg.model.bbox_mode = "backbone"
    cfg.model.n_classes = 21
    return cfg


# the images `bench.py:bench_yolov4_detect_pose` draws are the Mask R-CNN
# bench's: uniform [0, 1] from default_rng(0), no padding
yolo_detect_pose_batch = detect_pose_batch

# Conditioning of `darknet_state`: the variance gain of the body's kernels,
# N(0, BODY_GAIN / fan_in), which holds the activations near unit scale
# through the 115 convs; the scale of the head kernels' box rows; the bias
# of the w/h logits (boxes a few px across, inside their cell); the
# objectness bias of the coarsest head's largest anchor and of every other
# anchor; the class logit bias.
BODY_GAIN = 1.8
HEAD_BOX_KERNEL_SCALE = 0.05
HEAD_WH_BIAS = -2.6
HEAD_OBJ_BIAS_LARGEST, HEAD_OBJ_BIAS_OTHERS = -2.7, -12.0
HEAD_CLS_BIAS = 3.0


def darknet_state(cfg_sections, seed: int = 11) -> Dict[str, Dict[str, np.ndarray]]:
    """Seeded, well-conditioned darknet weights in the flax names of
    `DarknetBody` (`conv_{li}/kernel` HWIO, `conv_{li}/bias` for convs
    without BN, `bn_{li}/{weight,bias,running_mean,running_var}`): what
    `load_jax_params(model.backbone.body, ...)` takes and the JAX body's
    `params` holds, so both packages run the same network.

    At plain random init 115 convs with residual shortcuts drift the
    activation scale, and the head logits either saturate or sit at
    sigma(0)^2 = 0.25, under the 0.4 threshold: every candidate, or none,
    is valid. Here the kernels are drawn at BODY_GAIN (He's 2 grows the
    mish activations ~17x by the heads), the BN of each shortcut branch's
    last conv is damped by 0.2 (as `detector_state_dict` damps bn3), and
    the heads are biased so that on uniform-noise images only the coarsest
    head's largest anchor clears the threshold, in the tail of its
    objectness over the cells, with a confident class and a small box
    inside its cell: some valid detections per image, fewer than the 20
    kept, and every box inside the image (`chip_smoke.py` phase 13 reports
    the counts).
    """
    from poet_tpu_torch.models.yolov4 import _ints, channel_walk
    from poet_tpu_torch.utils.darknet_import import _channel_walk

    sections = [dict(s) for s in cfg_sections]
    body = sections[1:]
    strides = channel_walk(sections)[1]
    damped = {li - 1 for li, sec in enumerate(body) if sec["type"] == "shortcut"}
    heads = {li - 1: sec for li, sec in enumerate(body) if sec["type"] == "yolo"}
    coarsest = max(heads, key=lambda li: strides[li])
    g = np.random.default_rng(seed)
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for li, sec, cin in _channel_walk(sections):
        filters, size = int(sec["filters"]), int(sec["size"])
        fan_in = cin * size * size
        kernel = g.normal(size=(size, size, cin, filters))
        if li in heads:
            yolo = heads[li]
            anchors, mask = _ints(yolo["anchors"]), _ints(yolo["mask"])
            areas = [anchors[2 * m] * anchors[2 * m + 1] for m in mask]
            per = 5 + int(yolo["classes"])
            rows = np.ones(per, np.float32)
            rows[:4] = HEAD_BOX_KERNEL_SCALE
            bias = np.full((len(mask), per), HEAD_CLS_BIAS, np.float32)
            bias[:, :2] = 0.0
            bias[:, 2:4] = HEAD_WH_BIAS
            bias[:, 4] = HEAD_OBJ_BIAS_OTHERS
            if li == coarsest:
                bias[int(np.argmax(areas)), 4] = HEAD_OBJ_BIAS_LARGEST
            tree[f"conv_{li}"] = {
                "kernel": (kernel * np.tile(rows, len(mask)) / math.sqrt(fan_in)).astype(np.float32),
                "bias": bias.reshape(-1)}
            continue
        tree[f"conv_{li}"] = {"kernel": (kernel * math.sqrt(BODY_GAIN / fan_in)).astype(np.float32)}
        if int(sec.get("batch_normalize", 0)):
            scale = 0.2 if li in damped else 1.0
            tree[f"bn_{li}"] = {
                "weight": (scale * (1.0 + 0.1 * g.normal(size=(filters,)))).astype(np.float32),
                "bias": (0.1 * scale * g.normal(size=(filters,))).astype(np.float32),
                "running_mean": (0.1 * g.normal(size=(filters,))).astype(np.float32),
                "running_var": (0.5 + 0.5 * np.abs(g.normal(size=(filters,)))).astype(np.float32)}
        else:
            tree[f"conv_{li}"]["bias"] = (0.05 * g.normal(size=(filters,))).astype(np.float32)
    return tree


def yolo_detect_pose_model(cfg: PoETConfig, seed: int = 0):
    """The seeded YOLO detect+pose model, on the CPU: the JAX initializers
    for PoET (`utils/init.py`) and `darknet_state` for the darknet body."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights
    from poet_tpu_torch.utils.jax_params import load_jax_params

    model = init_weights(build_model(cfg), seed=seed)
    body = model.backbone.body
    load_jax_params(body, darknet_state(body.sections))
    return model.eval()


EVAL_POINTS = 15_000        # points per model cloud: BOP models_eval size
BOP_SCENE = 48              # the first YCB-V test scene


class EvalFixture:
    """A seeded in-memory eval set with the `PoseDataset` interface
    (`__len__`, `ids`, `file_name`, `__getitem__(i, rng=)`), a fixture like
    `flagship_batch` and not a dataset reader.

    Image i is 480x640 f32 uniform [0, 1] noise drawn from (seed, i). Its
    targets hold 1-10 objects: normalized cxcywh boxes, a YCB-V class
    (1-21), a random rotation, a translation ~1 m in front of the camera
    and the intrinsics; `targets` replaces them (one dict per image). File
    names follow the BOP layout, test/<scene>/rgb/<im>.png. `evaluator()`
    builds the YCB-V `PoseEvaluator`: the 21 classes and symmetries of
    `dataset_files/ycbv_{classes,symmetries}.json`, each class a seeded
    15 000-point cloud on the surface of a cuboid of 4-24 cm sides, its
    diameter (mm) the cloud's largest point distance."""

    def __init__(self, n_images: int, H: int = 480, W: int = 640, seed: int = 0,
                 targets=None):
        import os

        from poet_tpu_torch.evaluation.pose_evaluator import (
            SHIPPED_ASSETS,
            load_classes,
            load_model_symmetry,
        )

        self.H, self.W, self.seed = H, W, seed
        self.ids = list(range(n_images))
        self.classes = load_classes(os.path.join(SHIPPED_ASSETS, "ycbv_classes.json"))
        self.symmetries = load_model_symmetry(
            os.path.join(SHIPPED_ASSETS, "ycbv_symmetries.json"), self.classes)
        self.targets = targets if targets is not None else [
            self._draw_targets(np.random.default_rng((seed, 0, i)), i) for i in self.ids]

    def _draw_targets(self, rng, image_id):
        n = int(rng.integers(1, 11))
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.3, (n, 2))],
                               axis=1).astype(np.float32)
        q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
        q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
        q[:, :, 0] *= np.linalg.det(q)[:, None]
        t = np.concatenate([rng.normal(0.0, 0.15, (n, 2)), rng.uniform(0.6, 1.4, (n, 1))], axis=1)
        K = np.array([1066.778, 0, 312.9869, 0, 1067.487, 241.3109, 0, 0, 1], np.float32)
        return {"boxes": boxes, "labels": rng.integers(1, len(self.classes) + 1, n),
                "relative_position": t.astype(np.float32),
                "relative_rotation": q.astype(np.float32),
                "intrinsics": np.tile(K, (n, 1)), "image_id": image_id}

    def __len__(self):
        return len(self.ids)

    def file_name(self, image_id: int) -> str:
        return f"test/{BOP_SCENE + image_id // 1000:06d}/rgb/{image_id % 1000 + 1:06d}.png"

    def image(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 1, i))
        return rng.uniform(size=(self.H, self.W, 3)).astype(np.float32)

    def __getitem__(self, i: int, rng=None):
        return self.image(self.ids[i]), dict(self.targets[i])

    def evaluator(self, n_points: int = EVAL_POINTS):
        from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator

        names = list(self.classes.values())
        models, info = eval_model_clouds(names, n_points, self.seed)
        return PoseEvaluator(models, names, info, self.symmetries)


def eval_model_clouds(names, n_points: int, seed: int):
    """(models {name: {"pts": (n, 3) m}}, models_info {name: {"diameter":
    mm}}): per class a cloud on the surface of a cuboid with seeded half
    sides of 2-12 cm; the diameter is the largest distance between two
    points of the cloud (over its convex hull's vertices)."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    models, info = {}, {}
    for name in names:
        half = rng.uniform(0.02, 0.12, 3)
        face = rng.integers(0, 6, n_points)
        pts = rng.uniform(-1.0, 1.0, (n_points, 3))
        pts[np.arange(n_points), face % 3] = np.where(face < 3, -1.0, 1.0)
        pts *= half
        hull = pts[ConvexHull(pts).vertices]
        diameter = np.sqrt(((hull[:, None] - hull[None]) ** 2).sum(-1)).max()
        models[name] = {"pts": pts}
        info[name] = {"diameter": float(diameter * 1000.0)}
    return models, info
