"""YOLOv4-CSP backbone: the darknet-cfg-driven network and its detection head.

Counterpart of `poet_tpu/models/yolov4.py` (the reference's external
Scaled-YOLOv4 wrapper, selected with `--backbone yolov4`):
  * `parse_darknet_cfg` / `load_cfg_sections` read a darknet cfg;
  * `DarknetBody` runs its graph: convolutional (+ frozen BN + mish / leaky /
    logistic / linear), route (concat, `groups`/`group_id`), shortcut (add,
    its activation), maxpool (SPP, padded with -inf as flax pads),
    nearest upsample (`jax.image.resize`'s half-pixel rule);
  * `decode_yolo_u5` / `decode_yolo_darknet` decode each yolo head in f32;
  * `YOLOv4Backbone` thresholds, takes the top `pre_nms` and runs the
    (class-specific or agnostic) NMS of `ops/detection.py` for the whole
    batch, and returns the CSP-PAN maps (strides 8/16/32) for PoET.

The convolutions run NCHW (channels-last memory on the card) and the
module takes and returns NHWC, like `models/resnet_fpn.py`. The small-C
entry convolutions (`_use_stem`: 3x3 3->32, 3x3/2 32->64 and 3x3 32->64 at
480x640) fold their FrozenBN into the kernel and bias and go through
`ops/conv_stem_cuda.py:conv_stem`, which launches the hand-written stem
kernel on the card: the JAX package's `POET_YOLO_STEM=1` route, with the
same predicate on every device. Every other conv with a FrozenBN and a
mish, leaky or linear activation (`_use_epilogue`: 109 of the 115 convs of
the shipped cfgs) is cuDNN's conv followed by one pass of
`ops/darknet_epilogue_cuda.py:darknet_epilogue`, which applies the BN and
the activation in the hand-written epilogue kernel on the card and in their
plain composition on the CPU. The TPU-only `_Stride2ConvS2D` and the stem
`optimization_barrier` are not carried over.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from poet_tpu_torch.models.layers import Conv
from poet_tpu_torch.models.resnet_fpn import FrozenBatchNorm, downsample_mask
from poet_tpu_torch.ops.conv_stem_cuda import conv_stem, mish  # noqa: F401  (mish re-exported)
from poet_tpu_torch.ops.darknet_epilogue_cuda import (ACTIVATIONS as EPILOGUE_ACTIVATIONS,
                                                      CHANNEL_MULTIPLE, MAX_CHANNELS,
                                                      activate, darknet_epilogue)
from poet_tpu_torch.ops.detection import NEG_INF, batched_class_nms, nms_padded, topk
from poet_tpu_torch.utils.tracing import span, traced
from poet_tpu_torch.utils.tables import device_table

Sections = Tuple[Tuple[Tuple[str, Any], ...], ...]


def parse_darknet_cfg(text: str) -> List[Dict[str, Any]]:
    """Parse a darknet .cfg into a list of {type, **options} dicts."""
    sections: List[Dict[str, Any]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("["):
            sections.append({"type": line.strip("[]")})
        else:
            k, _, v = line.partition("=")
            sections[-1][k.strip()] = v.strip()
    return sections


def _ints(s: str) -> List[int]:
    return [int(t) for t in re.split(r"[,\s]+", s.strip()) if t]


def load_cfg_sections(path: str) -> Sections:
    """Read a darknet cfg into the frozen (hashable) form the modules take."""
    with open(path) as f:
        sections = parse_darknet_cfg(f.read())
    return tuple(tuple(sorted(s.items())) for s in sections)


def channel_walk(sections: Sequence[Dict[str, Any]]) -> Tuple[List[int], List[int]]:
    """Each layer's output channels and stride, tracked through the graph as
    `DarknetBody` runs it (a yolo section keeps the previous output)."""
    if sections[0]["type"] != "net":
        raise ValueError("a darknet cfg starts with [net]")
    channels: List[int] = []
    strides: List[int] = []
    c, s = int(sections[0].get("channels", 3)), 1
    for li, sec in enumerate(sections[1:]):
        t = sec["type"]
        if t == "convolutional":
            c, s = int(sec["filters"]), s * int(sec.get("stride", 1))
        elif t == "route":
            idx = [i if i >= 0 else li + i for i in _ints(sec["layers"])]
            c = sum(channels[i] // int(sec.get("groups", 1)) for i in idx)
            s = strides[idx[0]]
        elif t == "maxpool":
            s *= int(sec.get("stride", sec.get("size", 2)))
        elif t == "upsample":
            s //= int(sec.get("stride", 2))
        elif t == "yolo":
            c, s = channels[-1], strides[-1]
        elif t != "shortcut":
            raise NotImplementedError(f"darknet section {t}")
        channels.append(c)
        strides.append(s)
    return channels, strides


def _conv_geometry(sec: Dict[str, Any]) -> Tuple[int, int, int, int, bool, str]:
    """(filters, size, stride, pad, batch_normalize, activation) of a conv."""
    size = int(sec["size"])
    pad = (size // 2) if int(sec.get("pad", 0)) else int(sec.get("padding", 0))
    return (int(sec["filters"]), size, int(sec.get("stride", 1)), pad,
            bool(int(sec.get("batch_normalize", 0))), sec.get("activation", "linear"))


def _use_stem(size: int, stride: int, pad: int, act: str, cin: int, hw: Tuple[int, int]) -> bool:
    """The convs `poet_tpu/models/yolov4.py:_use_pallas_stem` sends to the
    fused stem kernel on a TPU: the small-C entry convs at large maps."""
    return (size in (1, 3, 5, 7) and stride in (1, 2) and pad == size // 2 and cin <= 32
            and act in ("mish", "leaky", "linear") and hw[0] * hw[1] >= 128 * 128)


def _use_epilogue(x: torch.Tensor, bn: bool, act: str) -> bool:
    """The convs whose FrozenBN and activation go through the
    `darknet_epilogue` operator, by what the conv's output x (NCHW view)
    shows: a BN and an activation the kernel applies; a device the operator
    runs on (the CPU's plain version, the card's kernel); f32 or bf16;
    channels-last contiguous memory, whole 16-byte vectors of channels, no
    more channels than the kernel's fold holds; no gradient wanted (the
    darknet is frozen)."""
    return (bn and act in EPILOGUE_ACTIVATIONS and x.device.type in ("cpu", "cuda")
            and x.dtype in (torch.float32, torch.bfloat16) and x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.shape[1] % CHANNEL_MULTIPLE == 0 and x.shape[1] <= MAX_CHANNELS
            and not x.requires_grad)


def epilogue_convs(sections: Sequence[Dict[str, Any]], H: int = 480,
                   W: int = 640) -> List[Tuple[int, int, int, str]]:
    """(H, W, C, activation) of the output of each conv that `DarknetBody`
    sends to the epilogue operator at an H x W image, in the body's order,
    when it runs channels-last in f32 or bf16 with no gradient wanted
    (`_use_epilogue`)."""
    channels, strides = channel_walk(sections)
    convs, cin, s_in = [], int(sections[0].get("channels", 3)), 1
    for li, sec in enumerate(sections[1:]):
        if sec["type"] == "convolutional":
            filters, size, stride, pad, bn, act = _conv_geometry(sec)
            if (bn and act in EPILOGUE_ACTIVATIONS and filters % CHANNEL_MULTIPLE == 0
                    and filters <= MAX_CHANNELS
                    and not _use_stem(size, stride, pad, act, cin, (H // s_in, W // s_in))):
                convs.append((H // strides[li], W // strides[li], filters, act))
        cin, s_in = channels[li], strides[li]
    return convs


class DarknetBody(nn.Module):
    """Runs the darknet graph: (B, H, W, 3) images -> (yolo_inputs, yolo_specs,
    features), each map NHWC. `yolo_inputs` are the raw outputs feeding the
    yolo sections; `features` the conv outputs just before each head's 1x1
    conv (the CSP-PAN maps PoET consumes).

    The body is itself the container of its layers: `conv_{li}` and `bn_{li}`
    (li = the section's index after [net]), the flax module names, so
    `load_jax_params` maps `backbone.body.conv_3` onto `backbone/body/conv_3`.
    """

    def __init__(self, sections: Sections, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sections = [dict(s) for s in sections]
        self.dtype = dtype
        channels, self.strides = channel_walk(self.sections)
        cin = int(self.sections[0].get("channels", 3))
        for li, sec in enumerate(self.sections[1:]):
            if sec["type"] == "convolutional":
                filters, size, stride, pad, bn, _ = _conv_geometry(sec)
                self.add_module(f"conv_{li}", Conv(cin, filters, size, stride=stride,
                                                   padding=pad, bias=not bn,
                                                   compute_dtype=dtype))
                if bn:
                    self.add_module(f"bn_{li}", FrozenBatchNorm(filters))
            cin = channels[li]
        self.channels = channels

    def _stem(self, li: int, x: torch.Tensor, stride: int, pad: int, act: str) -> torch.Tensor:
        """conv + FrozenBN + activation of layer li through the stem kernel,
        the BN folded as `poet_tpu/models/yolov4.py:226-233` folds it: the
        kernel scaled in its at-rest dtype, the offset added to the bias."""
        conv = getattr(self, f"conv_{li}")
        k, b = conv.weight, conv.bias                   # (F, C, kh, kw)
        bn = getattr(self, f"bn_{li}", None)
        if bn is not None:
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            off = bn.bias - bn.running_mean * inv
            k = k * inv.to(k.dtype)[:, None, None, None]
            b = off if b is None else b + off
        w = k.to(self.dtype).permute(2, 3, 1, 0).contiguous()     # HWIO
        y = conv_stem(x.permute(0, 2, 3, 1).contiguous(), w,
                      None if b is None else b.float().contiguous(), stride=stride,
                      padding=((pad, pad), (pad, pad)),
                      activation=None if act == "linear" else act)
        return y.permute(0, 3, 1, 2)                               # NCHW view

    def _epilogue(self, li: int, x: torch.Tensor, act: str) -> torch.Tensor:
        """FrozenBN + activation of layer li's conv output in one pass."""
        bn = getattr(self, f"bn_{li}")
        y = darknet_epilogue(x.permute(0, 2, 3, 1), bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps, act)
        return y.permute(0, 3, 1, 2)                               # NCHW view

    def forward(self, images: torch.Tensor):
        """The `backbone.body` span counts the convs of this forward that
        took the epilogue operator (`epilogue`) and those that took the
        plain BN and activation (`plain`); the stem's are neither."""
        with span("backbone.body") as sp:
            routes = {"epilogue": 0, "plain": 0}
            out = self._run(images, routes)
            sp.add(**routes)
        return out

    def _run(self, images: torch.Tensor, routes: Dict[str, int]):
        x = images.to(self.dtype).permute(0, 3, 1, 2)              # NCHW view
        outputs: List[torch.Tensor] = []
        yolo_inputs, yolo_specs, features = [], [], []
        for li, sec in enumerate(self.sections[1:]):
            t = sec["type"]
            if t == "convolutional":
                _, size, stride, pad, bn, act = _conv_geometry(sec)
                if _use_stem(size, stride, pad, act, x.shape[1], tuple(x.shape[2:])):
                    x = self._stem(li, x, stride, pad, act)
                else:
                    x = getattr(self, f"conv_{li}")(x)
                    if _use_epilogue(x, bn, act):
                        x = self._epilogue(li, x, act)
                        routes["epilogue"] += 1
                    else:
                        if bn:
                            x = getattr(self, f"bn_{li}")(x)
                        x = activate(x, act)
                        routes["plain"] += 1
            elif t == "route":
                srcs = [outputs[i if i >= 0 else li + i] for i in _ints(sec["layers"])]
                groups = int(sec.get("groups", 1))
                if groups > 1:
                    gid = int(sec.get("group_id", 0))
                    srcs = [s.chunk(groups, dim=1)[gid] for s in srcs]
                x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            elif t == "shortcut":
                frm = int(sec["from"])
                x = x + outputs[frm if frm >= 0 else li + frm]
                if sec.get("activation", "linear") == "leaky":
                    x = F.leaky_relu(x, 0.1)
            elif t == "maxpool":
                size = int(sec.get("size", 2))
                stride = int(sec.get("stride", size))
                # flax pads the window with -inf, as max_pool2d does
                x = F.max_pool2d(x, size, stride=stride, padding=size // 2)
            elif t == "upsample":
                s = int(sec.get("stride", 2))
                x = F.interpolate(x, scale_factor=s, mode="nearest-exact")
            elif t == "yolo":
                yolo_inputs.append(x.permute(0, 2, 3, 1))
                features.append(outputs[li - 2].permute(0, 2, 3, 1))
                anchors, mask = _ints(sec["anchors"]), _ints(sec["mask"])
                yolo_specs.append({
                    "anchors": [(anchors[2 * i], anchors[2 * i + 1]) for i in mask],
                    "classes": int(sec["classes"]),
                    "scale_x_y": float(sec.get("scale_x_y", 1.0)),
                    "new_coords": int(sec.get("new_coords", 0)),
                })
                x = outputs[-1]                 # a leaf: the graph pointer stays
            else:
                raise NotImplementedError(f"darknet section {t}")
            outputs.append(x)
        return yolo_inputs, yolo_specs, features


@device_table
def _anchor_table(anchors: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """(A, 2) f32 anchors on `device`, made once: a tensor built from a host
    list on every call would be a blocking copy."""
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def _grid(H: int, W: int, device) -> torch.Tensor:
    """(H, W, 2) cell coordinates (x, y), f32."""
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def decode_yolo_u5(raw: torch.Tensor, anchors, num_classes: int, stride: int):
    """ScaledYOLOv4 (u5) decode of one head, the reference wrapper's:
    xy = (2 sigma - 0.5 + grid) stride, wh = (2 sigma)^2 anchor.
    raw (B, H, W, A*(5+nc)) f32 -> boxes (B, H*W*A, 4) xyxy pixels, obj*cls
    scores (B, H*W*A, nc)."""
    B, H, W, _ = raw.shape
    A = len(anchors)
    raw = raw.reshape(B, H, W, A, 5 + num_classes)
    xy = torch.sigmoid(raw[..., 0:2])
    wh = torch.sigmoid(raw[..., 2:4]) * 2.0
    grid = _grid(H, W, raw.device)[None, :, :, None, :]
    xy = (xy * 2.0 - 0.5 + grid) * stride
    wh = wh * wh * _anchor_table(tuple(anchors), raw.device)
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    scores = torch.sigmoid(raw[..., 4:5]) * torch.sigmoid(raw[..., 5:])
    return boxes.reshape(B, H * W * A, 4), scores.reshape(B, H * W * A, num_classes)


def decode_yolo_darknet(raw: torch.Tensor, anchors, num_classes: int, stride: int,
                        scale_x_y: float = 1.0):
    """Classic darknet (new_coords=0) decode of one head: xy = (sigma s -
    (s-1)/2 + grid) stride with s = the cfg's scale_x_y, wh = exp(t) anchor
    (t clipped to [-20, 20])."""
    B, H, W, _ = raw.shape
    A = len(anchors)
    raw = raw.reshape(B, H, W, A, 5 + num_classes)
    xy = torch.sigmoid(raw[..., 0:2]) * scale_x_y - (scale_x_y - 1.0) / 2.0
    wh = torch.exp(torch.clamp(raw[..., 2:4], -20.0, 20.0))
    xy = (xy + _grid(H, W, raw.device)[None, :, :, None, :]) * stride
    wh = wh * _anchor_table(tuple(anchors), raw.device)
    boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
    scores = torch.sigmoid(raw[..., 4:5]) * torch.sigmoid(raw[..., 5:])
    return boxes.reshape(B, H * W * A, 4), scores.reshape(B, H * W * A, num_classes)


class YOLOv4Backbone(nn.Module):
    """The frozen YOLOv4-CSP backbone for PoET: (images (B, H, W, 3), pad_mask)
    -> (features, masks, detections). `features` are the CSP-PAN maps whose
    stride is at least `encoder_min_stride`; `detections` are fixed-size
    {boxes (B, max_detections, 4) xyxy pixels, scores, labels, valid} after
    the confidence threshold, the top `pre_nms` and NMS, labels being
    category ids (class index + 1; 0 is background)."""

    def __init__(self, cfg_sections: Sections, conf_thresh: float = 0.4,
                 iou_thresh: float = 0.5, agnostic_nms: bool = False,
                 max_detections: int = 100, pre_nms: int = 512,
                 encoder_min_stride: int = 1, box_decode: str = "u5",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if box_decode not in ("u5", "darknet"):
            raise ValueError(f"box_decode {box_decode!r} not in ('u5', 'darknet')")
        self.conf_thresh, self.iou_thresh = conf_thresh, iou_thresh
        self.agnostic_nms = agnostic_nms
        self.max_detections, self.pre_nms = max_detections, pre_nms
        self.encoder_min_stride = encoder_min_stride
        self.box_decode = box_decode
        self.body = DarknetBody(cfg_sections, dtype=dtype)
        self.requires_grad_(False)              # frozen, as in the reference
        # channels of the maps PoET takes: the features before each yolo
        # head whose stride is at least encoder_min_stride
        body = self.body
        self.num_channels = tuple(
            body.channels[li - 2] for li, sec in enumerate(body.sections[1:])
            if sec["type"] == "yolo" and body.strides[li - 2] >= encoder_min_stride)

    @traced("detector.decode")
    def decode(self, yolo_inputs, yolo_specs, image_h: int):
        """Every head decoded in f32 -> boxes (B, N, 4), scores (B, N, nc)."""
        all_boxes, all_scores = [], []
        for raw, spec in zip(yolo_inputs, yolo_specs):
            stride = image_h // raw.shape[1]
            if self.box_decode == "darknet":
                boxes, scores = decode_yolo_darknet(raw.float(), spec["anchors"],
                                                    spec["classes"], stride,
                                                    scale_x_y=spec["scale_x_y"])
            else:
                boxes, scores = decode_yolo_u5(raw.float(), spec["anchors"], spec["classes"],
                                               stride)
            all_boxes.append(boxes)
            all_scores.append(scores)
        return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)

    @traced("detector.select")
    def detect(self, boxes: torch.Tensor, scores: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Best class, threshold, top `pre_nms` (ties at the lower index, as
        `lax.top_k`) and NMS, every image in one fixed point."""
        best_score, best_cls = scores.amax(dim=-1), scores.argmax(dim=-1)
        s = torch.where(best_score > self.conf_thresh, best_score, NEG_INF)
        top_s, top_i = topk(s, min(self.pre_nms, s.shape[1]))
        cand_boxes = torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape, 4))
        cand_labels = torch.gather(best_cls, 1, top_i).to(torch.int32) + 1
        valid = torch.isfinite(top_s)
        if self.agnostic_nms:
            keep_idx, keep_valid = nms_padded(cand_boxes, torch.where(valid, top_s, NEG_INF),
                                              self.iou_thresh, self.max_detections)
        else:
            keep_idx, keep_valid = batched_class_nms(cand_boxes, top_s, cand_labels, valid,
                                                     self.iou_thresh, self.max_detections)
        keep = keep_idx.long()
        return {
            "boxes": torch.gather(cand_boxes, 1, keep[..., None].expand(*keep.shape, 4)),
            "scores": torch.where(keep_valid, torch.gather(top_s, 1, keep), 0.0),
            "labels": torch.where(keep_valid, torch.gather(cand_labels, 1, keep), -1),
            "valid": keep_valid,
        }

    def outputs(self, features, pad_mask: torch.Tensor, image_h: int):
        """(features, masks) of the maps PoET takes."""
        if self.encoder_min_stride > 1:
            features = [f for f in features if image_h // f.shape[1] >= self.encoder_min_stride]
            if not features:
                raise ValueError("encoder_min_stride dropped every feature map")
        return features, [downsample_mask(pad_mask, f.shape[1:3]) for f in features]

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor, detections: bool = True):
        """`detections=False` (PoET in gt and jitter mode, which reads none)
        skips the decode and the NMS and returns None for them, as XLA's
        dead-code elimination drops them from poet_tpu's jitted step."""
        # frozen: no autograd graph (poet_tpu's stop_gradient)
        with torch.no_grad():
            yolo_inputs, yolo_specs, features = self.body(images)
            dets = None
            if detections:
                boxes, scores = self.decode(yolo_inputs, yolo_specs, images.shape[1])
                dets = self.detect(boxes, scores)
        features, masks = self.outputs(features, pad_mask, images.shape[1])
        return features, masks, dets
