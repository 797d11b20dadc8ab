"""Plain YOLOv4-CSP: the darknet graph of a cfg, its u5 decode, and the
detector's selection (confidence threshold, top-k, per-class greedy NMS), in
float32 PyTorch, written from the darknet cfg format and Scaled-YOLOv4's
`models/yolo.py` decode.

Parameters are a flat dict under the names `prefix + conv_{li}.weight`
(OIHW), `conv_{li}.bias` (convs without batch norm) and `bn_{li}.{weight,
bias,running_mean,running_var}` (frozen batch norm, eps 1e-5), li being the
section's index after [net]. Departures from the darknet program: mish is
the one-exp form x (1 - 2 / ((1 + e^x)^2 + 1)), x clamped at 25 before the
exp and returned unchanged above 25 (the reference package's); upsampling is
nearest at integer scale; maxpool pads with -inf.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.numerics import conv2d


def parse_cfg(text: str) -> List[Dict[str, str]]:
    sections: List[Dict[str, str]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            sections.append({"type": line.strip("[]")})
        else:
            k, _, v = line.partition("=")
            sections[-1][k.strip()] = v.strip()
    return sections


def ints(s: str) -> List[int]:
    return [int(t) for t in re.split(r"[,\s]+", s.strip()) if t]


def conv_geometry(sec) -> Tuple[int, int, int, int, bool, str]:
    """(filters, size, stride, pad, batch_normalize, activation)."""
    size = int(sec["size"])
    pad = size // 2 if int(sec.get("pad", 0)) else int(sec.get("padding", 0))
    return (int(sec["filters"]), size, int(sec.get("stride", 1)), pad,
            bool(int(sec.get("batch_normalize", 0))), sec.get("activation", "linear"))


def walk(sections) -> List[Tuple[int, int, int]]:
    """(channels, stride, input channels) after each section of the body."""
    out = []
    c, s = int(sections[0].get("channels", 3)), 1
    chans: List[int] = []
    strides: List[int] = []
    for li, sec in enumerate(sections[1:]):
        cin, t = c, sec["type"]
        if t == "convolutional":
            c, s = int(sec["filters"]), s * int(sec.get("stride", 1))
        elif t == "route":
            idx = [i if i >= 0 else li + i for i in ints(sec["layers"])]
            c = sum(chans[i] // int(sec.get("groups", 1)) for i in idx)
            s = strides[idx[0]]
        elif t == "maxpool":
            s *= int(sec.get("stride", sec.get("size", 2)))
        elif t == "upsample":
            s //= int(sec.get("stride", 2))
        elif t == "yolo":
            c, s = chans[-1], strides[-1]
        elif t != "shortcut":
            raise NotImplementedError(t)
        chans.append(c)
        strides.append(s)
        out.append((c, s, cin))
    return out


def param_shapes(sections, prefix: str = "backbone.body."):
    """{name: shape} of every parameter and frozen statistic of the body."""
    shapes = {}
    for li, (sec, (_, _, cin)) in enumerate(zip(sections[1:], walk(sections))):
        if sec["type"] != "convolutional":
            continue
        f, k, _, _, bn, _ = conv_geometry(sec)
        shapes[f"{prefix}conv_{li}.weight"] = (f, cin, k, k)
        if bn:
            for n in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{prefix}bn_{li}.{n}"] = (f,)
        else:
            shapes[f"{prefix}conv_{li}.bias"] = (f,)
    return shapes


def mish(x: torch.Tensor) -> torch.Tensor:
    e = torch.exp(torch.clamp(x, max=25.0))
    return torch.where(x > 25.0, x, x * (1.0 - 2.0 / ((1.0 + e) ** 2 + 1.0)))


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "mish":
        return mish(x)
    if act == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if act == "logistic":
        return torch.sigmoid(x)
    if act != "linear":
        raise NotImplementedError(act)
    return x


def body(params: Dict[str, torch.Tensor], sections, images: torch.Tensor,
         prefix: str = "backbone.body."):
    """images (B, H, W, 3) in [0, 1] -> (head inputs, head specs, features):
    the raw maps feeding each [yolo] section and the maps two sections before
    each (the CSP-PAN maps the pose transformer takes), all NCHW float32."""
    x = images.float().permute(0, 3, 1, 2)
    outputs, heads, specs, feats = [], [], [], []
    for li, sec in enumerate(sections[1:]):
        t = sec["type"]
        if t == "convolutional":
            _, _, stride, pad, bn, act = conv_geometry(sec)
            x = conv2d(x, params[f"{prefix}conv_{li}.weight"],
                       None if bn else params[f"{prefix}conv_{li}.bias"], stride, pad)
            if bn:
                p = f"{prefix}bn_{li}."
                scale = params[p + "weight"] / torch.sqrt(params[p + "running_var"] + 1e-5)
                shift = params[p + "bias"] - params[p + "running_mean"] * scale
                x = x * scale[:, None, None] + shift[:, None, None]
            x = activate(x, act)
        elif t == "route":
            srcs = [outputs[i if i >= 0 else li + i] for i in ints(sec["layers"])]
            g = int(sec.get("groups", 1))
            if g > 1:
                gid = int(sec.get("group_id", 0))
                srcs = [s[:, s.shape[1] // g * gid: s.shape[1] // g * (gid + 1)] for s in srcs]
            x = torch.cat(srcs, 1)
        elif t == "shortcut":
            frm = int(sec["from"])
            x = activate(x + outputs[frm if frm >= 0 else li + frm],
                         sec.get("activation", "linear"))
        elif t == "maxpool":
            size = int(sec.get("size", 2))
            stride = int(sec.get("stride", size))
            x = F.max_pool2d(F.pad(x, (size // 2,) * 4, value=float("-inf")), size, stride)
        elif t == "upsample":
            s = int(sec.get("stride", 2))
            x = x.repeat_interleave(s, 2).repeat_interleave(s, 3)
        elif t == "yolo":
            heads.append(x)
            feats.append(outputs[li - 2])
            anchors, mask = ints(sec["anchors"]), ints(sec["mask"])
            specs.append({"anchors": [(anchors[2 * i], anchors[2 * i + 1]) for i in mask],
                          "classes": int(sec["classes"])})
            x = outputs[-1]
        outputs.append(x)
    return heads, specs, feats


def decode(heads, specs, image_h: int):
    """Scaled-YOLOv4's decode of every head: xy = (2 s(t) - 0.5 + cell) stride,
    wh = (2 s(t))^2 anchor -> boxes (B, N, 4) xyxy pixels, scores (B, N, nc)
    = s(objectness) s(class), N running over (cell row, cell column, anchor);
    margins (B, N): the best class logit less the runner-up's."""
    all_boxes, all_scores, all_margins = [], [], []
    for raw, spec in zip(heads, specs):
        B, _, H, W = raw.shape
        A, nc = len(spec["anchors"]), spec["classes"]
        stride = image_h // H
        t = raw.permute(0, 2, 3, 1).reshape(B, H, W, A, 5 + nc)
        cy, cx = torch.meshgrid(torch.arange(H, device=raw.device, dtype=torch.float32),
                                torch.arange(W, device=raw.device, dtype=torch.float32),
                                indexing="ij")
        cell = torch.stack([cx, cy], -1)[None, :, :, None, :]
        anchor = torch.tensor(spec["anchors"], dtype=torch.float32, device=raw.device)
        xy = (2.0 * torch.sigmoid(t[..., 0:2]) - 0.5 + cell) * stride
        wh = (2.0 * torch.sigmoid(t[..., 2:4])) ** 2 * anchor
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        scores = torch.sigmoid(t[..., 4:5]) * torch.sigmoid(t[..., 5:])
        top2 = t[..., 5:].topk(2, dim=-1).values
        all_boxes.append(boxes.reshape(B, -1, 4))
        all_scores.append(scores.reshape(B, -1, nc))
        all_margins.append((top2[..., 0] - top2[..., 1]).reshape(B, -1))
    return torch.cat(all_boxes, 1), torch.cat(all_scores, 1), torch.cat(all_margins, 1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M)."""
    area = lambda x: (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def detect(boxes: torch.Tensor, scores: torch.Tensor, margins: torch.Tensor, conf: float,
           iou_thr: float, pre_nms: int, max_det: int):
    """Per image: each candidate's best class, kept above `conf`; the
    `pre_nms` best (stable order on ties); greedy NMS within each class in
    descending score; at most `max_det`. Returns a list over images of
    (boxes (n, 4) xyxy, scores (n,), labels (n,) = class index + 1, margins
    (n,): `margins`' entries), on the host."""
    best, cls = scores.max(-1)
    margin = margins.cpu()
    boxes, best, cls = boxes.cpu(), best.cpu(), cls.cpu()
    out = []
    for b in range(boxes.shape[0]):
        keep = torch.nonzero(best[b] > conf)[:, 0]
        order = torch.argsort(best[b][keep], descending=True, stable=True)[:pre_nms]
        idx = keep[order]
        bx, sc, lb, mg = boxes[b][idx], best[b][idx], cls[b][idx] + 1, margin[b][idx]
        overlap = (iou(bx, bx) > iou_thr) & (lb[:, None] == lb[None, :])
        alive = torch.ones(len(idx), dtype=torch.bool)
        kept = []
        for i in range(len(idx)):          # greedy: a kept box suppresses later ones
            if alive[i]:
                kept.append(i)
                alive &= ~overlap[i]
                if len(kept) == max_det:
                    break
        kept = torch.tensor(kept, dtype=torch.long)
        out.append((bx[kept], sc[kept], lb[kept], mg[kept]))
    return out
