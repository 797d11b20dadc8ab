"""Plain ResNet-50 + FPN (torchvision's `resnet_fpn_backbone('resnet50')`
with frozen batch norm, eps 1e-5), in float32 PyTorch, under torchvision's
parameter names below `prefix`. Raw [0, 1] images go in, as in PoET. Only
the pyramid levels the transformer reads are built: `levels` from '2', '3'
(the stride-16 and stride-32 maps) and 'pool' (a stride-2 subsample of the
coarsest output, torchvision's LastLevelMaxPool with a 1x1 window)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.numerics import conv2d

PREFIX = "backbone.backbone."
WIDTHS, BLOCKS = (64, 128, 256, 512), (3, 4, 6, 3)


def _finest(levels: Sequence[str]) -> int:
    return min(3 if l == "pool" else int(l) for l in levels)


def param_shapes(levels: Sequence[str], prefix: str = PREFIX) -> Dict[str, tuple]:
    s = {}

    def bn(name, c):
        for n in ("weight", "bias", "running_mean", "running_var"):
            s[f"{prefix}{name}.{n}"] = (c,)

    s[f"{prefix}body.conv1.weight"] = (64, 3, 7, 7)
    bn("body.bn1", 64)
    cin = 64
    for stage, (w, n) in enumerate(zip(WIDTHS, BLOCKS)):
        for b in range(n):
            p = f"body.layer{stage + 1}.{b}."
            s[f"{prefix}{p}conv1.weight"] = (w, cin, 1, 1)
            bn(p + "bn1", w)
            s[f"{prefix}{p}conv2.weight"] = (w, w, 3, 3)
            bn(p + "bn2", w)
            s[f"{prefix}{p}conv3.weight"] = (w * 4, w, 1, 1)
            bn(p + "bn3", w * 4)
            if b == 0:
                s[f"{prefix}{p}downsample.0.weight"] = (w * 4, cin, 1, 1)
                bn(p + "downsample.1", w * 4)
            cin = w * 4
    for i in range(_finest(levels), 4):
        s[f"{prefix}fpn.inner_blocks.{i}.weight"] = (256, 256 * 2 ** i, 1, 1)
        s[f"{prefix}fpn.inner_blocks.{i}.bias"] = (256,)
        if str(i) in levels or (i == 3 and "pool" in levels):
            s[f"{prefix}fpn.layer_blocks.{i}.weight"] = (256, 256, 3, 3)
            s[f"{prefix}fpn.layer_blocks.{i}.bias"] = (256,)
    return s


def _bn(p, name, x):
    scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"] + 1e-5)
    shift = p[name + ".bias"] - p[name + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, levels: Sequence[str],
            prefix: str = PREFIX) -> List[torch.Tensor]:
    """images (B, H, W, 3) -> the maps of sorted(levels), NCHW float32."""
    x = images.float().permute(0, 3, 1, 2)
    b = prefix + "body."
    x = F.relu(_bn(p, b + "bn1", conv2d(x, p[b + "conv1.weight"], None, 2, 3)))
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)
    cs = []
    for stage, n in enumerate(BLOCKS):
        for k in range(n):
            q = f"{b}layer{stage + 1}.{k}."
            stride = 2 if (stage > 0 and k == 0) else 1
            y = F.relu(_bn(p, q + "bn1", conv2d(x, p[q + "conv1.weight"])))
            y = F.relu(_bn(p, q + "bn2", conv2d(y, p[q + "conv2.weight"], None, stride, 1)))
            y = _bn(p, q + "bn3", conv2d(y, p[q + "conv3.weight"]))
            if k == 0:
                x = _bn(p, q + "downsample.1", conv2d(x, p[q + "downsample.0.weight"], None,
                                                       stride))
            x = F.relu(y + x)
        cs.append(x)
    f = prefix + "fpn."
    lateral = {}
    for i in range(3, _finest(levels) - 1, -1):
        inner = conv2d(cs[i], p[f"{f}inner_blocks.{i}.weight"], p[f"{f}inner_blocks.{i}.bias"])
        if i < 3:
            up = lateral[i + 1]
            sy, sx = inner.shape[-2] // up.shape[-2], inner.shape[-1] // up.shape[-1]
            inner = inner + up.repeat_interleave(sy, 2).repeat_interleave(sx, 3)
        lateral[i] = inner
    outs = {str(i): conv2d(lateral[i], p[f"{f}layer_blocks.{i}.weight"],
                           p[f"{f}layer_blocks.{i}.bias"], 1, 1)
            for i in lateral if f"{f}layer_blocks.{i}.weight" in p}
    if "pool" in levels:
        outs["pool"] = outs["3"][:, :, ::2, ::2]
    return [outs[k] for k in sorted(levels)]
