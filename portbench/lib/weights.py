"""Seeded weights, made on the device from `--seed` in a few large draws.

The distributions are the port's initializers (flax's: truncated-normal
lecun fan-in for every dense and conv kernel, zero biases, unit norms,
level_embed N(0, 1), the sampling-offset grid bias) and two conditionings
that keep a random detector working, copied here so that the yardstick does
not move with the program:
  * darknet (`darknet_*` keys of the configuration's "weights"): kernels
    N(0, gain / fan_in); the frozen BN before each shortcut damped; the head
    biased so that only the coarsest head's largest anchor clears the
    confidence threshold (`calibrate_darknet`), its box and class rows
    scaled apart, with boxes of a size the configuration sets
    (large enough that neighbouring cells' boxes overlap and NMS has work);
  * resnet (`resnet_*`): He-normal kernels, bn3 damped, FrozenBN statistics
    drawn around identity.
The configuration may scale the sampling-offset and attention-weight
kernels off zero (`offset_kernel_scale`, `attention_kernel_scale`), so that
sampling locations depend on the query as in a trained model. Each
rotation head's 6D output is biased towards two orthogonal vectors
(`ROTATION_BIAS_6D`), as a trained head's outputs lie: two random vectors
lie near parallel often enough that Gram-Schmidt turns a rounding into a
large turn of the frame and of the rotation loss's gradient.

One dict of float32 device tensors comes out; the program loads it through
`load_state_dict` and the reference reads it by name.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.lib import frames
from portbench.reference import darknet as ref_darknet
from portbench.reference import poet as ref_poet

TRUNC_STD = 0.87962566103423978     # std of N(0, 1) truncated to [-2, 2]
ROTATION_BIAS_6D = 2.0 * np.array([1, 0, 0, 0, 1, 0], np.float32)


class Draws:
    """Collects (name, shape, kind, scale) requests, then fills them from
    one uniform and one normal draw. kind: 'trunc' (lecun: truncated normal
    of std `scale`), 'normal' (N(0, 1) times `scale`, a number or a vector
    over the leading axis), 'abs_normal' (0.5 + 0.5 |N|), or a constant
    array ('const')."""

    def __init__(self):
        self.items = []

    def add(self, name, shape, kind, scale=1.0, offset=0.0):
        self.items.append((name, tuple(shape), kind, scale, offset))

    def make(self, seed: int, device) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        src_of = {"trunc": "trunc", "normal": "normal", "abs_normal": "normal"}
        n = {k: sum(int(np.prod(s)) for _, s, kk, _, _ in self.items if src_of.get(kk) == k)
             for k in ("trunc", "normal")}
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        u = torch.rand(n["trunc"], generator=g, device=device)
        trunc = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0) / TRUNC_STD
        normal = torch.randn(n["normal"], generator=g, device=device)
        at = {"trunc": 0, "normal": 0}
        out = {}
        for name, shape, kind, scale, offset in self.items:
            size = int(np.prod(shape))
            if kind == "const":
                out[name] = torch.as_tensor(np.asarray(scale, np.float32).reshape(shape),
                                            device=device)
                continue
            k = src_of[kind]
            x = (trunc if k == "trunc" else normal)[at[k]: at[k] + size].view(shape)
            at[k] += size
            if kind == "abs_normal":
                out[name] = 0.5 + 0.5 * x.abs()
                continue
            if isinstance(scale, np.ndarray):
                s = torch.as_tensor(scale.astype(np.float32), device=device)
                x = x * s.view((-1,) + (1,) * (len(shape) - 1))
            else:
                x = x * float(scale)
            out[name] = x + float(offset)
        return out


def poet_draws(d: Draws, shapes: Dict[str, tuple], m: dict, w: dict) -> None:
    """The transformer, input projections and heads (names not under
    'backbone.')."""
    H, L = m["nheads"], m["num_feature_levels"]
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "transformer.level_embed":
            d.add(name, shape, "normal")
        elif name.endswith("sampling_offsets.bias"):
            P = shape[0] // (H * L * 2)
            d.add(name, shape, "const", ref_poet.grid_bias(H, L, P))
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            scale = 1.0 / math.sqrt(fan_in)
            if "sampling_offsets" in name:
                scale *= w.get("offset_kernel_scale", 0.0)
            elif "attention_weights" in name:
                scale *= w.get("attention_kernel_scale", 0.0)
            if scale == 0.0:
                d.add(name, shape, "const", np.zeros(shape, np.float32))
            else:
                d.add(name, shape, "trunc", scale)
        elif leaf == "weight" and (".norm" in name or name.endswith(".1.weight")):
            d.add(name, shape, "const", np.ones(shape, np.float32))
        elif name.startswith("rotation_head.") and name.endswith(".layers.2.bias"):
            d.add(name, shape, "const", np.tile(ROTATION_BIAS_6D, shape[0] // 6))
        else:
            d.add(name, shape, "const", np.zeros(shape, np.float32))


def bn_draws(d: Draws, p: str, c: int, scale: float) -> None:
    d.add(p + "weight", (c,), "normal", 0.1 * scale, scale)
    d.add(p + "bias", (c,), "normal", 0.1 * scale)
    d.add(p + "running_mean", (c,), "normal", 0.1)
    d.add(p + "running_var", (c,), "abs_normal")


def darknet_draws(d: Draws, sections, w: dict, prefix: str = "backbone.body.") -> None:
    body = sections[1:]
    walk = ref_darknet.walk(sections)
    damped = {li - 1 for li, s in enumerate(body) if s["type"] == "shortcut"}
    heads = {li - 1: s for li, s in enumerate(body) if s["type"] == "yolo"}
    coarsest = max(heads, key=lambda li: walk[li][1])
    for li, sec in enumerate(body):
        if sec["type"] != "convolutional":
            continue
        f, k, _, _, bn, _ = ref_darknet.conv_geometry(sec)
        cin = walk[li][2]
        fan_in = cin * k * k
        name = f"{prefix}conv_{li}."
        if li in heads:
            anchors, mask = ref_darknet.ints(heads[li]["anchors"]), ref_darknet.ints(heads[li]["mask"])
            per = 5 + int(heads[li]["classes"])
            rows = np.ones(per, np.float32)
            rows[:4] = w["darknet_head_box_kernel_scale"]
            rows[5:] = w["darknet_head_cls_kernel_scale"]
            d.add(name + "weight", (f, cin, k, k), "normal",
                  np.tile(rows, len(mask)) / math.sqrt(fan_in))
            bias = np.full((len(mask), per), w["darknet_head_cls_bias"], np.float32)
            bias[:, :2] = 0.0
            bias[:, 2:4] = w["darknet_head_wh_bias"]
            bias[:, 4] = w["darknet_head_obj_bias_others"]
            if li == coarsest:
                areas = [anchors[2 * j] * anchors[2 * j + 1] for j in mask]
                bias[int(np.argmax(areas)), 4] = w["darknet_head_obj_bias_largest"]
            d.add(name + "bias", (f,), "const", bias.reshape(-1))
            continue
        d.add(name + "weight", (f, cin, k, k), "normal", math.sqrt(w["darknet_body_gain"] / fan_in))
        if bn:
            bn_draws(d, f"{prefix}bn_{li}.", f, w["darknet_damp"] if li in damped else 1.0)
        else:
            d.add(name + "bias", (f,), "normal", 0.05)


def resnet_draws(d: Draws, shapes: Dict[str, tuple], w: dict, prefix: str) -> None:
    """ResNet-50-FPN: conv kernels N(0, 2 / fan_in), the FPN's biases
    N(0, 0.05^2), FrozenBN statistics around identity, each block's bn3
    damped by `resnet_damp`."""
    for name, shape in shapes.items():
        if not name.startswith(prefix):
            continue
        if len(shape) == 4:
            d.add(name, shape, "normal", math.sqrt(2.0 / int(np.prod(shape[1:]))))
        elif name.endswith(".bias") and ".fpn." in name:
            d.add(name, shape, "normal", 0.05)
        elif name.endswith(".weight"):
            stem = name[: -len("weight")]
            bn_draws(d, stem, shape[0], w["resnet_damp"] if stem.endswith("bn3.") else 1.0)


def make_weights(conf, seed: int, device) -> Dict[str, torch.Tensor]:
    """The whole model's state dict for configuration `conf` (a loaded
    `portbench/configs/<name>.json`)."""
    d = Draws()
    shapes = dict(conf.poet_shapes)
    poet_draws(d, shapes, conf.model, conf.weights)
    if conf.backbone == "darknet":
        darknet_draws(d, conf.sections, conf.weights)
    else:
        resnet_draws(d, conf.backbone_shapes, conf.weights, "backbone.")
    state = d.make(seed, device)
    if conf.backbone == "darknet" and "darknet_detections_per_image" in conf.weights:
        calibrate_darknet(state, conf, seed, device)
    return state


def calibrate_darknet(state: Dict[str, torch.Tensor], conf, seed: int, device,
                      images: int = 2, prefix: str = "backbone.body.") -> None:
    """Set the objectness bias of the coarsest head's largest anchor so that
    `darknet_detections_per_image` candidates an image clear the confidence
    threshold, on average over `images` calibration images drawn from the
    seed (the configuration's "calibration_frames"): a drawn body's
    activation scale varies between seeds by a factor of two, and a fixed
    bias would give some seeds no detection at all. The body runs in float32
    (the reference's)."""
    from portbench.reference.numerics import exact

    sections, w = conf.sections, conf.weights
    body = sections[1:]
    walk = ref_darknet.walk(sections)
    heads = {li - 1: s for li, s in enumerate(body) if s["type"] == "yolo"}
    li = max(heads, key=lambda k: walk[k][1])
    anchors, mask = ref_darknet.ints(heads[li]["anchors"]), ref_darknet.ints(heads[li]["mask"])
    a = int(np.argmax([anchors[2 * j] * anchors[2 * j + 1] for j in mask]))
    per = 5 + int(heads[li]["classes"])
    H, W = conf.data["calibration_hw"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    x = frames.make(conf.data["calibration_frames"], images, H, W, g, device)
    bias = state[f"{prefix}conv_{li}.bias"]
    with torch.no_grad(), exact():
        raw = ref_darknet.body(state, sections, x)[0][sorted(heads).index(li)]
    t = raw.permute(0, 2, 3, 1).reshape(images, -1, len(mask), per)[:, :, a].float()
    z = t[..., 4] - bias[a * per + 4]
    p_cls = torch.sigmoid(t[..., 5:]).amax(-1)
    need = torch.logit((conf.data["detector"]["conf_thresh"] / p_cls).clamp(max=1 - 1e-6)) - z
    k = int(w["darknet_detections_per_image"] * images)
    b = torch.sort(need.reshape(-1)).values[k - 1] + 1e-3
    bias[a * per + 4] = b
