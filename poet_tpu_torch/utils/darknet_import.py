"""Darknet .weights reader for the YOLOv4-CSP backbone.

Counterpart of `poet_tpu/utils/darknet_import.py:_channel_walk` and
`load_darknet_weights`: it reads the darknet binary into the same
flax-named numpy tree as the JAX package, {'conv_<i>': {'kernel' (kh, kw,
in, out) [, 'bias']}, 'bn_<i>': {'weight', 'bias', 'running_mean',
'running_var'}}, so one file gives both packages the same weights. A port
model takes the tree strictly: `load_jax_params(model.backbone.body, tree)`
raises on a missing or unused leaf. JAX's `load_yolov4_weights` merges into
a whole model's tree with a missing/unexpected report
(`engine/checkpoint.merge_params`); that report is queued with the
checkpoint work and not ported.

Binary layout (AlexeyAB darknet, src/parser.c:save_weights_upto):
  int32 major, int32 minor, int32 revision,
  seen: int64 if major*10+minor >= 2 else int32,
  then for every [convolutional] section in cfg order:
    if batch_normalize: biases(f), scales(f), rolling_mean(f), rolling_var(f)
    else:               biases(f)
    conv weights (f, c_in, k, k) row-major float32.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from poet_tpu_torch.models.yolov4 import channel_walk


def _channel_walk(sections: List[Dict[str, Any]]) -> List[Tuple[int, Dict[str, Any], int]]:
    """(layer index, section, input channels) of every convolutional section."""
    channels, _ = channel_walk(sections)
    cin = [int(sections[0].get("channels", 3))] + channels[:-1]
    return [(li, sec, cin[li]) for li, sec in enumerate(sections[1:])
            if sec["type"] == "convolutional"]


def load_darknet_weights(cfg_sections, weights_path: str) -> Dict[str, Any]:
    """Read a darknet .weights file into a DarknetBody tree (flax names).
    `cfg_sections` is `load_cfg_sections`'s frozen form or a list of dicts.
    Raises if the file's size does not match the cfg exactly."""
    sections = [dict(s) for s in cfg_sections]
    with open(weights_path, "rb") as f:
        major, minor, _ = struct.unpack("<3i", f.read(12))
        f.read(8 if major * 10 + minor >= 2 else 4)              # images seen
        buf = np.frombuffer(f.read(), dtype=np.float32)

    tree: Dict[str, Any] = {}
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > buf.size:
            raise ValueError(f"darknet weights exhausted at float {pos} + {n} > {buf.size}: "
                             "the cfg does not match this .weights file")
        out = buf[pos:pos + n].copy()
        pos += n
        return out

    for li, sec, c_in in _channel_walk(sections):
        filters, size = int(sec["filters"]), int(sec["size"])
        if int(sec.get("groups", 1)) != 1:
            raise NotImplementedError("grouped convolutions (not used by yolov4-csp)")
        entry: Dict[str, Any] = {}
        if int(sec.get("batch_normalize", 0)):
            beta, gamma, mean, var = (take(filters) for _ in range(4))
            tree[f"bn_{li}"] = {"bias": beta, "weight": gamma, "running_mean": mean,
                                "running_var": var}
        else:
            entry["bias"] = take(filters)
        w = take(filters * c_in * size * size).reshape(filters, c_in, size, size)
        tree[f"conv_{li}"] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), **entry}

    if pos != buf.size:
        raise ValueError(f"darknet weights file has {buf.size - pos} unread floats: "
                         "the cfg does not match this .weights file")
    return tree
