"""Load a `poet_tpu` (flax) parameter tree into a port module, exactly.

`load_jax_params(model, tree)` takes the JAX package's `params` tree as
numpy arrays (nested dicts, optionally wrapped in {"params": ...}) and
fills every parameter and buffer of `model`; it raises if a port tensor is
left unset, if a leaf of the tree is left unused, or on any shape mismatch.
It works on the whole PoET module and on any ported submodule whose tree
is passed (e.g. one EncoderLayer and its flax subtree). The conversion
itself is `jax_state_dict(model, tree)`: the arrays by port name, whole,
with the model untouched; it also carries a tree shaped like the
parameters, such as an optax moment (`engine/train.py:Optimizer.
load_optax_state`), and, not strict, a checkpoint merged with a report
(`engine/checkpoint.py:load_orbax`).

Conversions (the inverse of `poet_tpu/utils/torch_import.py`):
  * flax Dense kernel (in, out) -> Linear weight (out, in),
  * flax Conv kernel HWIO -> Conv2d weight OIHW,
  * LayerNorm/GroupNorm scale -> weight,
  * flax MHA query/key/value kernels (C, H, Dh) + out (H, Dh, C) -> packed
    in_proj (3C, C) + out_proj (C, C).
Module names map onto flax names by the rules in `_RULES` (e.g.
`transformer.encoder.layers.0` -> `transformer/encoder_layer_0`,
`backbone.backbone.body.layer1.0.downsample.0` ->
`backbone/fpn_body/body/layer1_0/downsample_conv`, `backbone.rpn.head.conv`
-> `backbone/detector/rpn_head/conv`, `backbone.roi_heads.box_head.fc6` ->
`backbone/detector/box_head/fc6`; fc6's JAX kernel has Dense's (in, out)
layout in torchvision's (C, 7, 7) flatten order). A learned table
(`models/layers.py:Embedding`) is its flax leaf itself: `query_embed.weight`
<- `query_embed`, `position_embedding.row_embed.weight` <-
`position_embedding/row_embed` (and `col_embed`); the aleatoric heads
`translation_head_aleatoric.{l}` <- `translation_head_aleatoric_{l}` (and
the rotation's), the learned reference points `transformer.reference_points`
<- `transformer/reference_points`, as every Dense.

Into a tensor-parallel module (`parallel/tp.py:shard_module`) the tree is
read whole and each split tensor cut to the process's shard by the same
rules (`tp.param_spec`), so every process loads the same file.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.models.layers import Conv, Dense, Embedding, GroupNorm, LayerNorm
from poet_tpu_torch.models.resnet_fpn import FrozenBatchNorm
from poet_tpu_torch.models.transformer import DeformableTransformer, MultiheadAttention
from poet_tpu_torch.parallel.tp import shard_array

# port module name -> flax module path, applied in order to the dotted name
_RULES = (
    (r"(^|\.)backbone\.backbone(?=\.|$)", r"\1backbone.fpn_body"),
    (r"(^|\.)rpn\.head(?=\.|$)", r"\1detector.rpn_head"),
    (r"(^|\.)roi_heads\.(box_head|box_predictor)(?=\.|$)", r"\1detector.\2"),
    (r"(^|\.)encoder\.layers\.(\d+)", r"\1encoder_layer_\2"),
    (r"(^|\.)decoder\.layers\.(\d+)", r"\1decoder_layer_\2"),
    (r"(^|\.)((?:translation|rotation)_head(?:_aleatoric)?)\.(\d+)", r"\1\2_\3"),
    (r"(^|\.)input_proj\.(\d+)\.0$", r"\1input_proj_\2_conv"),
    (r"(^|\.)input_proj\.(\d+)\.1$", r"\1input_proj_\2_gn"),
    (r"(^|\.)layers\.(\d+)$", r"\1layer_\2"),            # MLP heads
    (r"(^|\.)inner_blocks\.(\d+)$", r"\1inner_\2"),
    (r"(^|\.)layer_blocks\.(\d+)$", r"\1layer_\2"),
    (r"(^|\.)layer(\d)\.(\d+)", r"\1layer\2_\3"),        # ResNet stages
    (r"\.downsample\.0$", ".downsample_conv"),
    (r"\.downsample\.1$", ".downsample_bn"),
)


def flax_path(module_name: str) -> Tuple[str, ...]:
    for pattern, repl in _RULES:
        module_name = re.sub(pattern, repl, module_name)
    return tuple(p for p in module_name.split(".") if p)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def jax_state_dict(model: nn.Module, tree: Dict[str, Any],
                   strict: bool = True) -> Dict[str, Any]:
    """The JAX tree converted by the rules above into `model`'s state-dict
    names, each array whole (not cut to a shard) and float32, without
    touching the model. A tensor whose leaves are all None stays None (an
    optax moment tree's masked leaves). `strict`: a missing leaf or one left
    unused raises KeyError; otherwise a port tensor whose leaves are missing
    is left out and each unused leaf is kept under its '/'-joined flax path
    (a state-dict merge then reports both)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    used = set()
    out: Dict[str, Any] = {}

    class Missing(Exception):
        pass

    def take(path):
        if path not in flat:
            if strict:
                raise KeyError(f"the JAX tree has no {'/'.join(path)}")
            raise Missing
        used.add(path)
        return None if flat[path] is None else np.asarray(flat[path], dtype=np.float32)

    def put(name, convert, *paths):
        """out[name] = convert(*leaves); None when every leaf is None."""
        try:
            leaves = [take(p) for p in paths]
        except Missing:
            return
        if all(x is None for x in leaves):
            out[name] = None
        elif any(x is None for x in leaves):
            raise ValueError(f"{name}: some of its JAX leaves are None, some are not")
        else:
            out[name] = convert(*leaves)

    def packed(*qkv):
        return np.concatenate([x.reshape(x.shape[0], -1).T for x in qkv])

    handled_by_parent = set()
    for name, m in model.named_modules():
        if name in handled_by_parent:
            continue
        pre = f"{name}." if name else ""
        path = flax_path(name)
        if isinstance(m, MultiheadAttention):
            qkv = ("query", "key", "value")
            put(pre + "in_proj_weight", packed, *(path + (p, "kernel") for p in qkv))
            put(pre + "in_proj_bias", lambda *b: np.concatenate([x.reshape(-1) for x in b]),
                *(path + (p, "bias") for p in qkv))
            put(pre + "out_proj.weight", lambda k: k.reshape(-1, k.shape[-1]).T,
                path + ("out", "kernel"))
            put(pre + "out_proj.bias", lambda b: b, path + ("out", "bias"))
            handled_by_parent.add(pre + "out_proj")
        elif isinstance(m, Dense):
            put(pre + "weight", lambda k: k.T, path + ("kernel",))
            put(pre + "bias", lambda b: b, path + ("bias",))
        elif isinstance(m, Conv):
            put(pre + "weight", lambda k: k.transpose(3, 2, 0, 1), path + ("kernel",))
            if m.bias is not None:
                put(pre + "bias", lambda b: b, path + ("bias",))
        elif isinstance(m, (LayerNorm, GroupNorm)):
            put(pre + "weight", lambda s: s, path + ("scale",))
            put(pre + "bias", lambda b: b, path + ("bias",))
        elif isinstance(m, FrozenBatchNorm):
            for b in ("weight", "bias", "running_mean", "running_var"):
                put(pre + b, lambda v: v, path + (b,))
        elif isinstance(m, Embedding):
            put(pre + "weight", lambda w: w, path)
        elif isinstance(m, DeformableTransformer):
            put(pre + "level_embed", lambda e: e, path + ("level_embed",))

    unused = sorted("/".join(p) for p in set(flat) - used)
    if unused and strict:
        raise KeyError(f"JAX leaves with no port tensor: {unused[:8]}")
    for p in unused:
        out[p] = flat[tuple(p.split("/"))]
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    layout = getattr(model, "layout", None)
    own = model.state_dict()
    converted = jax_state_dict(model, tree)
    for name, arr in converted.items():
        t = own[name]
        arr = shard_array(name, arr, layout)
        if tuple(t.shape) != arr.shape:
            raise ValueError(f"{name}: port shape {tuple(t.shape)} != JAX {arr.shape}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    missing = sorted(set(own) - set(converted))
    if missing:
        raise KeyError(f"port tensors not set from the JAX tree: {missing[:8]}")
    return model
