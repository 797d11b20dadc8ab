"""Checkpoint / resume in the reference's torch layout. Counterpart of
`poet_tpu/engine/checkpoint.py`, which writes orbax directories.

Parity target: the reference's main.py:285-317,357-369:
  * a rolling `output_dir/checkpoint.pth`, plus `checkpoint{epoch:04d}.pth`
    every `save_interval` epochs and before each LR drop;
  * the file holds {"model": state_dict, "optimizer": ..., "epoch", "step",
    "config": cfg.to_json()}: the optimizer entry is
    `engine/train.py:Optimizer.state_dict()` (its update and micro-step
    counts, the gradient-accumulation buffer and the torch AdamW/SGD state);
    the config is a JSON string, so the file loads with
    `torch.load(weights_only=True)`;
  * resume restores the parameters, the optimizer state and the epoch; the
    learning rates come from the current command line (the schedule is
    rebuilt from it), as in the JAX package;
  * missing and unexpected keys are tolerated with a report (main.py:293-298);
  * over more than one process rank 0 writes, after a ZeRO-1 optimizer has
    gathered its state there: the file holds the plain optimizer's layout,
    so it resumes with or without `--zero_opt_state`, over any number of
    processes.

`--resume` also takes a reference model-zoo file and an http(s) or file://
URL to either. A zoo file is read as `poet_tpu/utils/torch_import.py:
load_state_dict_file` reads it (`load_state_dict_file`): a `.pth`/`.pt`
through `torch.load`, a `.npz` through numpy; the state dict under
"model", "state_dict" or "model_state_dict", or the bare dict; DDP's
`module.` prefix dropped. `--backbone_weights` reads its `.pth`/`.npz` the
same way. A zoo file keeps its detector under `backbone.0.` (the port
names it `backbone.`) and a learned position embedding under `backbone.1.`
(the port: `position_embedding.`); its aleatoric heads
(`{translation,rotation}_head_aleatoric.*`) are read only for an aleatoric
model and required there, as `poet_tpu/engine/checkpoint.py:load_resume`
converts them.

`--resume`, `--eval`, `--eval_bop`, `--inference` and `--export_model`
also take the orbax directory that `poet_tpu` writes (its
`engine/checkpoint.py:save_checkpoint`: {params, opt_state, step, epoch}
and a config.json beside), read without orbax by
`utils/orbax_format.py:read_pytree` (`load_orbax`): the parameters into
the port's names through `utils/jax_params.py:jax_state_dict` (merged with
the report, as `poet_tpu` merges them), optax's state kept raw for
`engine/train.py:Optimizer.load_optax_state`, the step, and the start epoch
= its epoch + 1. Its config.json is read only to print the model widths
that differ from the command line's. A directory without `_METADATA`, or
with zarr v3 arrays, raises. Directories are local: a URL names a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# the reference's Joiner: Sequential(detector, position embedding)
ZOO_PREFIX = "backbone.0."
ZOO_POSITION_PREFIX = "backbone.1."
# the keys a zoo file may hold its state dict under, in the order they are tried
ZOO_PAYLOAD_KEYS = ("model", "state_dict", "model_state_dict")


def _torch_load(path: str):
    """torch.load with weights_only=True; reference zoo files pickle an
    argparse Namespace under "args", which is allowed for that."""
    torch.serialization.add_safe_globals([argparse.Namespace])
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(output_dir: str, names, model: nn.Module, optimizer, epoch: int,
                    step: int, cfg) -> str:
    """Write {model, optimizer, epoch, step, config} to output_dir/name for
    each of `names` (one name or several); returns the last path. Each file
    is written beside and renamed over the old one, so a crash mid-write
    leaves the old checkpoint whole.

    Over more than one process every process calls it: a ZeRO-1 optimizer
    consolidates its shares to rank 0 here (`parallel/zero.py`), a sharded
    model and its optimizer state are gathered whole over 'model'
    (`parallel/tp.py:gather_state_dict`), and rank 0 alone writes: the
    file is the one-process checkpoint whatever the layout."""
    from poet_tpu_torch.parallel.tp import gather_state_dict
    from poet_tpu_torch.utils.misc import get_rank

    opt_state = optimizer.state_dict() if optimizer is not None else None
    state = gather_state_dict(model)
    paths = [os.path.join(output_dir, n) for n in ([names] if isinstance(names, str) else names)]
    if get_rank() != 0:
        return paths[-1]
    payload = {"model": state,
               "optimizer": opt_state, "epoch": int(epoch), "step": int(step),
               "config": cfg.to_json()}
    for path in paths:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    return paths[-1]


def checkpoint_paths_for_epoch(output_dir: str, epoch: int, cfg):
    """The rolling and snapshot file names for an epoch. Parity: main.py:357-361."""
    names = ["checkpoint.pth"]
    if (epoch + 1) % cfg.optim.lr_drop == 0 or (epoch + 1) % cfg.runtime.save_interval == 0:
        names.append(f"checkpoint{epoch:04d}.pth")
    return names


_URL = re.compile(r"^(https?|file)://")


def fetch_checkpoint(path: str) -> str:
    """A `--resume` URL downloaded into ~/.cache/poet_tpu_torch/checkpoints
    (cached by the URL's hash), else the path itself. Parity: the reference
    accepts https:// checkpoint URLs (main.py:288-290); file:// makes the
    path testable without a network."""
    if not _URL.match(path):
        return path
    cache = os.path.join(os.path.expanduser("~"), ".cache", "poet_tpu_torch", "checkpoints")
    os.makedirs(cache, exist_ok=True)
    base = os.path.basename(path.split("?", 1)[0]) or "checkpoint"
    dest = os.path.join(cache, hashlib.sha1(path.encode()).hexdigest()[:16] + "_" + base)
    if not os.path.exists(dest):
        urllib.request.urlretrieve(path, dest)
    return dest


def _refuse_directory(path: str) -> None:
    """A zoo or detector file is a file: a directory raises."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: a state-dict file (.pth/.pt/.npz) is read "
                         "here; an orbax checkpoint directory is read by --resume")


# the model fields whose difference from the command line load_orbax reports
WIDTH_FIELDS = ("hidden_dim", "dim_feedforward", "enc_layers", "dec_layers", "nheads",
                "num_queries", "num_feature_levels", "enc_n_points", "dec_n_points",
                "n_classes", "aleatoric", "reference_points", "query_embedding")


def load_orbax(path: str, model: nn.Module, cfg=None) -> Tuple[Dict, int]:
    """An orbax checkpoint directory written by `poet_tpu` -> (payload,
    start epoch = its epoch + 1), as `poet_tpu/engine/checkpoint.py:
    load_checkpoint` restores it without a template. payload: "model" the
    parameters in `model`'s names (strict=False: a leaf the model lacks is
    kept under its flax path, for merge_params to report), "optax" the raw
    optimizer state (None when there is none), "step" and "epoch". With
    `cfg`, one line names the model widths in which the checkpoint's
    config.json differs from it."""
    from poet_tpu_torch.utils.jax_params import jax_state_dict
    from poet_tpu_torch.utils.orbax_format import read_pytree

    tree = read_pytree(path)
    if "params" not in tree:
        raise ValueError(f"{path} holds no 'params': not a poet_tpu checkpoint")
    cfg_path = os.path.join(path, "config.json")
    if cfg is not None and os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f).get("model", {})
        now = dataclasses.asdict(cfg.model)
        diff = [f"{k} {saved[k]!r} != {now[k]!r}" for k in WIDTH_FIELDS
                if k in saved and saved[k] != now[k]]
        if diff:
            print(f"note: {cfg_path} differs from the command line in model "
                  f"{', '.join(diff)}; the command line's model is built")
    payload = {"model": jax_state_dict(model, tree["params"], strict=False),
               "optax": tree.get("opt_state"), "step": int(tree.get("step", 0)),
               "epoch": int(tree.get("epoch", -1))}
    return payload, payload["epoch"] + 1


def load_checkpoint(path: str, model: Optional[nn.Module] = None) -> Tuple[Dict, int]:
    """A checkpoint file, or with `model` an orbax directory (`load_orbax`)
    -> (payload, start epoch = its epoch + 1)."""
    if os.path.isdir(path):
        return _load_directory(path, model)
    payload = _torch_load(path)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path} holds no 'model' state dict")
    return payload, int(payload.get("epoch", -1)) + 1


def _read_file(path: str):
    """A `.npz` as {name: tensor}, any other file through `_torch_load`."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    return _torch_load(path)


def _zoo_state_dict(obj) -> Dict:
    """The state dict of a loaded zoo file: under the first of
    ZOO_PAYLOAD_KEYS that holds a dict, else the file's dict itself; DDP's
    `module.` prefix dropped."""
    if isinstance(obj, dict):
        for key in ZOO_PAYLOAD_KEYS:
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"a zoo file holds a state dict, not a {type(obj).__name__}")
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}


def load_state_dict_file(path: str) -> Dict:
    """A reference zoo or detector file (`.pth`/`.pt`/`.npz`) -> its flat
    state dict, as `poet_tpu/utils/torch_import.py:load_state_dict_file`
    reads it."""
    _refuse_directory(path)
    return _zoo_state_dict(_read_file(path))


def zoo_to_port(sd: Dict, aleatoric: bool = False) -> Dict:
    """A reference zoo state dict in the port's names: `module.` dropped,
    the Joiner's `backbone.0.` -> `backbone.` and `backbone.1.` ->
    `position_embedding.`; the aleatoric heads kept only when `aleatoric`,
    and then required (KeyError without them)."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    heads = [k for k in sd if "_head_aleatoric." in k]
    if aleatoric and not heads:
        raise KeyError("an aleatoric model resumed from a zoo file without "
                       "translation_head_aleatoric / rotation_head_aleatoric weights")
    out = {}
    for k, v in sd.items():
        if k in heads and not aleatoric:
            continue
        for zoo, port in ((ZOO_PREFIX, "backbone."), (ZOO_POSITION_PREFIX, "position_embedding.")):
            if k.startswith(zoo):
                k = port + k[len(zoo):]
                break
        out[k] = v
    return out


def _load_directory(path: str, model: Optional[nn.Module], cfg=None) -> Tuple[Dict, int]:
    from poet_tpu_torch.utils.orbax_format import read_metadata

    read_metadata(path)                # raises naming what is missing or refused
    if model is None:
        raise ValueError(f"{path} is an orbax checkpoint: reading it needs the model whose "
                         "names its parameters take")
    return load_orbax(path, model, cfg)


def load_resume(path: str, aleatoric: bool = False, model: Optional[nn.Module] = None,
                cfg=None) -> Tuple[Dict, int]:
    """`--resume` dispatcher: the port's checkpoint (parameters, optimizer
    state, epoch), a reference zoo file (parameters only, through
    `zoo_to_port`: training starts at epoch 0 with a fresh optimizer), a
    local path or a URL; or, given `model`, an orbax directory written by
    `poet_tpu` (`load_orbax`: parameters, optax's state, step, epoch).
    Returns (payload, start_epoch); payload["model"] is in the port's
    names."""
    local = fetch_checkpoint(path)
    if os.path.isdir(local):
        return _load_directory(local, model, cfg)
    obj = _read_file(local)
    if isinstance(obj, dict) and "config" in obj and "model" in obj:   # the port's own file
        return obj, int(obj.get("epoch", -1)) + 1
    return {"model": zoo_to_port(_zoo_state_dict(obj), aleatoric)}, 0


def merge_params(module: nn.Module, state_dict: Dict[str, torch.Tensor]):
    """Copy `state_dict` into `module`'s parameters and buffers by name,
    strict=False: returns (missing_keys, unexpected_keys), a shape mismatch
    reported as missing. Parity: torch load_state_dict(strict=False)'s
    report (main.py:293-298) and the JAX package's merge_params."""
    missing, unexpected = [], []
    own = module.state_dict()
    with torch.no_grad():
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = torch.as_tensor(state_dict[name])
            if tuple(src.shape) != tuple(t.shape):
                missing.append(f"{name} (shape {tuple(src.shape)} != {tuple(t.shape)})")
                continue
            t.copy_(src)
    unexpected = [k for k in state_dict if k not in own]
    return missing, unexpected
