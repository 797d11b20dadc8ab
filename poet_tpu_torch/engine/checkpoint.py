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

`--resume` also takes a reference model-zoo `.pth` and an http(s) or file://
URL to either. A zoo file keeps its detector under `backbone.0.` (the port
names it `backbone.`) and a learned position embedding under `backbone.1.`
(the port: `position_embedding.`); its aleatoric heads
(`{translation,rotation}_head_aleatoric.*`) are read only for an aleatoric
model and required there, as `poet_tpu/engine/checkpoint.py:load_resume`
converts them. Orbax directories written by `poet_tpu` cannot be read
without orbax, which the port does not use: they raise.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import urllib.request
from typing import Dict, Tuple

import torch
import torch.nn as nn

# the reference's Joiner: Sequential(detector, position embedding)
ZOO_PREFIX = "backbone.0."
ZOO_POSITION_PREFIX = "backbone.1."


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
    consolidates its shares to rank 0 here (`parallel/zero.py`), and rank 0
    alone writes (the model is replicated)."""
    from poet_tpu_torch.utils.misc import get_rank

    opt_state = optimizer.state_dict() if optimizer is not None else None
    paths = [os.path.join(output_dir, n) for n in ([names] if isinstance(names, str) else names)]
    if get_rank() != 0:
        return paths[-1]
    payload = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
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


def load_checkpoint(path: str) -> Tuple[Dict, int]:
    """A checkpoint file -> (payload, start epoch = its epoch + 1)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint written by poet_tpu, which the port "
            "cannot read without orbax. Resume from a .pth: the port's own checkpoint or a "
            "reference model-zoo file")
    payload = _torch_load(path)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path} holds no 'model' state dict")
    return payload, int(payload.get("epoch", -1)) + 1


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


def load_resume(path: str, aleatoric: bool = False) -> Tuple[Dict, int]:
    """`--resume` dispatcher: the port's checkpoint (parameters, optimizer
    state, epoch) or a reference zoo `.pth` (parameters only, through
    `zoo_to_port`: training starts at epoch 0 with a fresh optimizer), a
    local path or a URL. Returns (payload, start_epoch); payload["model"] is
    in the port's names."""
    payload, start = load_checkpoint(fetch_checkpoint(path))
    if "config" in payload:                           # the port's own file
        return payload, start
    return {"model": zoo_to_port(payload["model"], aleatoric)}, 0


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
