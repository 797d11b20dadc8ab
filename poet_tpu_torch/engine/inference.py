"""Inference over a flat directory of images -> results.json. Counterpart of
`poet_tpu/engine/inference.py`.

Parity target: the reference's inference_tools/inference_engine.py:24-76 and
dataset.py:23-59: image files sorted by the first number in their name,
batch size 1, detector-predicted boxes (bbox_mode='backbone', which the CLI
forces, main.py:407), output {img_id: {det_idx: {t, rot, box, class}}}.
Images are decoded by the port's PNG decoder (`poet_tpu_torch/native`).
"""

from __future__ import annotations

import json
import os
import re

import torch
import torch.nn as nn

from poet_tpu_torch.native import load_image_rgb_f32
from poet_tpu_torch.utils.params import cast_params_for_inference


def _numeric_key(name: str):
    m = re.findall(r"\d+", name)
    return (int(m[0]) if m else 0, name)


def list_inference_images(path: str):
    """Image files sorted by their first number. Parity: inference_tools/dataset.py:23-40."""
    files = [f for f in os.listdir(path)
             if f.lower().rsplit(".", 1)[-1] in ("png", "jpg", "jpeg", "bmp")]
    return sorted(files, key=_numeric_key)


def inference(model: nn.Module, cfg, device="cuda"):
    """Run PoET on an unannotated image directory and write results.json
    into `runtime.inference_output` (or `runtime.output_dir`). `model` is
    the built, initialized detector model with its weights loaded; it is
    moved to `device` (the card unless the caller passes another) and stays
    there, channels_last on the card, its bf16-compute weights cast at rest
    for a bf16 model. Returns the results dict."""
    if not cfg.runtime.inference_path:
        raise ValueError("--inference needs --inference_path")
    if cfg.model.bbox_mode != "backbone":
        raise ValueError("inference uses detector-predicted boxes: bbox_mode must be "
                         "'backbone' (the CLI forces it, as the reference's main.py:407)")
    files = list_inference_images(cfg.runtime.inference_path)
    if not files:
        raise FileNotFoundError(f"no images in {cfg.runtime.inference_path}")
    out_dir = cfg.runtime.inference_output or cfg.runtime.output_dir
    os.makedirs(out_dir, exist_ok=True)

    dev = torch.device(device)
    model = model.to(dev).eval()
    if cfg.model.dtype == "bfloat16":
        cast_params_for_inference(model)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)

    results = {}

    def consume(out, img_id, fname):
        n = int(out["n_boxes"][0])
        trans = out["translations"][-1, 0].float().cpu().numpy()
        rots = out["rotations"][-1, 0].float().cpu().numpy()
        boxes = out["pred_boxes"][0].float().cpu().numpy()
        classes = out["pred_classes"][0].cpu().numpy()
        results[img_id] = {
            d: {"t": trans[d].tolist(), "rot": rots[d].tolist(), "box": boxes[d].tolist(),
                "class": int(classes[d])}
            for d in range(n)}
        print(f"Processed {img_id + 1}/{len(files)}: {fname} ({n} objects)")

    # one image deep: image k+1 is decoded and its forward enqueued before
    # image k's outputs are read (the reference's loop is synchronous at bs 1)
    pending = None
    with torch.inference_mode():
        for img_id, fname in enumerate(files):
            arr = load_image_rgb_f32(os.path.join(cfg.runtime.inference_path, fname))[None]
            img = torch.from_numpy(arr).to(dev)
            pad_mask = torch.zeros(arr.shape[:3], dtype=torch.bool, device=dev)
            out = model(img, pad_mask, None)
            if pending is not None:
                consume(*pending)
            pending = (out, img_id, fname)
        if pending is not None:
            consume(*pending)

    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f)
    return results
