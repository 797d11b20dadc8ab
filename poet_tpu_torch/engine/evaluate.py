"""Evaluation loops: pose metrics and the BOP export. Counterpart of
`poet_tpu/engine/evaluate.py`.

Parity targets: engine.py:96-184 (pose_evaluate) and engine.py:187-242
(bop_evaluate). The forward and the final layer's match run on the model's
device (the card unless the caller passes another); only the matched pose
pairs come to the host, batch by batch, as in the reference
(engine.py:130-141). The weights live in the `nn.Module`, so there is no
`params` argument.

The match's identity certificate reads one bool on the host
(`models/matcher.py`), so in gt mode each eval forward returns only when
the card has finished it: the one-batch-deep pipeline below then overlaps
the loader and the upload with the card, not the host's pair extraction.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.engine.train import _put, make_eval_forward
from poet_tpu_torch.utils import quaternions as Q
from poet_tpu_torch.utils.params import cast_params_for_inference, should_cast


def _matched_pairs_to_host(out, targets, rotation_mode):
    """Extract the matched (pred, tgt) pose pairs as numpy from a forward's
    device outputs and the batch's host targets. Parity: engine.py:127-141."""
    valid = out["match_valid"].cpu().numpy()
    tgt_idx = out["match_tgt_idx"].cpu().numpy()
    pred_t = out["pred_translation"].float().cpu().numpy()
    pred_r = out["pred_rotation"].float().cpu()
    pred_s = out["pred_scores"].float().cpu().numpy() if "pred_scores" in out else None
    if rotation_mode in ("quat", "silho_quat"):
        pred_r = Q.quat2rot(pred_r)
    pred_r = pred_r.numpy()
    tgt_t = np.asarray(targets["relative_position"])
    tgt_r = np.asarray(targets["relative_rotation"])
    labels = np.asarray(targets["labels"])
    intr = np.asarray(targets["intrinsics"]) if "intrinsics" in targets else None
    image_ids = np.asarray(targets["image_id"]) if "image_id" in targets else None

    pairs = []
    B, Qn = valid.shape
    for b in range(B):
        for i in range(Qn):
            if not valid[b, i]:
                continue
            j = tgt_idx[b, i]
            pairs.append(dict(
                cls=int(labels[b, j]),
                pred_rotation=pred_r[b, i],
                pred_translation=pred_t[b, i],
                tgt_rotation=tgt_r[b, j],
                tgt_translation=tgt_t[b, j],
                intrinsics=intr[b, j] if intr is not None else None,
                image_id=int(image_ids[b]) if image_ids is not None else -1,
                score=float(pred_s[b, i]) if pred_s is not None else 1.0,
            ))
    return pairs


def parse_scene_img(img_file: str):
    """BOP path -> (scene_id, im_id).

    The reference parses fixed path positions of
    '<split>/<scene_id>/rgb/<im_id>.png' (engine.py:229-230); the scene is
    equivalently the third-from-last component, which also covers dataset
    roots written without a split prefix. Malformed components give 0."""
    parts = img_file.split("/")

    def to_int(x):
        try:
            return int(x)
        except ValueError:
            return 0

    scene = to_int(parts[-3]) if len(parts) >= 3 else 0
    return scene, to_int(os.path.splitext(parts[-1])[0])


def gather_pairs_across_hosts(pairs):
    """All-gather the matched pose pairs, so that every process evaluates
    the full set when the eval loader is sharded by process: through
    `torch.distributed.all_gather_object` (lists of any length, in rank
    order) when a process group is initialized, the identity otherwise. The loader's shards are contiguous chunks of the
    dataset, so where the images divide evenly among the processes the
    gathered list is in one process's order."""
    import torch.distributed as dist

    from poet_tpu_torch.parallel.mesh import is_distributed

    if not is_distributed():
        return pairs
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, pairs)
    return [pr for shard in gathered for pr in shard]


@contextlib.contextmanager
def _inference_weights(model: nn.Module, cfg: PoETConfig):
    """bf16 weights at rest for a bf16 model while the loop runs (bit-identical
    to casting at each use, as JAX's cast at :193-198); the caller's f32
    weights come back afterwards, so a model under training can be evaluated
    between epochs (the optimizer refuses bf16 parameters)."""
    saved = {name: p.data for name, p in model.named_parameters()
             if cfg.model.dtype == "bfloat16" and should_cast(name, p)}
    if saved:
        cast_params_for_inference(model)
    try:
        yield
    finally:
        for name, p in model.named_parameters():
            if name in saved:
                p.data = saved[name]


def _on_device(model: nn.Module, device) -> torch.device:
    dev = torch.device(device)
    model.to(dev)
    if dev.type == "cuda":
        # cuDNN's fast bf16 convs want NHWC, which the NHWC input already is
        model.to(memory_format=torch.channels_last)
    return dev


def _upload(batch, dev):
    images, pad_mask, targets = batch
    return (_put(images, dev), _put(pad_mask, dev),
            {k: _put(v, dev) for k, v in targets.items()})


def pose_evaluate(model: nn.Module, pose_evaluator, data_loader, cfg: PoETConfig,
                  image_set: str, epoch: Optional[int] = None, *, output_dir: str,
                  device="cuda"):
    """Full-dataset pose evaluation: every batch of `data_loader.epoch(0)`
    through the eval forward on `device` (the card unless the caller passes
    another), the matched pairs into `pose_evaluator`, then the five metric
    passes into `output_dir/eval_{image_set}_{bbox_mode}[_{epoch}]/`, ADD-S
    on the same `device`. The model is moved to `device` and stays there
    (channels_last on the card). Returns the ADD(-S) results. Over more than
    one process each evaluates its shard of the loader, the pairs are
    gathered, and rank 0 runs the metric passes, writes the files and
    returns the results (the others None). Parity: engine.py:96-184."""
    from poet_tpu_torch.utils.misc import get_rank

    bbox_mode = cfg.model.bbox_mode
    name = f"eval_{image_set}_{bbox_mode}" + (f"_{epoch}" if epoch is not None else "")
    out_dir = os.path.join(output_dir, name) + "/"
    main = get_rank() == 0
    if main:
        Path(out_dir).mkdir(parents=True, exist_ok=True)

    pose_evaluator.reset()
    dev = _on_device(model, device)
    forward = make_eval_forward(model, cfg)

    print("Process validation dataset:")
    n_images = len(data_loader.dataset)
    processed = 0
    start = time.time()
    file_names = {i: data_loader.dataset.file_name(i) for i in data_loader.dataset.ids}
    local_pairs = []
    rotation_mode = cfg.model.rotation_representation
    with _inference_weights(model, cfg):
        # one batch deep: batch k+1 is uploaded and its forward enqueued
        # before batch k's pairs are read back
        pending = None
        for batch in data_loader.epoch(0):
            out = forward(*_upload(batch, dev))
            if pending is not None:
                local_pairs.extend(_matched_pairs_to_host(*pending, rotation_mode))
            pending = (out, batch[2])
            processed += batch[0].shape[0]
            print(f"Processed {processed}/{n_images}")
        if pending is not None:
            local_pairs.extend(_matched_pairs_to_host(*pending, rotation_mode))
    # full-dataset metrics when the eval loader is sharded by process: the
    # pairs gathered, rank 0 evaluates and writes the files
    pairs = gather_pairs_across_hosts(local_pairs)
    if not main:
        return None
    for pr in pairs:
        pose_evaluator.record(
            pr["cls"], pr["pred_rotation"], pr["pred_translation"],
            pr["tgt_rotation"], pr["tgt_translation"],
            img_file=file_names.get(pr["image_id"], ""),
            intrinsics=pr["intrinsics"],
        )
    total = time.time() - start
    print(f"Network Processing Time: {datetime.timedelta(seconds=int(total))}  "
          f"Images: {processed}  s/img: {total / max(processed, 1):.4f}")

    print("Start Calculating ADD")
    pose_evaluator.evaluate_pose_add(out_dir)
    print("Start Calculating ADD-S")
    pose_evaluator.evaluate_pose_adi(out_dir, device=dev)
    print("Start Calculating ADD(-S)")
    results = pose_evaluator.evaluate_pose_adds(out_dir, device=dev)
    print("Start Calculating Average Translation Error")
    pose_evaluator.calculate_class_avg_translation_error(out_dir)
    print("Start Calculating Average Rotation Error")
    pose_evaluator.calculate_class_avg_rotation_error(out_dir)
    return results


def bop_evaluate(model: nn.Module, data_loader, cfg: PoETConfig, image_set: str, *,
                 output_dir: str, device="cuda"):
    """BOP-challenge CSV export into `output_dir/bop_{bbox_mode}/{dataset}.csv`:
    one row per matched object, scene_id, im_id, obj_id, score, R
    (row-major), t (mm), and the batch's forward time with its result on the
    host. The model is moved to `device` (the card unless the caller passes
    another) and stays there. Over more than one process each process runs
    its shard and rank 0 writes every shard's rows, in rank order. Parity:
    engine.py:187-242."""
    from poet_tpu_torch.utils.misc import get_rank

    out_dir = os.path.join(output_dir, f"bop_{cfg.model.bbox_mode}") + "/"
    dev = _on_device(model, device)
    forward = make_eval_forward(model, cfg)

    file_names = {i: data_loader.dataset.file_name(i) for i in data_loader.dataset.ids}
    csv_path = os.path.join(out_dir, f"{cfg.data.dataset}.csv")
    rows = []
    with _inference_weights(model, cfg):
        counter = 1
        for images, pad_mask, targets in data_loader.epoch(0):
            t0 = time.time()
            out = forward(*_upload((images, pad_mask, targets), dev))
            out["pred_translation"].cpu()        # the result on the host: honest timing
            pred_time = time.time() - t0
            pairs = _matched_pairs_to_host(out, targets, cfg.model.rotation_representation)
            for pr in pairs:
                scene_id, img_id = parse_scene_img(file_names.get(pr["image_id"], ""))
                R = pr["pred_rotation"]
                t = pr["pred_translation"] * 1000.0
                # score: the reference hardcodes 1.0 (engine.py:232); in
                # backbone mode the detector's confidence is written (gt
                # queries carry 1.0)
                rows.append(
                    "\n{},{},{},{},{} {} {} {} {} {} {} {} {}, {} {} {}, {}".format(
                        scene_id, img_id, pr["cls"], pr["score"],
                        R[0, 0], R[0, 1], R[0, 2], R[1, 0], R[1, 1], R[1, 2],
                        R[2, 0], R[2, 1], R[2, 2], t[0], t[1], t[2], pred_time,
                    )
                )
            print(f"Processed batch {counter}")
            counter += 1
    # over more than one process: every shard's rows, in rank order, to rank 0
    rows = gather_pairs_across_hosts(rows)
    if get_rank() == 0:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("scene_id,im_id,obj_id,score,R,t,time")
            f.writelines(rows)
    return csv_path
