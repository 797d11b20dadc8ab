"""CLI of the port: train, resume, evaluate and infer from image files.

    python -m poet_tpu_torch.cli --dataset_path DATA --output_dir OUT [flags]
    python -m poet_tpu_torch.cli ... --device cpu        (no card)

Counterpart of `poet_tpu/cli.py` (itself flag-compatible with the
reference's main.py:33-189): every option string of its `get_args_parser`
is accepted, `args_to_config` fills the same config fields, and `main`
follows `poet_tpu/cli.py:main`: train (default), `--eval`, `--eval_bop`,
`--inference`, `--resume`, with the same checkpoints' schedule, log.txt,
eval interval, NaN gate and SIGTERM checkpoint. It runs on the card
(`--device cuda`, the default) and raises without one, unless the caller
asks for the CPU (`--device cpu`).

Every model, optimizer and data flag of `poet_tpu.cli` runs here: the
learned query embedding, reference points and position embedding,
`--aleatoric` (and `--calibrate`, which trains only its heads), `--mu_bf16`,
training with `--bbox_mode backbone` (Mask R-CNN or YOLOv4-CSP detections
matched in the step), PNG and JPEG datasets, and `--synt_background` ('synt'
RGBA images composited onto random backgrounds).

Data parallel (`parallel/mesh.py`): one process per card,

    torchrun --nproc_per_node N -m poet_tpu_torch.cli --mesh_data N [--zero_opt_state] ...

each process loading `--batch_size` images of its shard (the global batch
is batch_size x N, JAX's multi-process rule and the reference's DDP rule),
seeded `--seed` + rank; the step sums the gradients of the global batch's
loss over the processes (`engine/train.py`); `--zero_opt_state` shards the
optimizer state (ZeRO-1, `parallel/zero.py`; a no-op over one process);
rank 0 writes the checkpoints, log.txt and the evaluation's files.
`--mesh_data` must be -1 or the number of processes started.

`--export_model DIR` writes the serving artifact of the resumed (or
initialized) model, `engine/serving.py:export_model` at
`--export_batch_size` and `--export_image_size`, servable on the
`--export_platforms` ('cpu', 'cuda'; the port has no TPU), and returns DIR;
`ExportedPoseServer(DIR)` runs it without model code. The TPU runtime's
flags (`--rng_impl`, `--xla_cache_dir`, `--enc_remat`) and the reference's torch-distributed
flags (the process group comes from torchrun's environment) are accepted
and ignored, with one warning line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import signal
import time
from pathlib import Path

import numpy as np

from poet_tpu_torch.config import PoETConfig

DEFORM_CHOICES = ("auto", "sep", "fused", "mxu", "patch", "gather", "sep_cv", "pallas")


def get_args_parser():
    p = argparse.ArgumentParser("Pose Estimation Transformer (PyTorch + CUDA)", add_help=False)
    # Learning (main.py:38-50)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--lr_backbone_names", default=["backbone"], type=str, nargs="+")
    p.add_argument("--lr_backbone", default=2e-5, type=float)
    p.add_argument("--lr_linear_proj_names",
                   default=["reference_points", "sampling_offsets"], type=str, nargs="+")
    p.add_argument("--lr_linear_proj_mult", default=0.1, type=float)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--eval_batch_size", default=16, type=int)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--lr_drop", default=100, type=int)
    # parsed and unused, as in the reference (StepLR reads --lr_drop only)
    p.add_argument("--lr_drop_epochs", default=None, type=int, nargs="+")
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    # Backbone (main.py:52-71)
    p.add_argument("--backbone", default="maskrcnn", type=str,
                   choices=["yolov4", "maskrcnn", "fasterrcnn"])
    p.add_argument("--backbone_cfg", default="", type=str)
    p.add_argument("--backbone_weights", default=None, type=str)
    p.add_argument("--backbone_conf_thresh", default=0.4, type=float)
    p.add_argument("--backbone_iou_thresh", default=0.5, type=float)
    p.add_argument("--backbone_agnostic_nms", action="store_true")
    p.add_argument("--post_nms_top_n", default=1000, type=int,
                   help="RPN proposals entering the RoI heads (torchvision's 1000)")
    p.add_argument("--yolo_box_decode", default="u5", type=str, choices=("u5", "darknet"))
    p.add_argument("--encoder_min_stride", default=1, type=int,
                   help="drop backbone feature maps finer than this stride from the "
                        "transformer input (1: every map, the reference)")
    p.add_argument("--position_embedding", default="sine", type=str,
                   choices=("sine", "learned"))
    p.add_argument("--position_embedding_scale", default=2 * math.pi, type=float)
    p.add_argument("--num_feature_levels", default=4, type=int)
    # parsed and unused, as in the reference (a DETR flag no model reads)
    p.add_argument("--dilation", action="store_true")
    # PoET (main.py:73-83)
    p.add_argument("--bbox_mode", default="gt", type=str, choices=("gt", "backbone", "jitter"))
    p.add_argument("--reference_points", default="bbox", type=str, choices=("bbox", "learned"))
    p.add_argument("--query_embedding", default="bbox", type=str, choices=("bbox", "learned"))
    p.add_argument("--rotation_representation", default="6d", type=str,
                   choices=("6d", "quat", "silho_quat"))
    p.add_argument("--class_mode", default="specific", type=str,
                   choices=("agnostic", "specific"))
    # Transformer (main.py:85-101)
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--dim_feedforward", default=1024, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--num_queries", default=10, type=int)
    p.add_argument("--dec_n_points", default=4, type=int)
    p.add_argument("--enc_n_points", default=4, type=int)
    # Uncertainty (main.py:103-105)
    p.add_argument("--aleatoric", action="store_true")
    p.add_argument("--calibrate", action="store_true")
    # Matcher (main.py:107-114)
    p.add_argument("--matcher_type", default="pose", choices=["pose"], type=str)
    p.add_argument("--set_cost_class", default=1, type=float)
    p.add_argument("--set_cost_bbox", default=1, type=float)
    p.add_argument("--set_cost_giou", default=2, type=float)
    # Loss (main.py:116-122)
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--translation_loss_coef", default=1, type=float)
    p.add_argument("--rotation_loss_coef", default=1, type=float)
    # Dataset (main.py:124-139)
    p.add_argument("--dataset", default="ycbv", type=str, choices=("ycbv", "lmo"))
    p.add_argument("--dataset_path", default="/data", type=str)
    p.add_argument("--train_set", default="train", type=str)
    p.add_argument("--eval_set", default="test", type=str)
    p.add_argument("--synt_background", default=None, type=str)
    p.add_argument("--n_classes", default=21, type=int)
    p.add_argument("--jitter_probability", default=0.5, type=float)
    p.add_argument("--rgb_augmentation", action="store_true")
    p.add_argument("--grayscale", action="store_true")
    # Evaluator (main.py:141-149)
    p.add_argument("--eval_interval", type=int, default=10)
    p.add_argument("--class_info", type=str, default="/annotations/classes.json")
    p.add_argument("--models", type=str, default="/models_eval/")
    p.add_argument("--model_symmetry", type=str, default="/annotations/symmetries.json")
    # Inference (main.py:151-157)
    p.add_argument("--inference", action="store_true")
    p.add_argument("--inference_path", type=str, default=None)
    p.add_argument("--inference_output", type=str, default=None)
    # Misc (main.py:159-174)
    p.add_argument("--sgd", action="store_true")
    p.add_argument("--save_interval", default=5, type=int)
    p.add_argument("--output_dir", default="")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_bop", action="store_true")
    p.add_argument("--export_model", default=None, type=str,
                   help="write the serving artifact (torch.export program + weights) here")
    p.add_argument("--export_batch_size", default=1, type=int)
    p.add_argument("--export_image_size", default=[480, 640], type=int, nargs=2)
    p.add_argument("--export_platforms", default=["cpu", "cuda"], type=str, nargs="+",
                   help="devices the exported artifact may be served on: cpu, cuda")
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--cache_mode", default=False, action="store_true")
    p.add_argument("--decoded_cache_mb", default=0, type=int,
                   help="decoded-image cache budget in MB (0: off): epochs 2+ skip "
                        "the decode of cached images")
    # The reference's torch.distributed flags (main.py:176-187): accepted and
    # ignored, except --device, which is the port's device
    p.add_argument("--gpu", default=0, type=int, help="accepted and ignored")
    p.add_argument("--device", default="cuda", type=str,
                   help="where the port runs: 'cuda' (the default; raises without a card) "
                        "or 'cpu'")
    for flag, default in (("--dist_backend", "nccl"), ("--dist_url", "env://")):
        p.add_argument(flag, default=default, type=str, help="accepted and ignored")
    for flag in ("--world_size", "--local_rank"):
        p.add_argument(flag, default=None, type=int, help="accepted and ignored")
    p.add_argument("--distributed", action="store_true", help="accepted and ignored")
    p.add_argument("--mesh_data", default=-1, type=int,
                   help="processes on the data axis (-1: all that torchrun started; one "
                        "process per card)")
    p.add_argument("--grad_accum_steps", default=1, type=int,
                   help="micro-batches averaged per optimizer update")
    p.add_argument("--zero_opt_state", action="store_true",
                   help="ZeRO-1: the optimizer state sharded over the data-parallel processes")
    p.add_argument("--mu_bf16", action="store_true",
                   help="bfloat16 AdamW first moment (the second stays float32)")
    p.add_argument("--dtype", default="float32", type=str)
    p.add_argument("--enc_deform_impl", default=None, type=str, choices=DEFORM_CHOICES,
                   help="encoder sampling core: 'pallas' runs the dense one-hot kernels, "
                        "every other value the gather kernels (config.DEFORM_IMPLS)")
    p.add_argument("--dec_deform_impl", default=None, type=str, choices=DEFORM_CHOICES,
                   help="decoder cross-attention sampling core, as --enc_deform_impl")
    p.add_argument("--enc_remat", default="auto", type=str, choices=("auto", "on", "off"),
                   help="TPU runtime flag: accepted and ignored (the port's autograd "
                        "Functions save only their inputs)")
    p.add_argument("--rng_impl", default="threefry2x32", type=str,
                   choices=("threefry2x32", "rbg"), help="TPU runtime flag: accepted and ignored")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler Chrome trace of the first train epoch here")
    p.add_argument("--xla_cache_dir", default=None, type=str,
                   help="TPU runtime flag: accepted and ignored")
    return p


def args_to_config(args) -> PoETConfig:
    """The parsed flags as a config, field for field as poet_tpu's
    args_to_config; `runtime.device` from --device."""
    cfg = PoETConfig()
    o, b, m, mt, l, d, e, r = (cfg.optim, cfg.backbone, cfg.model, cfg.matcher,
                               cfg.loss, cfg.data, cfg.eval, cfg.runtime)
    for k in ("lr", "lr_backbone", "lr_linear_proj_mult", "batch_size",
              "eval_batch_size", "weight_decay", "epochs", "lr_drop",
              "clip_max_norm", "sgd", "grad_accum_steps", "mu_bf16"):
        setattr(o, k, getattr(args, k))
    o.lr_backbone_names = tuple(args.lr_backbone_names)
    o.lr_linear_proj_names = tuple(args.lr_linear_proj_names)
    b.name = args.backbone
    b.cfg_path = args.backbone_cfg
    b.weights = args.backbone_weights
    b.conf_thresh = args.backbone_conf_thresh
    b.iou_thresh = args.backbone_iou_thresh
    b.agnostic_nms = args.backbone_agnostic_nms
    b.post_nms_top_n = args.post_nms_top_n
    b.encoder_min_stride = args.encoder_min_stride
    b.yolo_box_decode = args.yolo_box_decode
    b.position_embedding = args.position_embedding
    b.position_embedding_scale = args.position_embedding_scale
    for k in ("bbox_mode", "reference_points", "query_embedding",
              "rotation_representation", "class_mode", "enc_layers", "dec_layers",
              "dim_feedforward", "hidden_dim", "dropout", "nheads", "num_queries",
              "dec_n_points", "enc_n_points", "aleatoric", "calibrate",
              "aux_loss", "n_classes", "num_feature_levels"):
        setattr(m, k, getattr(args, k))
    mt.matcher_type = args.matcher_type
    mt.set_cost_class = args.set_cost_class
    mt.set_cost_bbox = args.set_cost_bbox
    mt.set_cost_giou = args.set_cost_giou
    l.translation_loss_coef = args.translation_loss_coef
    l.rotation_loss_coef = args.rotation_loss_coef
    for k in ("dataset", "dataset_path", "train_set", "eval_set", "synt_background",
              "jitter_probability", "rgb_augmentation", "grayscale", "num_workers",
              "cache_mode", "decoded_cache_mb"):
        setattr(d, k, getattr(args, k))
    e.eval_interval = args.eval_interval
    e.class_info = args.class_info
    e.models_path = args.models
    e.model_symmetry = args.model_symmetry
    for k in ("inference", "inference_path", "inference_output", "save_interval",
              "output_dir", "seed", "resume", "start_epoch", "eval", "eval_bop",
              "mesh_data", "dtype", "zero_opt_state", "rng_impl",
              "export_model", "export_batch_size", "xla_cache_dir", "device"):
        setattr(r, k, getattr(args, k))
    r.export_image_size = tuple(args.export_image_size)
    r.export_platforms = tuple(args.export_platforms)
    m.dtype = args.dtype
    if args.enc_deform_impl:
        m.enc_deform_impl = args.enc_deform_impl
    if args.dec_deform_impl:
        m.dec_deform_impl = args.dec_deform_impl
    m.__post_init__()                  # the deformable impls' check
    cfg.profile_dir = args.profile_dir
    return cfg


# flag -> default of the flags accepted and ignored: the TPU runtime's and
# the reference's torch-distributed ones
IGNORED_FLAGS = {"rng_impl": "threefry2x32",
                 "xla_cache_dir": None, "enc_remat": "auto", "gpu": 0,
                 "dist_backend": "nccl", "dist_url": "env://", "world_size": None,
                 "local_rank": None, "distributed": False}


def warn_ignored_flags(args) -> None:
    """One line naming the ignored flags set away from their defaults."""
    set_flags = [f"--{k}" for k, d in IGNORED_FLAGS.items() if getattr(args, k, d) != d]
    if set_flags:
        print(f"note: {', '.join(set_flags)} ignored (TPU runtime and torch-distributed "
              f"flags have no effect in the port: its process group comes from torchrun's "
              f"environment)")


def resolve_device(name: str):
    """The port's device (`cuda:LOCAL_RANK` for 'cuda'); 'cuda' without a
    card raises (no silent CPU run)."""
    import torch

    from poet_tpu_torch.parallel.mesh import local_device

    dev = local_device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; pass --device cpu "
                           "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name!r}: the port runs on 'cuda' or 'cpu'")
    return dev


def load_backbone_weights(model, cfg):
    """--backbone_weights into the model's backbone: a torchvision-named
    detector .pth or .npz (strict=False, with merge_params' report; read by
    `engine/checkpoint.py:load_state_dict_file`) or, for yolov4, a darknet
    .weights file (strict, through utils/darknet_import.py)."""
    from poet_tpu_torch.engine.checkpoint import load_state_dict_file, merge_params

    path = cfg.backbone.weights
    if path.endswith(".weights"):
        from poet_tpu_torch.models.yolov4 import load_cfg_sections
        from poet_tpu_torch.utils.darknet_import import load_darknet_weights
        from poet_tpu_torch.utils.jax_params import load_jax_params

        if not cfg.backbone.cfg_path:
            raise ValueError("--backbone_weights *.weights needs --backbone_cfg (darknet cfg)")
        load_jax_params(model.backbone.body, load_darknet_weights(
            load_cfg_sections(cfg.backbone.cfg_path), path))
        print(f"Loaded backbone weights from {path}")
        return
    missing, unexpected = merge_params(model.backbone, load_state_dict_file(path))
    print(f"Loaded backbone weights from {path}")
    if missing:
        print("Backbone missing keys:", missing)
    if unexpected:
        print("Backbone unexpected keys:", unexpected)


def main(cfg: PoETConfig):
    """Run the mode the config asks for. Training returns {"model",
    "optimizer", "start_epoch"} after its last epoch and final evaluation;
    --eval the ADD(-S) results; --eval_bop the CSV's path; --inference the
    results dict."""
    import torch

    from poet_tpu_torch.data.dataset import build_dataset
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine.checkpoint import (
        checkpoint_paths_for_epoch, load_resume, merge_params, save_checkpoint,
    )
    from poet_tpu_torch.engine.evaluate import bop_evaluate, pose_evaluate
    from poet_tpu_torch.engine.inference import inference
    from poet_tpu_torch.engine.metrics import MetricLogger, SmoothedValue
    from poet_tpu_torch.engine.train import (
        make_lr_schedule, make_optimizer, make_train_step, prepare_batch,
    )
    from poet_tpu_torch.evaluation.pose_evaluator import build_pose_evaluator
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.utils.init import init_weights
    from poet_tpu_torch.utils.misc import get_rank, get_sha

    dev = resolve_device(cfg.runtime.device)
    # the process group torchrun describes (WORLD_SIZE > 1), or one the caller made
    mesh.init_distributed(dev.type)
    rank, world = get_rank(), mesh.world_size()
    layout = mesh.data_layout()         # the CLI's layout: every process a data slot
    n_data = mesh.data_axis_size(cfg.runtime.mesh_data, cfg.optim.batch_size,
                                 cfg.optim.eval_batch_size)
    print(f"git:\n  {get_sha()}\n")             # the reference's main.py:195
    if world > 1:
        print(f"data parallel: rank {rank} of {n_data} on {dev}, global batch "
              f"{cfg.optim.batch_size * world}"
              + (", ZeRO-1 optimizer state" if cfg.runtime.zero_opt_state else ""))
    seed = cfg.runtime.seed + layout.data_index   # per-slot offset (main.py:198-202)
    np.random.seed(seed)
    torch.manual_seed(seed)

    model = init_weights(build_model(cfg), seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print("number of params:", n_params)
    output_dir = Path(cfg.runtime.output_dir) if cfg.runtime.output_dir else None
    if output_dir:
        output_dir.mkdir(parents=True, exist_ok=True)

    if cfg.backbone.weights:             # build-time detector load (backbone_maskrcnn.py:138-149)
        load_backbone_weights(model, cfg)

    resume_payload = None
    if cfg.runtime.resume:
        resume_payload, start_epoch = load_resume(cfg.runtime.resume, cfg.model.aleatoric)
        missing, unexpected = merge_params(model, resume_payload["model"])
        if missing:
            print("Missing Keys:", missing)
        if unexpected:
            print("Unexpected Keys:", unexpected)
        if not cfg.runtime.eval:
            cfg.runtime.start_epoch = start_epoch
    mesh.replicate(model)               # rank 0's weights (each rank seeded its own)

    if cfg.runtime.inference:            # one image directory, one results.json: rank 0
        return inference(model, cfg, device=dev) if rank == 0 else None

    if cfg.runtime.export_model:
        # the deployment step (the trtexec analogue): the fixed-shape serving
        # program + weights as an artifact ExportedPoseServer runs without
        # model code; rank 0 writes it
        from poet_tpu_torch.engine.serving import export_model

        if rank != 0:
            return None
        path = export_model(cfg, model, cfg.runtime.export_model,
                            batch_size=cfg.runtime.export_batch_size,
                            image_size=tuple(cfg.runtime.export_image_size),
                            platforms=tuple(cfg.runtime.export_platforms))
        print(f"Exported serving artifact to {path}")
        return path

    def make_loader(split, batch_size, shuffle, device_put_fn=None):
        return PoseDataLoader(
            build_dataset(split, cfg), batch_size=batch_size,
            num_queries=cfg.model.num_queries, shuffle=shuffle, drop_last=shuffle,
            seed=cfg.runtime.seed, process_index=layout.data_index,
            process_count=layout.n_data,
            num_workers=cfg.data.num_workers or 4,
            with_jitter=(cfg.model.bbox_mode == "jitter"),
            device_put_fn=device_put_fn, pad_to_full_batch=not shuffle, alloc=alloc)

    def alloc(shape, dtype):
        """Batch images in pinned memory on the card: the workers write each
        image into it and the upload needs no staging copy."""
        if dev.type != "cuda":
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                           pin_memory=True).numpy()

    loader_val = make_loader(cfg.data.eval_set, cfg.optim.eval_batch_size, False)
    out = str(output_dir) if output_dir else ""
    if cfg.runtime.eval or cfg.runtime.eval_bop:
        if cfg.runtime.eval:
            return pose_evaluate(model, build_pose_evaluator(cfg), loader_val, cfg,
                                 cfg.data.eval_set, output_dir=out, device=dev)
        return bop_evaluate(model, loader_val, cfg, cfg.data.eval_set, output_dir=out,
                            device=dev)

    # ---- training
    # the producer thread matches each batch on the host and uploads it, so
    # the loop's wait for the loader (the logger's `data`) is the pipeline's
    loader_train = make_loader(cfg.data.train_set, cfg.optim.batch_size, True,
                               device_put_fn=lambda b: prepare_batch(cfg, *b, dev))
    evaluator = build_pose_evaluator(cfg)
    steps_per_epoch = loader_train.steps_per_epoch()
    model.to(dev)
    optimizer = make_optimizer(cfg, model, steps_per_epoch)
    host_step = 0          # train steps taken (JAX's state.step)
    if resume_payload is not None and resume_payload.get("optimizer") is not None:
        optimizer.load_state_dict(resume_payload["optimizer"])
        host_step = int(resume_payload["step"])
    step_fn = make_train_step(model, cfg, optimizer)
    # dropout masks: a generator of the model's device, seeded per run
    generator = torch.Generator(device=dev).manual_seed(seed)

    print("Start training")
    # preemption: finish the in-flight step, write the rolling checkpoint
    # mid-epoch (its epoch the last finished one) and exit cleanly
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
        print("SIGTERM received — checkpointing at the next step boundary")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:                      # not the main thread
        prev_sigterm = None

    profile_dir = getattr(cfg, "profile_dir", None)
    prof = None
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    start_time = time.time()
    lr_schedule = make_lr_schedule(cfg.optim.lr, cfg.optim.lr_drop, steps_per_epoch)
    try:
        for epoch in range(cfg.runtime.start_epoch, cfg.optim.epochs):
            logger = MetricLogger(device=dev)
            logger.add_meter("lr", SmoothedValue(1, "{value:.6f}"))
            header = f"Epoch: [{epoch}]"

            def consume_metrics(m, step_idx):
                values = torch.stack([v.float() for v in m.values()]).tolist()  # one copy
                host = dict(zip(m, values))
                if not math.isfinite(host["loss"]):
                    print(f"Loss is {host['loss']}, stopping training")
                    print(host)
                    raise SystemExit(1)
                logger.update(lr=float(lr_schedule(step_idx)))
                logger.update(**host)

            # one step deep: step k + 1 is enqueued before step k's metrics
            # are read; the NaN gate fires before any checkpoint is written
            pending = None
            for batch in logger.log_every(loader_train.epoch(epoch), 10, header):
                metrics = step_fn(*batch, generator)
                if pending is not None:
                    consume_metrics(*pending)
                pending = (metrics, host_step)
                host_step += 1
                # every process stops at the same step (their collectives pair up)
                if mesh.any_process(preempted["flag"]):
                    consume_metrics(*pending)
                    pending = None
                    if output_dir:
                        save_checkpoint(str(output_dir), "checkpoint.pth", model, optimizer,
                                        epoch - 1, host_step, cfg)
                    print(f"preempted at epoch {epoch} step {host_step}: "
                          "checkpoint written, exiting cleanly")
                    return {"model": model, "optimizer": optimizer,
                            "start_epoch": cfg.runtime.start_epoch}
            if pending is not None:
                consume_metrics(*pending)
            logger.synchronize_between_processes()
            print("Averaged stats:", logger)
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                prof = None

            if output_dir:               # every process: a ZeRO-1 state is gathered
                save_checkpoint(str(output_dir),
                                checkpoint_paths_for_epoch(str(output_dir), epoch, cfg),
                                model, optimizer, epoch, host_step, cfg)
            if epoch % cfg.eval.eval_interval == 0:
                # pose_evaluate moves the model to `dev` (channels_last on the
                # card) and leaves it there; the parameters stay the same
                # objects, so the optimizer and the train step keep them
                pose_evaluate(model, evaluator, loader_val, cfg, cfg.data.eval_set, epoch,
                              output_dir=out, device=dev)
            if output_dir and rank == 0:
                log_stats = {f"train_{k}": mt.global_avg for k, mt in logger.meters.items()}
                log_stats.update(epoch=epoch, n_parameters=n_params)
                with (output_dir / "log.txt").open("a") as f:
                    f.write(json.dumps(log_stats) + "\n")
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)

    total = time.time() - start_time
    print("Training time", str(datetime.timedelta(seconds=int(total))))
    print("Evaluate final trained model")
    pose_evaluate(model, evaluator, loader_val, cfg, cfg.data.eval_set, output_dir=out,
                  device=dev)
    return {"model": model, "optimizer": optimizer, "start_epoch": cfg.runtime.start_epoch}


def parse_config(argv=None) -> PoETConfig:
    """Parse a command line into the config `main` runs: --inference forces
    bbox_mode='backbone' (the reference's main.py:407)."""
    parser = argparse.ArgumentParser("PoET training and evaluation script",
                                     parents=[get_args_parser()])
    args = parser.parse_args(argv)
    warn_ignored_flags(args)
    cfg = args_to_config(args)
    if cfg.runtime.inference:
        cfg.model.bbox_mode = "backbone"
    return cfg


def run(argv=None):
    cfg = parse_config(argv)
    if cfg.runtime.output_dir:
        Path(cfg.runtime.output_dir).mkdir(parents=True, exist_ok=True)
    return main(cfg)


if __name__ == "__main__":
    run()
