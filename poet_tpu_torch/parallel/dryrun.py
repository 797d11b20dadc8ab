"""One train step under a ('data', 'seq', 'model') layout: the port's
counterpart of `__graft_entry__.py:dryrun_multichip`.

    torchrun --nproc_per_node N -m poet_tpu_torch.parallel.dryrun \\
        --data D --seq S --model M [--zero_opt_state] [--device cpu] [--dtype float32]

JAX's dry-run config: the paper config (gt boxes, Mask R-CNN feature
backbone) cut to 2 encoder / 2 decoder layers, hidden 64, 4 heads, FFN 128,
at 64x64, one image per data slot (the flagship batch of D images). One
process per card under NCCL (`--device cuda`, the default), or gloo on the
CPU. Every process builds the same seeded weights (seed 0, whole, then
sharded by `parallel/tp.py:shard_module`), takes its data slot's image and
takes one AdamW step (ZeRO-1 over 'data' with `--zero_opt_state`); rank 0
prints the layout, the loss and the gradient norm. D = -1 takes the
processes left after S x M.
"""

from __future__ import annotations

import argparse
import math
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m poet_tpu_torch.parallel.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=int, default=-1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--model", type=int, default=1)
    p.add_argument("--zero_opt_state", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    return p.parse_args(argv)


def main(argv=None) -> float:
    import torch
    import torch.distributed as dist

    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.parallel import mesh, tp
    from poet_tpu_torch.utils.init import init_weights
    from poet_tpu_torch.utils.misc import get_rank

    args = parse_args(argv)
    dev = mesh.local_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    mesh.init_distributed(dev.type)
    cfg = flagship_config(args.dtype)
    m = cfg.model
    m.enc_layers, m.dec_layers, m.hidden_dim, m.nheads, m.dim_feedforward = 2, 2, 64, 4, 128
    cfg.runtime.zero_opt_state = args.zero_opt_state
    layout = mesh.create_layout(args.data, args.seq, args.model, m.nheads, m.dim_feedforward)
    model = tp.shard_module(init_weights(build_model(cfg), seed=0), layout).to(dev)
    images, pad_mask, targets = flagship_batch(layout.n_data, 64, 64)
    rows = slice(layout.data_index, layout.data_index + 1)
    batch = (images[rows], pad_mask[rows], {k: v[rows] for k, v in targets.items()})
    optimizer = make_optimizer(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg, optimizer)
    generator = torch.Generator(device=dev).manual_seed(cfg.runtime.seed + layout.data_index)
    metrics = fetch_metrics(step(*prepare_batch(cfg, *batch, dev), generator))
    if not math.isfinite(metrics["grad_norm"]):
        raise FloatingPointError(f"grad_norm is {metrics['grad_norm']}")
    if get_rank() == 0:
        print(f"dryrun: dp={layout.n_data} x sp={layout.n_seq} x tp={layout.n_model}"
              + (" + ZeRO-1 optimizer state" if args.zero_opt_state else "")
              + f" on {dev} ({m.dtype}): loss {metrics['loss']:.6f}, "
              f"grad_norm {metrics['grad_norm']:.6f}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return metrics["loss"]


if __name__ == "__main__":
    main(sys.argv[1:])
