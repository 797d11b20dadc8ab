"""Training engine: param groups, optimizer, train step, eval forward.

Counterpart of `poet_tpu/engine/train.py`:
  * `label_params` — main / linear_proj / backbone / frozen by the same name
    keywords, on the port's parameter names; in calibrate mode 'main' for
    the aleatoric heads and 'frozen' for every other parameter;
  * `make_lr_schedule` — StepLR by step; under gradient accumulation sized
    in updates per epoch;
  * `make_optimizer` — the optax chain clip_by_global_norm -> multi_transform
    (AdamW or SGD(0.9) with added decayed weights, per group lr; frozen
    excluded) -> MultiSteps, over a torch optimizer. The clip's norm, as
    optax's, is over every gradient, the frozen parameters' included (in
    calibrate mode the transformer's are not zero); only the trained
    parameters are updated. `mu_bf16` keeps AdamW's first moment in bf16
    (`AdamWMuBf16`, optax's `mu_dtype`);
  * `make_loss_fn` / `make_train_step` — forward with dropout, the shared
    matching, all per-layer losses, backward through the deformable adjoint
    kernels, clip, update; metrics stay on the device; in a process group
    data parallel (the global matched count, summed gradients), and under a
    model's layout (`parallel/tp.py:shard_module`) sequence and tensor
    parallel too;
  * `make_eval_forward` — forward and the final-layer match.

Matching: in gt and jitter mode the matched boxes and classes come from the
targets alone, so the trainer matches on the host before the batch is
uploaded (`match_targets`) and the step itself never waits on the device.
In bbox_mode='backbone' the queries are the frozen detector's detections,
known only after the forward: the step runs the forward, then
`match_poses` on the model's `pred_boxes`, `pred_classes` and `n_boxes`
(cost, then the GIoU and class post-filter), then the losses, JAX's
`loss_fn` order. That match waits for the device once (its identity
certificate's bool, then the cost matrix's copy for the solver), on top of
the detector's NMS waits inside the forward. The NaN guard reads the
metrics on the host once they are fetched (`fetch_metrics`).

The training model keeps f32 master weights: it must not go through
`utils/params.py:cast_params_for_inference`. bf16 modules cast each f32
weight at use (`models/layers.py`), bit-identical to the JAX step's
pre-cast, and autograd returns f32 gradients.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from poet_tpu_torch.config import PoETConfig
from poet_tpu_torch.models import criterion as crit
from poet_tpu_torch.models.matcher import MatchResult, match_poses
from poet_tpu_torch.models.poet import gt_queries

Batch = Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], Optional[MatchResult]]


# ---------------------------------------------------------------------------
# Optimizer with the reference param groups
# ---------------------------------------------------------------------------

def label_params(model: nn.Module, cfg: PoETConfig) -> Dict[str, str]:
    """Parameter name -> one of {main, linear_proj, backbone, frozen}.

    The detector backbone is 'frozen' (the reference's requires_grad_(False)),
    so the 'backbone' group stays empty, as in the JAX package. Calibrate
    mode trains the aleatoric heads alone (the reference's main.py:337-347).
    The learned position embedding's tables (`position_embedding.*`) label
    'main', as in JAX, whose path holds no 'backbone' either.
    """

    def label_of(name: str) -> str:
        if cfg.model.calibrate:
            return "main" if "aleatoric" in name else "frozen"
        if "backbone" in name:
            return "frozen"
        if any(k in name for k in cfg.optim.lr_linear_proj_names):
            return "linear_proj"
        return "main"

    return {name: label_of(name) for name, _ in model.named_parameters()}


def make_lr_schedule(base_lr: float, lr_drop_epochs: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR: lr * 0.1^(epoch // lr_drop), epoch = step // steps_per_epoch."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (0.1 ** (epoch // lr_drop_epochs))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares of every element), a device scalar."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamWMuBf16(torch.optim.Optimizer):
    """optax `adamw(mu_dtype=bfloat16)`, in torch `_foreach` ops.

    The first moment is stored in bf16, the second in f32. Each step, per
    group: mu = (1 - b1) g + b1 mu in f32 from the stored bf16 mu, as the
    jitted optax update computes it on XLA: b1 is a weakly typed scalar and
    takes mu's dtype (0.9 -> 0.8984375), the product b1 mu is exact in f32,
    and the sum is one fused multiply-add, fma((1 - b1), g, b1 mu), rounded
    once (here from a float64 sum, exact but for a double rounding once in
    ~2^29 elements); nu = (1 - b2) g^2 + b2 nu in f32; the update
    (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) from that f32 mu, plus
    weight_decay * p (decoupled), times -lr, added to p; only then is mu
    stored in bf16 (round to nearest even). `load_state_dict` keeps mu in
    bf16 (the torch base class would cast it to the parameter's dtype)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            count = states[0]["step"] + 1
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            one_minus_b1 = float(np.float32(1.0 - b1))
            # both products are exact in float64: the sum rounds once in it
            mu32 = [(m.double() * b1_bf16 + g.double() * one_minus_b1).float()
                    for m, g in zip(mus, grads)]
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            # the bias corrections in f32, as optax's 1 - decay**count
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu32, bc1)
            torch._foreach_div_(upd, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            for m, m32, st in zip(mus, mu32, states):
                m.copy_(m32)
                st["step"] = count

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


class Optimizer:
    """optax `MultiSteps(chain(clip_by_global_norm, multi_transform(...)))`.

    `step()` reads the parameters' `.grad` (one micro-batch). Every
    `grad_accum_steps` calls it takes the mean of the accumulated gradients
    (optax's running mean), clips it by its global norm as optax does
    (t / norm * max_norm when norm >= max_norm; torch's clip_grad_norm_
    divides by norm + 1e-6), sets each group's StepLR rate for this update
    and applies the torch optimizer. It returns True when it updated.

    The gradients accumulated, clipped and reported (`grads()`) are those
    of every parameter autograd reaches (`requires_grad`), as optax's clip
    and norm run over the whole tree before `multi_transform` drops the
    frozen group; `params` are the trained ones, which alone are updated
    and decayed. The two lists differ in calibrate mode, where the frozen
    transformer, projections and pose heads get gradients.
    """

    def __init__(self, cfg: PoETConfig, model: nn.Module, steps_per_epoch: int):
        from poet_tpu_torch.parallel import tp

        o = cfg.optim
        labels = label_params(model, cfg)
        scale = {"main": 1.0, "linear_proj": o.lr_linear_proj_mult,
                 "backbone": o.lr_backbone / o.lr}
        groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
        self.clip_params: List[torch.Tensor] = []
        self.clip_names: List[str] = []
        for name, p in model.named_parameters():
            if p.requires_grad:
                self.clip_params.append(p)
                self.clip_names.append(name)
            if labels[name] == "frozen":
                continue
            if p.dtype != torch.float32:
                raise TypeError(f"{name} is {p.dtype}: training needs f32 master weights "
                                "(do not cast the model for inference)")
            groups.setdefault(labels[name], []).append((name, p))
        if not groups:
            raise ValueError("every parameter is frozen: calibrate mode trains the aleatoric "
                             "heads alone (calibrate needs aleatoric)")
        self.param_groups = [{"params": [p for _, p in ps], "name": lab,
                              "lr": o.lr * scale[lab], "lr_scale": scale[lab]}
                             for lab, ps in groups.items()]
        self._scale = scale
        self.params = [p for g in self.param_groups for p in g["params"]]
        self.param_names = [n for ps in groups.values() for n, _ in ps]
        # under a layout: the data group of ZeRO, the sharded tensors of the
        # norm and of the consolidated state
        self.layout = tp.layout_of(model)
        self.norm = tp.grad_norm_fn(self.layout, self.clip_names)
        self.torch_opt = self._torch_optimizer(o, self._owned_groups())
        self.accum = max(o.grad_accum_steps, 1)
        # the inner count advances once per update: size StepLR in updates
        self.schedule = make_lr_schedule(1.0, o.lr_drop,
                                         max(1, steps_per_epoch // self.accum))
        self.clip_max_norm = o.clip_max_norm
        self.micro_step = 0
        self.updates = 0
        self._acc: Optional[List[torch.Tensor]] = None

    @staticmethod
    def _torch_optimizer(o, groups: List[Dict]) -> torch.optim.Optimizer:
        if o.sgd:
            # optax add_decayed_weights before sgd == torch SGD's weight_decay
            return torch.optim.SGD(groups, lr=o.lr, momentum=0.9, weight_decay=o.weight_decay)
        if o.mu_bf16:
            return AdamWMuBf16(groups, lr=o.lr, weight_decay=o.weight_decay)
        # optax adamw: eps outside the sqrt, bias correction, decay lr*wd*p on
        # the pre-update parameter, on every trained tensor
        return torch.optim.AdamW(groups, lr=o.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=o.weight_decay)

    def _owned_groups(self) -> List[Dict]:
        """The param groups whose state this process keeps: all of them
        (ZeRO-1 keeps a share, `parallel/zero.py`)."""
        return self.param_groups

    def _update(self) -> None:
        """Apply the torch optimizer to the clipped gradients."""
        self.torch_opt.step()

    def _torch_state(self) -> Dict:
        return self.torch_opt.state_dict()

    def _load_torch_state(self, state: Dict) -> None:
        self.torch_opt.load_state_dict(state)

    def grads(self) -> List[torch.Tensor]:
        """The gradients of every parameter autograd reaches (the clip's and
        the reported norm's); a missing one counts as zero (optax would still
        decay a trained parameter)."""
        for p in self.clip_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.clip_params]

    def zero_grad(self) -> None:
        for p in self.clip_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = self.grads()
        if self.accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # acc + (g - acc) / (k + 1), optax MultiSteps' running mean
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.micro_step + 1))
            self.micro_step += 1
            if self.micro_step < self.accum:
                return False
            for a, g in zip(self._acc, grads):
                g.copy_(a)
                a.zero_()
            self.micro_step = 0
        if self.clip_max_norm > 0:
            norm = self.norm(grads)
            clip = norm >= self.clip_max_norm      # stays on the device: no sync
            div = torch.where(clip, norm, torch.ones_like(norm))
            mul = torch.where(clip, torch.full_like(norm, self.clip_max_norm),
                              torch.ones_like(norm))
            trained = [p.grad for p in self.params]     # the others are not used again
            torch._foreach_div_(trained, div)
            torch._foreach_mul_(trained, mul)
        factor = self.schedule(self.updates)
        # the torch optimizer's own groups: a load_state_dict replaces them
        for group in self.torch_opt.param_groups:
            group["lr"] = self.torch_opt.defaults["lr"] * group["lr_scale"] * factor
        self._update()
        self.updates += 1
        return True

    def state_dict(self) -> Dict:
        """Everything a resume needs: the update and micro-step counts, the
        gradient-accumulation buffer, the torch optimizer's state. Under a
        model axis its sharded tensors are gathered whole (a collective), so
        the state is the one-process optimizer's whatever the layout."""
        from poet_tpu_torch.parallel import tp

        acc = None if self._acc is None else [
            tp.gather_tensor(a, n, self.layout) for a, n in zip(self._acc, self.clip_names)]
        return {"updates": self.updates, "micro_step": self.micro_step, "acc": acc,
                "torch": tp.gather_optimizer_state(self._torch_state(), self.param_names,
                                                   self.layout)}

    def load_state_dict(self, state: Dict) -> None:
        """Restore `state_dict()`'s output (written under any layout: a
        sharded tensor is cut to this process's shard). The rates and decay
        stay this optimizer's, from the current config (torch's load would
        put the saved groups' back): the schedule is rebuilt from the command
        line, as in the JAX package."""
        from poet_tpu_torch.parallel import tp

        lay = self.layout
        self._load_torch_state(tp.shard_optimizer_state(state["torch"], self.param_names, lay))
        for group in self.torch_opt.param_groups:
            group["lr_scale"] = self._scale[group["name"]]
            group["weight_decay"] = self.torch_opt.defaults["weight_decay"]
        self.updates = int(state["updates"])
        self.micro_step = int(state["micro_step"])
        dev = self.params[0].device
        self._acc = (None if state["acc"] is None else [
            tp.shard_tensor(a, tp.param_spec(n), lay.model_index, lay.n_model).to(dev)
            for a, n in zip(state["acc"], self.clip_names)])


def make_optimizer(cfg: PoETConfig, model: nn.Module, steps_per_epoch: int) -> Optimizer:
    """`Optimizer`, or with `runtime.zero_opt_state` over more than one data
    slot its ZeRO-1 form (`parallel/zero.py`); over one data slot ZeRO is a
    no-op, as JAX's `mesh.shape["data"] > 1` guard makes it."""
    from poet_tpu_torch.parallel.tp import layout_of

    if cfg.runtime.zero_opt_state and layout_of(model).n_data > 1:
        from poet_tpu_torch.parallel.zero import ZeroOptimizer

        return ZeroOptimizer(cfg, model, steps_per_epoch)
    return Optimizer(cfg, model, steps_per_epoch)


# ---------------------------------------------------------------------------
# Matching on the host, the batch on the device
# ---------------------------------------------------------------------------

def match_targets(cfg: PoETConfig, targets: Dict[str, torch.Tensor]) -> Optional[MatchResult]:
    """`match_poses` from the (CPU) targets: in gt/jitter mode the model's
    boxes and classes are `gt_queries` of the targets. None in
    bbox_mode='backbone': the step matches the model's detections."""
    mcfg = cfg.model
    if mcfg.bbox_mode == "backbone":
        return None
    boxes, classes, n_boxes, _ = gt_queries(targets, mcfg.num_queries, mcfg.bbox_mode)
    return match_poses(boxes, classes, targets["boxes"], targets["labels"], n_boxes,
                       targets["n_boxes"], bbox_mode=mcfg.bbox_mode,
                       class_mode=mcfg.class_mode, cost_bbox=cfg.matcher.set_cost_bbox,
                       cost_class=cfg.matcher.set_cost_class,
                       giou_thresh=cfg.matcher.giou_thresh)


def match_outputs(cfg: PoETConfig, outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor]) -> MatchResult:
    """`match_poses` of a forward's queries (its `pred_boxes`,
    `pred_classes`, `n_boxes`) against the targets, on their device."""
    mcfg = cfg.model
    return match_poses(outputs["pred_boxes"], outputs["pred_classes"], targets["boxes"],
                       targets["labels"], outputs["n_boxes"], targets["n_boxes"],
                       bbox_mode=mcfg.bbox_mode, class_mode=mcfg.class_mode,
                       cost_bbox=cfg.matcher.set_cost_bbox,
                       cost_class=cfg.matcher.set_cost_class,
                       giou_thresh=cfg.matcher.giou_thresh)


def _put(x, device) -> torch.Tensor:
    """Host array -> `device`; through pinned memory to a GPU, so the copy
    is asynchronous (from pageable memory it would first wait for the
    stream)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prepare_batch(cfg: PoETConfig, images, pad_mask, targets: Dict, device) -> Batch:
    """Host arrays (numpy or CPU tensors) -> (images, pad_mask, targets,
    match) on `device`, the match computed on the host first (None in
    bbox_mode='backbone', where the step matches)."""
    host = {k: torch.as_tensor(np.asarray(v)) for k, v in targets.items()}
    match = match_targets(cfg, host)
    if match is not None:
        match = MatchResult(_put(match.tgt_idx, device), _put(match.valid, device))
    return (_put(images, device), _put(pad_mask, device),
            {k: _put(v, device) for k, v in host.items()}, match)


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def make_loss_fn(model: nn.Module, cfg: PoETConfig,
                 count: Optional[Callable[[MatchResult], torch.Tensor]] = None) -> Callable:
    """loss_fn(images, pad_mask, targets, match, generator) -> (total, losses).
    `match` is None in bbox_mode='backbone': the forward's queries are
    matched to the targets here, between the forward and the losses.
    `count(match)`, when given, is the matched count every loss divides by
    (a data-parallel step's global count)."""
    mcfg = cfg.model

    def loss_fn(images, pad_mask, targets, match: Optional[MatchResult],
                generator: Optional[torch.Generator]):
        outputs = model(images, pad_mask, targets, generator=generator)
        if match is None:
            match = match_outputs(cfg, outputs, targets)
        losses = crit.compute_losses(outputs, targets, match,
                                     rotation_mode=mcfg.rotation_representation,
                                     aleatoric=mcfg.aleatoric,
                                     num_matched=None if count is None else count(match))
        total = crit.weighted_total(losses, cfg.loss.translation_loss_coef,
                                    cfg.loss.rotation_loss_coef)
        return total, losses

    return loss_fn


def global_count(match: MatchResult, group=None) -> torch.Tensor:
    """The matched count summed over the processes of `group` (a
    collective; None: every process)."""
    import torch.distributed as dist

    n = match.num_matched.clone()
    dist.all_reduce(n, group=group)
    return n


def reduce_over_processes(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor],
                          group=None) -> None:
    """Sum the gradients and the metrics over the processes of `group`
    (None: every process), in place, in one all-reduce of one flat f32
    buffer."""
    import torch.distributed as dist

    values = list(metrics.values())
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [v.reshape(1).float() for v in values])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    summed = flat[offset:].clone()          # the metrics keep no view of the buffer
    for i, (k, v) in enumerate(zip(metrics, values)):
        metrics[k] = summed[i].to(v.dtype)


def make_train_step(model: nn.Module, cfg: PoETConfig, optimizer: Optimizer) -> Callable:
    """step(images, pad_mask, targets, match, generator) -> metrics: the loss
    dict, 'loss' and 'grad_norm' (of this micro-batch's gradients), all
    device scalars. Forward in train() mode, backward, clip and update.

    In a process group (`parallel/mesh.py`) the step is data parallel, as
    JAX's jit over the global batch (`poet_tpu/engine/train.py:
    176-178`): the matching stays per process (it is per image), the losses
    divide by the matched count summed over the processes (an all-reduce
    before the division), and the gradients and the losses are then summed
    over the processes (one all-reduce): the gradient of the global batch's
    loss, not DDP's mean of per-process means. The clip, `grad_norm` and the
    update run on the summed gradients, identical on every process, and the
    metrics are the global ones.

    Under a model's layout (`parallel/tp.py:shard_module`) the matched count
    and the metrics are reduced over 'data' only: the seq and model
    processes of a data slot hold the same images and matches. The encoder
    layers' gradients, partial over 'seq' (each process ran its own tokens),
    are summed over 'seq' first; every other gradient is whole on each seq
    and model process (`parallel/tp.py`'s collectives), so each parameter's
    gradient is that of the global batch, as `jax.grad` gives.

    A model on the GPU is converted to channels_last in place (the
    parameters stay the same objects, so `optimizer` still holds them), as
    `PoseServer` does: cuDNN's fast bf16 convs want NHWC, which the NHWC
    input already is."""
    from poet_tpu_torch.parallel import tp

    if next(model.parameters()).is_cuda:
        model.to(memory_format=torch.channels_last)
    layout = tp.layout_of(model)
    data_parallel = layout.data_collective
    loss_fn = make_loss_fn(model, cfg, count=(lambda m: global_count(m, layout.data_group))
                           if data_parallel else None)
    seq_partial = ([i for i, n in enumerate(optimizer.clip_names) if tp.seq_partial(n)]
                   if layout.n_seq > 1 else [])

    def step(images, pad_mask, targets, match: Optional[MatchResult],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        total, losses = loss_fn(images, pad_mask, targets, match, generator)
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        grads = optimizer.grads()
        if seq_partial:
            reduce_over_processes([grads[i] for i in seq_partial], {}, layout.seq_group)
        if data_parallel:
            reduce_over_processes(grads, metrics, layout.data_group)
        metrics["grad_norm"] = optimizer.norm(grads)
        optimizer.step()
        return metrics

    return step


def fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Metrics on the host; raises FloatingPointError on a non-finite loss
    (the reference stops training there)."""
    values = torch.stack([v.float() for v in metrics.values()]).tolist()  # one copy
    host = dict(zip(metrics, values))
    if not math.isfinite(host["loss"]):
        raise FloatingPointError(f"loss is {host['loss']}, stopping training: {host}")
    return host


def make_eval_forward(model: nn.Module, cfg: PoETConfig) -> Callable:
    """forward(images, pad_mask, targets) -> final-layer poses and the match,
    in eval() mode without autograd."""

    def forward(images, pad_mask, targets) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            outputs = model(images, pad_mask, targets)
        match = match_outputs(cfg, outputs, targets)
        return {
            "pred_translation": outputs["translations"][-1],
            "pred_rotation": outputs["rotations"][-1],
            "pred_boxes": outputs["pred_boxes"],
            "pred_classes": outputs["pred_classes"],
            "pred_scores": outputs["pred_scores"],
            "match_tgt_idx": match.tgt_idx,
            "match_valid": match.valid,
        }

    return forward
