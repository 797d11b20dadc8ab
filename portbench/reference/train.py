"""Plain PoET training in float32: the pose matcher in gt mode (box L1 cost,
Hungarian assignment by scipy), the losses of every decoder layer
(translation: the L2 distance; rotation: the geodesic angle arccos(0.5
(tr(R T^T) - 1)), its argument clamped 1e-6 inside +-1), each the mean over
the batch's matched pairs, summed over the layers; the gradient over the
whole batch, taken in blocks of rows; global-norm clipping as optax's
`clip_by_global_norm` (g max_norm / norm where norm >= max_norm); AdamW as
optax's `adamw` (bias-corrected moments, eps outside the square root, the
decay lr wd p on the parameter before the update). The backbone is frozen:
its maps are computed without a gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from portbench.reference import poet as ref_poet

ROWS = 4


def match(boxes: np.ndarray, n: np.ndarray) -> np.ndarray:
    """(B, Q) target slot of each query: the queries are the targets' own
    boxes (gt mode), assigned by the L1 cost of the boxes."""
    B, Q = boxes.shape[:2]
    idx = np.tile(np.arange(Q), (B, 1))
    for b in range(B):
        k = int(n[b])
        cost = np.abs(boxes[b, :k, None, :] - boxes[b, None, :k, :]).sum(-1)
        rows, cols = linear_sum_assignment(cost)
        idx[b, rows] = cols
    return idx


def layer_losses(T, R, tgt_t, tgt_R, idx, valid, n_matched: float) -> torch.Tensor:
    """(L,) translation + rotation loss of each decoder layer: sums over the
    rows given, divided by the batch's matched count."""
    ti = torch.gather(tgt_t, 1, idx[..., None].expand(*idx.shape, 3))
    Ri = torch.gather(tgt_R, 1, idx[..., None, None].expand(*idx.shape, 3, 3))
    lt = torch.sqrt(((T - ti) ** 2).sum(-1))
    prod = R @ Ri.transpose(-1, -2)
    cos = 0.5 * (prod[..., 0, 0] + prod[..., 1, 1] + prod[..., 2, 2] - 1.0)
    lr = torch.arccos(torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6))
    v = valid.to(lt.dtype)
    return ((lt + lr) * v).sum((-2, -1)) / n_matched


def loss_and_grads(params: Dict[str, torch.Tensor], trained: List[str], m: dict, feats,
                   batch: dict, device):
    """(total loss, {layer: loss}, {name: gradient}) of one batch, the
    backbone's `feats` given; rows in blocks of ROWS."""
    B = batch["images"].shape[0]
    n = batch["n_boxes"]
    idx_np = match(batch["boxes"], n)
    valid_np = np.arange(batch["boxes"].shape[1])[None, :] < n[:, None]
    n_matched = max(float(valid_np.sum()), 1.0)
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in trained}
    p = dict(params, **leaves)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    per_layer = None
    for i in range(0, B, ROWS):
        r = slice(i, min(i + ROWS, B))
        t = lambda a, dt=None: torch.as_tensor(a[r] if dt is None else a[r].astype(dt),
                                               device=device)
        T, R = ref_poet.forward(p, m, [f[r] for f in feats], t(batch["boxes"]),
                                t(batch["labels"], np.int64), t(n, np.int64), all_layers=True)
        losses = layer_losses(T, R, t(batch["relative_position"]),
                              t(batch["relative_rotation"]), t(idx_np, np.int64),
                              t(valid_np), n_matched)
        g = torch.autograd.grad(losses.sum(), list(leaves.values()), allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
        per_layer = losses.detach() if per_layer is None else per_layer + losses.detach()
    return float(per_layer.sum()), per_layer.cpu().numpy(), grads


def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> float:
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    if max_norm > 0 and norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return norm


def adamw(params, grads, state, lrs: Dict[str, float], wd: float, step: int,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One optax-`adamw` update of the trained leaves, in place."""
    for k, g in grads.items():
        mu, nu = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = mu / (1 - b1 ** step)
        vhat = nu / (1 - b2 ** step)
        p = params[k]
        params[k] = p - lrs[k] * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
