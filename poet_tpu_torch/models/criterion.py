"""Set criterion — translation/rotation losses over matched pairs.

Counterpart of `poet_tpu/models/criterion.py`: the six losses (`:47-97`),
`compute_losses` (`:100`) over the stacked decoder-layer axis with one
shared matching, and `weighted_total` (`:159`). Matched pairs are selected
by masking and a gather, and every loss divides by max(n_matched, 1).

  translation  — per-pair L2 norm, mean over matched pairs
  rotation     — geodesic arccos(0.5 (tr(R R̃ᵀ) − 1)), clamped to ±(1−1e−6)
  quaternion   — −log(⟨q, q̃⟩² + 1e−4)
  silho_quat   — log(1 − |⟨q, q̃⟩| + 1e−4)
  aleatoric translation / rotation (s = log σ²)

The per-layer functions broadcast over any leading dims before (B, Q), so
`compute_losses` evaluates all layers at once, as the JAX package's vmap.
"""

from __future__ import annotations

from typing import Dict

import torch

from poet_tpu_torch.models.matcher import MatchResult
from poet_tpu_torch.utils.rotations import so3_log_map


def _gather_tgt(tgt: torch.Tensor, match: MatchResult) -> torch.Tensor:
    """Per-prediction targets: (B, Q, ...) reordered by the match."""
    idx = match.tgt_idx.long()
    idx = idx.reshape(idx.shape + (1,) * (tgt.dim() - 2)).expand_as(tgt)
    return torch.gather(tgt, 1, idx)


def _masked_mean_sum(per_pair: torch.Tensor, match: MatchResult,
                     denom: float = 1.0) -> torch.Tensor:
    """Sum over valid pairs / (denom * n_valid) per leading index."""
    n = torch.clamp(match.num_matched, min=1).to(per_pair.dtype)
    masked = torch.where(match.valid, per_pair, torch.zeros_like(per_pair))
    return masked.sum((-2, -1)) / (denom * n)


def loss_translation(pred_t, tgt_t, match: MatchResult) -> torch.Tensor:
    tgt = _gather_tgt(tgt_t, match)
    d = torch.sqrt(((pred_t - tgt) ** 2).sum(-1))
    return _masked_mean_sum(d, match)


def loss_translation_aleatoric(pred_t, pred_s, tgt_t, match: MatchResult) -> torch.Tensor:
    tgt = _gather_tgt(tgt_t, match)
    per_pair = (torch.exp(-pred_s) * (tgt - pred_t) ** 2).sum(-1) + pred_s.sum(-1)
    return _masked_mean_sum(per_pair, match, denom=2.0)


def loss_rotation(pred_R, tgt_R, match: MatchResult, eps: float = 1e-6) -> torch.Tensor:
    tgt = _gather_tgt(tgt_R, match)
    prod = pred_R @ tgt.transpose(-1, -2)
    trace = prod[..., 0, 0] + prod[..., 1, 1] + prod[..., 2, 2]
    theta = torch.clamp(0.5 * (trace - 1.0), -1.0 + eps, 1.0 - eps)
    return _masked_mean_sum(torch.arccos(theta), match)


def loss_rotation_aleatoric(pred_R, pred_s, tgt_R, match: MatchResult) -> torch.Tensor:
    tgt = _gather_tgt(tgt_R, match)
    v = so3_log_map(pred_R @ tgt.transpose(-1, -2))
    per_pair = (torch.exp(-pred_s) * v ** 2).sum(-1) + pred_s.sum(-1)
    return _masked_mean_sum(per_pair, match, denom=2.0)


def loss_quaternion(pred_q, tgt_q, match: MatchResult, eps: float = 1e-4) -> torch.Tensor:
    dp = (pred_q * _gather_tgt(tgt_q, match)).sum(-1)
    return _masked_mean_sum(-torch.log(dp ** 2 + eps), match)


def loss_silho_quaternion(pred_q, tgt_q, match: MatchResult, eps: float = 1e-4) -> torch.Tensor:
    dp = (pred_q * _gather_tgt(tgt_q, match)).sum(-1)
    return _masked_mean_sum(torch.log(1.0 - dp.abs() + eps), match)


def compute_losses(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                   match: MatchResult, rotation_mode: str = "6d",
                   aleatoric: bool = False) -> Dict[str, torch.Tensor]:
    """All per-layer losses from stacked (n_layers, B, Q, ...) outputs.

    Names follow the reference: the final layer 'loss_trans' / 'loss_rot',
    the others suffixed '_{i}' for i in [0, n_layers - 2].
    """
    trans, rots = outputs["translations"], outputs["rotations"]
    n_layers = trans.shape[0]
    # the targets broadcast over the layer axis: gather once on (B, Q, ...)
    if aleatoric:
        lt_all = loss_translation_aleatoric(trans, outputs["translations_aleatoric"],
                                            targets["relative_position"], match)
        lr_all = loss_rotation_aleatoric(rots, outputs["rotations_aleatoric"],
                                         targets["relative_rotation"], match)
    elif rotation_mode == "6d":
        lt_all = loss_translation(trans, targets["relative_position"], match)
        lr_all = loss_rotation(rots, targets["relative_rotation"], match)
    elif rotation_mode in ("quat", "silho_quat"):
        lt_all = loss_translation(trans, targets["relative_position"], match)
        rot_loss = loss_quaternion if rotation_mode == "quat" else loss_silho_quaternion
        lr_all = rot_loss(rots, targets["relative_quaternions"], match)
    else:
        raise NotImplementedError(rotation_mode)

    losses: Dict[str, torch.Tensor] = {}
    for lvl in range(n_layers):
        suffix = "" if lvl == n_layers - 1 else f"_{lvl}"
        losses[f"loss_trans{suffix}"] = lt_all[lvl]
        losses[f"loss_rot{suffix}"] = lr_all[lvl]
    return losses


def weighted_total(losses: Dict[str, torch.Tensor], translation_coef: float = 1.0,
                   rotation_coef: float = 1.0) -> torch.Tensor:
    """The scalar training loss (the same coefficient for the aux layers)."""
    total = 0.0
    for k, v in losses.items():
        if k.startswith("loss_trans"):
            total = total + translation_coef * v
        elif k.startswith("loss_rot"):
            total = total + rotation_coef * v
    return total
