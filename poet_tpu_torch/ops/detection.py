"""Fixed-shape detection ops: NMS and the multi-scale RoIAlign plain version.

Counterpart of `poet_tpu/ops/detection.py`. The NMS family is plain torch
(none of it is a Pallas kernel there). Every function takes leading batch
dimensions, so the detector runs one fixed point for all its images and
RPN levels at once:

  * `nms_keep_mask` is the greedy-NMS keep set as the fixed point of
    k_j = valid_j AND NOT any_{i<j}(k_i AND iou_ij > thr) in score order,
    iterated from k = valid. `lax.while_loop` becomes PyTorch's `while_loop`
    operator: its convergence test reads one bool per iteration (the host
    waits on the device once per iteration; `FIXED_POINT` counts iterations
    and waits in eager calls, and under a profiler each loop is an
    `nms.fixed_point` span with its `iterations`), and a `torch.export`ed
    program holds the whole loop, which its runtime iterates in the same
    way.
  * top-k is a stable descending sort: ties keep the lower index first, as
    `jax.lax.top_k` does, so keep sets and selections match JAX exactly;
  * `nms_padded` and `batched_class_nms` (the YOLO detector's agnostic and
    per-class NMS) run through the same fixed point.

RoIAlign (torchvision `MultiScaleRoIAlign`, aligned=False) is split in two:
`roi_geometry` computes each box's level and, per sample, the lower corner
and the two bilinear weights of each axis, in torch for both versions; then
`multiscale_roi_align_torch` (the plain version, what the JAX flat oracle
`_multiscale_roi_align_flat` computes) or the CUDA kernel
(`ops/roi_align_cuda.py`) only gathers and blends. Computing the geometry
once keeps the kernel free of the cell-edge and level decisions that FMA
contraction in nvcc could move. `multiscale_roi_align` is JAX's single-image
view of the batched entry (`ops/roi_align_cuda.py`), and `roi_align` its
single-level RoIAlign with the `aligned` flag, in plain torch as in JAX (an
XLA op there, not a Pallas kernel).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from poet_tpu_torch.utils.tables import device_table
from poet_tpu_torch.utils.tracing import span

NEG_INF = float("-inf")


class FixedPointStats:
    """Counts of the NMS fixed point's loop: `calls`, `iterations` (one host
    wait each) and the largest iteration count of one call. The host time in
    the loops is the `nms.fixed_point` spans' (`utils/tracing.py`)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = self.iterations = self.max_iterations = 0


FIXED_POINT = FixedPointStats()


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: descending, ties lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pairwise_iou_xyxy(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU, 0 where the union is 0."""
    x1a, y1a, x2a, y2a = boxes1.unbind(-1)
    x1b, y1b, x2b, y2b = boxes2.unbind(-1)
    area1 = (x2a - x1a).clamp(min=0) * (y2a - y1a).clamp(min=0)
    area2 = (x2b - x1b).clamp(min=0) * (y2b - y1b).clamp(min=0)
    iw = (torch.minimum(x2a[..., :, None], x2b[..., None, :])
          - torch.maximum(x1a[..., :, None], x1b[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2a[..., :, None], y2b[..., None, :])
          - torch.maximum(y1a[..., :, None], y1b[..., None, :])).clamp(min=0)
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype,
                                                             device=inter.device))


def _fixed_point_continues(t, k, changed, valid, sup):
    return changed & (t < k.shape[-1])


def _fixed_point_step(t, k, changed, valid, sup):
    k_new = valid & ~(sup & k[..., :, None]).any(dim=-2)
    return t + 1, k_new, (k_new != k).any()


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Greedy-NMS keep set of (..., N, 4) boxes -> (..., N) bool in the
    original order; candidates with score -inf are invalid. Every leading
    problem converges in one shared loop (a converged one stays put).

    The loop is the `while_loop` operator with JAX's condition (`changed &
    (t < N)`, `poet_tpu/ops/detection.py:104-108`): it reads one bool per
    iteration, as a Python loop would, and a traced program (`torch.export`)
    keeps it whole. `FIXED_POINT` counts eager calls only; its iterations
    are the loop's own `t`."""
    N = boxes.shape[-2]
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    valid = s > NEG_INF
    upper = torch.ones(N, N, dtype=torch.bool, device=boxes.device).triu(1)
    sup = upper & (pairwise_iou_xyxy(b, b) > iou_threshold)
    start = (torch.zeros((), dtype=torch.int64, device=boxes.device), valid.clone(),
             torch.ones((), dtype=torch.bool, device=boxes.device))
    with span("nms.fixed_point") as sp:
        t, k, _ = while_loop_op(_fixed_point_continues, _fixed_point_step, start, (valid, sup))
        if not torch.compiler.is_exporting():
            # a traced program keeps no count; eagerly the loop has run
            iterations = int(t)
            FIXED_POINT.calls += 1
            FIXED_POINT.iterations += iterations
            FIXED_POINT.max_iterations = max(FIXED_POINT.max_iterations, iterations)
            sp.add(iterations=iterations)
    return torch.zeros_like(k).scatter(-1, order, k)


def nms_fixed_point(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                    max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-point NMS + top-`max_outputs` (JAX's `nms_padded`/`nms_fixed_point`):
    (keep_idx int32, keep_valid), in descending score; invalid slots hold
    index 0."""
    N = boxes.shape[-2]
    keep = nms_keep_mask(boxes, scores, iou_threshold)
    top_s, top_i = topk(torch.where(keep, scores, NEG_INF), min(max_outputs, N))
    keep_valid = top_s > NEG_INF
    keep_idx = torch.where(keep_valid, top_i, 0).to(torch.int32)
    pad = max_outputs - keep_idx.shape[-1]
    if pad > 0:
        keep_idx = torch.nn.functional.pad(keep_idx, (0, pad))
        keep_valid = torch.nn.functional.pad(keep_valid, (0, pad))
    return keep_idx, keep_valid


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's `nms_padded` with leading batch dimensions: (..., N, 4) boxes,
    (..., N) scores with -inf for invalid candidates -> (keep_idx, keep_valid)
    of `max_outputs` in descending score, through `nms_fixed_point`."""
    return nms_fixed_point(boxes, scores, iou_threshold, max_outputs)


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor, iou_threshold: float,
                      max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS by the coordinate-offset trick (torchvision batched_nms,
    JAX's `batched_class_nms`), with leading batch dimensions: each problem's
    boxes move by label x (its largest valid coordinate + 1), so boxes of
    different classes never overlap, and one NMS runs over all of them."""
    max_coord = torch.where(valid[..., None], boxes, 0.0).amax(dim=(-2, -1),
                                                               keepdim=True) + 1.0
    shifted = boxes + labels.to(boxes.dtype)[..., None] * max_coord
    return nms_padded(shifted, torch.where(valid, scores, NEG_INF), iou_threshold,
                      max_outputs)


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_outputs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The literal sequential greedy recurrence on one (N, 4) set: the tests'
    oracle for `nms_fixed_point`."""
    N = boxes.shape[0]
    iou = pairwise_iou_xyxy(boxes, boxes)
    alive = scores.clone()
    keep_idx = torch.zeros(max_outputs, dtype=torch.int32, device=boxes.device)
    keep_valid = torch.zeros(max_outputs, dtype=torch.bool, device=boxes.device)
    ar = torch.arange(N, device=boxes.device)
    for i in range(max_outputs):
        best = int(torch.argmax(alive))
        valid = bool(alive[best] > NEG_INF)
        keep_idx[i] = best if valid else 0
        keep_valid[i] = valid
        if valid:
            alive = torch.where((iou[best] > iou_threshold) | (ar == best), NEG_INF, alive)
    return keep_idx, keep_valid


def exact_class_nms_mask(boxes_pc: torch.Tensor, scores_pc: torch.Tensor, ncls: int,
                         iou_threshold: float) -> torch.Tensor:
    """Exact per-class greedy-NMS keep mask over (..., P * ncls) candidates in
    proposal-major / class-minor order: one (P, P) problem per class."""
    lead, PN = scores_pc.shape[:-1], scores_pc.shape[-1]
    P = PN // ncls
    boxes_cls = boxes_pc.reshape(*lead, P, ncls, 4).transpose(-3, -2)   # (..., ncls, P, 4)
    scores_cls = scores_pc.reshape(*lead, P, ncls).transpose(-2, -1)    # (..., ncls, P)
    keep = nms_keep_mask(boxes_cls, scores_cls, iou_threshold)
    return keep.transpose(-2, -1).reshape(*lead, PN)


def class_nms_select_pruned(boxes_pc: torch.Tensor, scores_pc: torch.Tensor,
                            labels_pc: torch.Tensor, iou_threshold: float,
                            max_detections: int, prune_k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS + top-`max_detections` over only the global
    score-top-`prune_k` candidates, with the exactness certificate of
    `poet_tpu/ops/detection.py:class_nms_select_pruned`.

    Returns (sel int32 indices into the PN set, keep_valid, certified), each
    with the leading dims. Where `certified` holds, the selection equals
    exact per-class NMS of the full set followed by top-`max_detections`:
    a candidate's keep bit depends only on same-class candidates ranked
    before it, the top-k holds a prefix of every class's order, and no
    dropped candidate (score <= s_next) can enter the final top-md when
    nothing valid was dropped or md kept scores strictly exceed s_next.
    """
    PN = boxes_pc.shape[-2]
    md = max_detections
    k = min(prune_k, PN - 1)
    if k < md:
        raise ValueError(f"prune_k ({prune_k}) must allow at least "
                         f"max_detections ({md}) candidates")
    s_k1, i_k1 = topk(scores_pc, k + 1)
    cand_s, cand_i, s_next = s_k1[..., :k], i_k1[..., :k], s_k1[..., k]
    cand_boxes = torch.gather(boxes_pc, -2, cand_i[..., None].expand(*cand_i.shape, 4))
    cand_labels = torch.gather(labels_pc.expand(*scores_pc.shape), -1, cand_i)
    finite = torch.isfinite(cand_s)
    max_coord = torch.where(finite[..., None], cand_boxes, 0.0).amax(
        dim=(-2, -1), keepdim=True) + 1.0
    shifted = cand_boxes + cand_labels.to(cand_boxes.dtype)[..., None] * max_coord
    keep = nms_keep_mask(shifted, cand_s, iou_threshold)
    top_s, sel_k = topk(torch.where(keep, cand_s, NEG_INF), md)
    keep_valid = torch.isfinite(top_s)
    certified = (s_next == NEG_INF) | ((keep.sum(-1) >= md) & (top_s[..., md - 1] > s_next))
    sel = torch.where(keep_valid, torch.gather(cand_i, -1, sel_k), 0).to(torch.int32)
    return sel, keep_valid, certified


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------

@dataclass
class RoiGeometry:
    """Per box (B * R rows): the pyramid level, and per sample of each axis
    (N = output_size * sampling_ratio) the lower corner and the weights of
    the lower and upper corner, zero for samples outside the map."""

    level: torch.Tensor      # (BR,) int32
    ylo: torch.Tensor        # (BR, N) int32
    yw: torch.Tensor         # (BR, N, 2) f32
    xlo: torch.Tensor        # (BR, N) int32
    xw: torch.Tensor         # (BR, N, 2) f32


def roi_levels(boxes: torch.Tensor, strides: Sequence[int], n_levels: int,
               canonical_scale: int = 224, canonical_level: int = 4) -> torch.Tensor:
    """torchvision LevelMapper: floor(4 + log2(sqrt(w h) / 224 + 1e-6)),
    clipped to the levels, as an index from k_min = log2(strides[0]).
    (..., 4) xyxy boxes -> (...,) int32; non-finite boxes take level 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    k_min = int(round(math.log2(strides[0])))
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(w * h) / canonical_scale + 1e-6))
    lvl = torch.nan_to_num(lvl, nan=float(k_min))
    return (lvl.clamp(k_min, k_min + n_levels - 1) - k_min).to(torch.int32)


def _axis(coords: torch.Tensor, size: torch.Tensor):
    """torchvision's sample rule on one axis: 0 outside [-1, size]; else the
    coordinate clamped to [0, size - 1] and lo = clamp(floor, 0, size - 2).
    Non-finite coordinates count as outside."""
    size = size[:, None]
    outside = (coords < -1.0) | (coords > size) | ~torch.isfinite(coords)
    c = torch.minimum(torch.where(outside, 0.0, coords).clamp(min=0.0), size - 1.0)
    lo = torch.minimum(torch.floor(c), size - 2.0).clamp(min=0.0)
    frac = c - lo
    inside = (~outside).to(torch.float32)
    return lo.to(torch.int32), torch.stack([(1.0 - frac) * inside, frac * inside], dim=-1)


@device_table
def _level_table(shapes: Tuple[Tuple[int, int], ...], strides: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """(3, L) f32 rows H_l, W_l, 1/stride_l on `device`, made once: a
    tensor built from a host list on every call would be a blocking copy."""
    return torch.tensor([[float(h) for h, _ in shapes], [float(w) for _, w in shapes],
                         [1.0 / s for s in strides]], dtype=torch.float32, device=device)


def roi_geometry(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 boxes: torch.Tensor, output_size: int = 7, sampling_ratio: int = 2,
                 canonical_scale: int = 224, canonical_level: int = 4) -> RoiGeometry:
    """The shared geometry of (B, R, 4) xyxy image-pixel boxes on levels of
    (H_l, W_l) (`_roi_level_geometry` + `_roi_sample_coords` in JAX)."""
    for li, (h, w) in enumerate(shapes):
        if min(h, w) < 2:
            raise ValueError(f"multiscale_roi_align: level {li} is {h}x{w}; every "
                             "pyramid level needs H >= 2 and W >= 2")
    dev = boxes.device
    bf = boxes.reshape(-1, 4).to(torch.float32)
    lvl = roi_levels(bf, strides, len(shapes), canonical_scale, canonical_level)
    H, W, inv_stride = _level_table(tuple(map(tuple, shapes)), tuple(strides),
                                    dev)[:, lvl.long()]
    b = bf * inv_stride[:, None]
    s = sampling_ratio
    ii = torch.arange(output_size, dtype=torch.float32, device=dev)
    kk = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    grid = (ii[:, None] + kk[None, :]).reshape(-1)                    # (N,)
    x0, y0 = b[:, 0], b[:, 1]
    bin_w = torch.clamp(b[:, 2] - x0, min=1.0) / output_size
    bin_h = torch.clamp(b[:, 3] - y0, min=1.0) / output_size
    xlo, xw = _axis(x0[:, None] + grid[None, :] * bin_w[:, None], W)
    ylo, yw = _axis(y0[:, None] + grid[None, :] * bin_h[:, None], H)
    return RoiGeometry(lvl, ylo, yw, xlo, xw)


def roi_blend_plain(features: Sequence[torch.Tensor], geo: RoiGeometry, B: int, R: int,
                    output_size: int = 7, chunk: int = 2048) -> torch.Tensor:
    """Gather and blend from the geometry: (B, R, o, o, C) in the features'
    dtype, summed in f32 and rounded once. Boxes go in chunks of `chunk` so
    the (chunk, N, N, C) corner gathers stay bounded."""
    C = features[0].shape[-1]
    dt = features[0].dtype
    dev = features[0].device
    if B * R == 0:
        return torch.zeros((B, R, output_size, output_size, C), dtype=dt, device=dev)
    N = geo.ylo.shape[1]
    s = N // output_size
    flat = torch.cat([f.reshape(-1, C) for f in features])
    sizes = [f.shape[1] * f.shape[2] for f in features]
    base = torch.tensor([B * sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    size = torch.tensor(sizes, device=dev)
    Wl = torch.tensor([f.shape[2] for f in features], device=dev)
    idx = geo.level.long()
    img = torch.arange(B * R, device=dev) // R
    start = base[idx] + img * size[idx]                                # (BR,)
    width = Wl[idx]
    out = torch.empty((B * R, output_size, output_size, C), dtype=dt, device=dev)
    for a in range(0, B * R, chunk):
        sl = slice(a, a + chunk)
        r = start[sl].shape[0]
        row = start[sl, None] + geo.ylo[sl].long() * width[sl, None]   # (r, N)
        acc = torch.zeros((r, N, N, C), dtype=torch.float32, device=dev)
        for dy in (0, 1):
            for dx in (0, 1):
                i = (row[:, :, None] + dy * width[sl, None, None]
                     + geo.xlo[sl].long()[:, None, :] + dx)            # (r, N, N)
                w = geo.yw[sl, :, None, dy] * geo.xw[sl, None, :, dx]
                acc += flat[i.reshape(-1)].reshape(r, N, N, C).float() * w[..., None]
        acc = acc.reshape(r, output_size, s, output_size, s, C).sum((2, 4)) / (s * s)
        out[sl] = acc.to(dt)
    return out.reshape(B, R, output_size, output_size, C)


def multiscale_roi_align_torch(features: Sequence[torch.Tensor], strides: Sequence[int],
                               boxes: torch.Tensor, output_size: int = 7,
                               sampling_ratio: int = 2) -> torch.Tensor:
    """torchvision MultiScaleRoIAlign (aligned=False), the plain version of
    the RoIAlign kernel: per-level (B, H_l, W_l, C) features and (B, R, 4)
    xyxy image-pixel boxes -> (B, R, o, o, C) in the features' dtype."""
    B, R = boxes.shape[:2]
    geo = roi_geometry([tuple(f.shape[1:3]) for f in features], strides, boxes,
                       output_size, sampling_ratio)
    return roi_blend_plain(features, geo, B, R, output_size)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2,
              aligned: bool = False) -> torch.Tensor:
    """Single-level, single-image RoIAlign with torchvision's semantics
    (`poet_tpu/ops/detection.py:roi_align`): (H, W, C) features and (R, 4)
    xyxy image-pixel boxes -> (R, output_size, output_size, C), the mean of
    `sampling_ratio`^2 bilinear samples per bin. `aligned` shifts by -0.5
    pixel (the legacy False does not). A sample within one pixel outside
    the map is clamped into it, farther out it is 0; the lower corner is
    clipped to size - 2."""
    H, W, C = features.shape
    R = boxes.shape[0]
    off = 0.5 if aligned else 0.0
    b = boxes * spatial_scale
    x0, y0 = b[:, 0] - off, b[:, 1] - off
    floor = 1e-6 if aligned else 1.0
    # true divisions, as JAX's: CUDA multiplies by the reciprocal of a
    # Python number, an ulp off the CPU's quotient
    out_n = torch.full((), float(output_size), dtype=b.dtype, device=b.device)
    s = sampling_ratio
    bin_w = torch.clamp(b[:, 2] - off - x0, min=floor) / out_n
    bin_h = torch.clamp(b[:, 3] - off - y0, min=floor) / out_n
    ii = torch.arange(output_size, dtype=b.dtype, device=b.device)
    kk = (torch.arange(s, dtype=b.dtype, device=b.device) + 0.5) / torch.full(
        (), float(s), dtype=b.dtype, device=b.device)
    grid = ii[None, :, None] + kk[None, None, :]                         # (1, out, s)
    ys = (y0[:, None, None] + grid * bin_h[:, None, None]).reshape(R, output_size * s)
    xs = (x0[:, None, None] + grid * bin_w[:, None, None]).reshape(R, output_size * s)

    def lin(coords, size):
        c = torch.clamp(coords, 0.0, size - 1.0)
        lo = torch.clamp(torch.floor(c), 0, size - 2).long()
        return lo, c - lo, (coords < -1.0) | (coords > size)

    ylo, wy, y_out = lin(ys, H)                                          # (R, N)
    xlo, wx, x_out = lin(xs, W)
    rows = ylo[:, :, None] * W                                           # (R, N, 1)
    flat = features.reshape(H * W, C)

    def corner(dy, dx):
        return flat[(rows + dy * W + xlo[:, None, :] + dx).reshape(-1)].reshape(
            R, ys.shape[1], xs.shape[1], C)

    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    out = (corner(0, 0) * (1 - wy) * (1 - wx) + corner(0, 1) * (1 - wy) * wx
           + corner(1, 0) * wy * (1 - wx) + corner(1, 1) * wy * wx)
    out = out * ((~y_out)[:, :, None] & (~x_out)[:, None, :])[..., None]
    return out.reshape(R, output_size, s, output_size, s, C).mean(dim=(2, 4))


def multiscale_roi_align(features: Sequence[torch.Tensor], strides: Sequence[int],
                         boxes: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2, canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """torchvision MultiScaleRoIAlign on one image: per-level (H_l, W_l, C)
    features and (R, 4) xyxy image-pixel boxes -> (R, o, o, C). The
    single-image view of `ops/roi_align_cuda.py:multiscale_roi_align`: the
    plain version on the CPU, on CUDA the kernel on the route `plan_roi`
    gives."""
    from poet_tpu_torch.ops.roi_align_cuda import multiscale_roi_align as batched

    return batched([f[None] for f in features], strides, boxes[None], output_size,
                   sampling_ratio, canonical_scale, canonical_level)[0]
