"""How `correct` is decided: the program's answers to a sample of the
window's requests, or its first training steps, against the plain reference
(`portbench/reference/`), run once the window has closed, in blocks of
`BLOCK` images. A cell's `portbench/limits/<workload>.json` names the
readings held to a limit; the others are printed for the record (PERF.md
says why each is or is not held).

Serving, per sampled request (the worst request's):
  pose_t_med  the median over the served queries of the widest translation
              gap, over the request's largest reference translation; pose_t
              the widest. The reference runs the pose transformer on the
              served boxes and classes: poses are chaotic in the box
              coordinates, so they are compared on shared detections.
  pose_R_med  the median over the served queries of the widest rotation
              matrix entry gap; pose_R the widest.
Detector mode, from the reference's own detections (decode, threshold
lowered by RELAX, top `pre_nms`, class NMS, uncapped). bf16's darknet moves
a score near the threshold by up to a quarter and a class logit by several
units at these weights, so these count shares over every sampled request
and the guarantee of NMS, not box-for-box equality (pair_iou is held; the
shares, which the control does not part from sound runs, are printed for
the record):
  pair_iou    the largest IoU between two served boxes of one class in one
              image: the configuration's NMS guarantees at most iou_thresh.
  det_missed_share  the share of the reference's sure detections with no
              served box of the same class at IoU MATCH_IOU or more. Sure:
              scoring RELAX or more above the threshold, a class logit
              MARGIN or more above the runner-up, and ranked within the
              first Q - SLACK served. A box that the program's NMS suppressed
              instead has a kept partner of its class at IoU above
              iou_thresh. (det_missed: their number.)
  det_unmatched_share  the share of served boxes with no reference
              detection of any class at IoU MATCH_IOU or more.
  cross_pair_loss  over every sampled request: 1 less the served pairs of
              boxes of different classes overlapping above iou_thresh over
              the reference's served pairs (0 where the reference has fewer
              than CROSS_MIN): NMS within each class keeps such pairs, NMS
              across classes (the class offset lost) keeps none.

Training (`reference_training`, `train_readings`): the reference follows
the program's first steps from the same weights and batches.
  loss1_gap   the first step's loss (before any update), relative gap;
              loss_gap the widest over the checked steps.
  grad_gap_med  the first update's gradient as the optimizer took it (the
              program's from AdamW's first moment): per trained leaf the gap
              of the norms over the larger of the reference leaf's and the
              median leaf's; the median leaf (grad_gap: the worst).
  grad_vec_med  the first update's gradient vectors: per leaf, each side's
              over its own median leaf's norm (blind to the clip's one
              factor on every leaf, which follows the global norm and so
              the few leaves whose gradient is ill-conditioned at the
              initial weights), the L2 of the difference over the larger of
              the reference leaf's and the median's; the median leaf
              (grad_vec: the worst). Every row of the batch adds to it.
  change_gap_med  the same as grad_gap_med for each leaf's change over the
              checked steps (change_gap: the worst).
Leaves whose reference gradient is under GRAD_FLOOR of the median leaf's
(rounding residue, as a bias before a softmax) are left out of all these.

The control (`control_answers`, `reference_training(precision=...)`) is the
reference itself in the precision below the configuration's (fp8 for bf16,
`portbench/reference/numerics.py`), put in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import darknet as ref_darknet
from portbench.reference import poet as ref_poet
from portbench.reference.numerics import exact

BLOCK = 4
GRAD_FLOOR = 1e-3
RELAX = 0.1          # score
MARGIN = 2.0         # class logit
SLACK = 3            # ranks
MATCH_IOU = 0.3
CROSS_MIN = 10       # pairs


def _blocks(n: int):
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


def backbone_maps(conf, state, images: torch.Tensor):
    """The reference backbone: (darknet head inputs and specs or None, maps)."""
    if conf.backbone == "darknet":
        heads, specs, feats = ref_darknet.body(state, conf.sections, images)
        return (heads, specs), feats
    from portbench.reference import resnet_fpn
    return None, resnet_fpn.forward(state, images, conf.data["fpn_levels"])


def reference_detections(conf, heads, specs, H: int):
    """The reference detector's decode, threshold, top `pre_nms` and class
    NMS at the threshold lowered by RELAX, uncapped: per image (boxes (n, 4)
    xyxy pixels, scores, labels, class-logit margins), in descending score.
    Its detections above the threshold itself are the ones it serves, in the
    same order: a box below the threshold never suppresses one above it."""
    det = conf.data["detector"]
    boxes, scores, margins = ref_darknet.decode(heads, specs, H)
    return ref_darknet.detect(boxes, scores, margins, det["conf_thresh"] - RELAX,
                              det["iou_thresh"], det["pre_nms"], det["pre_nms"])


def served_boxes(conf, dets, H: int, W: int, Q: int):
    """What the reference detector hands PoET: the top Q of its detections
    above the threshold, at most `max_detections` -> (boxes (B, Q, 4)
    normalized cxcywh, -1 padded; classes (B, Q), -1 padded; n (B,))."""
    det = conf.data["detector"]
    B = len(dets)
    out_b = np.full((B, Q, 4), -1.0, np.float32)
    out_c = np.full((B, Q), -1, np.int32)
    n = np.zeros(B, np.int32)
    for b, (bx, sc, lb, _) in enumerate(dets):
        keep = np.nonzero((sc > det["conf_thresh"]).numpy())[0][: det["max_detections"]]
        bx, lb = bx.double().numpy()[keep], lb.numpy()[keep]
        k = min(Q, len(bx))
        n[b] = k
        out_b[b, :k] = xyxy_to_cxcywh(bx[:k]) / np.array([W, H, W, H])
        out_c[b, :k] = lb[:k]
    return out_b, out_c, n


def xyxy_to_cxcywh(b: np.ndarray) -> np.ndarray:
    return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                     b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)


def cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    return np.concatenate([b[:, :2] - b[:, 2:] / 2, b[:, :2] + b[:, 2:] / 2], -1)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy, float64 -> (N, M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def reference_answers(conf, state, images: np.ndarray, answers: Dict[str, np.ndarray],
                      device, precision=None) -> Dict[str, np.ndarray]:
    """What the reference says of one request: its own detections (detector
    mode), and its poses on the answer's boxes and classes."""
    m = conf.model
    B, H, W = images.shape[:3]
    res = {"translation": [], "rotation": []}
    dets = []
    with torch.no_grad(), exact(precision):
        for rows in _blocks(B):
            x = torch.from_numpy(images[rows]).to(device)
            det, feats = backbone_maps(conf, state, x)
            if det is not None:
                dets += reference_detections(conf, *det, H)
            t, r = ref_poet.forward(
                state, m, feats, torch.from_numpy(answers["boxes"][rows]).to(device),
                torch.from_numpy(answers["classes"][rows].astype(np.int64)).to(device),
                torch.from_numpy(answers["n_boxes"][rows].astype(np.int64)).to(device))
            res["translation"].append(t.cpu().numpy())
            res["rotation"].append(r.cpu().numpy())
    out = {k: np.concatenate(v) for k, v in res.items()}
    if dets:
        out["detections"] = [(bx.double().numpy(), sc.double().numpy(), lb.numpy(),
                              mg.double().numpy()) for bx, sc, lb, mg in dets]
        out["detector"] = conf.data["detector"]
    return out


def control_answers(conf, state, images: np.ndarray, device, precision: str,
                    tracker_inputs=None) -> Dict[str, np.ndarray]:
    """The reference in `precision`, answering as the program does."""
    m = conf.model
    B, H, W = images.shape[:3]
    Q = m["num_queries"]
    parts = {"boxes": [], "classes": [], "n_boxes": [], "translation": [], "rotation": []}
    with torch.no_grad(), exact(precision):
        for rows in _blocks(B):
            x = torch.from_numpy(images[rows]).to(device)
            det, feats = backbone_maps(conf, state, x)
            if det is not None:
                bx, cl, n = served_boxes(conf, reference_detections(conf, *det, H), H, W, Q)
            else:
                bx, cl, n = (a[rows] for a in tracker_inputs)
            t, r = ref_poet.forward(state, m, feats, torch.from_numpy(bx).to(device),
                                    torch.from_numpy(cl.astype(np.int64)).to(device),
                                    torch.from_numpy(n.astype(np.int64)).to(device))
            for k, v in (("boxes", bx), ("classes", cl), ("n_boxes", n),
                         ("translation", t.cpu().numpy()), ("rotation", r.cpu().numpy())):
                parts[k].append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in parts.items()}


def _cross_pairs(boxes: np.ndarray, labels: np.ndarray, thresh: float) -> int:
    """Pairs of boxes of different classes overlapping above `thresh`."""
    if len(boxes) < 2:
        return 0
    other = labels[:, None] != labels[None, :]
    return int(np.triu(other & (box_iou(boxes, boxes) > thresh), 1).sum())


def detection_readings(answers: Dict[str, np.ndarray], ref: dict, image_hw) -> Dict[str, float]:
    """pair_iou, det_missed, det_unmatched and cross_pair_loss of one
    request (see the module's docstring)."""
    H, W = image_hw
    det = ref["detector"]
    n = answers["n_boxes"].astype(np.int64)
    Q = answers["boxes"].shape[1]
    pair, missed, sure_n, unmatched = 0.0, 0, 0, 0
    cross_prog = cross_ref = 0
    for b, (rbx, rsc, rlb, rmg) in enumerate(ref["detections"]):
        sbx = cxcywh_to_xyxy(answers["boxes"][b, :n[b]].astype(np.float64)
                             * np.array([W, H, W, H]))
        slb = answers["classes"][b, :n[b]].astype(np.int64)
        if len(sbx) > 1:
            same = (slb[:, None] == slb[None, :]) & ~np.eye(len(sbx), dtype=bool)
            pair = max(pair, float(np.where(same, box_iou(sbx, sbx), 0.0).max()))
        if len(sbx):
            ious = box_iou(sbx, rbx) if len(rbx) else np.zeros((len(sbx), 0))
            unmatched += int((~(ious >= MATCH_IOU).any(1)).sum())
        strict = rsc > det["conf_thresh"]
        served = np.nonzero(strict)[0][: min(Q, det["max_detections"])]
        cross_prog += _cross_pairs(sbx, slb, det["iou_thresh"])
        cross_ref += _cross_pairs(rbx[served], rlb[served], det["iou_thresh"])
        rank = np.cumsum(strict) - 1
        sure = (strict & (rsc >= det["conf_thresh"] + RELAX) & (rmg >= MARGIN)
                & (rank < Q - SLACK))
        for j in np.nonzero(sure)[0]:
            sure_n += 1
            hit = (slb == rlb[j]) & (box_iou(rbx[j:j + 1], sbx)[0] >= MATCH_IOU) \
                if len(sbx) else np.zeros(0, bool)
            missed += int(not hit.any())
    return {"pair_iou": pair, "det_missed": float(missed), "det_sure": float(sure_n),
            "det_unmatched": float(unmatched), "det_served": float(n.sum()),
            "cross_pairs": float(cross_prog), "cross_pairs_ref": float(cross_ref)}


def readings(answers: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
             image_hw) -> Dict[str, float]:
    """The numbers compared, for one request (see the module's docstring)."""
    n = answers["n_boxes"].astype(np.int64)
    B, Q = answers["boxes"].shape[:2]
    valid = np.arange(Q)[None, :] < n[:, None]
    out = detection_readings(answers, ref, image_hw) if "detections" in ref else {}
    if valid.any():
        t_ref = ref["translation"][valid]
        scale = max(float(np.abs(t_ref).max()), 1e-12)
        dt = np.abs(answers["translation"][valid] - t_ref).max(-1) / scale
        out["pose_t"] = float(dt.max())
        out["pose_t_med"] = float(np.median(dt))
        dR = np.abs(answers["rotation"][valid] - ref["rotation"][valid]).reshape(-1, 9).max(-1)
        out["pose_R"] = float(dR.max())
        out["pose_R_med"] = float(np.median(dR))
    else:
        out["pose_t"] = out["pose_t_med"] = out["pose_R"] = out["pose_R_med"] = 0.0
    for k, v in out.items():
        if not math.isfinite(v):
            out[k] = math.inf
    return out


SUMMED = ("det_missed", "det_sure", "det_unmatched", "det_served", "cross_pairs",
          "cross_pairs_ref")


def worst(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    """The sample's readings: each request's worst, and the detector's
    shares over every sampled request (summed: one request may hold few)."""
    keys = sorted({k for r in per_request for k in r} - set(SUMMED))
    out = {k: max(r.get(k, 0.0) for r in per_request) for k in keys}
    if any("det_sure" in r for r in per_request):
        tot = {k: sum(r[k] for r in per_request) for k in SUMMED}
        out.update(det_missed=tot["det_missed"], cross_pairs_ref=tot["cross_pairs_ref"])
        out["det_missed_share"] = tot["det_missed"] / tot["det_sure"] if tot["det_sure"] else 0.0
        out["det_unmatched_share"] = (tot["det_unmatched"] / tot["det_served"]
                                      if tot["det_served"] else 0.0)
        ref = tot["cross_pairs_ref"]
        out["cross_pair_loss"] = (max(0.0, 1.0 - tot["cross_pairs"] / ref)
                                  if ref >= CROSS_MIN else 0.0)
    return out


def judge(read: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in read and read[k] <= lim for k, lim in limits.items())


def reference_training(conf, t: dict, state, batches, device, precision=None,
                       steps: int = None) -> dict:
    """The reference's (or the control's) first steps: {"loss": [per step],
    "grad": {leaf: norm of the clipped first gradient}, "change": {leaf:
    norm of the change over the steps}}."""
    from portbench.reference import train as ref_train

    m = dict(conf.model, bbox_mode=t["bbox_mode"])
    opt = t["optimizer"]
    trained = sorted(conf.poet_shapes)
    params = {k: v.detach().clone().float() for k, v in state.items()}
    p0 = {k: params[k].clone() for k in trained}
    lrs = {k: opt["lr"] * (opt["lr_linear_proj_mult"]
                           if any(n in k for n in opt["lr_linear_proj_names"]) else 1.0)
           for k in trained}
    adam, out = {}, {"loss": []}
    for s in range(steps or t["checked_steps"]):
        batch = batches[s % len(batches)]
        with torch.no_grad(), exact(precision):
            feats = None
            for rows in _blocks(batch["images"].shape[0]):
                _, f = backbone_maps(conf, params, torch.from_numpy(
                    batch["images"][rows]).to(device))
                feats = f if feats is None else [torch.cat([a, b]) for a, b in zip(feats, f)]
        with exact(precision):
            loss, _, grads = ref_train.loss_and_grads(params, trained, m, feats, batch, device)
        del feats
        ref_train.clip(grads, opt["clip_max_norm"])
        if s == 0:
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            out["grad_vec"] = {k: g.detach().float().cpu() for k, g in grads.items()}
        ref_train.adamw(params, grads, adam, lrs, opt["weight_decay"], s + 1)
        out["loss"].append(loss)
    out["change"] = {k: float((params[k] - p0[k]).norm()) for k in trained}
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> np.ndarray:
    med = float(np.median([ref[k] for k in keep])) if keep else 1.0
    return np.array([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep])


def _vector_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 keep) -> np.ndarray:
    """Per leaf: each side's vector over its own median leaf's norm (blind
    to the clip's one factor on every leaf), the L2 of their difference over
    the larger of the reference leaf's norm and the median's (1)."""
    med = lambda v: float(np.median([float(v[k].norm()) for k in keep])) if keep else 0.0
    mp, mr = med(prog), med(ref)
    if mp <= 0 or mr <= 0:
        return np.array([math.inf])
    return np.array([float((prog[k] / mp - ref[k] / mr).norm()) / max(float(ref[k].norm()) / mr, 1.0)
                     for k in keep])


def leaf_report(prog: dict, ref: dict, top: int = 6) -> dict:
    """Where grad_vec's gaps lie, for the calibration's record: the worst
    leaves, and the median gap of each kind of leaf (its name less the
    layer's number)."""
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, v in ref["grad"].items() if v >= GRAD_FLOOR * med]
    gaps = dict(zip(keep, _vector_gaps(prog["grad_vec"], ref["grad_vec"], keep)))
    kinds: Dict[str, list] = {}
    for k, v in gaps.items():
        kinds.setdefault(".".join(p for p in k.split(".") if not p.isdigit()), []).append(v)
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"worst": [[k, round(float(v), 4)] for k, v in worst],
            "kinds": {k: round(float(np.median(v)), 4) for k, v in sorted(kinds.items())}}


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    med = float(np.median(list(ref["grad"].values())))
    keep = [k for k, v in ref["grad"].items() if v >= GRAD_FLOOR * med]
    g = _leaf_gaps(prog["grad"], ref["grad"], keep)
    c = _leaf_gaps(prog["change"], ref["change"], keep)
    vec = _vector_gaps(prog["grad_vec"], ref["grad_vec"], keep)
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    first = abs(prog["loss"][0] - ref["loss"][0]) / max(abs(ref["loss"][0]), 1e-30)
    out = {"loss_gap": float(loss), "loss1_gap": float(first), "grad_gap": float(g.max()), "grad_gap_med": float(np.median(g)),
           "grad_vec": float(vec.max()), "grad_vec_med": float(np.median(vec)),
           "change_gap": float(c.max()), "change_gap_med": float(np.median(c)),
           "leaves_kept": float(len(keep)), "leaves": float(len(ref["grad"]))}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def reference_poses(conf, t: dict, state, batch: dict, device) -> np.ndarray:
    """Every decoder layer's rotations (L, B, Q, 3, 3) for a training batch,
    by the float32 reference (gt mode: the batch's own boxes)."""
    m = dict(conf.model, bbox_mode=t["bbox_mode"])
    out = []
    with torch.no_grad(), exact():
        for rows in _blocks(batch["images"].shape[0]):
            _, feats = backbone_maps(conf, state, torch.from_numpy(batch["images"][rows])
                                     .to(device))
            tt = lambda k, dt=None: torch.as_tensor(
                batch[k][rows] if dt is None else batch[k][rows].astype(dt), device=device)
            _, r = ref_poet.forward(state, m, feats, tt("boxes"), tt("labels", np.int64),
                                    tt("n_boxes", np.int64), all_layers=True)
            out.append(r.cpu().numpy())
    return np.concatenate(out, 1)
