"""Pose evaluator: ADD / ADD-S / ADD(-S), average translation and rotation
errors. Counterpart of `poet_tpu/evaluation/pose_evaluator.py`.

Parity targets, as there:
  * evaluation_tools/pose_evaluator.py (YCB-V: absolute 2/5/10 cm
    thresholds + AUC over 0-10 cm by Simpson at 0.1 mm steps),
  * evaluation_tools/pose_evaluator_lmo.py (LM-O: diameter-relative 0.02d /
    0.05d / 0.10d thresholds),
  * the .log / .json layout of each metric directory.

ADD, the rotation and translation errors and the threshold sweeps are
numpy float64 on the host, as in the JAX package. The ADD-S nearest
neighbour is the brute-force minimum over the predicted cloud,
`ops/nn_cuda.py:min_dist_sq`: on the card the hand-written kernel, on the
CPU its plain version. Neither pads the cloud, so the ADD-S mean is over
the N real points as it stands.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

try:  # scipy >= 1.12 renamed simps -> simpson
    from scipy.integrate import simpson as _simpson
except ImportError:  # pragma: no cover
    from scipy.integrate import simps as _simpson

from poet_tpu_torch.evaluation.ply import load_ply
from poet_tpu_torch.ops.nn_cuda import min_dist_sq

_DX = 0.0001          # AUC threshold step (pose_evaluator.py:98)
_AUC_MAX = 0.1        # AUC range [0, 0.1) m
# Poses per min-distance launch. Pose chunks only bound memory: a chunk
# holds 64 (N + M) x 12 bytes of transformed clouds (23 MB at the BOP size,
# N = M = 15 000). They do not shape the grid to the card: 64 poses at
# N = 15 000 make 960 blocks of 1024 gt points, and at the 40 registers per
# thread that ptxas reports for sm_90a, 6 blocks of 256 threads fit on an
# SM (792 on the H100's 132 SMs at once), so 960 blocks take 1.2 waves and
# the busiest SM runs 8 blocks against 7.3 on average. A YCB-V class has
# ~32 poses per test pass (480 blocks, under one wave). An ADD-S pass
# launches the kernel sum over classes of ceil(P_c / 64) times.
POSE_CHUNK = 64
# the class maps and symmetry flags shipped with the repository
SHIPPED_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "dataset_files")


def add_errors(pts: np.ndarray, poses_pred: np.ndarray, poses_gt: np.ndarray) -> np.ndarray:
    """ADD for a stack of poses: the mean point distance. pts (N, 3); poses
    (P, 3, 4). Returns (P,). Parity: calc_add (pose_evaluator.py:692-712)."""
    R_p, t_p = poses_pred[:, :, :3], poses_pred[:, :, 3]
    R_g, t_g = poses_gt[:, :, :3], poses_gt[:, :, 3]
    est = np.einsum("pij,nj->pni", R_p, pts) + t_p[:, None, :]
    gt = np.einsum("pij,nj->pni", R_g, pts) + t_g[:, None, :]
    return np.linalg.norm(est - gt, axis=-1).mean(axis=-1)


def _rotate(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """R (P, 3, 3) applied to pts (N, 3) -> (P, N, 3), as elementwise
    products: a matmul would follow the process-wide TF32 flag on the card
    and round ~0.1 m coordinates to ~5e-5 m, half the AUC step."""
    return (R[:, None, :, 0] * pts[:, 0, None] + R[:, None, :, 1] * pts[:, 1, None]
            + R[:, None, :, 2] * pts[:, 2, None])


def _transform_clouds(pts: torch.Tensor, pp: torch.Tensor, pg: torch.Tensor):
    """Transformed (gt, est) clouds, centred on the gt translation.

    Subtracting t_gt from both clouds leaves every pairwise distance as it
    is but shrinks the coordinates from |t| ~ 0.5-1.5 m (camera frame) to
    the model radius ~0.1 m, so f32 keeps ~(|t|/r)^2 more of each squared
    distance (the JAX package measured 0.17 mm of error without it, at
    |t| = 0.5 m and 15k points, against the 0.1 mm AUC step)."""
    est = _rotate(pp[:, :, :3], pts) + (pp[:, :, 3] - pg[:, :, 3])[:, None, :]
    return _rotate(pg[:, :, :3], pts), est


def adi_errors(pts: np.ndarray, poses_pred: np.ndarray, poses_gt: np.ndarray,
               device="cuda") -> np.ndarray:
    """ADD-S (symmetric): the mean over the gt cloud's points of the distance
    to the nearest point of the predicted cloud, f32 on `device`. pts (N, 3);
    poses (P, 3, 4). Returns (P,) float64. Parity: calc_adi
    (pose_evaluator.py:714-739).

    Every pose chunk is enqueued before any result is read, so the host
    waits for the card once per call."""
    P = poses_pred.shape[0]
    if P == 0:
        return np.zeros((0,))
    dev = torch.device(device)
    pts_t = torch.as_tensor(np.asarray(pts, np.float32)).to(dev)
    pp = torch.as_tensor(np.asarray(poses_pred, np.float32)).to(dev)
    pg = torch.as_tensor(np.asarray(poses_gt, np.float32)).to(dev)
    means = []
    for s in range(0, P, POSE_CHUNK):
        gt, est = _transform_clouds(pts_t, pp[s:s + POSE_CHUNK], pg[s:s + POSE_CHUNK])
        means.append(torch.sqrt(min_dist_sq(gt, est)).mean(-1))
    return torch.cat(means).cpu().numpy().astype(np.float64)


def rotation_errors_deg(poses_pred: np.ndarray, poses_gt: np.ndarray) -> np.ndarray:
    """Geodesic rotation error in degrees, trace clamped to [-1, 3].
    Parity: pose_evaluator.py:584-599."""
    prod = np.einsum("pij,pkj->pik", poses_pred[:, :, :3], poses_gt[:, :, :3])
    trace = np.clip(np.trace(prod, axis1=1, axis2=2), -1.0, 3.0)
    return np.degrees(np.arccos(0.5 * (trace - 1.0)))


def translation_errors(poses_pred: np.ndarray, poses_gt: np.ndarray) -> np.ndarray:
    """L2 translation error in meters. Parity: pose_evaluator.py:538-543."""
    return np.linalg.norm(poses_pred[:, :, 3] - poses_gt[:, :, 3], axis=-1)


def se3_mul(RT1: np.ndarray, RT2: np.ndarray) -> np.ndarray:
    """Concatenate two (3, 4) [R|t] transforms. Parity: pose_evaluator.py:617-634."""
    R1, T1 = RT1[:3, :3], RT1[:3, 3:4]
    R2, T2 = RT2[:3, :3], RT2[:3, 3:4]
    out = np.zeros((3, 4), dtype=np.float64)
    out[:3, :3] = R1 @ R2
    out[:3, 3:4] = R1 @ T2 + T1
    return out


def project_pts(pts: np.ndarray, rot: np.ndarray, t: np.ndarray, K: np.ndarray) -> np.ndarray:
    """3D points -> 2D pixels. Parity: pose_evaluator.py:649-669."""
    if K.shape == (9,):
        K = K.reshape(3, 3)
    cam = K @ (rot @ pts.T + t.reshape(3, 1))
    return (cam[:2] / cam[2:3]).T


def reprojection_errors(pts: np.ndarray, poses_pred: np.ndarray,
                        poses_gt: np.ndarray, Ks: np.ndarray) -> np.ndarray:
    """Mean 2D reprojection error per pose pair. Parity: pose_evaluator.py:671-690."""
    out = []
    for pp, pg, K in zip(poses_pred, poses_gt, Ks):
        a = project_pts(pts, pp[:3, :3], pp[:, 3], np.asarray(K))
        b = project_pts(pts, pg[:3, :3], pg[:, 3], np.asarray(K))
        out.append(np.linalg.norm(a - b, axis=1).mean())
    return np.asarray(out)


class PoseEvaluator:
    """Accumulates per-class pose pairs and computes the BOP-style metrics.

    diameter_relative=False -> YCB-V evaluator (absolute thresholds);
    diameter_relative=True  -> LM-O evaluator (0.02/0.05/0.10 x diameter).
    The passes that need ADD-S (`evaluate_pose_adi`, `evaluate_pose_adds`)
    run it on their `device` argument: the card unless the caller passes
    "cpu" (`pose_evaluate` passes its own).
    """

    def __init__(self, models, classes, models_info, model_symmetry,
                 depth_scale: float = 0.1, diameter_relative: bool = False):
        self.models = models
        self.classes = list(classes)
        self.models_info = models_info
        self.model_symmetry = model_symmetry
        self.depth_scale = depth_scale
        self.diameter_relative = diameter_relative
        self.reset()

    def reset(self):
        """Parity: pose_evaluator.py:50-65."""
        self.poses_pred: Dict[str, list] = {c: [] for c in self.classes}
        self.poses_gt: Dict[str, list] = {c: [] for c in self.classes}
        self.poses_img: Dict[str, list] = {c: [] for c in self.classes}
        self.camera_intrinsics: Dict[str, list] = {c: [] for c in self.classes}
        self.num: Dict[str, float] = {c: 0.0 for c in self.classes}
        self._err_cache: Dict[tuple, np.ndarray] = {}

    def record(self, cls_idx: int, pred_rotation, pred_translation,
               tgt_rotation, tgt_translation, img_file: str = "", intrinsics=None):
        """Store one matched pair. cls_idx is the 1-based label (engine.py:146)."""
        cls = self.classes[int(cls_idx) - 1]
        self.poses_pred[cls].append(
            np.concatenate([pred_rotation, np.reshape(pred_translation, (3, 1))], axis=1))
        self.poses_gt[cls].append(
            np.concatenate([tgt_rotation, np.reshape(tgt_translation, (3, 1))], axis=1))
        self.poses_img[cls].append(img_file)
        self.num[cls] += 1
        self.camera_intrinsics[cls].append(intrinsics)
        self._err_cache.pop((cls, "add"), None)
        self._err_cache.pop((cls, "adi"), None)

    def _thresholds(self, cls_name: str) -> np.ndarray:
        if self.diameter_relative:
            d = self.models_info[cls_name]["diameter"] / 1000.0  # mm -> m
            return np.array([0.02, 0.05, 0.10]) * d
        return np.array([0.02, 0.05, 0.10])

    def _class_errors(self, cls_name: str, method: str, device) -> np.ndarray:
        # Memoized across metric passes: ADD(-S) reuses the ADD and ADD-S
        # vectors of each class, so its pass computes (and launches) nothing
        # new. record()/reset() invalidate.
        key = (cls_name, method)
        if key in self._err_cache:
            return self._err_cache[key]
        pred = np.asarray(self.poses_pred[cls_name], dtype=np.float64)
        gt = np.asarray(self.poses_gt[cls_name], dtype=np.float64)
        if len(pred) == 0:
            errors = np.zeros((0,))
        else:
            pts = np.asarray(self.models[cls_name]["pts"], dtype=np.float64)
            errors = (add_errors(pts, pred, gt) if method == "add"
                      else adi_errors(pts, pred, gt, device=device))
        self._err_cache[key] = errors
        return errors

    def evaluate_pose_add(self, output_path: str):
        return self._evaluate(output_path, "add", "add", "Metric ADD", lambda cls: "add", None)

    def evaluate_pose_adi(self, output_path: str, device="cuda"):
        return self._evaluate(output_path, "adi", "adds", "Metric ADD-S", lambda cls: "adi",
                              device)

    def evaluate_pose_adds(self, output_path: str, device="cuda"):
        return self._evaluate(output_path, "adds", "adds", "Metric ADD(-S)",
                              lambda cls: "adi" if self.model_symmetry[cls] else "add", device)

    def _evaluate(self, output_path, dir_name, file_stem, title, method_for, device):
        """Shared threshold/AUC/report pass (pose_evaluator.py:67-218)."""
        output_dir = os.path.join(output_path, dir_name) + "/"
        if os.path.exists(output_dir):
            shutil.rmtree(output_dir)
        os.makedirs(output_dir)
        log_file = open(output_dir + f"{file_stem}.log", "w")
        json_file = open(output_dir + f"{file_stem}.json", "w")
        log_file.write("\n* {} *\n {:^}\n* {} *\n".format("-" * 100, title, "-" * 100))

        # A sorted COPY for the report's layout: self.classes is the
        # positional cls_idx -> name map record() indexes into, and the
        # reference's in-place sort (pose_evaluator.py:106) would misattribute
        # every later epoch's poses whenever classes.json is not alphabetical.
        classes = sorted(self.classes)
        n_classes = len(classes)
        auc_grid = np.arange(0, _AUC_MAX, _DX)
        results = {"thresholds": [0.02, 0.05, 0.10]}

        count_all = np.zeros(n_classes)
        acc = {k: np.zeros(n_classes) for k in ("0.02", "0.05", "0.10", "auc")}

        for i, cls in enumerate(classes):
            errors = self._class_errors(cls, method_for(cls), device)
            n_poses = len(errors)
            count_all[i] = n_poses
            th = self._thresholds(cls)
            correct = [(errors < t).sum() for t in th]
            # (n_poses, n_thresh) comparisons -> counts
            correct_curve = (errors[:, None] < auc_grid[None, :]).sum(0).astype(np.float64)
            results[cls] = {
                "threshold": {
                    "0.02": float(correct[0]),
                    "0.05": float(correct[1]),
                    "0.10": float(correct[2]),
                    "mean": correct_curve.tolist(),
                }
            }
            if n_poses == 0:
                continue
            area = _simpson(correct_curve / n_poses, dx=_DX) / _AUC_MAX
            acc["auc"][i] = area * 100
            for key, c in zip(("0.02", "0.05", "0.10"), correct):
                acc[key][i] = 100.0 * c / n_poses
            log_file.write(f"** {cls} **")
            log_file.write("threshold=[0.0, 0.10], area: {:.2f}\n".format(acc["auc"][i]))
            for key, c in zip(("0.02", "0.05", "0.10"), correct):
                log_file.write(
                    "threshold={}, correct poses: {}, all poses: {}, accuracy: {:.2f}\n".format(
                        key, float(c), count_all[i], acc[key][i]))
            log_file.write("\n")
            results[cls]["accuracy"] = {
                "n_poses": float(count_all[i]),
                "0.02": acc["0.02"][i],
                "0.05": acc["0.05"][i],
                "0.10": acc["0.10"][i],
                "auc": acc["auc"][i],
            }

        num_valid = n_classes
        log_file.write("=" * 30 + "\n")
        log_file.write(f"---------- {title} performance over {num_valid} classes -----------\n")
        summary = {}
        for key in ("0.02", "0.05", "0.10", "auc"):
            summary[key] = float(acc[key].sum() / num_valid) if num_valid else float("nan")
            log_file.write("threshold={}, mean accuracy: {:.2f}\n".format(key, summary[key]))
        results["accuracy"] = summary
        log_file.write("=" * 30 + "\n")
        log_file.close()
        json.dump(results, json_file)
        json_file.close()
        return results

    def calculate_class_avg_translation_error(self, output_path: str):
        """Parity: pose_evaluator.py:514-559."""
        return self._avg_error(output_path, "avg_t_error", translation_errors,
                               "Metric Average Translation Error in Meters")

    def calculate_class_avg_rotation_error(self, output_path: str):
        """Parity: pose_evaluator.py:561-615."""
        return self._avg_error(output_path, "avg_rot_error", rotation_errors_deg,
                               "Metric Average Rotation Error in Degrees")

    def _avg_error(self, output_path, dir_name, err_fn, title):
        output_dir = os.path.join(output_path, dir_name) + "/"
        if os.path.exists(output_dir):
            shutil.rmtree(output_dir)
        os.makedirs(output_dir)
        log_file = open(output_dir + f"{dir_name}.log", "w")
        json_file = open(output_dir + f"{dir_name}.json", "w")
        log_file.write("\n* {} *\n {:^}\n* {} *\n".format("-" * 100, title, "-" * 100))

        all_errors = []
        avg: Dict[str, float] = {}
        for cls in self.classes:
            pred = np.asarray(self.poses_pred[cls], dtype=np.float64)
            gt = np.asarray(self.poses_gt[cls], dtype=np.float64)
            if len(pred):
                errs = err_fn(pred, gt)
                avg[cls] = float(np.sum(errs) / len(errs))
                all_errors.extend(errs.tolist())
            else:
                avg[cls] = float("nan")
            log_file.write("Class: {} \t\t {}\n".format(cls, avg[cls]))
        total = float(np.sum(all_errors) / len(all_errors)) if all_errors else float("nan")
        log_file.write("All:\t\t\t\t\t {}\n".format(total))
        avg["mean"] = [total]
        log_file.close()
        json.dump(avg, json_file)
        json_file.close()
        return avg


# ---------------------------------------------------------------------------
# Bootstrap (parity: evaluation_tools/pose_evaluator_init.py)
# ---------------------------------------------------------------------------

def load_classes(path: str) -> Dict[str, str]:
    with open(path) as f:
        return json.load(f)


def load_models(models_path: str, classes: Dict[str, str]):
    """Load PLY clouds (scaled mm -> m) and the models_info.json diameters.
    Parity: pose_evaluator_init.py:36-54."""
    with open(os.path.join(models_path, "models_info.json")) as f:
        info_data = json.load(f)
    models, models_info = {}, {}
    for cls_id, name in classes.items():
        model = load_ply(os.path.join(models_path, f"obj_{int(cls_id):06d}.ply"))
        model["pts"] = model["pts"] / 1000.0
        models[name] = model
        models_info[name] = info_data[cls_id]
    return models, models_info


def load_model_symmetry(path: str, classes: Dict[str, str]) -> Dict[str, bool]:
    with open(path) as f:
        sym = json.load(f)
    return {name: sym[name] for name in classes.values()}


def _resolve_asset(dataset_path: str, rel: str, shipped: str) -> str:
    """An evaluator asset's path: dataset_path + the flag's value (the
    reference's join, pose_evaluator_init.py:15-21), else the flag's value
    alone, else the asset shipped under SHIPPED_ASSETS (dataset_files/ at
    the root of the repository that holds this package); else the joined
    path, so that the error names it."""
    joined = dataset_path + rel
    for cand in (joined, rel, os.path.join(SHIPPED_ASSETS, shipped)):
        if cand and os.path.exists(cand):
            return cand
    return joined


def build_pose_evaluator(cfg) -> PoseEvaluator:
    """Parity: pose_evaluator_init.py:73-92 (driven by the config)."""
    ds = cfg.data.dataset
    classes = load_classes(_resolve_asset(
        cfg.data.dataset_path, cfg.eval.class_info, f"{ds}_classes.json"))
    models, models_info = load_models(cfg.data.dataset_path + cfg.eval.models_path, classes)
    symmetry = load_model_symmetry(_resolve_asset(
        cfg.data.dataset_path, cfg.eval.model_symmetry, f"{ds}_symmetries.json"), classes)
    return PoseEvaluator(models, [classes[k] for k in classes], models_info, symmetry,
                         diameter_relative=(ds == "lmo"))
