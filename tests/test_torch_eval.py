"""The port's evaluation pieces against `poet_tpu`, on the CPU.

ADD-S (`adi_errors`) against JAX's einsum default and its Pallas route
(`POET_ADI_PALLAS=1`, interpret mode), poses ~1 m from the camera; ADD,
the rotation, translation and reprojection errors; `PoseEvaluator` YCB-V
and LM-O runs on the same seeded pose pairs, whose errors straddle the
thresholds, with every .log and .json compared; the error cache, the
sorted-copy class order and `build_pose_evaluator`'s shipped-asset
fallback; the PLY loader; the quaternion functions; `pad_targets` and
`PoseDataLoader` batch for batch against JAX's on one dataset object;
`parse_scene_img` and the cross-process gather (simulated, and over two
gloo processes). The port's ADD-S runs its
plain version here (`device="cpu"`); the card's kernel is held against it
by `chip_smoke.py` phases 15-16.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
# ADD-S of the port (f32 direct difference form) against JAX (f32
# expansion |g|^2 + |e|^2 - 2 g.e, both centred on the gt translation), in
# meters: the expansion's rounding, ~1e-9 m^2 on a squared distance, grows
# through the square root of a ~1 mm nearest-neighbour distance to ~1e-6 m
# on single points; the means agree far below the 1e-4 m AUC step
ADI_ATOL = 1e-6
# metric files: counts exactly; AUCs and mean errors to this
JSON_ATOL = 1e-6


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return q


def _small_rotations(rng, n, max_rad):
    """Rotations by up to `max_rad` about random axes (Rodrigues)."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, max_rad, n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    s, c = np.sin(ang)[:, None, None], np.cos(ang)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * K @ K


def _pose_pairs(rng, n, t_offsets=(0.002, 0.03)):
    """(pred, gt) (n, 3, 4): gt ~1 m in front of the camera, pred a small
    rotation and a translation offset of the given size range away."""
    R = _rotations(rng, n)
    t = np.concatenate([rng.normal(0, 0.2, (n, 2)), rng.uniform(0.8, 1.3, (n, 1))], axis=1)
    gt = np.concatenate([R, t[:, :, None]], axis=2)
    d = rng.normal(size=(n, 3))
    d *= (rng.uniform(*t_offsets, n) / np.linalg.norm(d, axis=1))[:, None]
    pred = np.concatenate([_small_rotations(rng, n, 0.1) @ R, (t + d)[:, :, None]], axis=2)
    return pred, gt


def _cloud(rng, n=257, scale=0.05):
    return rng.normal(scale=scale, size=(n, 3))


# ---------------------------------------------------------------------------
# error functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["einsum", "pallas"])
def test_adi_errors_match_jax(route, monkeypatch):
    """70 poses (two of the port's 64-pose chunks, and a padded chunk in
    both of JAX's routes) at |t| ~ 1 m, against JAX's default einsum route
    and its Pallas kernel (interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.evaluation import pose_evaluator as jpe
    from poet_tpu_torch.evaluation.pose_evaluator import adi_errors

    rng = np.random.default_rng(1)
    pts = _cloud(rng)
    pred, gt = _pose_pairs(rng, 70)
    assert np.linalg.norm(gt[:, :, 3], axis=1).min() > 0.75
    got = adi_errors(pts, pred, gt, device="cpu")
    if route == "pallas":
        monkeypatch.setenv("POET_ADI_PALLAS", "1")
        with pltpu.force_tpu_interpret_mode():
            want = jpe.adi_errors(pts, pred, gt)
    else:
        want = jpe.adi_errors(pts, pred, gt)
    assert got.dtype == np.float64 and got.shape == (70,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADI_ATOL)


def test_adi_errors_of_a_diverged_pose_are_nan_and_count_as_wrong(tmp_path):
    """A NaN pose gives a NaN ADD-S in the port as in JAX (fminf would drop
    it), and the evaluator counts it as not correct at every threshold."""
    from poet_tpu.evaluation import pose_evaluator as jpe
    from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator, adi_errors

    rng = np.random.default_rng(2)
    pts = _cloud(rng, 100)
    pred, gt = _pose_pairs(rng, 3)
    pred[1, 0, 3] = np.nan
    got = adi_errors(pts, pred, gt, device="cpu")
    want = jpe.adi_errors(pts, pred, gt)
    np.testing.assert_array_equal(np.isnan(got), [False, True, False])
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    ev = PoseEvaluator({"a": {"pts": pts}}, ["a"], {"a": {"diameter": 100.0}}, {"a": True})
    ev.record(1, pred[1, :, :3], pred[1, :, 3], gt[1, :, :3], gt[1, :, 3])
    res = ev.evaluate_pose_adi(str(tmp_path) + "/", device="cpu")
    assert res["a"]["threshold"]["0.10"] == 0.0 and sum(res["a"]["threshold"]["mean"]) == 0


def test_host_error_functions_match_jax():
    from poet_tpu.evaluation import pose_evaluator as jpe
    from poet_tpu_torch.evaluation import pose_evaluator as pe

    rng = np.random.default_rng(3)
    pts = _cloud(rng, 120)
    pred, gt = _pose_pairs(rng, 9, (0.001, 0.2))
    Ks = np.tile([600.0, 0, 320, 0, 600, 240, 0, 0, 1], (9, 1))
    for name in ("rotation_errors_deg", "translation_errors"):
        np.testing.assert_array_equal(getattr(pe, name)(pred, gt), getattr(jpe, name)(pred, gt))
    np.testing.assert_array_equal(pe.add_errors(pts, pred, gt), jpe.add_errors(pts, pred, gt))
    np.testing.assert_array_equal(pe.reprojection_errors(pts, pred, gt, Ks),
                                  jpe.reprojection_errors(pts, pred, gt, Ks))
    np.testing.assert_array_equal(pe.se3_mul(pred[0], gt[1]), jpe.se3_mul(pred[0], gt[1]))
    np.testing.assert_array_equal(pe.project_pts(pts, gt[0, :, :3], gt[0, :, 3], Ks[0]),
                                  jpe.project_pts(pts, gt[0, :, :3], gt[0, :, 3], Ks[0]))


# ---------------------------------------------------------------------------
# PoseEvaluator: the same pose pairs through both packages
# ---------------------------------------------------------------------------

CLASSES = ["obj_c", "obj_a", "obj_b"]            # not alphabetical: the report sorts a copy
SYMMETRY = {"obj_a": False, "obj_b": True, "obj_c": False}


def _evaluators(rng, diameter_relative):
    from poet_tpu.evaluation.pose_evaluator import PoseEvaluator as JPoseEvaluator
    from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator

    models = {c: {"pts": _cloud(rng, 300)} for c in CLASSES}
    info = {c: {"diameter": d} for c, d in zip(CLASSES, (150.0, 220.0, 310.0))}
    return (JPoseEvaluator(models, CLASSES, info, SYMMETRY, diameter_relative=diameter_relative),
            PoseEvaluator(models, CLASSES, info, SYMMETRY, diameter_relative=diameter_relative))


def _record_straddling(rng, evaluators):
    """Per class 40 pairs whose translation offsets straddle the absolute
    (2/5/10 cm) and the diameter-relative thresholds."""
    offsets = np.array([0.003, 0.0025, 0.0035, 0.006, 0.0075, 0.011, 0.0145, 0.0165,
                        0.019, 0.021, 0.03, 0.0305, 0.049, 0.051, 0.07, 0.099, 0.101, 0.15])
    for idx in range(1, len(CLASSES) + 1):
        pred, gt = _pose_pairs(rng, 40)
        d = pred[:, :, 3] - gt[:, :, 3]
        scale = rng.choice(offsets, 40) / np.linalg.norm(d, axis=1)
        pred[:, :, 3] = gt[:, :, 3] + d * scale[:, None]
        for p, g in zip(pred, gt):
            for ev in evaluators:
                ev.record(idx, p[:, :3], p[:, 3], g[:, :3], g[:, 3], img_file="x.png")


def _assert_json_close(got, want, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_json_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), where
    else:
        assert abs(got - want) <= JSON_ATOL, f"{where}: {got} vs {want}"


def _run_metric(ev, method, out):
    """One metric pass; the port's ADD-S passes on the CPU."""
    from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator

    if isinstance(ev, PoseEvaluator) and method in ("evaluate_pose_adi", "evaluate_pose_adds"):
        return getattr(ev, method)(out, device="cpu")
    return getattr(ev, method)(out)


METRICS = (("evaluate_pose_add", "add/add"), ("evaluate_pose_adi", "adi/adds"),
           ("evaluate_pose_adds", "adds/adds"),
           ("calculate_class_avg_translation_error", "avg_t_error/avg_t_error"),
           ("calculate_class_avg_rotation_error", "avg_rot_error/avg_rot_error"))


def assert_metric_files_equal(got_dir, want_dir):
    """Every .log equal as text, every .json equal (counts exactly, AUCs and
    means within JSON_ATOL)."""
    for _, stem in METRICS:
        assert (Path(got_dir) / f"{stem}.log").read_text() == \
            (Path(want_dir) / f"{stem}.log").read_text(), stem
        _assert_json_close(json.loads((Path(got_dir) / f"{stem}.json").read_text()),
                           json.loads((Path(want_dir) / f"{stem}.json").read_text()), stem)


@pytest.mark.parametrize("dataset", ["ycbv", "lmo"])
def test_pose_evaluator_matches_jax(dataset, tmp_path):
    rng = np.random.default_rng(4)
    jev, tev = _evaluators(rng, diameter_relative=(dataset == "lmo"))
    _record_straddling(rng, (jev, tev))
    results = {}
    for label, ev in (("jax", jev), ("port", tev)):
        out = str(tmp_path / label) + "/"
        results[label] = [_run_metric(ev, method, out) for method, _ in METRICS]
    assert_metric_files_equal(tmp_path / "port", tmp_path / "jax")
    adds = results["port"][2]
    # the pairs straddle the thresholds: neither 0 nor 100 at any of them
    assert all(0 < adds["accuracy"][k] < 100 for k in ("0.02", "0.05", "0.10"))


def test_error_cache_serves_add_s_and_record_invalidates(tmp_path, monkeypatch):
    """ADD-S launches the min distance sum over classes of ceil(P_c / 64)
    times; ADD(-S) reuses the cached vectors and launches nothing; record()
    invalidates only its class."""
    from poet_tpu_torch.evaluation.pose_evaluator import POSE_CHUNK
    from poet_tpu_torch.ops import nn_cuda

    calls = []
    plain = nn_cuda.min_dist_sq_plain
    monkeypatch.setattr(nn_cuda, "min_dist_sq_plain",
                        lambda gt, est: calls.append(gt.shape[0]) or plain(gt, est))
    rng = np.random.default_rng(5)
    _, ev = _evaluators(rng, diameter_relative=False)
    for idx, n in ((1, 70), (2, 3)):
        pred, gt = _pose_pairs(rng, n)
        for p, g in zip(pred, gt):
            ev.record(idx, p[:, :3], p[:, 3], g[:, :3], g[:, 3])
    out = str(tmp_path) + "/"
    first = ev.evaluate_pose_adi(out, device="cpu")
    assert POSE_CHUNK == 64 and sorted(calls) == [3, 6, 64]
    calls.clear()
    ev.evaluate_pose_adds(out, device="cpu")
    assert ev.evaluate_pose_adi(out, device="cpu") == first and calls == []
    ev.record(2, pred[0, :, :3], pred[0, :, 3] + 1.0, gt[0, :, :3], gt[0, :, 3])
    assert ("obj_c", "adi") in ev._err_cache and ("obj_a", "adi") not in ev._err_cache
    res = ev.evaluate_pose_adi(out, device="cpu")
    assert calls == [4] and res["obj_a"]["accuracy"]["n_poses"] == 4.0
    ev.reset()
    assert ev._err_cache == {}


def test_class_order_stable_across_epochs(tmp_path):
    """cls_idx -> name is positional; a metric pass sorts a copy, so the
    second epoch's record() still hits the first class."""
    from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator

    rng = np.random.default_rng(6)
    classes = ["obj_z", "obj_a"]
    ev = PoseEvaluator({c: {"pts": _cloud(rng, 50)} for c in classes}, classes,
                       {c: {"diameter": 100.0} for c in classes}, {c: False for c in classes})
    for epoch in range(2):
        ev.record(1, np.eye(3), np.zeros(3), np.eye(3), np.zeros(3))
        ev.evaluate_pose_add(str(tmp_path / f"e{epoch}") + "/")
        assert ev.classes == classes
    assert ev.num == {"obj_z": 2.0, "obj_a": 0.0}


def _write_ascii_ply(path, pts):
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\nend_header\n")
        for q in pts:
            f.write(f"{q[0]} {q[1]} {q[2]}\n")


def test_build_pose_evaluator_matches_jax_and_falls_back_to_the_shipped_assets(tmp_path):
    """With no annotations/ under dataset_path, both packages fall back to
    dataset_files/ (the port from its own location in the repository) and
    build the same LM-O evaluator."""
    from poet_tpu.config import PoETConfig as JConfig
    from poet_tpu.evaluation import build_pose_evaluator as jbuild
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.evaluation import build_pose_evaluator
    from poet_tpu_torch.evaluation.pose_evaluator import _resolve_asset

    rng = np.random.default_rng(7)
    (tmp_path / "models_eval").mkdir()
    classes = json.loads((ROOT / "dataset_files" / "lmo_classes.json").read_text())
    info = {}
    for cls_id in classes:
        _write_ascii_ply(tmp_path / "models_eval" / f"obj_{int(cls_id):06d}.ply",
                         rng.normal(size=(16, 3)) * 50)
        info[cls_id] = {"diameter": 150.0 + int(cls_id)}
    (tmp_path / "models_eval" / "models_info.json").write_text(json.dumps(info))
    cfgs = (JConfig(), PoETConfig())
    for cfg in cfgs:
        cfg.data.dataset, cfg.data.dataset_path = "lmo", str(tmp_path)
    assert _resolve_asset(str(tmp_path), cfgs[1].eval.class_info, "lmo_classes.json") == \
        str(ROOT / "dataset_files" / "lmo_classes.json")
    want, got = jbuild(cfgs[0]), build_pose_evaluator(cfgs[1])
    assert got.diameter_relative
    assert got.classes == want.classes and got.model_symmetry == want.model_symmetry
    assert got.models_info == want.models_info
    for c in want.classes:
        np.testing.assert_array_equal(got.models[c]["pts"], want.models[c]["pts"])


# ---------------------------------------------------------------------------
# PLY, quaternions
# ---------------------------------------------------------------------------

def _ply_bytes(kind, rng):
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    head = "element vertex 6\nproperty float x\nproperty float y\nproperty float z\n"
    if kind == "ascii with faces":
        body = "".join(f"{q[0]} {q[1]} {q[2]}\n" for q in pts) + "3 0 1 2\n3 3 4 5\n"
        return ("ply\nformat ascii 1.0\n" + head + "element face 2\n"
                "property list uchar int vertex_indices\nend_header\n" + body).encode()
    if kind == "ascii quad face":
        body = "".join(f"{q[0]} {q[1]} {q[2]}\n" for q in pts) + "4 0 1 2 3\n"
        return ("ply\nformat ascii 1.0\n" + head + "element face 1\n"
                "property list uchar int vertex_indices\nend_header\n" + body).encode()
    if kind == "truncated header":
        return b"ply\nformat ascii 1.0\nelement vertex 1\n"
    endian = "<" if kind == "binary little endian" else ">"
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    body = b"".join(struct.pack(endian + "fffBBB", *q, 10, 20, 30) for q in pts)
    return (f"ply\nformat {fmt} 1.0\n{head}property uchar red\nproperty uchar green\n"
            f"property uchar blue\nend_header\n").encode() + body


@pytest.mark.parametrize("kind", ["ascii with faces", "binary little endian",
                                  "binary big endian", "ascii quad face", "truncated header"])
def test_load_ply_matches_jax(kind, tmp_path):
    from poet_tpu.evaluation.ply import load_ply as jload
    from poet_tpu_torch.evaluation.ply import load_ply

    path = tmp_path / "m.ply"
    path.write_bytes(_ply_bytes(kind, np.random.default_rng(8)))
    if kind in ("ascii quad face", "truncated header"):
        match = "triangular" if "quad" in kind else "end_header"
        for fn in (jload, load_ply):
            with pytest.raises(ValueError, match=match):
                fn(str(path))
        return
    want, got = jload(str(path)), load_ply(str(path))
    assert sorted(got) == sorted(want) and "pts" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_quaternions_match_jax():
    from poet_tpu.utils import quaternions as JQ
    from poet_tpu_torch.utils import quaternions as Q

    rng = np.random.default_rng(9)
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q32 = q.astype(np.float32)
    R = JQ.quat2rot_np(q)
    t = torch.from_numpy
    np.testing.assert_allclose(Q.quat2rot(t(q32)).numpy(),
                               np.asarray(JQ.quat2rot(jnp.asarray(q32))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(Q.rot2quat(t(R.astype(np.float32))).numpy(),
                               np.asarray(JQ.rot2quat(jnp.asarray(R.astype(np.float32)))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(Q.quat2rot_np(q), JQ.quat2rot_np(q), rtol=0, atol=1e-15)
    np.testing.assert_allclose(Q.rot2quat_np(R), JQ.rot2quat_np(R), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Q.rot2quat_np(R), np.where(q[:, :1] < 0, -q, q), atol=1e-12)
    for name in ("quat_mult", "quat_error"):
        np.testing.assert_allclose(getattr(Q, name)(t(q32[:10]), t(q32[10:])).numpy(),
                                   np.asarray(getattr(JQ, name)(jnp.asarray(q32[:10]),
                                                                jnp.asarray(q32[10:]))),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(Q.quat_inverse(t(2 * q32)).numpy(),
                               np.asarray(JQ.quat_inverse(jnp.asarray(2 * q32))), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# batches: pad_targets and PoseDataLoader against JAX's on one dataset
# ---------------------------------------------------------------------------

def test_pad_targets_matches_jax():
    from poet_tpu.data.structures import pad_targets as jpad
    from poet_tpu_torch.data.structures import pad_targets

    rng = np.random.default_rng(10)
    items = []
    for n in (3, 0, 12):                    # 12 > Q: truncated
        items.append({"boxes": rng.uniform(size=(n, 4)), "labels": rng.integers(1, 5, n),
                      "relative_position": rng.normal(size=(n, 3)),
                      "relative_rotation": rng.normal(size=(n, 3, 3)),
                      "relative_quaternions": rng.normal(size=(n, 4)),
                      "intrinsics": rng.normal(size=(n, 9)),
                      "jitter_boxes": rng.uniform(size=(n, 4)), "image_id": 7 + n})
    for jitter in (False, True):
        want, got = jpad(items, 10, with_jitter=jitter), pad_targets(items, 10, with_jitter=jitter)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, drop_last=False, pad_to_full_batch=True),
    dict(shuffle=True, drop_last=False, process_index=0, process_count=2),
    dict(shuffle=True, drop_last=False, process_index=1, process_count=2),
    dict(shuffle=False, drop_last=True),
])
def test_loader_batches_match_jax(kwargs):
    """One dataset object (the eval fixture: 7 images, 1-10 objects each)
    through both loaders: the same batches, epoch 0 and epoch 1."""
    from poet_tpu.data.loader import PoseDataLoader as JLoader
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.flagship import EvalFixture

    data = EvalFixture(7, H=6, W=8)
    loaders = [cls(data, 3, 10, num_workers=2, **kwargs) for cls in (JLoader, PoseDataLoader)]
    assert loaders[1].steps_per_epoch() == loaders[0].steps_per_epoch()
    for epoch in (0, 1):
        want, got = (list(ld.epoch(epoch)) for ld in loaders)
        assert len(got) == len(want) == loaders[0].steps_per_epoch()
        for (gi, gm, gt), (wi, wm, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
            assert list(gt) == list(wt)
            for k in wt:
                np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
    if kwargs.get("pad_to_full_batch"):
        assert (got[-1][2]["image_id"][1:] == -1).all() and (got[-1][2]["n_boxes"][1:] == 0).all()


def test_loader_stopped_early_leaves_no_thread_behind():
    """A consumer that stops after one batch: the producer, blocked on the
    full prefetch queue, still ends."""
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.flagship import EvalFixture

    # the threads alive before, by identity: one left by an earlier test may
    # end meanwhile, which a count would take for this loader's producer
    before = set(threading.enumerate())
    it = PoseDataLoader(EvalFixture(12, H=6, W=8), 1, 10, prefetch=1, num_workers=1).epoch(0)
    next(it)
    time.sleep(0.2)                         # the producer fills the queue and blocks
    it.close()
    deadline = time.monotonic() + 20
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


# ---------------------------------------------------------------------------
# pairs: BOP paths, the cross-process gather
# ---------------------------------------------------------------------------

def test_parse_scene_img_matches_jax():
    from poet_tpu.engine.evaluate import parse_scene_img as jparse
    from poet_tpu_torch.engine.evaluate import parse_scene_img

    for path, want in (("test/000048/rgb/000123.png", (48, 123)),
                       ("train_pbr/000001/rgb/1.jpg", (1, 1)),
                       ("000002/rgb/000007.png", (2, 7)), ("weird.png", (0, 0)), ("", (0, 0)),
                       ("test/abc/rgb/x12.png", (0, 0))):
        assert parse_scene_img(path) == jparse(path) == want


@pytest.mark.parametrize("rotation_mode", ["6d", "quat"])
def test_matched_pairs_to_host_matches_jax(rotation_mode):
    """The pairs of one batch's forward outputs: the same pairs, in order,
    with quaternion outputs turned into matrices (`utils/quaternions.py`)."""
    from poet_tpu.engine.evaluate import _matched_pairs_to_host as jpairs
    from poet_tpu_torch.engine.evaluate import _matched_pairs_to_host

    rng = np.random.default_rng(13)
    Bn, Qn = 3, 10
    rot = (rng.normal(size=(Bn, Qn, 4)) if rotation_mode == "quat"
           else rng.normal(size=(Bn, Qn, 3, 3))).astype(np.float32)
    out = {"match_valid": rng.uniform(size=(Bn, Qn)) < 0.6,
           "match_tgt_idx": rng.permuted(np.tile(np.arange(Qn, dtype=np.int32), (Bn, 1)), axis=1),
           "pred_translation": rng.normal(size=(Bn, Qn, 3)).astype(np.float32),
           "pred_rotation": rot, "pred_scores": rng.uniform(size=(Bn, Qn)).astype(np.float32)}
    targets = {"relative_position": rng.normal(size=(Bn, Qn, 3)).astype(np.float32),
               "relative_rotation": rng.normal(size=(Bn, Qn, 3, 3)).astype(np.float32),
               "labels": rng.integers(1, 22, (Bn, Qn)).astype(np.int32),
               "intrinsics": rng.normal(size=(Bn, Qn, 9)).astype(np.float32),
               "image_id": np.array([4, 9, -1], np.int64)}
    want = jpairs(out, targets, rotation_mode)
    got = _matched_pairs_to_host({k: torch.from_numpy(v) for k, v in out.items()}, targets,
                                 rotation_mode)
    assert len(got) == len(want) == int(out["match_valid"].sum())
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)


def _pairs(rng, n, first_id=16_777_220, with_intr=True):
    return [dict(cls=int(rng.integers(1, 5)), image_id=first_id + i,   # ids above 2^24
                 pred_rotation=rng.normal(size=(3, 3)).astype(np.float32),
                 pred_translation=rng.normal(size=(3,)).astype(np.float32),
                 tgt_rotation=rng.normal(size=(3, 3)).astype(np.float32),
                 tgt_translation=rng.normal(size=(3,)).astype(np.float32),
                 intrinsics=rng.normal(size=(9,)).astype(np.float32) if with_intr else None,
                 score=float(rng.uniform()))
            for i in range(n)]


def test_a_simulated_two_process_merge(monkeypatch):
    """The gather hands every process both shards' pairs as they were sent
    (float64 poses, ids above 2^24, intrinsics or None), in rank order; with
    no process group it is the identity."""
    import torch.distributed as dist

    from poet_tpu_torch.engine.evaluate import gather_pairs_across_hosts

    rng = np.random.default_rng(11)
    pairs = _pairs(rng, 7, with_intr=False) + _pairs(rng, 2, first_id=5)
    for pr in pairs[:3]:
        pr["pred_rotation"] = pr["pred_rotation"].astype(np.float64) + 1e-12
    assert gather_pairs_across_hosts(pairs) is pairs        # no process group: identity
    shards = [pairs[:4], pairs[4:]]                          # ragged: 4 and 5 pairs
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "all_gather_object",
                        lambda out, obj: out.__setitem__(slice(None), shards))
    merged = gather_pairs_across_hosts(shards[0])
    assert [p["image_id"] for p in merged] == [p["image_id"] for p in pairs]
    for a, b in zip(pairs, merged):
        assert a.keys() == b.keys() and a["pred_rotation"].dtype == b["pred_rotation"].dtype
        np.testing.assert_array_equal(a["pred_rotation"], b["pred_rotation"])
        assert (a["intrinsics"] is None) == (b["intrinsics"] is None)


_GATHER_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from poet_tpu_torch.engine.evaluate import gather_pairs_across_hosts

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
pairs = [dict(cls=rank + 1, image_id=2**24 + 100 * rank + i, score=0.5,
              pred_rotation=np.eye(3) * (rank + 1) + 1e-12,
              pred_translation=np.full(3, i, np.float32),
              tgt_rotation=np.eye(3, dtype=np.float32), tgt_translation=np.zeros(3, np.float32),
              intrinsics=None) for i in range(2 + rank)]          # ragged: 2 and 3 pairs
merged = gather_pairs_across_hosts(pairs)
ids = [p["image_id"] for p in merged]
assert ids == [2**24 + i for i in (0, 1, 100, 101, 102)], ids
assert merged[3]["cls"] == 2 and merged[3]["pred_rotation"][0, 0] == 2.0 + 1e-12
assert float(merged[4]["pred_translation"][0]) == 2.0 and merged[0]["intrinsics"] is None
dist.destroy_process_group()
print("gathered", len(merged))
"""


def test_gather_across_two_gloo_processes():
    """Two processes in a gloo group: every process gets both shards, in
    rank order, ragged lengths, float64 poses and ids above 2^24 included."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER_WORKER, str(r), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "gathered 5" in out
