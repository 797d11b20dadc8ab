"""The evaluation slice as a whole against `poet_tpu`, on the CPU, gt mode.

A small PoET (full-depth ResNet-50-FPN, 2 encoder / 2 decoder layers,
hidden 64, 4 heads, FFN 128, Q=10, f32) over the PoET-format dataset of
`tests/helpers.make_synthetic_dataset` (5 test images of 96x128, 1-3
objects each, 3 classes with 100-point model clouds, one symmetric): the
JAX `PoseDataset` object feeds both packages' loaders (batch 2, the last
batch padded with a dummy row). The port's seeded weights go to JAX through
the reference-checkpoint converters and come back into the port through
`load_jax_params`, so both hold one tree. JAX runs `pose_evaluate` and
`bop_evaluate` as its own tests run them on the CPU (the XLA deformable
path, the einsum ADD-S); the port runs its own on the CPU (the plain
versions). Compared: the matched pairs (class, image, poses), every
metric file, and the BOP CSV row for row except the time column.
"""

import csv
import io
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, ENC, DEC, HEADS = 2, 2, 2, 4
# poses relative to the output scale: f32 through ResNet-50 and two layers
# of each transformer stack, summed in other orders by XLA and torch (as
# tests/test_torch_slice.py)
RTOL_SCALE = 1e-4
# metric files: counts exactly; the mean errors, which average each
# package's own poses, to RTOL_SCALE of their value
METRICS = ("add/add", "adi/adds", "adds/adds", "avg_t_error/avg_t_error",
           "avg_rot_error/avg_rot_error")


def _configs(root):
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg, tcfg = PoETConfig(), flagship_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
        cfg.model.dtype = "float32"
        cfg.data.dataset_path = str(root)
    return jcfg, tcfg


# JAX's side runs in a process of its own. In a pytest worker that ran
# JAX's Pallas ADD-S kernel in interpret mode earlier
# (tests/test_torch_eval.py::test_adi_errors_match_jax[pallas]), JAX's eval
# forward failed here with "Execution supplied 408 buffers but compiled
# program expected 412"; clearing JAX's caches, its runtime tokens and the
# interpreter's shared memory did not help, so nothing is shared.
JAX_TIMEOUT_S = 600
EVALUATOR_STATE = ("classes", "num", "poses_img", "poses_gt", "poses_pred")
LOADER_KW = dict(shuffle=False, drop_last=False, pad_to_full_batch=True, num_workers=2)


def _jax_side(root: Path) -> None:
    """JAX's `pose_evaluate` and `bop_evaluate` on the tree in
    root/tree.pkl; the evaluator's state and the CSV path go to
    root/jax.pkl."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from poet_tpu.data.dataset import PoseDataset
    from poet_tpu.data.loader import PoseDataLoader as JLoader
    from poet_tpu.data.transforms import make_pose_estimation_transform
    from poet_tpu.engine import evaluate as jev
    from poet_tpu.engine.train import make_eval_forward as jforward
    from poet_tpu.evaluation import build_pose_evaluator as jbuild_evaluator
    from poet_tpu.models import build_model as jbuild

    jcfg, _ = _configs(root / "data")
    tree = pickle.loads((root / "tree.pkl").read_bytes())
    ds = PoseDataset(str(root / "data" / "test_all"),
                     str(root / "data" / "annotations" / "test.json"),
                     transforms=make_pose_estimation_transform("test"))
    jmodel = jbuild(jcfg)
    forward = jforward(jmodel, jcfg)          # one trace for both JAX loops
    jev.make_eval_forward = lambda m, c: forward
    jeval = jbuild_evaluator(jcfg)
    jev.pose_evaluate(jmodel, {"params": tree}, jeval, JLoader(ds, B, 10, **LOADER_KW),
                      jcfg, "test", output_dir=str(root / "jax"))
    jcsv = jev.bop_evaluate(jmodel, {"params": tree}, JLoader(ds, B, 10, **LOADER_KW),
                            jcfg, "test", output_dir=str(root / "jax"))
    state = {k: getattr(jeval, k) for k in EVALUATOR_STATE}
    (root / "jax.pkl").write_bytes(pickle.dumps((state, jcsv)))



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from poet_tpu.data.dataset import PoseDataset
    from poet_tpu.data.transforms import make_pose_estimation_transform
    from poet_tpu.utils.torch_import import (
        convert_poet_checkpoint,
        convert_resnet_fpn,
        state_dict_to_numpy,
    )
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine.evaluate import bop_evaluate, pose_evaluate
    from poet_tpu_torch.evaluation import build_pose_evaluator
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.helpers import make_synthetic_dataset

    root = tmp_path_factory.mktemp("eval_slice")
    make_synthetic_dataset(str(root / "data"), n_train=0, n_test=5, H=96, W=128, seed=3)
    _, tcfg = _configs(root / "data")
    sd = state_dict_to_numpy(init_weights(build_model(tcfg), seed=0).state_dict())
    tree = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    (root / "tree.pkl").write_bytes(pickle.dumps(tree))
    child = subprocess.run([sys.executable, __file__, str(root)], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                           text=True, timeout=JAX_TIMEOUT_S)
    assert child.returncode == 0, child.stdout[-4000:] + child.stderr[-4000:]
    state, jcsv = pickle.loads((root / "jax.pkl").read_bytes())
    jeval = types.SimpleNamespace(**state)

    model = load_jax_params(build_model(tcfg), tree)
    ds = PoseDataset(str(root / "data" / "test_all"),
                     str(root / "data" / "annotations" / "test.json"),
                     transforms=make_pose_estimation_transform("test"))
    teval = build_pose_evaluator(tcfg)
    pose_evaluate(model, teval, PoseDataLoader(ds, B, 10, **LOADER_KW), tcfg, "test",
                  output_dir=str(root / "port"), device="cpu")
    tcsv = bop_evaluate(model, PoseDataLoader(ds, B, 10, **LOADER_KW), tcfg, "test",
                        output_dir=str(root / "port"), device="cpu")
    return root, (jeval, jcsv), (teval, tcsv)


def _close(got, want, name, rtol=RTOL_SCALE):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol, err_msg=name)


def test_the_same_matched_pairs(runs):
    _, (jeval, _), (teval, _) = runs
    assert teval.classes == jeval.classes and teval.num == jeval.num
    assert sum(teval.num.values()) >= 5             # every gt object matched
    for c in jeval.classes:
        assert teval.poses_img[c] == jeval.poses_img[c], c
        if jeval.poses_gt[c]:
            np.testing.assert_array_equal(np.stack(teval.poses_gt[c]), np.stack(jeval.poses_gt[c]))
            _close(np.stack(teval.poses_pred[c]), np.stack(jeval.poses_pred[c]), c)


def _json_close(got, want, where):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _json_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), where
    else:
        assert abs(got - want) <= RTOL_SCALE * max(abs(want), 1e-3), f"{where}: {got} vs {want}"


def test_the_same_metric_files(runs):
    """Every metric file: the threshold counts and AUC curves exactly (they
    are counts), the summaries and mean errors to RTOL_SCALE."""
    root, _, _ = runs
    got_dir, want_dir = root / "port" / "eval_test_gt", root / "jax" / "eval_test_gt"
    for stem in METRICS:
        got = json.loads((got_dir / f"{stem}.json").read_text())
        want = json.loads((want_dir / f"{stem}.json").read_text())
        _json_close(got, want, stem)
        for cls, v in want.items():
            if isinstance(v, dict) and "threshold" in v:
                assert got[cls]["threshold"] == v["threshold"], f"{stem} {cls}"
        got_log = (got_dir / f"{stem}.log").read_text().splitlines()
        want_log = (want_dir / f"{stem}.log").read_text().splitlines()
        if stem.startswith("avg"):          # "Class: name \t\t value" lines: values to RTOL_SCALE
            assert len(got_log) == len(want_log) and got_log[:4] == want_log[:4]
            for g, w in zip(got_log[4:], want_log[4:]):
                (g_label, g_val), (w_label, w_val) = g.rsplit(None, 1), w.rsplit(None, 1)
                assert g_label == w_label
                _json_close(float(g_val), float(w_val), f"{stem}.log {w_label}")
        else:
            assert got_log == want_log, stem


def test_the_same_bop_csv(runs):
    """The CSV header and rows character for character but the time column
    and the pose numbers, which agree to RTOL_SCALE of their scale."""
    _, (_, jcsv), (_, tcsv) = runs
    assert Path(tcsv).name == Path(jcsv).name == "ycbv.csv"
    got, want = Path(tcsv).read_text().split("\n"), Path(jcsv).read_text().split("\n")
    assert got[0] == want[0] == "scene_id,im_id,obj_id,score,R,t,time"
    assert len(got) == len(want) >= 6
    for g, w in zip(got[1:], want[1:]):
        g, w = next(csv.reader(io.StringIO(g))), next(csv.reader(io.StringIO(w)))
        assert len(g) == len(w) == 7 and g[:4] == w[:4]
        for col, scale in ((4, 1.0), (5, 1000.0)):              # R, t in mm
            _close(np.array(g[col].split(), float), np.array(w[col].split(), float),
                   g[:4], rtol=RTOL_SCALE * scale)
        assert float(g[6]) > 0


def test_entry_points_default_to_the_card():
    import inspect

    from poet_tpu_torch.engine.evaluate import bop_evaluate, pose_evaluate
    from poet_tpu_torch.evaluation.pose_evaluator import PoseEvaluator, adi_errors

    for fn in (pose_evaluate, bop_evaluate, PoseEvaluator.evaluate_pose_adi,
               PoseEvaluator.evaluate_pose_adds, adi_errors):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # the evaluator holds no device of its own: pose_evaluate's is the one
    assert "device" not in inspect.signature(PoseEvaluator).parameters


def test_pose_evaluate_runs_add_s_on_its_own_device(tmp_path, monkeypatch):
    """pose_evaluate(device="cpu") runs the ADD-S passes on the CPU too."""
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine import evaluate
    from poet_tpu_torch.evaluation import pose_evaluator
    from poet_tpu_torch.flagship import EvalFixture, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    cfg = flagship_config("float32")
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
    devices = []
    adi = pose_evaluator.adi_errors
    monkeypatch.setattr(pose_evaluator, "adi_errors",
                        lambda *a, device: devices.append(torch.device(device)) or adi(
                            *a, device=device))
    data = EvalFixture(2, H=64, W=64)
    evaluate.pose_evaluate(init_weights(build_model(cfg), seed=0), data.evaluator(n_points=50),
                           PoseDataLoader(data, 2, 10, shuffle=False), cfg, "test",
                           output_dir=str(tmp_path), device="cpu")
    assert devices and all(d.type == "cpu" for d in devices)


def test_bf16_weights_are_cast_for_the_loop_and_restored(tmp_path):
    """pose_evaluate casts a bf16 model's weights at rest for its loop (as
    JAX casts its tree) and gives the caller back its f32 weights, so a
    model in training can be evaluated between epochs."""
    from poet_tpu_torch.data.loader import PoseDataLoader
    from poet_tpu_torch.engine import evaluate
    from poet_tpu_torch.flagship import EvalFixture, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    cfg = flagship_config("bfloat16")
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
    model = init_weights(build_model(cfg), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []
    forward = evaluate.make_eval_forward

    def spy(m, c):
        fwd = forward(m, c)

        def run(*args):
            seen.append(m.transformer.encoder.layers[0].linear1.weight.dtype)
            return fwd(*args)
        return run

    evaluate.make_eval_forward = spy
    try:
        data = EvalFixture(2, H=64, W=64)
        evaluate.pose_evaluate(model, data.evaluator(n_points=50),
                               PoseDataLoader(data, 2, 10, shuffle=False), cfg, "test",
                               output_dir=str(tmp_path), device="cpu")
    finally:
        evaluate.make_eval_forward = forward
    assert seen == [torch.bfloat16]
    after = model.state_dict()
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k


if __name__ == "__main__":
    _jax_side(Path(sys.argv[1]))
