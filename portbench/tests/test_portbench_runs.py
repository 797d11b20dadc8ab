"""Whole runs of the harness (tiny_run.py): on the CPU at a tiny size, the
result line's keys, no JAX loaded, and `correct` false with a served answer
altered where it is produced; on the card (marker `card`) at the cells' own
sizes, `correct` false with each fault of `portbench/lib/faults.py` that a
cell can have: training with half of each batch left out (the mean taken
over the rest) and with a step that leaves the state unchanged; serving
from the previous request's images; YOLO's NMS skipped or at IoU 0.9 (the
class offset lost escapes the held numbers on this traffic: PERF.md §7).
These run at the cells' sizes because the limits
are set there: at a tiny size on the CPU a sound step already reads past
them, and a tiny frame holds too few detections.

    python3 -m pytest --noconftest -m card portbench/tests/test_portbench_runs.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).with_name("tiny_run.py")
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


HELD = {w["name"] for w in json.loads(TINY.with_name("held_cells.json").read_text())["workloads"]}


def tiny(workload, trace=0, fault=None, seed=3000000017, card=False):
    cmd = [sys.executable, str(TINY)] + (["--fault", fault] if fault else []) + (
        ["--card"] if card else []) + (["--held"] if workload in HELD else []) + [
        "--", "--workload", workload, "--seed", str(seed), "--seconds", "2", "--trace", str(trace)]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("workload,trace", [("yolo-detect-b32", 0), ("yolo-detect-b32", 1),
                                            ("rcnn-track-b16", 1), ("yolo-train-b64", 0)])
def test_result_line(workload, trace):
    res, err = tiny(workload, trace)
    keys = list(res)
    assert keys[:5] == REQUIRED
    assert keys[-1] == "checks"
    assert set(keys) == set(REQUIRED) | {"checks"} | ({"breakdown"} if trace else set())
    for k, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
        assert f"check {k} = " in err.strip().splitlines()[-len(res["checks"]):][list(
            res["checks"]).index(k)]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_jax_loaded():
    """The harness refuses (exit 4) a run that loaded a module whose
    top-level name is jax, jaxlib, flax or poet_tpu, compared whole."""
    sys.path.insert(0, str(ROOT))
    from portbench import run

    before = dict(sys.modules)
    try:
        sys.modules["poet_tpu_torch_x"] = object()
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in before} & set(run.FORBIDDEN))
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for k in ("poet_tpu_torch_x", "jax.numpy"):
            sys.modules.pop(k, None)
    code = ("import sys, runpy; sys.argv = [sys.argv[0]] + sys.argv[1:];"
            "runpy.run_path(%r, run_name='__main__')" % str(TINY))
    out = subprocess.run([sys.executable, "-c", code + ";", "--held", "--", "--workload",
                          "rcnn-track-b16", "--seed", "7", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0 and "loaded" not in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("workload", ["yolo-detect-b32", "rcnn-track-b16"])
def test_altered_answer_is_not_correct(workload):
    res, _ = tiny(workload, fault="answer")
    assert res["correct"] is False, res["checks"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training faults run at the cell's own size")


@pytest.mark.card
@pytest.mark.parametrize("seed", [2800000021, 2800000022, 2800000023])
@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_training_fault_is_not_correct(card, fault, seed):
    res, _ = tiny("yolo-train-b64", fault=fault, seed=seed, card=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("fault", ["prev_frame", "nms_skip", "nms_iou"])
def test_serving_fault_is_not_correct(card, fault):
    res, _ = tiny("yolo-detect-b32", fault=fault, seed=2800000031, card=True)
    assert res["correct"] is False, res["checks"]
