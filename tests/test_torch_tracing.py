"""The program's spans (`poet_tpu_torch/utils/tracing.py`) on the CPU.

Without a profiler a span is the shared no-op and nothing is recorded. Under
`torch.profiler` (CPU activity): a detector-mode `PoseServer` request of
the YOLO slice (the mini cfg of `tests/test_torch_yolov4.py`) and of the
Mask R-CNN slice (`flagship.detector_state_dict`'s weights at 128x160)
records the serving, model and NMS spans in order, under their parents and
of one request, answers what the untraced request answered, and every
`aten::` event lies wholly inside `serve.forward` or wholly outside it (one
clock); the fixed points' `iterations` are `FIXED_POINT`'s. A tracker-mode
request and one train step record theirs, the step's metrics and weights
equal to the untraced step's. An export under the profiler records nothing
and its graph holds no span; the exported server records its own. The
CLI's `--profile_dir` writes the spans beside its trace.
"""

import copy
import json
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poet_tpu_torch.utils import tracing
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_yolov4 import B, CONF, H_IMG, MINI_CFG, W_IMG

RCNN_HW = (128, 160)
RCNN_CLASSES, RCNN_PROPOSALS, RCNN_DETECTIONS = 4, 32, 10

SERVE = ["serve.request", "serve.upload", "serve.forward"]
DETECTOR_SPANS = {
    "yolo": SERVE + ["backbone.body", "detector.decode", "detector.select", "transformer",
                     "serve.fetch"],
    # the RPN's proposals, then the final per-class selection
    "rcnn": SERVE + ["backbone.body", "detector.select", "detector.select", "transformer",
                     "serve.fetch"],
}


def _small(cfg):
    cfg.model.enc_layers = cfg.model.dec_layers = 2
    cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, 4, 128
    cfg.model.dtype, cfg.model.dropout = "float32", 0.0
    return cfg


@pytest.fixture(scope="module")
def yolo_cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "mini.cfg"
    path.write_text(MINI_CFG)
    return str(path)


def _yolo(cfg_path, bbox_mode):
    from poet_tpu_torch.flagship import yolo_detect_pose_config, yolo_detect_pose_model

    cfg = _small(yolo_detect_pose_config("float32"))
    cfg.backbone.cfg_path = cfg_path
    cfg.backbone.conf_thresh, cfg.backbone.max_detections = CONF, 8
    cfg.model.bbox_mode = bbox_mode
    cfg.model.num_queries, cfg.model.n_classes, cfg.model.num_feature_levels = 5, 4, 3
    return cfg, yolo_detect_pose_model(cfg)


def _rcnn():
    from poet_tpu_torch.flagship import detect_pose_config, detect_pose_model

    cfg = _small(detect_pose_config("float32"))
    cfg.model.n_classes = RCNN_CLASSES - 1
    cfg.backbone.post_nms_top_n = RCNN_PROPOSALS
    cfg.backbone.max_detections = RCNN_DETECTIONS
    return cfg, detect_pose_model(cfg)


def _server(cfg, model, hw=(H_IMG, W_IMG)):
    from poet_tpu_torch.engine.serving import PoseServer

    return PoseServer(cfg, model, batch_size=B, image_size=hw, device="cpu")


def _images(hw=(H_IMG, W_IMG)):
    return np.random.default_rng(5).uniform(size=(B, *hw, 3)).astype(np.float32)


def _tracker_inputs(Q=5):
    boxes = np.full((B, Q, 4), -1.0, np.float32)
    boxes[:, :2] = [[0.4, 0.5, 0.3, 0.2], [0.6, 0.4, 0.2, 0.3]]
    labels = np.full((B, Q), -1, np.int32)
    labels[:, :2] = [1, 3]
    return boxes, labels, np.full(B, 2, np.int32)


def _traced(fn):
    """fn() under a CPU profiler, the recorder emptied first: (its result,
    the records, the profiler)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    records = tracing.recorded()
    tracing.clear()
    return out, records, prof


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_untraced_calls_record_nothing_and_make_no_span(yolo_cfg_path, monkeypatch):
    assert tracing.span("x") is tracing.NO_SPAN and not tracing.NO_SPAN
    tracing.clear()

    def refuse(*args, **kwargs):
        raise AssertionError("a span object was made without a profiler")

    monkeypatch.setattr(tracing, "Span", refuse)
    server = _server(*_yolo(yolo_cfg_path, "backbone"))
    server.infer(_images())
    assert tracing.recorded() == [] and tracing.dropped() == 0


def test_recorder_links_units_counts_bound_and_threads(monkeypatch):
    def work():
        with tracing.span("a", unit=7) as a:
            with tracing.span("b", bytes=2) as b:
                b.add(bytes=3, n=1)
                b.add(n=1)
            tracing.traced("c")(lambda: None)()
        return a

    _, recs, _ = _traced(work)
    assert [(r["name"], r["parent"], r["unit"], r["counts"]) for r in recs] == [
        ("a", None, 7, {}), ("b", 0, 7, {"bytes": 5, "n": 2}), ("c", 0, 7, {})]
    assert recs[0]["start_ns"] <= recs[1]["start_ns"] <= recs[1]["end_ns"] \
        <= recs[2]["start_ns"] <= recs[2]["end_ns"] <= recs[0]["end_ns"]

    # each thread its own stack: a span open on one is no parent on another
    def thread_work():
        with tracing.span("outer", unit=1):
            t = threading.Thread(target=lambda: tracing.span("other").__enter__().__exit__())
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()

    _, recs, _ = _traced(thread_work)
    assert {r["name"]: r["parent"] for r in recs} == {"outer": None, "other": None}

    # the buffer keeps the newest records and counts the others
    monkeypatch.setattr(tracing, "_buffer", deque(maxlen=3))
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("top", unit=0):
            for i in range(4):
                with tracing.span(f"s{i}"):
                    pass
    recs = tracing.recorded()
    assert [r["name"] for r in recs] == ["s1", "s2", "s3"] and tracing.dropped() == 2
    assert [r["parent"] for r in recs] == [None] * 3 and [r["unit"] for r in recs] == [0] * 3
    tracing.clear()
    assert tracing.recorded() == [] and tracing.dropped() == 0

    # nothing while a program is exported
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    _, recs, _ = _traced(work)
    assert recs == []


@pytest.fixture(scope="module")
def detector_servers(yolo_cfg_path):
    return {"yolo": (_server(*_yolo(yolo_cfg_path, "backbone")), (H_IMG, W_IMG)),
            "rcnn": (_server(*_rcnn(), hw=RCNN_HW), RCNN_HW)}


@pytest.mark.parametrize("detector", ["yolo", "rcnn"])
def test_detector_request_spans(detector_servers, detector):
    from poet_tpu_torch.ops.detection import FIXED_POINT

    server, hw = detector_servers[detector]
    images = _images(hw)
    want = server.infer(images)
    iterations = FIXED_POINT.iterations
    got, recs, prof = _traced(lambda: server.fetch(server.infer_async(images)))
    _assert_same(got, want)

    nms = [r for r in recs if r["name"] == "nms.fixed_point"]
    assert nms and all(recs[r["parent"]]["name"] == "detector.select" for r in nms)
    assert sum(r["counts"]["iterations"] for r in nms) == FIXED_POINT.iterations - iterations
    rest = [r for r in recs if r["name"] != "nms.fixed_point"]
    assert [r["name"] for r in rest] == DETECTOR_SPANS[detector]
    index = {id(r): i for i, r in enumerate(recs)}
    request, forward = index[id(rest[0])], index[id(rest[2])]
    parents = [recs[index[id(r)]]["parent"] for r in rest]
    assert parents == [None, request, request] + [forward] * (len(rest) - 4) + [None]
    assert {r["unit"] for r in recs} == {server._requests - 1}
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    assert rest[1]["counts"] == {"bytes": images.nbytes}
    assert rest[-1]["counts"] == {"bytes": sum(v.nbytes for v in got.values())}

    # one clock: no aten event straddles the forward's edges, every conv is inside
    fw = rest[2]
    aten = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    inside = [e for e in aten if fw["start_ns"] <= e.start_ns() and e.end_ns() <= fw["end_ns"]]
    outside = [e for e in aten if e.end_ns() <= fw["start_ns"] or e.start_ns() >= fw["end_ns"]]
    assert len(inside) + len(outside) == len(aten) and inside and outside
    convs = [e for e in aten if e.name() == "aten::convolution"]
    assert convs and all(e in inside for e in convs)


@pytest.mark.parametrize("cfg, hw, counts", [
    ("mini", (H_IMG, W_IMG), (2, 5, 3)),
    # 256x256 puts the third entry conv (32->64 at 128x128) on the stem too
    ("shipped", (256, 256), (3, 109, 3))])
def test_darknet_body_routes_and_span_counts(cfg, hw, counts, monkeypatch):
    """Every BN conv with a mish, leaky or linear activation that the stem
    does not take goes through the epilogue operator, every other conv but
    the stem's the plain path, and the `backbone.body` span counts both
    (the shipped cfg: 109 and 3)."""
    from poet_tpu_torch.models import yolov4
    from tests.test_torch_yolov4 import SHIPPED, _frozen

    text = MINI_CFG if cfg == "mini" else SHIPPED[0].read_text()
    body = yolov4.DarknetBody(_frozen(text)).eval()
    seen = {"stem": [], "epilogue": []}
    for route in seen:
        fn = getattr(yolov4.DarknetBody, f"_{route}")
        monkeypatch.setattr(yolov4.DarknetBody, f"_{route}",
                            lambda self, li, *a, fn=fn, route=route:
                            seen[route].append(li) or fn(self, li, *a))
    images = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(1, *hw, 3)).astype(np.float32))
    with torch.no_grad():
        _, recs, _ = _traced(lambda: body(images))
    convs = {li: yolov4._conv_geometry(sec) for li, sec in enumerate(body.sections[1:])
             if sec["type"] == "convolutional"}
    bn_convs = [li for li, g in convs.items()
                if g[4] and g[5] in ("mish", "leaky", "linear") and li not in seen["stem"]]
    assert seen["epilogue"] == bn_convs
    assert (len(seen["stem"]), len(bn_convs), len(convs) - len(bn_convs) - len(seen["stem"])) \
        == counts
    assert [(r["name"], r["counts"]) for r in recs] == [
        ("backbone.body", {"epilogue": counts[1], "plain": counts[2]})]


def test_tracker_request_spans(yolo_cfg_path):
    server = _server(*_yolo(yolo_cfg_path, "gt"))
    images, inputs = _images(), _tracker_inputs()
    want = server.infer(images, *inputs)
    got, recs, _ = _traced(lambda: server.fetch(server.infer_async(images, *inputs)))
    _assert_same(got, want)
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("serve.request", None), ("serve.upload", 0), ("serve.forward", 0),
        ("backbone.body", 2), ("transformer", 2), ("serve.fetch", None)]
    assert {r["unit"] for r in recs} == {1}
    assert recs[1]["counts"] == {"bytes": images.nbytes + sum(x.nbytes for x in inputs)}


def test_train_step_spans_and_metrics(yolo_cfg_path):
    from poet_tpu_torch.engine.train import (
        fetch_metrics, make_optimizer, make_train_step, prepare_batch,
    )

    cfg, model = _yolo(yolo_cfg_path, "gt")
    boxes, labels, n_boxes = _tracker_inputs()
    rng = np.random.default_rng(3)
    targets = {"boxes": boxes, "labels": labels, "n_boxes": n_boxes,
               "relative_position": rng.normal(size=(B, 5, 3)).astype(np.float32),
               "relative_rotation": np.tile(np.eye(3, dtype=np.float32), (B, 5, 1, 1))}
    batch = (_images(), np.zeros((B, H_IMG, W_IMG), bool), targets)
    runs = []
    for m in (copy.deepcopy(model), model):          # the traced one's optimizer is the newest
        opt = make_optimizer(cfg, m, steps_per_epoch=10)
        step = make_train_step(m, cfg, opt)
        runs.append((m, lambda step=step: fetch_metrics(step(*prepare_batch(
            cfg, *batch, "cpu"), None))))
    want = runs[0][1]()
    got, recs, _ = _traced(runs[1][1])
    assert got == want
    for (n, p), q in zip(runs[1][0].named_parameters(), runs[0][0].parameters()):
        assert torch.equal(p, q), n
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("train.prepare", None), ("train.match", 0), ("train.upload", 0),
        ("train.step", None), ("train.forward", 3), ("backbone.body", 4), ("transformer", 4),
        ("train.backward", 3), ("train.optimizer", 3), ("train.fetch", None)]
    assert [r["unit"] for r in recs[:-1]] == [0] * 9 and recs[-1]["unit"] is None
    assert recs[2]["counts"]["bytes"] == sum(x.nbytes for x in batch[:2]) + sum(
        np.asarray(v).nbytes for v in targets.values()) + B * 5 * (4 + 1)  # the match


def test_export_records_no_span_and_the_exported_server_records_its_own(yolo_cfg_path,
                                                                        tmp_path):
    from poet_tpu_torch.engine.serving import ExportedPoseServer, export_model

    cfg, model = _yolo(yolo_cfg_path, "gt")
    path, recs, _ = _traced(lambda: export_model(cfg, model, str(tmp_path / "art"),
                                                 batch_size=B, image_size=(H_IMG, W_IMG),
                                                 platforms=("cpu",)))
    assert recs == []
    program = torch.export.load(f"{path}/module.pt2")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "tracing" in t or "time" in t]

    server = ExportedPoseServer(path, device="cpu")
    images, inputs = _images(), _tracker_inputs()
    want = server.infer(images, *inputs)
    got, recs, _ = _traced(lambda: server.fetch(server.infer_async(images, *inputs)))
    _assert_same(got, want)
    assert [(r["name"], r["parent"], r["unit"]) for r in recs] == [
        ("serve.request", None, 1), ("serve.upload", 0, 1), ("serve.forward", 0, 1),
        ("serve.fetch", None, 1)]


def test_cli_profile_dir_writes_the_spans_beside_the_trace(tmp_path, monkeypatch):
    from poet_tpu_torch import cli
    from tests.helpers import make_synthetic_dataset
    from tests.test_torch_cli import SMALL

    monkeypatch.chdir(tmp_path)             # the evaluation writes its files here
    data = make_synthetic_dataset(str(tmp_path / "data"))
    prof = tmp_path / "prof"
    cli.run(["--dataset_path", data, "--epochs", "1", "--profile_dir", str(prof),
             "--eval_interval", "5", "--device", "cpu"] + SMALL)
    trace = json.loads((prof / "trace.json").read_text())
    recs = [json.loads(line) for line in (prof / "spans.jsonl").read_text().splitlines()]
    names = [r["name"] for r in recs]
    # 8 train images, batches of 4: two steps
    assert names.count("train.prepare") == names.count("train.step") == 2
    assert {r["unit"] for r in recs if r["name"] == "train.step"} == {0, 1}
    assert all(r["start_ns"] <= r["end_ns"] for r in recs)
    assert trace["traceEvents"]
