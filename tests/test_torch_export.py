"""The port's export twin on the CPU: `engine/serving.py:export_model` +
`ExportedPoseServer` against `poet_tpu`'s, and the pieces that make a model
traceable by `torch.export`:

* the five kernel entries as custom operators (`torch.library.opcheck` on
  their CPU registrations: schema, fake implementation against the real
  output, autograd registration, an AOT trace with dynamic shapes, the two
  deformable ones' gradients included);
* the NMS fixed point as the `while_loop` operator against JAX's
  `nms_keep_mask` and against the host loop it replaces (hypothesis cases
  with score ties and -inf candidates), its `FIXED_POINT` counts against
  that loop's, and exported against eager; the final NMS's certificate as
  the `cond` operator, exported against eager on both branches;
* tracker mode against JAX's artifact: JAX's `tests/test_serving.py` tiny
  config at B=2, JAX's init carried to the port by `load_jax_params`,
  JAX's `export_model(..., platforms=("cpu",))` + `ExportedPoseServer`
  beside the port's `export_model` + `ExportedPoseServer(device="cpu")`,
  poses within 1e-5 (JAX's own tolerance for its artifact; with the
  aleatoric heads: tests/test_torch_export_cli.py); `stream` and
  `latency_stats`. The images
  are 128x128: at 64x64 the last pyramid level is 1x1 and its input_proj
  GroupNorm groups hold 2 values, where the two frameworks' live models
  already part by 5e-5 (the export adds nothing: the port's artifact
  equals its live model bit for bit);
* an artifact served in a fresh process that imports no model code;
* the platforms: 'tpu' refused at export, a device outside the artifact's
  platforms refused at load.

Detector mode: tests/test_torch_export_detect.py; the CLI and the
aleatoric heads: tests/test_torch_export_cli.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, HW, Q = 2, (128, 128), 5
POSE_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the custom operators
# ---------------------------------------------------------------------------

def _deform_operands(rng):
    from poet_tpu_torch.ops.deform_attn_cuda import flat_levels

    shapes = [(6, 8), (3, 4)]
    S = sum(h * w for h, w in shapes)
    Bq, Qq, H, D, L, P = 2, 5, 2, 4, 2, 2
    value = _t(rng.normal(size=(Bq, S, H, D)).astype(np.float32)).requires_grad_()
    locs = _t(rng.uniform(-0.1, 1.1, size=(Bq, Qq, H, L, P, 2)).astype(np.float32))
    attn = _t(rng.uniform(size=(Bq, Qq, H, L, P)).astype(np.float32))
    return value, flat_levels(shapes), locs.requires_grad_(), attn.requires_grad_()


def _roi_operands(rng):
    from poet_tpu_torch.ops.detection import roi_geometry

    feats = [_t(rng.normal(size=(2, 8, 10, 8)).astype(np.float32)),
             _t(rng.normal(size=(2, 4, 5, 8)).astype(np.float32))]
    xy = rng.uniform(0, 30, size=(2, 3, 2))
    boxes = _t(np.concatenate([xy, xy + rng.uniform(2, 30, size=(2, 3, 2))], -1)
               .astype(np.float32))
    geo = roi_geometry([(8, 10), (4, 5)], [4, 8], boxes, 3, 2)
    return feats, boxes, geo.level, geo.ylo, geo.yw, geo.xlo, geo.xw, 3


def _stem_operands(rng, bias, stride, padding, activation, out_dtype):
    x = _t(rng.normal(size=(2, 9, 11, 3)).astype(np.float32))
    w = _t(rng.normal(size=(3, 3, 3, 5)).astype(np.float32))
    b = _t(rng.normal(size=5).astype(np.float32)) if bias else None
    return x, w, b, stride, padding, activation, out_dtype


def _epilogue_operands(rng, dtype, activation):
    x = _t(rng.uniform(-30, 30, size=(2, 5, 7, 16)).astype(np.float32)).to(dtype)
    weight, bias, mean = (_t(rng.uniform(lo, hi, 16).astype(np.float32))
                          for lo, hi in ((0.5, 1.5), (-2, 2), (-2, 2)))
    var = _t(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    return x, weight, bias, mean, var, 1e-5, activation


OPS = {
    "ms_deform_attn": lambda rng: (*_deform_operands(rng), "merged"),
    "ms_deform_attn_dense": _deform_operands,
    "roi_align_blend": _roi_operands,
    "conv_stem": lambda rng: _stem_operands(rng, True, 2, [1, 1, 1, 1], "mish", None),
    "conv_stem_bf16": lambda rng: _stem_operands(rng, False, 1, [1, 0, 0, 1], "",
                                                 torch.bfloat16),
    "darknet_epilogue": lambda rng: _epilogue_operands(rng, torch.float32, "mish"),
    "darknet_epilogue_bf16": lambda rng: _epilogue_operands(rng, torch.bfloat16, "leaky"),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_custom_op_registration(name):
    """opcheck on the CPU registration; the CUDA one is the kernel's wrapper,
    which the card's script drives."""
    import poet_tpu_torch.ops  # noqa: F401  (registers the operators)

    op = getattr(torch.ops.poet_tpu_torch, name.removesuffix("_bf16")).default
    torch.library.opcheck(op, OPS[name](np.random.default_rng(0)))


def test_deform_entries_keep_their_gradients():
    """The two deformable entries give the plain adjoint's gradients through
    the operators' registered backward."""
    from poet_tpu_torch.ops.deform_attn import ms_deform_attn_torch
    from poet_tpu_torch.ops.deform_attn_cuda import level_pairs, ms_deform_attn
    from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense

    value, flat, locs, attn = _deform_operands(np.random.default_rng(1))
    shapes = level_pairs(flat)
    dout = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(ms_deform_attn_torch(value, shapes, locs, attn),
                               (value, locs, attn), dout)
    for entry in (lambda *a: ms_deform_attn(*a, adjoint="pair"), ms_deform_attn_dense):
        got = torch.autograd.grad(entry(value, shapes, locs, attn), (value, locs, attn), dout)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_device_tables_outlive_inference_mode_and_traces():
    """A cached table made while serving (inference mode) serves a training
    forward's autograd later; one made under a trace is not kept."""
    from torch._subclasses.fake_tensor import FakeTensor

    from poet_tpu_torch.models.transformer import _level_wh

    shapes, cpu = ((3, 4), (2, 2)), torch.device("cpu")
    _level_wh.cache_clear()
    with torch.inference_mode():
        made = _level_wh(shapes, cpu)
    assert not made.is_inference()
    x = torch.ones(2, 2, requires_grad=True)
    (x / _level_wh(shapes, cpu)).sum().backward()
    torch.testing.assert_close(x.grad, 1.0 / made, rtol=0, atol=0)

    class Scaled(torch.nn.Module):
        def forward(self, x):
            return x / _level_wh(((5, 6),), x.device)

    _level_wh.cache_clear()
    program = torch.export.export(Scaled(), (torch.ones(1, 2),))
    kept = _level_wh(((5, 6),), cpu)
    assert not isinstance(kept, FakeTensor)
    torch.testing.assert_close(program.module()(torch.ones(1, 2)), 1.0 / kept)


# ---------------------------------------------------------------------------
# the loops on the device
# ---------------------------------------------------------------------------

def _host_loop_keep(boxes, scores, iou_threshold):
    """The fixed point as the port ran it before `while_loop`: a Python loop
    reading one bool per iteration. Returns (keep, iterations)."""
    from poet_tpu_torch.ops.detection import NEG_INF, pairwise_iou_xyxy

    N = boxes.shape[-2]
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    valid = s > NEG_INF
    sup = torch.ones(N, N, dtype=torch.bool).triu(1) & (pairwise_iou_xyxy(b, b) > iou_threshold)
    k, iterations = valid, 0
    for _ in range(N):
        k_new = valid & ~(sup & k[..., :, None]).any(dim=-2)
        changed = bool((k_new != k).any())
        k, iterations = k_new, iterations + 1
        if not changed:
            break
    return torch.zeros_like(k).scatter(-1, order, k), iterations


N_CAND = 24


@st.composite
def nms_problems(draw):
    """Three problems of N_CAND boxes: coordinates on a coarse grid (exact
    duplicates and shared edges), scores from a few values (ties) with
    -inf candidates."""
    n = 3 * N_CAND
    xy = np.asarray(draw(st.lists(st.integers(0, 12), min_size=2 * n, max_size=2 * n)))
    wh = np.asarray(draw(st.lists(st.integers(1, 8), min_size=2 * n, max_size=2 * n)))
    s = draw(st.lists(st.sampled_from([-np.inf, 0.1, 0.5, 0.5, 0.9]), min_size=n, max_size=n))
    xy = xy.reshape(n, 2).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh.reshape(n, 2)], -1).reshape(3, N_CAND, 4)
    return boxes.astype(np.float32), np.asarray(s, np.float32).reshape(3, N_CAND)


@pytest.fixture(scope="module")
def jax_keep():
    from poet_tpu.ops import detection as jdet

    return jax.jit(jdet.nms_keep_mask, static_argnums=2)


@settings(max_examples=25, deadline=None)
@given(problem=nms_problems(), iou_threshold=st.sampled_from([0.3, 0.5, 0.7]))
def test_nms_while_loop_matches_jax_and_the_host_loop(jax_keep, problem, iou_threshold):
    from poet_tpu_torch.ops.detection import FIXED_POINT, nms_keep_mask

    boxes, scores = problem
    want, iterations = _host_loop_keep(_t(boxes), _t(scores), iou_threshold)
    FIXED_POINT.reset()
    got = nms_keep_mask(_t(boxes), _t(scores), iou_threshold)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (FIXED_POINT.calls, FIXED_POINT.iterations, FIXED_POINT.max_iterations) \
        == (1, iterations, iterations)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax_keep(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                                iou_threshold)))


class _Keep(torch.nn.Module):
    def forward(self, boxes, scores):
        from poet_tpu_torch.ops.detection import nms_keep_mask

        return nms_keep_mask(boxes, scores, 0.5)


def test_exported_nms_equals_eager():
    """The exported fixed point holds the loop (not an unrolled trace of the
    example's iterations): inputs that need other iteration counts give the
    eager keep sets. Tracing and the exported runs leave FIXED_POINT alone."""
    from poet_tpu_torch.ops.detection import FIXED_POINT, nms_keep_mask

    rng = np.random.default_rng(3)
    problems = []
    for n_dup in (0, 6, 12):
        xy = rng.integers(0, 10, size=(3, N_CAND, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.integers(1, 6, size=(3, N_CAND, 2))], -1)
        boxes[:, :n_dup] = boxes[:, :1]                # a chain of suppressions
        scores = rng.choice([-np.inf, 0.2, 0.6, 0.9], size=(3, N_CAND)).astype(np.float32)
        problems.append((boxes.astype(np.float32), scores))
    FIXED_POINT.reset()
    program = torch.export.export(_Keep(), (_t(problems[0][0]), _t(problems[0][1])))
    assert "while_loop" in str(program.graph)
    run = program.module()
    for boxes, scores in problems:
        torch.testing.assert_close(run(_t(boxes), _t(scores)),
                                   nms_keep_mask(_t(boxes), _t(scores), 0.5), rtol=0, atol=0)
    assert FIXED_POINT.calls == len(problems)        # the eager calls alone


class _Select(torch.nn.Module):
    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, boxes_pc, masked, labels_pc):
        return self.detector.select(boxes_pc, masked, labels_pc)


def test_exported_certificate_takes_both_branches():
    """The final NMS's certified pruned path and its exact fallback, chosen
    by the `cond` operator: an exported selection equals the eager one on a
    batch the certificate passes and on one it fails."""
    from poet_tpu_torch.models.maskrcnn import MaskRCNNDetector
    from poet_tpu_torch.ops.detection import class_nms_select_pruned

    ncls, P, md, prune_k = 4, 32, 6, 20
    det = MaskRCNNDetector(ncls, max_detections=md, nms_prune_k=prune_k, in_channels=8)
    rng = np.random.default_rng(5)
    labels = torch.arange(ncls).repeat(P)

    def batch(valid_share, one_box):
        xy = rng.uniform(0, 50, size=(2, P * ncls, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 20, size=(2, P * ncls, 2))], -1)
        if one_box:                      # every class keeps one box: fewer than md kept
            boxes[:] = boxes[:, :1]
        s = rng.uniform(size=(2, P * ncls))
        s[rng.uniform(size=s.shape) > valid_share] = -np.inf
        return _t(boxes.astype(np.float32)), _t(s.astype(np.float32))

    program = torch.export.export(_Select(det), (*batch(0.5, False), labels))
    assert "cond" in str(program.graph)
    run = program.module()
    certified = []
    # few valid candidates: nothing valid is dropped; one box per image: the
    # kept ones do not fill the top md
    for share, one_box in ((0.1, False), (0.9, True)):
        boxes, masked = batch(share, one_box)
        _, _, cert = class_nms_select_pruned(boxes, masked, labels, det.nms_thresh, md, prune_k)
        certified.append(bool(cert.all()))
        for g, w in zip(run(boxes, masked, labels), det.select(boxes, masked, labels)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert certified == [True, False]


# ---------------------------------------------------------------------------
# tracker mode against JAX's artifact
# ---------------------------------------------------------------------------

def _inputs():
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(B, *HW, 3)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.7, size=(B, Q, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.2, size=(B, Q, 2))
    labels = rng.integers(1, 5, size=(B, Q)).astype(np.int32)
    n_boxes = np.array([3, 5], np.int32)
    for b in range(B):
        boxes[b, n_boxes[b]:] = -1.0
        labels[b, n_boxes[b]:] = -1
    return images, boxes, labels, n_boxes


def _port_config(aleatoric):
    """The port's counterpart of `tests/test_model.py:tiny_config`."""
    from poet_tpu_torch.config import PoETConfig

    cfg = PoETConfig()
    cfg.backbone.name = "maskrcnn"
    m = cfg.model
    m.hidden_dim, m.nheads, m.enc_layers, m.dec_layers = 64, 4, 2, 2
    m.dim_feedforward, m.num_queries, m.n_classes, m.dropout = 128, Q, 4, 0.0
    m.dtype, m.aleatoric = "float32", aleatoric
    return cfg


def tracker_run(aleatoric, root):
    """JAX's and the port's tracker-mode artifacts of one model, served on
    `_inputs()`, and the port's live server's answer."""
    from poet_tpu.engine.serving import ExportedPoseServer as JServer, export_model as jexport
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer, export_model
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_model import tiny_config

    jcfg, tcfg = tiny_config(aleatoric=aleatoric), _port_config(aleatoric)
    images, boxes, labels, n_boxes = _inputs()
    targets = {"boxes": jnp.asarray(boxes), "labels": jnp.asarray(labels),
               "n_boxes": jnp.asarray(n_boxes)}
    params = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                        jnp.zeros((B, *HW), bool), targets)
    jpath = jexport(jcfg, params, str(root / "jax"), batch_size=B, image_size=HW,
                    platforms=("cpu",))
    want = JServer(jpath).infer(images, boxes, labels, n_boxes)
    model = load_jax_params(build_model(tcfg), jax.tree_util.tree_map(np.asarray,
                                                                       params["params"]))
    live = PoseServer(tcfg, model, batch_size=B, image_size=HW, device="cpu")
    path = export_model(tcfg, model, str(root / "port"), batch_size=B, image_size=HW,
                        platforms=("cpu",))
    server = ExportedPoseServer(path, device="cpu")
    got = server.infer(images, boxes, labels, n_boxes)
    return dict(aleatoric=aleatoric, path=path, server=server, got=got, want=want,
                live=live.infer(images, boxes, labels, n_boxes), inputs=(images, boxes, labels,
                                                                          n_boxes))


@pytest.fixture(scope="module")
def tracker(tmp_path_factory):
    return tracker_run(False, tmp_path_factory.mktemp("export"))


def check_tracker_artifact(tracker):
    """The port's artifact against JAX's (poses within POSE_ATOL, the rest
    equal) and against the port's live server (equal)."""
    got, want = tracker["got"], tracker["want"]
    keys = {"translation", "rotation", "boxes", "classes", "n_boxes"}
    if tracker["aleatoric"]:
        keys |= {"translation_var", "rotation_var"}
    assert set(got) == set(want) == keys
    assert got["translation"].shape == (B, Q, 3) and got["rotation"].shape == (B, Q, 3, 3)
    for k in ("translation", "rotation", "translation_var", "rotation_var"):
        if k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=POSE_ATOL, err_msg=k)
    for k in ("boxes", "classes", "n_boxes"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in keys:                      # the export adds nothing to the live forward
        np.testing.assert_array_equal(got[k], tracker["live"][k], err_msg=k)


def test_tracker_artifact_matches_jax_artifact(tracker):
    check_tracker_artifact(tracker)


def test_tracker_artifact_stream_and_latency_stats(tracker):
    server, (images, boxes, labels, n_boxes) = tracker["server"], tracker["inputs"]
    server.reset_latency_stats()
    streamed = list(server.stream([images, images * 0.5],
                                  boxes_fn=lambda prev: (boxes, labels, n_boxes)))
    assert len(streamed) == 2
    for k in tracker["got"]:
        np.testing.assert_array_equal(streamed[0][k], tracker["got"][k], err_msg=k)
    assert not np.array_equal(streamed[1]["translation"], streamed[0]["translation"])
    stats = server.latency_stats()
    assert stats["frames"] == 2 and stats["p95_ms"] >= stats["p50_ms"] > 0
    with pytest.raises(ValueError, match="tracker mode needs boxes"):
        server.infer(images)
    with pytest.raises(ValueError, match="images"):
        server.infer(images[:1], boxes, labels, n_boxes)


def test_artifact_runs_without_model_code(tracker):
    """A fresh process loads the artifact and answers one request; neither
    the model package nor the trainer was imported."""
    images, boxes, labels, n_boxes = tracker["inputs"]
    out = Path(tracker["path"]).parent / "request.npz"
    np.savez(out, images=images, boxes=boxes, labels=labels, n_boxes=n_boxes,
             translation=tracker["got"]["translation"])
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from poet_tpu_torch.engine.serving import ExportedPoseServer\n"
        f"r = np.load({str(out)!r})\n"
        f"s = ExportedPoseServer({tracker['path']!r}, device='cpu')\n"
        "got = s.infer(r['images'], r['boxes'], r['labels'], r['n_boxes'])\n"
        "assert np.array_equal(got['translation'], r['translation'])\n"
        "loaded = sorted(m for m in sys.modules if m.startswith(('poet_tpu_torch.models', "
        "'poet_tpu_torch.engine.train', 'jax', 'poet_tpu.')))\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout, res.stdout


# ---------------------------------------------------------------------------
# the platforms
# ---------------------------------------------------------------------------

def test_platforms_are_checked(tracker, tmp_path):
    import json

    from poet_tpu_torch.engine.serving import ExportedPoseServer, export_model

    with pytest.raises(ValueError, match="no TPU"):
        export_model(_port_config(False), torch.nn.Identity(), str(tmp_path / "x"),
                     platforms=("cpu", "tpu"))
    assert not (tmp_path / "x").exists()
    meta = json.loads((Path(tracker["path"]) / "meta.json").read_text())
    assert meta == {"batch_size": B, "image_size": list(HW), "bbox_mode": "gt",
                    "num_queries": Q, "platforms": ["cpu"], "dtype": "float32",
                    "aleatoric": False}
    with pytest.raises(ValueError, match="serves"):
        ExportedPoseServer(tracker["path"], device="cuda")
