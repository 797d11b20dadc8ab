"""The Mask R-CNN detect+pose slice against `poet_tpu`, on the CPU at f32.

Detector: the seeded, well-conditioned torchvision-named weights of
`tests/test_detector_numeric_parity.py` load into the port through its
state_dict and into JAX through `utils/torch_import`; 2 images of 128x160,
4 detector classes, 32 proposals, 10 detections. JAX runs the Pallas
RoIAlign kernel (`POET_ROI_IMPL=pallas`, interpret mode). Compared: every
FPN level (strides 4 to 64), the RPN head outputs, the proposals (against
the independent torch oracle of that test file) and the final rows, with
its rank-flip-robust matcher (score 1e-4, box 5e-3 px).

Detect+pose: JAX `build_model` + `init` in bbox_mode='backbone' (2
encoder / 2 decoder layers, hidden 64) with the detector's weights above,
loaded into the port with `load_jax_params`. Compared: the selected queries
(boxes, classes, scores, n_boxes); every decoder layer's poses within 1e-4
of scale when the port's PoET takes JAX's selected queries as its
detections, and within 1e-3 on the port's own detections (their boxes
differ from JAX's by ~5e-4 px, f32 through ResNet-50 and the heads in
other orders, and the 6D Gram-Schmidt of the small random-init rotation
outputs amplifies that); and `PoseServer` detector mode (`infer`, and
`stream`'s order).
"""

import ast
import inspect
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

B, H_IMG, W_IMG, NCLS, POST, DETS = 2, 128, 160, 4, 32, 10
ENC, DEC, HEADS = 2, 2, 4
LEVELS = ("0", "1", "2", "3", "pool")
RTOL_SCALE = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    from tests.test_detector_numeric_parity import _rcnn_state_dict

    return _rcnn_state_dict(num_classes=NCLS)


def test_flagship_detector_weights_are_the_parity_tests_draws(weights):
    """`flagship.detector_state_dict` (what chip_smoke.py loads) draws
    exactly the JAX numeric-parity test's weights."""
    from poet_tpu_torch.flagship import detector_state_dict

    ours = detector_state_dict(num_classes=NCLS)
    assert list(ours) == list(weights)
    for k, v in weights.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def features(weights, images):
    """FPN levels of both packages on the same images and weights."""
    from poet_tpu.models.resnet_fpn import ResNetFPN as JResNetFPN
    from poet_tpu.utils.torch_import import convert_resnet_fpn
    from poet_tpu_torch.models.resnet_fpn import ResNetFPN

    jf = jax.jit(JResNetFPN().apply)({"params": convert_resnet_fpn(weights)},
                                     jnp.asarray(images))
    port = ResNetFPN()                       # levels=None: every level, strides 4..64
    port.load_state_dict({k[len("backbone."):]: _t(v) for k, v in weights.items()
                          if k.startswith("backbone.")})
    with torch.no_grad():
        tf = port(_t(images))
    return {k: np.asarray(v) for k, v in jf.items()}, {k: v.numpy() for k, v in tf.items()}


def _assert_close(got, want, name, rtol=RTOL_SCALE):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol, err_msg=name)


def test_fpn_builds_and_matches_every_level(features):
    jf, tf = features
    assert sorted(tf) == sorted(LEVELS)
    for k, stride in zip(LEVELS, (4, 8, 16, 32, 64)):
        assert tf[k].shape == (B, -(-H_IMG // stride), -(-W_IMG // stride), 256), k
        _assert_close(tf[k], jf[k], f"level {k}", rtol=2e-5)


def test_rpn_head_matches_jax(weights, features):
    from poet_tpu.models.maskrcnn import RPNHead as JRPNHead
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads
    from poet_tpu_torch.models.maskrcnn import RPNHead

    jf, _ = features
    feats = [jf[k] for k in LEVELS]
    jl, jd = JRPNHead(3).apply({"params": convert_maskrcnn_heads(weights)["rpn_head"]},
                               [jnp.asarray(f) for f in feats])
    head = RPNHead()
    head.load_state_dict({k[len("rpn.head."):]: _t(v) for k, v in weights.items()
                          if k.startswith("rpn.head.")})
    with torch.no_grad():
        tl, td = head([_t(f) for f in feats])
    for li in range(len(LEVELS)):
        _assert_close(tl[li].numpy(), np.asarray(jl[li]), f"logits {li}")
        _assert_close(td[li].numpy(), np.asarray(jd[li]), f"deltas {li}")


def _port_detector(weights, **kw):
    from poet_tpu_torch.models.maskrcnn import MaskRCNNDetector

    det = MaskRCNNDetector(NCLS, **kw).eval()
    det.load_state_dict({k: _t(v) for k, v in weights.items()
                         if k.startswith(("rpn.", "roi_heads."))})
    return det


def test_proposals_match_the_torch_oracle(weights, features):
    """Per image, the port's valid proposals are the oracle's
    (torchvision filter_proposals, per-image loops), score for score."""
    from tests.test_detector_numeric_parity import _assert_rows_match, t_rpn

    jf, _ = features
    det = _port_detector(weights, post_nms_top_n=1000)
    feats = [_t(jf[k]) for k in LEVELS]
    grids = [tuple(f.shape[1:3]) for f in feats]
    strides = [(H_IMG // g[0], W_IMG // g[1]) for g in grids]
    with torch.no_grad():
        logits, deltas = det.rpn["head"](feats)
        boxes, scores = det.proposals(logits, deltas, det.anchors(grids, strides, "cpu"),
                                      (H_IMG, W_IMG))
        for b in range(B):
            tfeats = {k: _t(jf[k][b:b + 1]).permute(0, 3, 1, 2) for k in LEVELS}
            tprop, tscores = t_rpn(weights, tfeats, (H_IMG, W_IMG))
            valid = torch.isfinite(scores[b])
            n = int(valid.sum())
            assert n == len(tscores) and bool(valid[:n].all())
            _assert_rows_match(boxes[b, :n].numpy(), torch.sigmoid(scores[b, :n]).numpy(),
                               np.zeros(n), tprop.numpy(), tscores.numpy(), np.zeros(n))


@pytest.fixture(scope="module")
def jax_detections(weights, features):
    """JAX's detector rows, pooled through the Pallas RoIAlign kernel
    (interpreted). Its final NMS is exact whichever path it takes."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.models.maskrcnn import MaskRCNNDetector as JDetector
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads

    jf, _ = features
    jdet = JDetector(num_classes=NCLS, max_detections=DETS, post_nms_top_n=POST)
    os.environ["POET_ROI_IMPL"] = "pallas"
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(jdet.apply, static_argnums=2)(
                {"params": convert_maskrcnn_heads(weights)},
                {k: jnp.asarray(v) for k, v in jf.items()}, (H_IMG, W_IMG))
    finally:
        del os.environ["POET_ROI_IMPL"]
    return {k: np.asarray(v) for k, v in want.items()}


def _rows(dets, b):
    n = int(np.asarray(dets["valid"][b]).sum())
    assert np.asarray(dets["valid"][b])[:n].all(), "valid rows must come first"
    return [np.asarray(dets[k][b])[:n] for k in ("boxes", "scores", "labels")]


# nms_prune_k 0 runs the exact per-class NMS alone. At 64 every image's
# certificate holds here and the exact suppression never runs; the third
# case fails image 1's certificate, and the whole batch falls back to it.
@pytest.mark.parametrize("nms,prune_k,exact_runs", [
    ("exact", 0, 1), ("pruned", 64, 0), ("pruned, a certificate fails", 64, 1)])
def test_detector_rows_match_jax(weights, features, jax_detections, monkeypatch, nms,
                                 prune_k, exact_runs):
    from poet_tpu_torch.models import maskrcnn
    from tests.test_detector_numeric_parity import _assert_rows_match

    exact_calls = []
    exact = maskrcnn.exact_class_nms_mask
    monkeypatch.setattr(maskrcnn, "exact_class_nms_mask",
                        lambda *a: exact_calls.append(1) or exact(*a))
    if "fails" in nms:
        pruned = maskrcnn.class_nms_select_pruned

        def failing(*a):
            sel, keep_valid, cert = pruned(*a)
            assert bool(cert.all())
            return sel, keep_valid, cert & (torch.arange(B) != 1)

        monkeypatch.setattr(maskrcnn, "class_nms_select_pruned", failing)

    jf, _ = features
    det = _port_detector(weights, max_detections=DETS, post_nms_top_n=POST,
                         nms_prune_k=prune_k)
    with torch.no_grad():
        got = det({k: _t(v) for k, v in jf.items()}, (H_IMG, W_IMG))
    assert got["boxes"].shape == (B, DETS, 4) and got["labels"].dtype == torch.int32
    assert len(exact_calls) == exact_runs
    for b in range(B):
        g, w = _rows({k: v.numpy() for k, v in got.items()}, b), _rows(jax_detections, b)
        assert len(g[0]) == len(w[0]) >= 3
        _assert_rows_match(*g, *w)


def test_detector_backbone_takes_the_torchvision_state_dict(weights, images):
    from poet_tpu_torch.models.backbone import MaskRCNNDetectorBackbone

    bb = MaskRCNNDetectorBackbone(NCLS, max_detections=DETS, post_nms_top_n=POST,
                                  obj_id_map=((1, 1), (3, 2)))
    missing, unexpected = bb.load_state_dict({k: _t(v) for k, v in weights.items()})
    assert missing == [] and unexpected == []
    assert not any(p.requires_grad for p in bb.parameters())
    feats, masks, dets = bb(_t(images), torch.zeros((B, H_IMG, W_IMG), dtype=torch.bool))
    assert [tuple(f.shape[1:3]) for f in feats] == [(8, 10), (4, 5), (2, 3)]
    assert [tuple(m.shape) for m in masks] == [(B, 8, 10), (B, 4, 5), (B, 2, 3)]
    labels, valid = dets["labels"].numpy(), dets["valid"].numpy()
    assert set(labels[valid].tolist()) <= {1, 2} and (labels[~valid] == -1).all()


# ---------------------------------------------------------------------------
# detect+pose: the slice end to end
# ---------------------------------------------------------------------------

def _configs():
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import detect_pose_config

    jcfg, tcfg = PoETConfig(), detect_pose_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.bbox_mode = "backbone"
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
        cfg.model.n_classes = NCLS - 1
        cfg.model.dtype = "float32"
        cfg.backbone.post_nms_top_n, cfg.backbone.max_detections = POST, DETS
    jcfg.model.enc_deform_impl = "fused"
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX detect+pose tree: `init` of JAX `build_model` (its parameter
    shapes do not depend on the image size, so a 64x64 image initializes
    it), with the detector's weights above. The init traces the encoder's
    XLA deformable attention ('sep'): it makes the same tree as the Pallas
    'fused' kernel, without interpreting the kernel."""
    from poet_tpu.models import build_model
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads, convert_resnet_fpn
    from tests.test_detector_numeric_parity import _rcnn_state_dict

    jcfg, _ = _configs()
    jcfg.model.enc_deform_impl = "sep"
    model = build_model(jcfg)
    tree = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                               jnp.zeros((1, 64, 64), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = _rcnn_state_dict(num_classes=NCLS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd),
                        "detector": convert_maskrcnn_heads(sd)}
    return tree


@pytest.fixture(scope="module")
def slice_outputs(jax_tree, images):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    jcfg, tcfg = _configs()
    pad_mask = np.zeros((B, H_IMG, W_IMG), bool)
    os.environ["POET_ROI_IMPL"] = "pallas"
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jax.jit(jbuild(jcfg).apply)({"params": jax_tree}, jnp.asarray(images),
                                               jnp.asarray(pad_mask), None)
    finally:
        del os.environ["POET_ROI_IMPL"]
    model = load_jax_params(build_model(tcfg), jax_tree).eval()
    with torch.inference_mode():
        got = model(_t(images), _t(pad_mask))
    return tcfg, model, {k: v.numpy() for k, v in got.items()}, \
        {k: np.asarray(v) for k, v in want.items()}


def _pairing(got, want, b):
    """Port query index for each valid JAX query of image b: same class,
    score within 1e-4, box within 5e-3 px (boxes are normalized cxcywh)."""
    scale = np.array([W_IMG, H_IMG, W_IMG, H_IMG])
    n = int(want["n_boxes"][b])
    used, pairs = set(), []
    for j in range(n):
        cand = [i for i in range(n) if i not in used
                and got["pred_classes"][b, i] == want["pred_classes"][b, j]
                and abs(got["pred_scores"][b, i] - want["pred_scores"][b, j]) < 1e-4
                and (np.abs(got["pred_boxes"][b, i] - want["pred_boxes"][b, j]) * scale
                     ).max() < 5e-3]
        assert cand, f"image {b}: JAX query {j} has no match in the port"
        used.add(cand[0])
        pairs.append((cand[0], j))
    return pairs


def _as_detections(out):
    """A PoET output's selected queries as detections (xyxy pixels)."""
    cx, cy, w, h = np.moveaxis(out["pred_boxes"] * [W_IMG, H_IMG, W_IMG, H_IMG], -1, 0)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return {"boxes": _t(boxes.astype(np.float32)), "scores": _t(out["pred_scores"]),
            "labels": _t(out["pred_classes"]), "valid": _t(out["query_valid"])}


def test_detect_pose_matches_jax(slice_outputs, images):
    _, model, got, want = slice_outputs
    assert got["translations"].shape == want["translations"].shape == (DEC, B, 10, 3)
    np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
    assert (want["n_boxes"] >= 3).all()
    for b in range(B):
        pairs = _pairing(got, want, b)
        gi, wj = [p[0] for p in pairs], [p[1] for p in pairs]
        for lvl in range(DEC):
            for k in ("translations", "rotations"):
                _assert_close(got[k][lvl, b, gi], want[k][lvl, b, wj],
                              f"{k}[{lvl}] image {b}", rtol=1e-3)
        n = len(pairs)
        np.testing.assert_array_equal(got["query_valid"][b], want["query_valid"][b])
        np.testing.assert_array_equal(got["pred_classes"][b, n:], -1)
        np.testing.assert_array_equal(got["pred_boxes"][b, n:], -1.0)
        np.testing.assert_array_equal(got["pred_scores"][b, n:], 0.0)

    # the port's PoET on JAX's selected queries: the transformer and heads
    # see the same boxes, and every layer agrees to 1e-4 of scale
    with torch.inference_mode():
        same = model(_t(images), torch.zeros((B, H_IMG, W_IMG), dtype=torch.bool),
                     detections=_as_detections(want))
    same = {k: v.numpy() for k, v in same.items()}
    for k in ("pred_classes", "n_boxes", "query_valid", "pred_scores"):
        np.testing.assert_array_equal(same[k], want[k], err_msg=k)
    np.testing.assert_allclose(same["pred_boxes"], want["pred_boxes"], rtol=0, atol=1e-6)
    for lvl in range(DEC):
        for k in ("translations", "rotations"):
            for b in range(B):
                n = int(want["n_boxes"][b])
                _assert_close(same[k][lvl, b, :n], want[k][lvl, b, :n], f"{k}[{lvl}] image {b}")


def test_pose_server_detector_mode(slice_outputs, images):
    """`infer` takes images alone; the pipelined `stream` answers in frame
    order with the same numbers as `infer`."""
    from poet_tpu_torch.engine.serving import PoseServer

    tcfg, model, got, want = slice_outputs
    server = PoseServer(tcfg, model, batch_size=B, image_size=(H_IMG, W_IMG), device="cpu")
    res = server.infer(images)
    for k, g in (("translation", "translations"), ("rotation", "rotations")):
        np.testing.assert_array_equal(res[k], got[g][-1], err_msg=k)
    for k, g in (("boxes", "pred_boxes"), ("classes", "pred_classes"), ("n_boxes", "n_boxes")):
        np.testing.assert_array_equal(res[k], got[g], err_msg=k)
    with pytest.raises(ValueError, match="images only"):
        server.infer(images, boxes=np.zeros((B, 10, 4), np.float32))
    frames = [images, images[::-1].copy(), images]
    streamed = list(server.stream(iter(frames)))
    assert len(streamed) == 3
    for frame, out in zip(frames, streamed):
        ref = server.infer(frame)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(streamed[1]["n_boxes"], res["n_boxes"][::-1])
    assert server.latency_stats()["frames"] == 1 + 3


def test_pose_server_defaults_to_the_card():
    from poet_tpu_torch.engine.serving import PoseServer

    assert inspect.signature(PoseServer).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# weights, init, the bf16 policy, and the package boundary
# ---------------------------------------------------------------------------

def test_load_jax_params_round_trips_the_detector_tree(jax_tree):
    from poet_tpu.utils.torch_import import (
        convert_maskrcnn_heads,
        convert_poet_checkpoint,
        convert_resnet_fpn,
        state_dict_to_numpy,
    )
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    model = build_model(_configs()[1])
    for v in model.state_dict().values():
        v.fill_(np.nan)
    load_jax_params(model, jax_tree)        # raises on an unused leaf or an unset tensor
    sd = state_dict_to_numpy(model.state_dict())
    assert all(np.isfinite(v).all() for v in sd.values())
    back = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    back["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone."),
                        "detector": convert_maskrcnn_heads(sd, prefix="backbone.")}
    flat_a = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_init_covers_the_detector_with_the_jax_initializers():
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    sd = init_weights(build_model(_configs()[1]), seed=5).state_dict()   # raises if uncovered
    det = {k: v for k, v in sd.items() if k.startswith(("backbone.rpn.", "backbone.roi_heads."))}
    assert len(det) == 14
    for k, v in det.items():
        if k.endswith("bias"):
            assert torch.count_nonzero(v) == 0, k
    fc6 = det["backbone.roi_heads.box_head.fc6.weight"]
    assert tuple(fc6.shape) == (1024, 256 * 49)
    np.testing.assert_allclose(fc6.std().item(), np.sqrt(1 / (256 * 49)), rtol=0.02)
    conv = det["backbone.rpn.head.conv.weight"]
    np.testing.assert_allclose(conv.std().item(), np.sqrt(1 / (9 * 256)), rtol=0.05)
    assert det["backbone.roi_heads.box_predictor.cls_score.weight"].shape[0] == NCLS


def test_bf16_policy_casts_the_detector_heads_like_jax(jax_tree):
    from poet_tpu.utils.params import _should_cast
    from poet_tpu_torch.flagship import detect_pose_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.params import cast_params_for_inference

    jdet = jax.tree_util.tree_leaves_with_path(jax_tree["backbone"]["detector"])
    jcast = {tuple(p.key for p in path): _should_cast(
        ("backbone", "detector") + tuple(p.key for p in path), jnp.asarray(leaf))
        for path, leaf in jdet}
    assert sum(jcast.values()) == 7 and len(jcast) == 14
    cfg = detect_pose_config("bfloat16")
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    model = cast_params_for_inference(build_model(cfg))
    for name, p in model.named_parameters():
        if name.startswith(("backbone.rpn.", "backbone.roi_heads.")):
            assert (p.dtype == torch.bfloat16) == (p.dim() >= 2), name


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_poet_tpu():
    files = sorted((ROOT / "poet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "optax", "poet_tpu")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(ROOT)} imports {mod}"
