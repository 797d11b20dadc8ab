"""The YOLOv4-CSP detect+pose slice against `poet_tpu`, on the CPU at f32.

Weights: `flagship.darknet_state` draws a seeded, well-conditioned darknet
tree in flax names for any cfg; both packages take it as it is (JAX as its
`params`, the port through `load_jax_params`). The mini cfg below is
128x128 with a 3->16 3x3 and a 16->40 3x3/2 entry conv (the port's stem
route: C <= 32 at >= 128x128), every deeper conv with C > 32, and every
section type the shipped cfgs use (route with groups, shortcut, SPP
maxpool, upsample, two yolo heads; a logistic conv besides).

Compared: the cfg parser and channel walk (mini and both shipped cfgs);
mish; both decodes; the NMS keep sets; the darknet body within 1e-5 of
scale against JAX's stem route (`POET_YOLO_STEM=interpret`, the Pallas
kernel interpreted) and its default XLA route (the BN applied after the
conv instead of folded into it: a rounding apart); the backbone's
detections row for row (class-specific and agnostic, and
`encoder_min_stride`); darknet .weights files; and the slice, a tiny PoET
(hidden 64, 2 + 2 layers) in bbox_mode='backbone' through `PoseServer`:
detections row for row, poses on JAX's selected queries within 1e-4 of
scale.
"""

import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = [ROOT / "configs" / "ycbv_yolov4-csp.cfg", ROOT / "configs" / "lmo_yolov4-csp.cfg"]
B, H_IMG, W_IMG = 2, 128, 128
RTOL_SCALE = 1e-5
# the mini network's best scores top out near 0.08 (its head biases are the
# flagship's): this threshold leaves 11 and 5 detections in the two images,
# all of one class and with small boxes, so the backbone's NMS suppresses
# nothing here; the NMS test above covers suppression in both modes
CONF = 0.06
ANCHORS = "12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401"
MINI_CFG = textwrap.dedent(f"""
    [net]
    width=128
    height=128
    channels=3

    # 0, 1: the stem route (C <= 32 at >= 128x128)
    [convolutional]
    batch_normalize=1
    filters=16
    size=3
    stride=1
    pad=1
    activation=mish

    [convolutional]
    batch_normalize=1
    filters=40
    size=3
    stride=2
    pad=1
    activation=mish

    [convolutional]
    batch_normalize=1
    filters=48
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=40
    size=1
    stride=1
    pad=1
    activation=mish

    [convolutional]
    batch_normalize=1
    filters=48
    size=3
    stride=1
    pad=1
    activation=mish

    [shortcut]
    from=-3
    activation=linear

    [route]
    layers=-1
    groups=2
    group_id=1

    [route]
    layers=-1,-2

    [maxpool]
    size=5
    stride=1

    # 9: stride 8
    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    size=1
    stride=1
    pad=1
    filters=21
    activation=linear

    [yolo]
    mask=0,1,2
    anchors={ANCHORS}
    classes=2
    num=9
    scale_x_y=1.05

    [route]
    layers=-3

    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=2
    pad=1
    activation=logistic

    [upsample]
    stride=2

    [route]
    layers=-1,-3

    # 16: stride 16
    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=2
    pad=1
    activation=mish

    [convolutional]
    size=1
    stride=1
    pad=1
    filters=21
    activation=linear

    [yolo]
    mask=6,7,8
    anchors={ANCHORS}
    classes=2
    num=9
    scale_x_y=1.1
    """)


def _t(x):
    return torch.from_numpy(np.array(x))


def _frozen(text):
    from poet_tpu_torch.models.yolov4 import parse_darknet_cfg

    return tuple(tuple(sorted(s.items())) for s in parse_darknet_cfg(text))


def _assert_close(got, want, name, rtol=RTOL_SCALE):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def sections():
    return _frozen(MINI_CFG)


@pytest.fixture(scope="module")
def tree(sections):
    from poet_tpu_torch.flagship import darknet_state

    return darknet_state(sections)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the cfg, mish, the decodes, NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["mini"] + [p.name for p in SHIPPED])
def test_cfg_parser_and_channel_walk_match_jax(cfg):
    from poet_tpu.models.yolov4 import parse_darknet_cfg as jparse
    from poet_tpu.utils.darknet_import import _channel_walk as jwalk
    from poet_tpu_torch.models.yolov4 import load_cfg_sections, parse_darknet_cfg
    from poet_tpu_torch.utils.darknet_import import _channel_walk

    text = MINI_CFG if cfg == "mini" else (ROOT / "configs" / cfg).read_text()
    sections = parse_darknet_cfg(text)
    assert sections == jparse(text)
    assert _channel_walk(sections) == list(jwalk(jparse(text)))
    if cfg != "mini":
        assert len(_channel_walk(sections)) == 115
        assert load_cfg_sections(str(ROOT / "configs" / cfg)) == _frozen(text)


def test_mish_matches_jax():
    from poet_tpu.models.yolov4 import mish as jmish
    from poet_tpu_torch.models.yolov4 import mish

    x = np.random.default_rng(1).normal(0, 8, 20000).astype(np.float32)
    # 1e-6 absolute: an ulp of exp, amplified where 1 - 2/((1+e)^2+1) cancels
    np.testing.assert_allclose(mish(_t(x)).numpy(), np.asarray(jmish(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("decode", ["u5", "darknet"])
def test_decodes_match_jax(decode):
    from poet_tpu.models import yolov4 as J
    from poet_tpu_torch.models import yolov4 as P

    raw = np.random.default_rng(2).normal(0, 3, (2, 6, 8, 3 * 26)).astype(np.float32)
    anchors = [(142, 110), (192, 243), (459, 401)]
    if decode == "u5":
        want = J.decode_yolo_u5(jnp.asarray(raw), anchors, 21, 32)
        got = P.decode_yolo_u5(_t(raw), anchors, 21, 32)
    else:
        want = J.decode_yolo_darknet(jnp.asarray(raw), anchors, 21, 32, scale_x_y=1.05)
        got = P.decode_yolo_darknet(_t(raw), anchors, 21, 32, scale_x_y=1.05)
    # sigmoid/exp in two libraries: an ulp or two of each f32 result
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("agnostic", [False, True])
def test_nms_keep_sets_match_jax(agnostic):
    """Three problems in one batched call against JAX per problem: boxes on
    an integer grid (no IoU on a rounding edge), scores with ties, duplicate
    boxes, -inf candidates; classes 1-3."""
    from poet_tpu.ops import detection as J
    from poet_tpu_torch.ops import detection as P

    rng = np.random.default_rng(3)
    n, iou, k = 96, 0.5, 96
    xy = rng.integers(0, 32, size=(3, n, 2))
    boxes = np.concatenate([xy, xy + rng.integers(4, 30, size=(3, n, 2))], -1).astype(np.float32)
    boxes[:, 40:48] = boxes[:, :8]
    scores = np.round(rng.uniform(size=(3, n)), 1).astype(np.float32)
    labels = rng.integers(1, 4, size=(3, n)).astype(np.int32)
    valid = rng.uniform(size=(3, n)) > 0.2
    masked = np.where(valid, scores, -np.inf).astype(np.float32)
    if agnostic:
        got = P.nms_padded(_t(boxes), _t(masked), iou, k)
    else:
        got = P.batched_class_nms(_t(boxes), _t(scores), _t(labels), _t(valid), iou, k)
    for i in range(3):
        if agnostic:
            want = J.nms_padded(jnp.asarray(boxes[i]), jnp.asarray(masked[i]), iou, k)
            oracle = P.nms_greedy(_t(boxes[i]), _t(masked[i]), iou, k)
        else:
            want = J.batched_class_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                       jnp.asarray(labels[i]), jnp.asarray(valid[i]), iou, k)
            mc = np.where(valid[i][:, None], boxes[i], 0).max() + 1.0
            oracle = P.nms_greedy(_t(boxes[i] + labels[i][:, None] * mc), _t(masked[i]), iou, k)
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
            np.testing.assert_array_equal(g[i].numpy(), o.numpy())
    assert (0 < got[1].sum(1).numpy()).all() and (got[1].sum(1).numpy() < valid.sum(1)).all()


# ---------------------------------------------------------------------------
# the darknet body and the backbone
# ---------------------------------------------------------------------------

def _jax_body(sections, tree, images, monkeypatch, stem):
    from poet_tpu.models.yolov4 import DarknetBody

    monkeypatch.setenv("POET_YOLO_STEM", stem)
    yolo_in, _, feats = jax.jit(DarknetBody(sections).apply)({"params": tree},
                                                              jnp.asarray(images))
    return [np.asarray(y) for y in yolo_in], [np.asarray(f) for f in feats]


def test_flagship_tree_has_the_jax_body_structure(sections, tree):
    """`darknet_state` names and shapes every leaf as flax's DarknetBody
    does, for the mini cfg and the shipped one."""
    from poet_tpu.models.yolov4 import DarknetBody
    from poet_tpu_torch.flagship import darknet_state
    from poet_tpu_torch.models.yolov4 import load_cfg_sections

    full = load_cfg_sections(str(SHIPPED[0]))
    for secs, t in ((sections, tree), (full, darknet_state(full))):
        shapes = jax.eval_shape(lambda: DarknetBody(secs).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
        want = {jax.tree_util.keystr(p): s.shape
                for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
        got = {jax.tree_util.keystr(p): np.shape(v)
               for p, v in jax.tree_util.tree_leaves_with_path(t)}
        assert got == want


def test_darknet_body_matches_jax(sections, tree, images, monkeypatch):
    from poet_tpu_torch.models import yolov4
    from poet_tpu_torch.ops.conv_stem_cuda import conv_stem_torch
    from poet_tpu_torch.utils.jax_params import load_jax_params

    stems = []
    monkeypatch.setattr(yolov4, "conv_stem", lambda *a, **k: stems.append(
        tuple(a[0].shape)) or conv_stem_torch(*a, **k))
    body = load_jax_params(yolov4.DarknetBody(sections), tree)
    with torch.no_grad():
        yolo_in, specs, feats = body(_t(images))
    assert stems == [(B, 128, 128, 3), (B, 128, 128, 16)]
    assert [tuple(f.shape) for f in feats] == [(B, 16, 16, 64), (B, 8, 8, 64)]
    assert [s["scale_x_y"] for s in specs] == [1.05, 1.1]
    for stem in ("interpret", "0"):
        j_in, j_feats = _jax_body(sections, tree, images[:1], monkeypatch, stem)
        for k, (g, w) in enumerate(zip(yolo_in + feats, j_in + j_feats)):
            _assert_close(g[:1].numpy(), w, f"POET_YOLO_STEM={stem} output {k}")


@pytest.fixture(scope="module")
def backbones(sections, tree, images):
    from poet_tpu.models.yolov4 import YOLOv4Backbone as JBackbone
    from poet_tpu_torch.models.yolov4 import YOLOv4Backbone
    from poet_tpu_torch.utils.jax_params import load_jax_params

    out = {}
    pad = np.zeros((B, H_IMG, W_IMG), bool)
    for agnostic, min_stride in ((False, 1), (True, 1), (False, 16)):
        kw = dict(conf_thresh=CONF, agnostic_nms=agnostic, max_detections=16, pre_nms=64,
                  encoder_min_stride=min_stride)
        want = jax.jit(JBackbone(sections, **kw).apply)({"params": {"body": tree}},
                                                        jnp.asarray(images), jnp.asarray(pad))
        port = YOLOv4Backbone(sections, **kw)
        load_jax_params(port.body, tree)
        got = port(_t(images), _t(pad))
        out[(agnostic, min_stride)] = (port, got, jax.tree_util.tree_map(np.asarray, want))
    return out


@pytest.mark.parametrize("agnostic", [False, True])
def test_backbone_detections_match_jax(backbones, agnostic):
    from tests.test_detector_numeric_parity import _assert_rows_match

    _, (feats, masks, dets), (jfeats, jmasks, jdets) = backbones[(agnostic, 1)]
    assert dets["boxes"].shape == (B, 16, 4) and dets["labels"].dtype == torch.int32
    for b in range(B):
        n = int(jdets["valid"][b].sum())
        assert int(dets["valid"][b].sum()) == n and 2 <= n < 16 and jdets["valid"][b][:n].all()
        _assert_rows_match(*[dets[k][b, :n].numpy() for k in ("boxes", "scores", "labels")],
                           *[jdets[k][b, :n] for k in ("boxes", "scores", "labels")])
    np.testing.assert_array_equal(dets["labels"].numpy()[~dets["valid"].numpy()], -1)
    for g, w in zip(masks, jmasks):
        np.testing.assert_array_equal(g.numpy(), w)


def test_encoder_min_stride_drops_the_fine_map(backbones):
    port, (feats, masks, dets), (jfeats, jmasks, jdets) = backbones[(False, 16)]
    full = backbones[(False, 1)]
    assert port.num_channels == (64,) and full[0].num_channels == (64, 64)
    assert [tuple(f.shape) for f in feats] == [tuple(f.shape) for f in jfeats] == [(B, 8, 8, 64)]
    assert [tuple(m.shape) for m in masks] == [(B, 8, 8)]
    for k in dets:
        np.testing.assert_array_equal(dets[k].numpy(), full[1][2][k].numpy())


def test_darknet_weights_file_loads_like_jax(tmp_path, sections, tree):
    from poet_tpu.utils.darknet_import import load_darknet_weights as jload
    from poet_tpu_torch.models.yolov4 import DarknetBody
    from poet_tpu_torch.utils.darknet_import import load_darknet_weights
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_darknet_import import _write_darknet

    path = tmp_path / "mini.weights"
    _write_darknet(str(path), [dict(s) for s in sections], tree)
    got, want = load_darknet_weights(sections, str(path)), jload(sections, str(path))
    assert sorted(got) == sorted(want) == sorted(tree)
    for mod in want:
        assert sorted(got[mod]) == sorted(want[mod])
        for k in want[mod]:
            np.testing.assert_array_equal(got[mod][k], want[mod][k], err_msg=f"{mod}/{k}")
            np.testing.assert_array_equal(got[mod][k], tree[mod][k], err_msg=f"{mod}/{k}")
    load_jax_params(DarknetBody(sections), got)             # strict: every leaf, every tensor
    path.write_bytes(path.read_bytes()[:-64])
    with pytest.raises(ValueError, match="does not match"):
        load_darknet_weights(sections, str(path))


def test_build_model_falls_back_to_the_shipped_cfg():
    from poet_tpu_torch.flagship import yolo_detect_pose_config
    from poet_tpu_torch.models import build_model

    cfg = yolo_detect_pose_config("float32")
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    for dataset, classes in (("ycbv", 21), ("lmo", 8)):
        cfg.data.dataset = dataset
        bb = build_model(cfg).backbone
        assert bb.num_channels == (256, 512, 1024)
        heads = [s for s in bb.body.sections if s["type"] == "yolo"]
        assert [int(s["classes"]) for s in heads] == [classes] * 3
        assert not any(p.requires_grad for p in bb.parameters())
    cfg.backbone.cfg_path = "/nonexistent.cfg"
    with pytest.raises(FileNotFoundError):
        build_model(cfg)


# ---------------------------------------------------------------------------
# the slice: tiny PoET in bbox_mode='backbone' on the mini cfg
# ---------------------------------------------------------------------------

def _configs(cfg_path):
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import yolo_detect_pose_config

    jcfg, tcfg = PoETConfig(), yolo_detect_pose_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.backbone.name, cfg.backbone.cfg_path = "yolov4", cfg_path
        cfg.backbone.conf_thresh, cfg.backbone.max_detections = CONF, 8
        cfg.model.bbox_mode, cfg.model.dtype = "backbone", "float32"
        cfg.model.enc_layers = cfg.model.dec_layers = 2
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, 4, 128
        cfg.model.num_queries, cfg.model.n_classes, cfg.model.num_feature_levels = 5, 4, 3
        cfg.model.dropout = 0.0
    # the XLA deformable core computes the Pallas kernel's function
    jcfg.model.enc_deform_impl = "sep"
    return jcfg, tcfg


@pytest.fixture(scope="module")
def slice_outputs(tmp_path_factory, tree, images):
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    cfg_path = tmp_path_factory.mktemp("cfg") / "mini.cfg"
    cfg_path.write_text(MINI_CFG)
    jcfg, tcfg = _configs(str(cfg_path))
    jmodel = jbuild(jcfg)
    pad = jnp.zeros((B, H_IMG, W_IMG), bool)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images), pad, None)
    params = jax.tree_util.tree_map(np.asarray, params)["params"]
    assert (jax.tree_util.tree_structure(params["backbone"]["body"])
            == jax.tree_util.tree_structure(tree))
    params["backbone"]["body"] = tree
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(images), pad, None)
    model = load_jax_params(build_model(tcfg), params).eval()
    return tcfg, model, {k: np.asarray(v) for k, v in want.items()}


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


def test_slice_through_pose_server_matches_jax(slice_outputs, images):
    from poet_tpu_torch.engine.serving import PoseServer

    tcfg, model, want = slice_outputs
    Q = tcfg.model.num_queries
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in model(_t(images), torch.zeros((B, H_IMG, W_IMG),
                                                                      dtype=torch.bool)).items()}
    np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
    assert (want["n_boxes"] >= 2).all() and got["translations"].shape == (2, B, Q, 3)
    for b in range(B):
        _pairing(got, want, b)                       # class, score 1e-4, box 5e-3 px

    server = PoseServer(tcfg, model, batch_size=B, image_size=(H_IMG, W_IMG), device="cpu")
    res = server.infer(images)
    for k, g in (("translation", "translations"), ("rotation", "rotations")):
        np.testing.assert_array_equal(res[k], got[g][-1], err_msg=k)
    for k, g in (("boxes", "pred_boxes"), ("classes", "pred_classes"), ("n_boxes", "n_boxes")):
        np.testing.assert_array_equal(res[k], got[g], err_msg=k)

    # poses on JAX's selected queries: every decoder layer within 1e-4 of scale
    with torch.inference_mode():
        same = model(_t(images), torch.zeros((B, H_IMG, W_IMG), dtype=torch.bool),
                     detections=_as_detections(want))
    same = {k: v.numpy() for k, v in same.items()}
    for k in ("pred_classes", "n_boxes", "query_valid", "pred_scores"):
        np.testing.assert_array_equal(same[k], want[k], err_msg=k)
    for lvl in range(tcfg.model.dec_layers):
        for k in ("translations", "rotations"):
            for b in range(B):
                n = int(want["n_boxes"][b])
                _assert_close(same[k][lvl, b, :n], want[k][lvl, b, :n], f"{k}[{lvl}] image {b}",
                              rtol=1e-4)

