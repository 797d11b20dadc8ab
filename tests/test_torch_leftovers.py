"""The last public functions of `poet_tpu` the port carries, against their
JAX counterparts, on the CPU at f32, and the deformable kernels' pixel
coordinate (ROADMAP C8).

* `utils/rotations.py`: `hat`, `so3_exp_map`, `geodesic_distance`,
  `rotation_error_deg` (JAX's clamps), within 1e-6, and exp o log = id
  away from pi within 1e-5.
* `utils/boxes.py`: the rescale/normalize pair and `masks_to_boxes`
  (exact; the 1e8 sentinel of an empty mask, (0, 4) of no mask).
* `models/matcher.py:match_hungarian` against JAX's on seeded costs whose
  optimum is unique: the same pairs.
* `ops/detection.py:roi_align` (aligned and not, sampling ratios 1 and 2)
  and the single-image `multiscale_roi_align` view against JAX's
  `roi_align` and its flat oracle, within 1e-5 of max |feature|.
* `models/maskrcnn.py`'s `nms_candidates` cap: the detector on
  `tests/test_torch_detect.py`'s features against JAX's `MaskRCNNDetector`
  with the cap set (rows matched, score 1e-4, box 5e-3 px); the capped
  selection on whole-pixel boxes with distinct scores against JAX's
  capped branch restated in JAX, index for index, also under
  `torch.export`; JAX's adversarial cluster, where the cap gives JAX's
  capped answer and not the exact one.
* `native/`: `lapjv` against scipy, JAX's `native.lapjv` and the port's
  `hungarian`; `probe_image`, `decode_batch_f32` and `u8_to_f32` against
  the port's `decode_image` and JAX's image pipe, exact.
* YOLOv4-CSP in gt mode: the backbone's decode and NMS are not called, and
  features and poses are bit-equal to a run that computes the detections;
  poses within 1e-4 of scale of JAX's gt-mode forward; an exported gt
  program holds no NMS `while_loop`.
* C8: over the YOLO pyramid's seeded locations (the first points of each
  level moved next to the cell edges where the rounding matters), the
  points whose floor of loc * size - 0.5 one rounding and two part, and
  the plain variant (`tools/bench_v3_variants.py:plain_variant`, noy)
  floors as two roundings do.
"""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detect import (  # noqa: F401  (module fixtures)
    B as DET_B,
    DETS,
    H_IMG as DET_H,
    NCLS,
    POST,
    W_IMG as DET_W,
    _port_detector,
    _rows,
    features,
    images,
    weights,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return q.astype(np.float32)


# ---------------------------------------------------------------------------
# rotations and boxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hat", "so3_exp_map", "geodesic_distance",
                                  "geodesic_distance_same", "rotation_error_deg",
                                  "rotation_error_deg_same"])
def test_rotation_utilities_match_jax(name):
    from poet_tpu.utils import rotations as jr
    from poet_tpu_torch.utils import rotations as tr

    rng = np.random.default_rng(3)
    if name in ("hat", "so3_exp_map"):
        v = (rng.normal(size=(7, 3)) * 1.3).astype(np.float32)
        v[0] = 0.0                                   # the clamp of the angle at eps
        v[1] = 1e-3
        args = (v,)
    else:
        a = _rotations(rng, 9)
        # identical pairs put the trace at 3 (or a rounding past it): the clamps
        args = (a, a.copy()) if name.endswith("_same") else (a, _rotations(rng, 9))
    fn = name.removesuffix("_same")
    got = getattr(tr, fn)(*map(_t, args)).numpy()
    want = np.asarray(getattr(jr, fn)(*map(jnp.asarray, args)))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))


def test_exp_of_log_is_the_rotation_away_from_pi():
    from poet_tpu_torch.utils.rotations import so3_exp_map, so3_log_map

    rng = np.random.default_rng(4)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    v = (axis * rng.uniform(0.05, np.pi - 0.3, size=(64, 1))).astype(np.float32)
    R = so3_exp_map(_t(v))
    np.testing.assert_allclose(so3_log_map(R).numpy(), v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(so3_exp_map(so3_log_map(R)).numpy(), R.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["box_rescale_cxcywh", "box_normalize_xyxy", "box_rescale_xyxy"])
def test_box_scaling_matches_jax(name):
    from poet_tpu.utils import boxes as jb
    from poet_tpu_torch.utils import boxes as tb

    x = np.random.default_rng(5).uniform(0, 1.3, size=(3, 6, 4)).astype(np.float32)
    for image_size in ((480, 640), (37, 29)):
        got = getattr(tb, name)(_t(x), image_size).numpy()
        want = np.asarray(getattr(jb, name)(jnp.asarray(x), image_size))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 5])
def test_masks_to_boxes_matches_jax(n):
    from poet_tpu.utils.boxes import masks_to_boxes as jmasks
    from poet_tpu_torch.utils.boxes import masks_to_boxes

    masks = np.random.default_rng(6).uniform(size=(n, 11, 13)) > 0.8
    if n:
        masks[2] = False                             # empty: the 1e8 sentinel, maxima 0
        masks[3] = False
        masks[3, 4, 7] = True                        # one pixel
    got = masks_to_boxes(_t(masks))
    want = np.asarray(jmasks(jnp.asarray(masks)))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the legacy matcher
# ---------------------------------------------------------------------------

def test_match_hungarian_matches_jax():
    from poet_tpu.models.matcher import match_hungarian as jmatch
    from poet_tpu_torch.models.matcher import match_hungarian

    rng = np.random.default_rng(7)
    B, Q, C = 3, 8, 5
    logits = rng.normal(size=(B, Q, C)).astype(np.float32)
    pred = rng.uniform(0.1, 0.6, size=(B, Q, 4)).astype(np.float32)
    tgt = rng.uniform(0.1, 0.6, size=(B, Q, 4)).astype(np.float32)
    pred[0, 0, :2] = -0.05                           # the GIoU's clip at 0
    labels = rng.integers(0, C + 2, size=(B, Q)).astype(np.int32)  # past the classes: clipped
    n_tgt = np.array([8, 5, 1], np.int32)
    args = (logits, pred, tgt, labels, n_tgt)
    got = match_hungarian(*map(_t, args))
    want = jmatch(*map(jnp.asarray, args))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.tgt_idx.numpy()[valid], np.asarray(want.tgt_idx)[valid])
    assert got.tgt_idx.dtype == torch.int32 and valid.sum(1).tolist() == n_tgt.tolist()


# ---------------------------------------------------------------------------
# RoIAlign, single level and the single-image multiscale view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("ratio", [1, 2])
def test_roi_align_matches_jax(aligned, ratio):
    from poet_tpu.ops.detection import roi_align as jroi
    from poet_tpu_torch.ops.detection import roi_align

    rng = np.random.default_rng(8)
    feats = rng.normal(size=(20, 24, 6)).astype(np.float32)
    xy = rng.uniform(-12, 90, size=(15, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.3, 60, size=(15, 2))], 1).astype(np.float32)
    boxes[0] = [-30, -30, -10, -10]                  # wholly outside: zeros
    got = roi_align(_t(feats), _t(boxes), 7, 0.25, ratio, aligned).numpy()
    want = np.asarray(jroi(jnp.asarray(feats), jnp.asarray(boxes), 7, 0.25, ratio, aligned))
    assert got.shape == (15, 7, 7, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(feats).max())


def test_multiscale_roi_align_view_matches_jax_flat_oracle():
    from poet_tpu.ops.detection import _multiscale_roi_align_flat
    from poet_tpu_torch.ops.detection import multiscale_roi_align

    rng = np.random.default_rng(9)
    shapes, strides = ((32, 40), (16, 20), (8, 10), (4, 5)), (4, 8, 16, 32)
    feats = [rng.normal(size=(h, w, 8)).astype(np.float32) for h, w in shapes]
    xy = rng.uniform(0, 130, size=(40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 150, size=(40, 2))], 1).astype(np.float32)
    got = multiscale_roi_align([_t(f) for f in feats], strides, _t(boxes)).numpy()
    want = np.asarray(_multiscale_roi_align_flat([jnp.asarray(f) for f in feats], strides,
                                                 jnp.asarray(boxes), 7, 2, 224, 4))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(f).max() for f in feats))


# ---------------------------------------------------------------------------
# the final NMS's candidate cap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [12, 48])
def test_capped_detector_matches_jax(weights, features, cap):
    from poet_tpu.models.maskrcnn import MaskRCNNDetector as JDetector
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads
    from tests.test_detector_numeric_parity import _assert_rows_match

    jf, _ = features
    jdet = JDetector(num_classes=NCLS, max_detections=DETS, post_nms_top_n=POST,
                     nms_candidates=cap)
    os.environ["POET_ROI_IMPL"] = "flat"             # JAX's oracle formulation
    try:
        want = jax.jit(jdet.apply, static_argnums=2)(
            {"params": convert_maskrcnn_heads(weights)},
            {k: jnp.asarray(v) for k, v in jf.items()}, (DET_H, DET_W))
    finally:
        del os.environ["POET_ROI_IMPL"]
    want = {k: np.asarray(v) for k, v in want.items()}
    det = _port_detector(weights, max_detections=DETS, post_nms_top_n=POST,
                         nms_candidates=cap)
    with torch.no_grad():
        got = det({k: _t(v) for k, v in jf.items()}, (DET_H, DET_W))
    got = {k: v.numpy() for k, v in got.items()}
    for b in range(DET_B):
        g, w = _rows(got, b), _rows(want, b)
        assert len(g[0]) == len(w[0]) >= 2
        _assert_rows_match(*g, *w)


def _jax_capped(boxes_pc, masked, labels_pc, cap, thresh, md):
    """JAX's capped branch (`poet_tpu/models/maskrcnn.py:capped_one`), per image."""
    from poet_tpu.ops.detection import batched_class_nms

    labels_pc = jnp.asarray(labels_pc)

    def one(bx, ms):
        cand_scores, cand_i = jax.lax.top_k(ms, cap)
        keep_idx, keep_valid = batched_class_nms(
            bx[cand_i], cand_scores, labels_pc[cand_i], jnp.isfinite(cand_scores), thresh, md)
        return cand_i[keep_idx], keep_valid

    sel, valid = jax.vmap(one)(jnp.asarray(boxes_pc), jnp.asarray(masked))
    return np.asarray(sel), np.asarray(valid)


def _whole_pixel_candidates(rng, B, P, ncls, valid_share):
    xy = rng.integers(0, 60, size=(B, P * ncls, 2))
    boxes = np.concatenate([xy, xy + rng.integers(3, 25, size=(B, P * ncls, 2))], -1)
    scores = rng.permutation(B * P * ncls).reshape(B, P * ncls) / (B * P * ncls) + 0.01
    scores[rng.uniform(size=scores.shape) > valid_share] = -np.inf
    scores[-1, 5:] = -np.inf                         # the last image keeps fewer than md
    return boxes.astype(np.float32), scores.astype(np.float32)


class _Select(torch.nn.Module):
    def __init__(self, detector):
        super().__init__()
        self.detector = detector

    def forward(self, boxes_pc, masked, labels_pc):
        return self.detector.select(boxes_pc, masked, labels_pc)


@pytest.mark.parametrize("case", ["eager", "torch.export"])
def test_capped_selection_matches_jax_on_whole_pixel_boxes(case):
    from poet_tpu_torch.models.maskrcnn import MaskRCNNDetector

    ncls, P, md, cap = 4, 40, 8, 30
    det = MaskRCNNDetector(ncls, max_detections=md, nms_candidates=cap, in_channels=8)
    labels = torch.arange(ncls).repeat(P)
    rng = np.random.default_rng(10)
    boxes, masked = _whole_pixel_candidates(rng, 3, P, ncls, 0.6)
    run = det.select
    if case == "torch.export":
        program = torch.export.export(_Select(det), (_t(boxes), _t(masked), labels))
        assert "while_loop" in str(program.graph)
        run = program.module()
        boxes, masked = _whole_pixel_candidates(rng, 3, P, ncls, 0.4)   # other inputs
    sel, valid = run(_t(boxes), _t(masked), labels)
    want_sel, want_valid = _jax_capped(boxes, masked, labels.numpy(), cap, det.nms_thresh, md)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(sel.numpy(), want_sel)     # invalid slots too, as JAX
    assert 0 < want_valid.sum() < want_valid.size


def test_capped_selection_gives_jax_capped_answer_on_the_adversarial_cluster():
    """`tests/test_detection_ops.py:292`'s cluster: 500 near-tied boxes over
    99 separated ones. The exact NMS keeps 1 + 99; a 400-candidate cap sees
    the cluster alone and keeps 1 box: the port's cap answers JAX's cap."""
    from poet_tpu_torch.models.maskrcnn import MaskRCNNDetector

    rng = np.random.default_rng(0)
    P, ncls, md = 600, 3, 100
    boxes = np.zeros((P, ncls, 4), np.float32)
    scores = np.full((P, ncls), -np.inf, np.float32)
    cluster = np.array([450.0, 400.0, 470.0, 420.0], np.float32)
    for i in range(500):
        boxes[i, 1] = cluster + rng.uniform(-0.01, 0.01, 4).astype(np.float32)
        scores[i, 1] = 0.9 + i * 1e-6
    for i in range(99):
        x, y = 10.0 + 30.0 * (i % 20), 10.0 + 30.0 * (i // 20)
        boxes[500 + i, 1] = [x, y, x + 20, y + 20]
        scores[500 + i, 1] = 0.5
    boxes_pc, masked = boxes.reshape(1, P * ncls, 4), scores.reshape(1, P * ncls)
    labels = torch.arange(ncls).repeat(P)
    capped = MaskRCNNDetector(ncls, max_detections=md, nms_candidates=400, in_channels=8)
    exact = MaskRCNNDetector(ncls, max_detections=md, in_channels=8)
    sel, valid = capped.select(_t(boxes_pc), _t(masked), labels)
    want_sel, want_valid = _jax_capped(boxes_pc, masked, labels.numpy(), 400, 0.5, md)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    assert int(valid.sum()) == 1
    assert int(exact.select(_t(boxes_pc), _t(masked), labels)[1].sum()) == 100


# ---------------------------------------------------------------------------
# the host's JV solver and the image pipe's batch entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 5, 33, 64])
def test_lapjv_matches_scipy_and_jax(n):
    from scipy.optimize import linear_sum_assignment

    from poet_tpu import native as jn
    from poet_tpu_torch import native

    cost = np.random.default_rng(n).normal(size=(n, n)) * 10
    col = native.lapjv(cost)
    ri, ci = linear_sum_assignment(cost)
    assert col.dtype == np.int32 and sorted(col.tolist()) == list(range(n))
    np.testing.assert_allclose(cost[np.arange(n), col].sum(), cost[ri, ci].sum(), rtol=1e-12)
    np.testing.assert_array_equal(col, jn.lapjv(cost))


def test_lapjv_batched_matches_scipy_and_the_ports_hungarian():
    from scipy.optimize import linear_sum_assignment

    from poet_tpu import native as jn
    from poet_tpu_torch import native
    from poet_tpu_torch.ops.hungarian import hungarian

    costs = np.random.default_rng(12).uniform(size=(6, 12, 12))
    cols = native.lapjv(costs)
    assert cols.shape == (6, 12) and cols.dtype == np.int32
    np.testing.assert_array_equal(cols, jn.lapjv(costs))
    jv = hungarian(_t(costs.astype(np.float32))).numpy()
    for b in range(6):
        ri, ci = linear_sum_assignment(costs[b])
        best = costs[b][ri, ci].sum()
        np.testing.assert_allclose(costs[b][np.arange(12), cols[b]].sum(), best, rtol=1e-12)
        np.testing.assert_allclose(costs[b][np.arange(12), jv[b]].sum(), best, rtol=1e-5)
    with pytest.raises(ValueError, match="square"):
        native.lapjv(np.zeros((3, 4)))


def _encode(arr, fmt, mode, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(13)
    pix = lambda c: (rng.uniform(size=(32, 40, c)) * 255).astype(np.uint8)  # noqa: E731
    return ([_encode(pix(3), "PNG", "RGB") for _ in range(4)]
            + [_encode(pix(4), "PNG", "RGBA"), _encode(pix(3), "JPEG", "RGB")])


def test_decode_batch_matches_decode_image_and_jax(blobs):
    from poet_tpu import native as jn
    from poet_tpu_torch import native

    got = native.decode_batch_f32(blobs, 32, 40, n_threads=3)
    ref = np.stack([native.decode_image(b, 3) for b in blobs]).astype(np.float32) / 255.0
    np.testing.assert_array_equal(got, ref)
    out = np.full((len(blobs), 32, 40, 3), -1.0, np.float32)
    assert native.decode_batch_f32(blobs, 32, 40, out=out) is out
    np.testing.assert_array_equal(out, ref)
    assert jn.imagepipe_available()
    np.testing.assert_array_equal(got, jn.decode_batch_f32(blobs, 32, 40, n_threads=3))


def test_decode_batch_names_the_file_that_fails(blobs):
    from poet_tpu_torch import native

    small = _encode(np.zeros((8, 8, 3), np.uint8), "PNG", "RGB")
    with pytest.raises(ValueError, match="image 1"):
        native.decode_batch_f32([blobs[0], small], 32, 40)
    with pytest.raises(ValueError, match="image 0"):
        native.decode_batch_f32([b"not an image"], 32, 40)
    with pytest.raises(ValueError, match="out must be"):
        native.decode_batch_f32(blobs, 32, 40, out=np.zeros((len(blobs), 32, 40, 3)))
    assert native.decode_batch_f32([], 32, 40).shape == (0, 32, 40, 3)


def test_probe_image_and_u8_to_f32_match_jax(blobs):
    from PIL import Image

    from poet_tpu import native as jn
    from poet_tpu_torch import native

    gray = _encode((np.arange(48).reshape(6, 8) * 5).astype(np.uint8), "PNG", "L")
    palette = Image.fromarray((np.random.default_rng(14).uniform(size=(6, 8, 3)) * 255)
                              .astype(np.uint8)).convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    palette.save(buf, "PNG", transparency=3)
    for blob in blobs + [gray, buf.getvalue()]:
        assert native.probe_image(blob) == jn.probe_image(blob)
    assert [native.probe_image(b)[2] for b in (blobs[0], blobs[4], buf.getvalue())] == [3, 4, 4]
    u = (np.random.default_rng(15).uniform(size=(5, 7, 3)) * 255).astype(np.uint8)
    u[0, 0] = [0, 255, 128]
    np.testing.assert_array_equal(native.u8_to_f32(u), jn.u8_to_f32(u))
    assert native.u8_to_f32(u).dtype == np.float32


# ---------------------------------------------------------------------------
# YOLOv4-CSP in gt mode: no dead detector work
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo_gt(tmp_path_factory):
    """The port's YOLOv4-CSP mini model (`tests/test_torch_yolov4.py`) in gt
    mode with JAX's init, JAX's gt-mode forward on the same inputs."""
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import darknet_state
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_torch_yolov4 import B, H_IMG, MINI_CFG, W_IMG, _configs, _frozen

    path = tmp_path_factory.mktemp("yolo_gt") / "mini.cfg"
    path.write_text(MINI_CFG)
    jcfg, tcfg = _configs(str(path))
    for cfg in (jcfg, tcfg):
        cfg.model.bbox_mode = "gt"
    rng = np.random.default_rng(16)
    Q = tcfg.model.num_queries
    images = rng.uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.7, size=(B, Q, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.2, size=(B, Q, 2))
    labels = rng.integers(1, 5, size=(B, Q)).astype(np.int32)
    n_boxes = np.array([3, Q], np.int32)
    for b in range(B):
        boxes[b, n_boxes[b]:], labels[b, n_boxes[b]:] = -1.0, -1
    targets = {"boxes": boxes, "labels": labels, "n_boxes": n_boxes}
    pad = np.zeros((B, H_IMG, W_IMG), bool)
    jmodel = jbuild(jcfg)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    tree = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(pad),
                                jt)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["backbone"]["body"] = darknet_state(_frozen(MINI_CFG))
    want = jax.jit(jmodel.apply)({"params": tree}, jnp.asarray(images), jnp.asarray(pad), jt)
    model = load_jax_params(build_model(tcfg), tree).eval()
    return dict(cfg=tcfg, model=model, images=images, pad=pad, targets=targets,
                want={k: np.asarray(v) for k, v in want.items()})


def test_yolo_gt_mode_skips_decode_and_nms_with_the_same_bits(yolo_gt, monkeypatch):
    from poet_tpu_torch.models.yolov4 import YOLOv4Backbone
    from poet_tpu_torch.ops.detection import FIXED_POINT

    model = yolo_gt["model"]
    calls = []
    for name in ("decode", "detect"):
        fn = getattr(YOLOv4Backbone, name)
        monkeypatch.setattr(YOLOv4Backbone, name,
                            lambda self, *a, _n=name, _f=fn: calls.append(_n) or _f(self, *a))
    args = (_t(yolo_gt["images"]), _t(yolo_gt["pad"]),
            {k: _t(v) for k, v in yolo_gt["targets"].items()})
    FIXED_POINT.reset()
    with torch.inference_mode():
        off = model(*args)
        feats_off = model.backbone(*args[:2], detections=False)
        assert calls == [] and FIXED_POINT.calls == 0 and feats_off[2] is None
        # the parent's path: the backbone computes the detections nobody reads
        forward = model.backbone.forward
        model.backbone.forward = lambda images, pad_mask, detections=True: forward(images,
                                                                                   pad_mask)
        try:
            on = model(*args)
            feats_on = model.backbone(*args[:2])
        finally:
            del model.backbone.forward
    assert calls == ["decode", "detect"] * 2 and FIXED_POINT.calls == 2
    assert feats_on[2] is not None and feats_on[2]["valid"].shape[1] == 8
    for a, b in zip(feats_off[0] + feats_off[1], feats_on[0] + feats_on[1]):
        assert torch.equal(a, b)
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_yolo_gt_mode_matches_jax(yolo_gt):
    model, want = yolo_gt["model"], yolo_gt["want"]
    with torch.inference_mode():
        got = model(_t(yolo_gt["images"]), _t(yolo_gt["pad"]),
                    {k: _t(v) for k, v in yolo_gt["targets"].items()})
    for k in ("pred_classes", "n_boxes", "query_valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("translations", "rotations"):
        for b, n in enumerate(yolo_gt["targets"]["n_boxes"]):
            g, w = got[k].numpy()[:, b, :n], want[k][:, b, :n]
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4, err_msg=k)


def test_exported_yolo_gt_program_holds_no_nms_loop(yolo_gt, tmp_path):
    """The gt program holds no NMS loop; the same model exported in
    'backbone' mode holds one (the check sees the loop where it is)."""
    import copy

    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer, export_model

    cfg, model, images = yolo_gt["cfg"], yolo_gt["model"], yolo_gt["images"]
    B, H, W = images.shape[:3]

    def graph(cfg, model, name):
        path = export_model(cfg, model, str(tmp_path / name), batch_size=B, image_size=(H, W),
                            platforms=("cpu",))
        return path, str(torch.export.load(os.path.join(path, "module.pt2")).graph)

    path, gt_graph = graph(cfg, model, "gt")
    det_cfg, det_model = copy.deepcopy(cfg), copy.deepcopy(model)
    det_cfg.model.bbox_mode = det_model.cfg.bbox_mode = "backbone"
    _, det_graph = graph(det_cfg, det_model, "backbone")
    assert "while_loop" not in gt_graph and "while_loop" in det_graph
    t = yolo_gt["targets"]
    got = ExportedPoseServer(path, device="cpu").infer(images, t["boxes"], t["labels"],
                                                       t["n_boxes"])
    live = PoseServer(cfg, model, batch_size=B, image_size=(H, W), device="cpu").infer(
        images, t["boxes"], t["labels"], t["n_boxes"])
    for k in got:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)


# ---------------------------------------------------------------------------
# C8: the pixel coordinate's rounding
# ---------------------------------------------------------------------------

YOLO_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))


def test_c8_plain_floor_is_two_roundings_at_the_yolo_pyramid():
    """loc * size - 0.5 over the YOLO pyramid's seeded locations (B=2, the
    path's Q=S=6380, H=16, L=P=4): one rounding (the f32 product taken
    exactly in f64, then the subtraction rounded once, which a contracted
    FMA gives) and two part at some points' floors; the plain variant
    takes the two-rounding floor at each of them (noy on value = the
    token's index: its output is the sum of the in-map corners' indices)."""
    from poet_tpu_torch.tools.bench_v3_variants import plain_variant, with_edge_points

    rng = np.random.default_rng(21)
    B, H, P = 2, 16, 4
    S = sum(h * w for h, w in YOLO_LEVELS)
    locs = rng.uniform(size=(B, S, H, len(YOLO_LEVELS), P, 2)).astype(np.float32)
    # and, on each level, the first points moved next to the edges where the
    # two part (a uniform draw meets one in ~2^24 coordinates)
    locs = with_edge_points(_t(locs), YOLO_LEVELS).numpy()
    differ = []                                      # (b, q, h, l, p) of each parting point
    for l, (Hl, Wl) in enumerate(YOLO_LEVELS):
        for c, size in ((0, Wl), (1, Hl)):
            x = locs[:, :, :, l, :, c]
            once = (x.astype(np.float64) * size - 0.5).astype(np.float32)
            twice = np.float32(x * np.float32(size)) - np.float32(0.5)
            assert twice.dtype == np.float32
            for b, q, h, p in zip(*np.nonzero(np.floor(once) != np.floor(twice))):
                differ.append((b, q, h, l, p))
    differ = sorted(set(differ))
    assert len(differ) >= 4                          # C8's cause is in these locations
    # each parting point alone in a row of its own, attention 1, value the token index
    K = len(differ)
    sub = np.full((1, K, 1, len(YOLO_LEVELS), P, 2), -10.0, np.float32)
    attn = np.zeros((1, K, 1, len(YOLO_LEVELS), P), np.float32)
    for k, (b, q, h, l, p) in enumerate(differ):
        sub[0, k, 0, l, p] = locs[b, q, h, l, p]
        attn[0, k, 0, l, p] = 1.0
    value = np.arange(S, dtype=np.float32).reshape(1, S, 1, 1)
    got = plain_variant(_t(value), YOLO_LEVELS, _t(sub), _t(attn), "noy").numpy()[0, :, 0]
    starts = np.cumsum([0] + [h * w for h, w in YOLO_LEVELS])
    for rounding, expect_equal in (("twice", True), ("once", False)):
        want = np.zeros(K, np.float64)
        for k, (b, q, h, l, p) in enumerate(differ):
            Hl, Wl = YOLO_LEVELS[l]
            lx, ly = locs[b, q, h, l, p]
            if rounding == "twice":
                x = np.float32(lx * np.float32(Wl)) - np.float32(0.5)
                y = np.float32(ly * np.float32(Hl)) - np.float32(0.5)
            else:
                x = np.float32(np.float64(lx) * Wl - 0.5)
                y = np.float32(np.float64(ly) * Hl - 0.5)
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            want[k] = sum(starts[l] + yy * Wl + xx for yy in (y0, y0 + 1) for xx in (x0, x0 + 1)
                          if 0 <= xx < Wl and 0 <= yy < Hl)
        same = got == want
        assert same.all() if expect_equal else not same.all(), rounding
