"""The port's detection ops against `poet_tpu/ops/detection.py` and the
Pallas RoIAlign kernel, on the CPU at f32.

RoIAlign: the plain version (`multiscale_roi_align_torch`, the CUDA
kernel's plain version) against the JAX Pallas kernel run as its own tests
run it (`interpret=True`) and against the flat corner-gather oracle, within
1e-5 of the feature scale; boxes on every level, partly outside the image,
under 1 px, slivers (aspect ratio above 15) and a 2x2 level. Boxes are drawn
away from the level boundaries, where a log2 one ulp apart picks another
level; one test places boxes on those boundaries and compares the level
maps themselves. NMS: keep sets and selections equal to JAX exactly, on
random sets with ties and -inf candidates and on the adversarial clusters
of `tests/test_detection_ops.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROI_TOL = 1e-5      # x max|feature|: the same f32 blend summed in other orders
STRIDES = (4, 8, 16, 32)
# image (H, W) -> pyramid levels at strides 4..32; the second ends in 2x2
PYRAMIDS = {"96x128": (96, 128), "64x64 (2x2 level)": (64, 64)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _level_of(boxes):
    w = np.clip(boxes[..., 2] - boxes[..., 0], 0, None)
    h = np.clip(boxes[..., 3] - boxes[..., 1], 0, None)
    return 4 + np.log2(np.sqrt(w * h) / 224 + 1e-6)


def _roi_boxes(rng, B, H, W, n=28):
    """Per image: boxes on every level, partly outside the image, under
    1 px, and slivers (aspect ratio > 15), none within 1e-3 of a level
    boundary of the level map."""
    out = []
    for _ in range(B):
        rows = []
        while len(rows) < n:
            kind = len(rows) % 7
            x0, y0 = rng.uniform(-0.2 * W, W), rng.uniform(-0.2 * H, H)
            if kind == 0:                       # small: the finest level
                w, h = rng.uniform(2, 60, 2)
            elif kind == 1:                     # the second level
                w, h = rng.uniform(120, 210, 2)
            elif kind == 2:                     # up to the coarse levels
                w, h = rng.uniform(230, max(500, 2.5 * max(H, W)), 2)
            elif kind == 3:                     # under one pixel
                w, h = rng.uniform(0.05, 0.95, 2)
            elif kind == 4:                     # horizontal sliver
                w, h = rng.uniform(0.6, 1.2) * W, rng.uniform(1, W / 20)
            elif kind == 5:                     # vertical sliver
                w, h = rng.uniform(1, H / 20), rng.uniform(0.6, 1.2) * H
            else:                               # centred, larger than the image
                w, h = max(1.6 * W, 600), max(1.6 * H, 500)
                x0, y0 = (W - w) / 2, (H - h) / 2
            box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
            lv = _level_of(box)
            if abs(lv - round(lv)) < 1e-3:
                continue
            rows.append(box)
        out.append(np.stack(rows))
    return np.stack(out)


def _pyramid(rng, B, H, W, C=8):
    return [rng.normal(size=(B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_roi_align_plain_matches_pallas_kernel_and_flat_oracle(rng, pyramid):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.detection import _multiscale_roi_align_flat
    from poet_tpu.ops.roi_align_pallas import multiscale_roi_align_pallas
    from poet_tpu_torch.ops.detection import multiscale_roi_align_torch

    H, W = PYRAMIDS[pyramid]
    B = 2
    feats = _pyramid(rng, B, H, W)
    boxes = _roi_boxes(rng, B, H, W)
    levels = np.floor(_level_of(boxes)).clip(2, 5) - 2
    assert set(levels.reshape(-1).tolist()) == {0, 1, 2, 3}, "every level must be pooled"
    got = multiscale_roi_align_torch([_t(f) for f in feats], STRIDES, _t(boxes)).numpy()
    assert got.shape == (B, boxes.shape[1], 7, 7, 8)
    tol = ROI_TOL * max(float(np.abs(f).max()) for f in feats)

    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(multiscale_roi_align_pallas(
            [jnp.asarray(f) for f in feats], STRIDES, jnp.asarray(boxes), output_size=7,
            sampling_ratio=2, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol, err_msg="vs Pallas kernel")
    for b in range(B):
        flat = np.asarray(_multiscale_roi_align_flat(
            [jnp.asarray(f[b]) for f in feats], STRIDES, jnp.asarray(boxes[b]), 7, 2, 224, 4))
        np.testing.assert_allclose(got[b], flat, rtol=0, atol=tol, err_msg="vs flat oracle")


def test_roi_levels_match_jax_on_level_boundaries():
    """Square boxes whose side sits exactly on, and one f32 ulp either side
    of, each boundary of floor(4 + log2(side / 224 + 1e-6)): the plain
    version's level map is JAX's, box for box."""
    from poet_tpu.ops.detection import _roi_level_geometry
    from poet_tpu_torch.ops.detection import roi_levels

    sides = []
    for k in range(-3, 3):
        s = np.float32(224 * (2.0 ** k - 1e-6))
        sides += [np.nextafter(s, np.float32(0)), s, np.nextafter(s, np.float32(1e9))]
    sides = np.asarray(sides, np.float32)
    boxes = np.stack([np.full_like(sides, 3.0), np.full_like(sides, 5.0),
                      3.0 + sides, 5.0 + sides], 1).astype(np.float32)
    shapes = [(60, 80), (30, 40), (15, 20), (8, 10)]
    want = np.asarray(_roi_level_geometry(shapes, STRIDES, jnp.asarray(boxes), 224, 4)[0])
    got = roi_levels(_t(boxes), STRIDES, len(shapes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want.tolist())) == 4


def test_roi_align_entry_dispatches_cpu_to_plain_without_a_launch(rng):
    from poet_tpu_torch.ops import roi_align_cuda as rac
    from poet_tpu_torch.ops.detection import multiscale_roi_align_torch

    feats = [_t(f) for f in _pyramid(rng, 1, 64, 64)]
    boxes = _t(_roi_boxes(rng, 1, 64, 64, n=6))
    before = rac.ROI_ALIGN_FWD.launches
    got = rac.multiscale_roi_align(feats, STRIDES, boxes)
    np.testing.assert_array_equal(got.numpy(),
                                  multiscale_roi_align_torch(feats, STRIDES, boxes).numpy())
    assert rac.ROI_ALIGN_FWD.launches == before and rac.ROI_LIB._lib is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        rac.ROI_ALIGN_FWD(feats, STRIDES, boxes)
    assert rac.ROI_LIB._lib is None


def test_roi_align_plain_bf16_sums_in_f32_and_rounds_once(rng):
    from poet_tpu_torch.ops.detection import multiscale_roi_align_torch

    feats = [_t(f).bfloat16() for f in _pyramid(rng, 1, 64, 64)]
    boxes = _t(_roi_boxes(rng, 1, 64, 64, n=12))
    got = multiscale_roi_align_torch(feats, STRIDES, boxes)
    ref = multiscale_roi_align_torch([f.float() for f in feats], STRIDES, boxes)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref.bfloat16().float().numpy())


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _rand_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.8, size=(n, 2))
    wh = rng.uniform(2, size * 0.3, size=(n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _nms_case(rng, n=160):
    """Random boxes with ties (scores on a coarse grid), duplicates and
    -inf candidates."""
    boxes = _rand_boxes(rng, n)
    boxes[n // 2:n // 2 + 10] = boxes[:10]                       # exact duplicates
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
    scores[rng.uniform(size=n) < 0.2] = -np.inf
    return boxes, scores


@pytest.mark.parametrize("iou_t,max_out", [(0.5, 40), (0.7, 200)])
def test_nms_keep_sets_match_jax(rng, iou_t, max_out):
    from poet_tpu.ops import detection as jdet
    from poet_tpu_torch.ops import detection as det

    cases = [_nms_case(rng) for _ in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    # one batched fixed point for the three problems
    idx, valid = det.nms_fixed_point(_t(boxes), _t(scores), iou_t, max_out)
    keep = det.nms_keep_mask(_t(boxes), _t(scores), iou_t)
    for i in range(3):
        j_idx, j_valid = jdet.nms_fixed_point(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                              iou_t, max_out)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(j_valid))
        np.testing.assert_array_equal(
            keep[i].numpy(), np.asarray(jdet.nms_keep_mask(jnp.asarray(boxes[i]),
                                                           jnp.asarray(scores[i]), iou_t)))
        g_idx, g_valid = jdet.nms_greedy(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                         iou_t, max_out)
        p_idx, p_valid = det.nms_greedy(_t(boxes[i]), _t(scores[i]), iou_t, max_out)
        np.testing.assert_array_equal(p_idx.numpy(), np.asarray(g_idx))
        np.testing.assert_array_equal(p_valid.numpy(), np.asarray(g_valid))
        np.testing.assert_array_equal(p_idx.numpy(), idx[i].numpy())


def test_pairwise_iou_matches_jax(rng):
    from poet_tpu.ops.detection import pairwise_iou_xyxy as jiou
    from poet_tpu_torch.ops.detection import pairwise_iou_xyxy

    a, b = _rand_boxes(rng, 30), _rand_boxes(rng, 20)
    a[0] = [5, 5, 5, 9]                                          # zero area
    np.testing.assert_allclose(pairwise_iou_xyxy(_t(a), _t(b)).numpy(),
                               np.asarray(jiou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


def _cluster_case(rng, P=600, ncls=3):
    """Class 1: 500 near-identical high-score boxes at one spot + 99
    separated lower-score boxes (tests/test_detection_ops.py:427)."""
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
    return boxes.reshape(P * ncls, 4), scores.reshape(P * ncls)


def _generic_case(rng, P=300, ncls=4):
    boxes = np.tile(_rand_boxes(rng, P, 400.0)[:, None, :], (1, ncls, 1))
    boxes += rng.uniform(-2, 2, boxes.shape).astype(np.float32)
    scores = rng.uniform(0, 1, (P, ncls)).astype(np.float32)
    scores = np.where(scores > 0.35, scores, -np.inf)
    return boxes.reshape(P * ncls, 4).astype(np.float32), scores.reshape(P * ncls)


def _tie_case(P=300, ncls=2):
    boxes = np.zeros((P * ncls, 4), np.float32)
    scores = np.full(P * ncls, -np.inf, np.float32)
    for i in range(200):
        x, y = 5.0 + 22.0 * (i % 25), 5.0 + 22.0 * (i // 25)
        boxes[i * ncls + 1] = [x, y, x + 18, y + 18]
        scores[i * ncls + 1] = 0.75
    return boxes, scores


def test_exact_class_nms_matches_jax_on_the_adversarial_cluster(rng):
    from poet_tpu.ops.detection import exact_class_nms_mask as jexact
    from poet_tpu_torch.ops.detection import exact_class_nms_mask

    boxes, scores = _cluster_case(rng)
    got = exact_class_nms_mask(_t(boxes), _t(scores), 3, 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jexact(jnp.asarray(boxes),
                                                         jnp.asarray(scores), 3, 0.5)))
    assert got.sum() == 100


@pytest.mark.parametrize("case,ncls,md,k,certified", [
    ("generic", 4, 20, 128, True),
    ("cluster", 3, 100, 400, False),
    ("tie at the boundary", 2, 100, 128, False),
])
def test_pruned_class_nms_and_certificate_match_jax(rng, case, ncls, md, k, certified):
    from poet_tpu.ops.detection import class_nms_select_pruned as jpruned
    from poet_tpu_torch.ops.detection import class_nms_select_pruned

    boxes, scores = {"generic": lambda: _generic_case(rng),
                     "cluster": lambda: _cluster_case(rng),
                     "tie at the boundary": _tie_case}[case]()
    labels = np.tile(np.arange(ncls), len(scores) // ncls)
    j_sel, j_valid, j_cert = jpruned(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(labels), 0.5, md, k)
    # the port runs the problem twice, as a batch of two
    b2 = np.stack([boxes, boxes])
    s2 = np.stack([scores, scores])
    sel, valid, cert = class_nms_select_pruned(_t(b2), _t(s2), _t(labels), 0.5, md, k)
    assert bool(j_cert) == certified
    for i in range(2):
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(j_sel))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(j_valid))
        assert bool(cert[i]) == certified
