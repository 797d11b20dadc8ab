"""The eval forward in bbox_mode='backbone' against `poet_tpu`, on the CPU.

The small detect+pose configuration of `tests/test_torch_detect.py`
(B=2, 128x160, 4 detector classes, 2+2 layers, hidden 64), whose fixtures
give the JAX tree with the seeded detector weights and the images. The
targets are JAX's own detections of those images (so that every valid
detection has a match: GIoU 1, the same class) with seeded poses. JAX runs
`make_eval_forward` on its CPU routes (the XLA deformable path and the slab
RoIAlign, which `tests/test_torch_detect.py` holds the port against beside
the interpreted Pallas kernels), the port its `make_eval_forward` on the
CPU (the plain versions). Compared: the
detections row for row (rank-flip robust), the match (`match_tgt_idx`,
`match_valid`) of each paired row, and the poses on shared detections
(the port's PoET given JAX's selected queries): detect+pose poses are
chaotic in the box coordinates, so poses on each side's own detections are
not comparable (tests/test_torch_detect.py compares them the same way).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_detect import (  # noqa: F401  (fixtures)
    B,
    DEC,
    H_IMG,
    RTOL_SCALE,
    W_IMG,
    _as_detections,
    _assert_close,
    _configs,
    _pairing,
    _t,
    images,
    jax_tree,
)
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

Q = 10


def _with_counts(out):
    """An eval forward's outputs as numpy, with the selected queries' valid
    mask and count (a valid query has a class >= 1, dummies -1)."""
    out = {k: np.asarray(v) for k, v in out.items()}
    out["query_valid"] = out["pred_classes"] >= 0
    out["n_boxes"] = out["query_valid"].sum(1)
    return out


@pytest.fixture(scope="module")
def eval_outputs(jax_tree, images):
    from poet_tpu.engine.train import make_eval_forward as jforward
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.engine.train import make_eval_forward
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    jcfg, tcfg = _configs()
    pad_mask = np.zeros((B, H_IMG, W_IMG), bool)
    rng = np.random.default_rng(12)
    targets = {"boxes": np.full((B, Q, 4), -1.0, np.float32),
               "labels": np.full((B, Q), -1, np.int32), "n_boxes": np.zeros(B, np.int32),
               "relative_position": rng.normal(size=(B, Q, 3)).astype(np.float32),
               "relative_rotation": rng.normal(size=(B, Q, 3, 3)).astype(np.float32)}
    jcfg.model.enc_deform_impl = "sep"
    forward = jforward(jbuild(jcfg), jcfg)
    params = {"params": jax_tree}
    dets = _with_counts(forward(params, jnp.asarray(images), jnp.asarray(pad_mask),
                                {k: jnp.asarray(v) for k, v in targets.items()}))
    valid = dets["query_valid"]
    targets["boxes"] = np.where(valid[..., None], dets["pred_boxes"], -1.0)
    targets["labels"] = np.where(valid, dets["pred_classes"], -1).astype(np.int32)
    targets["n_boxes"] = dets["n_boxes"].astype(np.int32)
    want = _with_counts(forward(params, jnp.asarray(images), jnp.asarray(pad_mask),
                                {k: jnp.asarray(v) for k, v in targets.items()}))
    model = load_jax_params(build_model(tcfg), jax_tree).eval()
    got = make_eval_forward(model, tcfg)(_t(images), _t(pad_mask),
                                         {k: _t(v) for k, v in targets.items()})
    return model, targets, _with_counts({k: v.numpy() for k, v in got.items()}), want


def test_detections_row_for_row(eval_outputs):
    _, targets, got, want = eval_outputs
    np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
    assert (want["n_boxes"] >= 3).all()
    for b in range(B):
        _pairing(got, want, b)


def test_the_match_of_every_paired_row(eval_outputs):
    """JAX matches its own detections to themselves (the targets): every
    valid query, identity. The port's query paired with each of them has
    the same target and is valid too."""
    _, targets, got, want = eval_outputs
    for b in range(B):
        n = int(want["n_boxes"][b])
        np.testing.assert_array_equal(want["match_valid"][b], np.arange(Q) < n)
        np.testing.assert_array_equal(want["match_tgt_idx"][b, :n], np.arange(n))
        for i, j in _pairing(got, want, b):
            assert got["match_valid"][b, i] and got["match_tgt_idx"][b, i] == j, (b, i, j)
        assert got["match_valid"][b].sum() == n


def test_poses_on_shared_detections(eval_outputs, images):
    """The port's PoET on JAX's selected queries: the last layer's poses of
    every valid query agree with JAX's eval forward to RTOL_SCALE of scale."""
    model, _, _, want = eval_outputs
    with torch.inference_mode():
        same = model(_t(images), torch.zeros((B, H_IMG, W_IMG), dtype=torch.bool),
                     detections=_as_detections(want))
    for k, w in (("translations", "pred_translation"), ("rotations", "pred_rotation")):
        got = same[k][DEC - 1].numpy()
        for b in range(B):
            n = int(want["n_boxes"][b])
            _assert_close(got[b, :n], want[w][b, :n], f"{k} image {b}", rtol=RTOL_SCALE)
