"""Tensor parallelism's first-step gradients on well-conditioned targets:
the layout (1,1,2) over 2 gloo processes on the CPU against the port's one
process, every gradient tensor within 1e-5 relative L2, and against one
process taking TP's order of sums (`chip_smoke.tp_order`): the same losses
bit for bit, every gradient within 1e-5.

`tests/test_torch_ddp.py`'s small PoET at 64x64 (hidden 32, 4 heads, FFN
64, 2 encoder / 2 decoder layers, f32, the 'sep' core) on its first global
batch of 8 images. The target rotations are drawn as `chip_smoke.py`'s
layout phase draws its conditioned ones (`flagship.conditioned_rotations`
from the seed, checked on the one-process model's f32 forward): every
decoder layer's valid pair lies 20-160 degrees from its target. There the
rotation loss's arccos has a gradient of at most 1 / sin(20 deg), so the
other order of the f32 sums that TP takes (a row-parallel product summed in
halves, then over 'model') moves each gradient by about as much as it moves
the forward; on targets within a rounding-sized angle of 0 or pi the same
rounding moves a rotation head's gradient by orders of magnitude more.

Each child is joined with a timeout and killed on expiry.
"""

import os
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":       # the children import no JAX
    from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

from tests.test_torch_ddp import HEADS, FFN, _port_config, initial_model  # noqa: E402
from tests.test_torch_tp_train import (  # noqa: E402
    layout_run,
    sharded_model,
    start_children,
)

LAYOUT = (1, 1, 2)
TARGET_SEED = 22
# every gradient tensor against one process's, relative L2; a tensor whose
# one-process gradient is rounding noise (at most NOISE of the largest
# gradient element: a conv bias ahead of a GroupNorm of one channel a group,
# whose exact gradient is 0) has no relative measure and is held within
# NOISE of that largest element instead
GRAD_L2_RTOL, NOISE = 1e-5, 1e-8
LOSS_RTOL = 1e-6
CHILD_TIMEOUT_S = 240


def conditioned_batch(model, batch, seed=TARGET_SEED):
    """The batch with conditioned target rotations, and every layer's pair
    angle (degrees) on the one-process model's f32 forward."""
    from poet_tpu_torch.flagship import conditioned_rotations, pair_angles
    from tests.test_torch_variants import _predicted_rotations

    images, pad_mask, targets = batch
    rot = _predicted_rotations(model, batch).double().numpy()
    targets = dict(targets, relative_rotation=conditioned_rotations(rot, targets, seed))
    valid = np.arange(rot.shape[2])[None, :] < targets["n_boxes"][:, None]
    angles = np.degrees(pair_angles(rot, targets["relative_rotation"]))[:, valid]
    return (images, pad_mask, targets), angles


def _worker(out_dir, batch_path, start_path):
    import torch.distributed as dist

    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.utils.misc import get_rank

    assert mesh.init_distributed("cpu") and mesh.world_size() == 2
    with np.load(batch_path) as z:
        batch = (z["images"], z["pad_mask"],
                 {k[2:]: z[k] for k in z.files if k.startswith("t_")})
    layout = mesh.create_layout(*LAYOUT, nheads=HEADS, dim_feedforward=FFN)
    cfg = _port_config("sgd")
    model = sharded_model(torch.load(start_path, weights_only=True), cfg, layout)
    metrics, grads, _, _ = layout_run(model, cfg, [batch], 1)
    if get_rank() == 0:
        torch.save({"metrics": metrics[0], "grads": grads[0]},
                   os.path.join(out_dir, "results.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(start state, its file, the conditioned batch, its file, the angles)."""
    from tests.test_torch_ddp import global_batch

    root = tmp_path_factory.mktemp("tp_conditioning")
    state = initial_model().state_dict()
    start_path = str(root / "start.pt")
    torch.save(state, start_path)
    batch, angles = conditioned_batch(initial_model(state), global_batch(0))
    batch_path = str(root / "batch.npz")
    images, pad_mask, t = batch
    np.savez(batch_path, images=images, pad_mask=pad_mask,
             **{f"t_{k}": v for k, v in t.items()})
    return state, start_path, batch, batch_path, angles


@pytest.fixture(scope="module")
def layout_result(tmp_path_factory, setup):
    from tests.test_torch_ddp import join_children

    _, start_path, _, batch_path, _ = setup
    out = str(tmp_path_factory.mktemp("tp_conditioning_out"))
    started = start_children(2, out, batch_path, start_path, script=__file__)
    try:
        join_children(started, CHILD_TIMEOUT_S)
    finally:
        for p in started[1]:
            p.kill()
    return torch.load(os.path.join(out, "results.pt"), weights_only=False)


@pytest.fixture(scope="module")
def one_process(setup):
    state, _, batch, _, _ = setup
    metrics, grads, _, _ = layout_run(initial_model(state), _port_config("sgd"), [batch], 1)
    return metrics[0], grads[0]


@pytest.fixture(scope="module")
def tp_order_process(setup):
    """One process taking the layout's order of sums (`chip_smoke.tp_order`)."""
    import chip_smoke

    state, _, batch, _, _ = setup
    model = initial_model(state)
    with chip_smoke.tp_order(model, LAYOUT[2]):
        metrics, grads, _, _ = layout_run(model, _port_config("sgd"), [batch], 1)
    return metrics[0], grads[0]


def test_every_layer_pair_in_band(setup):
    from poet_tpu_torch.flagship import CONDITIONED_BAND_DEG

    angles = setup[4]
    assert angles.shape[0] == 2 and angles.shape[1] > 20
    lo, hi = CONDITIONED_BAND_DEG
    assert angles.min() >= lo and angles.max() <= hi, (angles.min(), angles.max())


def test_layout_gradients_match_one_process(layout_result, one_process):
    want_metrics, want = one_process
    got_metrics, got = layout_result["metrics"], layout_result["grads"]
    for k, v in want_metrics.items():
        if k != "grad_norm":
            np.testing.assert_allclose(got_metrics[k], v, rtol=LOSS_RTOL, err_msg=k)
    _assert_grads_close(got, want)


def _assert_grads_close(got, want):
    """Every tensor within GRAD_L2_RTOL relative L2, a noise-only one within
    NOISE of the largest gradient element."""
    assert list(got) == list(want) and len(want) > 50
    noise = NOISE * max(float(v.abs().max()) for v in want.values())
    real = {n for n, w in want.items() if float(w.abs().max()) > noise}
    assert len(real) > 50
    gaps = {n: float((got[n] - want[n]).norm()) / float(want[n].norm()) for n in real}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_L2_RTOL, (worst, gaps[worst])
    for n in set(want) - real:
        assert float((got[n] - want[n]).abs().max()) <= noise, n


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(*sys.argv[1:])


def test_layout_is_one_process_in_its_order_of_sums(layout_result, tp_order_process):
    """The layout's forward is one process's arithmetic in TP's order of
    sums bit for bit (the losses equal), and its gradients part from that
    only by the backward's order (a fault in TP's collectives or shards
    would show here, whatever the targets' conditioning)."""
    want_metrics, want = tp_order_process
    got_metrics, got = layout_result["metrics"], layout_result["grads"]
    assert {k: v for k, v in got_metrics.items() if k != "grad_norm"} == \
        {k: v for k, v in want_metrics.items() if k != "grad_norm"}
    _assert_grads_close(got, want)


# ---------------------------------------------------------------- the check's tools
def test_corner_index_rounds_twice():
    """`chip_smoke.corner_index` is floor(fl(fl(loc * size) - 0.5)), the
    kernels' `pixel_coord`, on points next to every cell edge too."""
    import chip_smoke

    shapes = ((30, 40), (15, 20), (8, 10), (4, 5))
    rng = np.random.default_rng(5)
    locs = rng.uniform(-0.1, 1.1, size=(2, 7, 3, 4, 4, 2)).astype(np.float32)
    for l, (h, w) in enumerate(shapes):
        for a, size in ((0, w), (1, h)):
            edge = (np.arange(1, size) + 0.5) / np.float32(size)
            n = min(edge.size, 4 * 2 * 7)
            flat = locs[..., l, :, a].reshape(-1)
            flat[:n] = np.nextafter(edge[:n].astype(np.float32),
                                    np.float32(rng.choice([-1, 1])))
            locs[..., l, :, a] = flat.reshape(locs[..., l, :, a].shape)
    got = chip_smoke.corner_index(torch.from_numpy(locs), shapes).numpy()
    size = np.array([[w, h] for h, w in shapes], np.float32)[:, None, :]
    want = np.floor((locs * size).astype(np.float32) - np.float32(0.5)).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_sampling_pin_takes_the_record_straight_through(setup):
    """A model pinned to another's record of its sampling outputs, the two
    differing only in the sampling projections' weights, takes the other's
    losses bit for bit, and the gradient passes the pin unchanged: the last
    decoder layer's sampling projections' own gradients and the pose heads'
    are the other's. (Every gradient upstream of a pinned projection passes
    through that projection's own, different weights.)"""
    import chip_smoke

    state, _, batch, _, _ = setup
    moved = dict(state)
    g = torch.Generator().manual_seed(3)
    for k, v in state.items():
        if k.endswith(("sampling_offsets.weight", "attention_weights.weight")):
            moved[k] = v + 0.01 * torch.randn(v.shape, generator=g)
    cfg = _port_config("sgd")
    recorder = initial_model(moved)
    with chip_smoke.sampling_pin(recorder) as record:
        want_metrics, want, _, _ = layout_run(recorder, cfg, [batch], 1)
    assert len(record) == 8 and all(len(v) == 1 for v in record.values())
    pinned = initial_model(state)
    with chip_smoke.sampling_pin(pinned, record):
        got_metrics, got, _, _ = layout_run(pinned, cfg, [batch], 1)
    assert {k: v for k, v in got_metrics[0].items() if k != "grad_norm"} == \
        {k: v for k, v in want_metrics[0].items() if k != "grad_norm"}
    last = "transformer.decoder.layers.1.cross_attn."
    same = [n for n in want[0] if n in (last + "sampling_offsets.weight",
                                        last + "attention_weights.weight")
            or n.startswith(("rotation_head.", "translation_head."))]
    assert len(same) == 2 + 2 * 2 * 6
    for n in same:
        assert torch.equal(got[0][n], want[0][n]), n


def test_flipped_layer_names():
    import chip_smoke

    flips = {"encoder.0": 0, "encoder.1": 3, "decoder.1": 1}
    assert chip_smoke.flipped_layer("transformer.encoder.layers.1.self_attn.value_proj.weight",
                                    flips)
    assert chip_smoke.flipped_layer("transformer.decoder.layers.1.norm1.bias", flips)
    assert not chip_smoke.flipped_layer("transformer.encoder.layers.0.linear1.weight", flips)
    assert not chip_smoke.flipped_layer("transformer.encoder.layers.11.linear1.weight", flips)
    assert not chip_smoke.flipped_layer("rotation_head.1.layers.0.weight", flips)


def test_pair_report_finds_the_clamp():
    """A pair at the target sits on the arccos clamp, one at 90 degrees does
    not; the smallest sin^2 is that of the pair nearest 0 or pi."""
    import chip_smoke
    from scipy.spatial.transform import Rotation

    targets = {"relative_rotation": Rotation.random(4, random_state=1).as_matrix()
               .reshape(1, 4, 3, 3), "n_boxes": np.array([3])}
    turn = Rotation.from_euler("x", [[0.0], [90.0], [179.0], [30.0]], degrees=True).as_matrix()
    rot = torch.from_numpy((targets["relative_rotation"][0] @ turn)[None, None])
    (row,) = chip_smoke.pair_report(rot, targets)
    assert row["n"] == 3 and row["clamped"] == 1
    np.testing.assert_allclose(row["deg"], [0.0, 90.0, 179.0], atol=1e-6)
    assert row["min_sin2"] < 1e-12 and row["min_sin2_deg"] < 1e-3
