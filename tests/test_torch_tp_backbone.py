"""The detect+pose forward (bbox_mode='backbone', Mask R-CNN) under the
(1, 2, 2) layout on 4 gloo processes against JAX's single-device forward:
the counterpart of `tests/test_tensor_parallel.py::
test_backbone_mode_sharded_matches_single_device`.

`tests/test_torch_detect.py`'s config and weights: 2 images of 128x160, 4
detector classes, 32 proposals, 10 detections, 2 encoder / 2 decoder
layers, hidden 64, 4 heads, f32; JAX's tree (`init`, then the detector's
seeded torchvision-named weights) is written once and loaded whole into
each process's sharded model (`utils/jax_params.py:load_jax_params` cuts
each split tensor to the process's shard). JAX runs its 'sep' core and its
slab RoIAlign, the CPU's defaults. The detector runs whole on every process,
so the layout's detections are the one-process port's; on JAX's selected
queries (`PoET.forward(..., detections=)`) every decoder layer's poses agree
within 1e-4 of scale, `tests/test_torch_detect.py`'s tolerance, and on its
own detections the selected classes and counts equal JAX's.
"""

import os
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":       # the children import no JAX
    from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H_IMG, W_IMG, NCLS, POST, DETS = 2, 128, 160, 4, 32, 10
ENC, DEC, HEADS, FFN = 2, 2, 4, 128
LAYOUT, W = (1, 2, 2), 4
RTOL_SCALE = 1e-4
CHILD_TIMEOUT_S = 240


def port_config():
    from poet_tpu_torch.flagship import detect_pose_config

    cfg = detect_pose_config("float32")
    m = cfg.model
    m.bbox_mode, m.enc_layers, m.dec_layers = "backbone", ENC, DEC
    m.hidden_dim, m.nheads, m.dim_feedforward, m.n_classes = 64, HEADS, FFN, NCLS - 1
    cfg.backbone.post_nms_top_n, cfg.backbone.max_detections = POST, DETS
    return cfg


def _worker(out_dir, inputs_path):
    import torch.distributed as dist

    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.parallel import mesh, tp
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from poet_tpu_torch.utils.misc import get_rank

    assert mesh.init_distributed("cpu") and mesh.world_size() == W
    inputs = torch.load(inputs_path, weights_only=False)
    cfg = port_config()
    layout = mesh.create_layout(*LAYOUT, nheads=HEADS, dim_feedforward=FFN)
    model = load_jax_params(tp.shard_module(build_model(cfg), layout), inputs["tree"]).eval()
    attn = model.transformer.encoder.layers[0].self_attn
    assert attn.n_heads == HEADS // LAYOUT[2]
    images = torch.from_numpy(inputs["images"])
    pad_mask = torch.zeros((B, H_IMG, W_IMG), dtype=torch.bool)
    with torch.inference_mode():
        own = model(images, pad_mask)
        shared = model(images, pad_mask, detections={
            k: torch.from_numpy(v) for k, v in inputs["detections"].items()})
    if get_rank() == 0:
        torch.save({"own": {k: v.numpy() for k, v in own.items()},
                    "shared": {k: v.numpy() for k, v in shared.items()},
                    "heads": attn.n_heads}, os.path.join(out_dir, "results.pt"))
    dist.destroy_process_group()


def _as_detections(out):
    """A PoET output's selected queries as detections (xyxy pixels)."""
    cx, cy, w, h = np.moveaxis(out["pred_boxes"] * [W_IMG, H_IMG, W_IMG, H_IMG], -1, 0)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return {"boxes": boxes.astype(np.float32), "scores": out["pred_scores"],
            "labels": out["pred_classes"], "valid": out["query_valid"]}


@pytest.fixture(scope="module")
def jax_forward(tmp_path_factory):
    """JAX's tree and single-device forward, and the children's input file."""
    import jax
    import jax.numpy as jnp

    from poet_tpu.config import PoETConfig
    from poet_tpu.models import build_model
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads, convert_resnet_fpn
    from tests.test_detector_numeric_parity import _rcnn_state_dict

    jcfg, tcfg = PoETConfig(), port_config()
    for sect in ("model", "backbone"):
        for k, v in vars(getattr(tcfg, sect)).items():
            if hasattr(getattr(jcfg, sect), k):
                setattr(getattr(jcfg, sect), k, v)
    jcfg.model.enc_deform_impl = "sep"
    model = build_model(jcfg)
    tree = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                               jnp.zeros((1, 64, 64), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = _rcnn_state_dict(num_classes=NCLS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd),
                        "detector": convert_maskrcnn_heads(sd)}
    images = np.random.default_rng(11).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    want = jax.jit(model.apply)({"params": tree}, jnp.asarray(images),
                                jnp.zeros((B, H_IMG, W_IMG), bool), None)
    want = {k: np.asarray(v) for k, v in want.items()}
    path = str(tmp_path_factory.mktemp("tp_backbone") / "inputs.pt")
    torch.save({"tree": tree, "images": images, "detections": _as_detections(want)}, path)
    return want, path


@pytest.fixture(scope="module")
def layout_forward(tmp_path_factory, jax_forward):
    from tests.test_torch_ddp import join_children
    from tests.test_torch_tp_train import start_children

    out = str(tmp_path_factory.mktemp("tp_backbone_out"))
    join_children(start_children(W, out, jax_forward[1], script=__file__), CHILD_TIMEOUT_S)
    return torch.load(os.path.join(out, "results.pt"), weights_only=False)


def _assert_close(got, want, name):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=RTOL_SCALE, err_msg=name)


def test_backbone_forward_under_layout_matches_jax(jax_forward, layout_forward):
    want, _ = jax_forward
    got = layout_forward["shared"]
    assert layout_forward["heads"] == HEADS // LAYOUT[2]
    assert got["translations"].shape == want["translations"].shape == (DEC, B, 10, 3)
    assert (want["n_boxes"] >= 3).all()
    for k in ("pred_classes", "n_boxes", "query_valid", "pred_scores"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for lvl in range(DEC):
        for k in ("translations", "rotations"):
            for b in range(B):
                n = int(want["n_boxes"][b])
                _assert_close(got[k][lvl, b, :n], want[k][lvl, b, :n], f"{k}[{lvl}] image {b}")


def test_backbone_detections_under_layout_match_jax(jax_forward, layout_forward):
    want, _ = jax_forward
    own = layout_forward["own"]
    np.testing.assert_array_equal(own["n_boxes"], want["n_boxes"])
    np.testing.assert_array_equal(np.sort(own["pred_classes"], -1),
                                  np.sort(want["pred_classes"], -1))
    assert np.isfinite(own["translations"]).all() and np.isfinite(own["rotations"]).all()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(*sys.argv[1:])
