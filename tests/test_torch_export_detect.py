"""The export twin in detector mode (bbox_mode='backbone'), on the CPU.

* Mask R-CNN at `tests/test_torch_detect.py`'s small config and YOLOv4-CSP
  at `tests/test_torch_yolov4.py`'s mini cfg, each with JAX's init (and
  the seeded detector weights those files use) carried to the port by
  `load_jax_params`: the port's artifact (`export_model` +
  `ExportedPoseServer(device="cpu")`, images alone) gives its live
  `PoseServer`'s detections and poses bit for bit, and JAX's artifact
  (`export_model(..., platforms=("cpu",))`, which lowers in backbone mode
  on the CPU) the same detections: per image the same count, and row by
  row the same class with the box within 5e-3 px. Poses are not compared
  across the frameworks here: neither artifact takes detections as an
  input, and a pose is chaotic in its box's coordinates (the dyadic box
  embedding; tests/test_torch_detect.py compares them on shared
  detections). `stream` answers what `infer` does. The YOLO program holds
  the darknet epilogue operator, one call a BN conv after the stem.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

BOX_PX = 5e-3


def _rcnn(cfg_dir):
    from poet_tpu.models import build_model as jbuild
    from poet_tpu.utils.torch_import import convert_maskrcnn_heads, convert_resnet_fpn
    from tests.test_detector_numeric_parity import _rcnn_state_dict
    from tests.test_torch_detect import B, H_IMG, NCLS, W_IMG, _configs

    jcfg, tcfg = _configs()
    jcfg.model.enc_deform_impl = "sep"
    tree = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                      jnp.zeros((1, 64, 64), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    sd = _rcnn_state_dict(num_classes=NCLS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd), "detector": convert_maskrcnn_heads(sd)}
    images = np.random.default_rng(11).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    return jcfg, tcfg, tree, images


def _yolo(cfg_dir):
    from poet_tpu.models import build_model as jbuild
    from poet_tpu_torch.flagship import darknet_state
    from tests.test_torch_yolov4 import B, H_IMG, MINI_CFG, W_IMG, _configs, _frozen

    path = cfg_dir / "mini.cfg"
    path.write_text(MINI_CFG)
    jcfg, tcfg = _configs(str(path))
    images = np.random.default_rng(5).uniform(size=(B, H_IMG, W_IMG, 3)).astype(np.float32)
    tree = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                      jnp.zeros((B, H_IMG, W_IMG), bool), None)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["backbone"]["body"] = darknet_state(_frozen(MINI_CFG))
    return jcfg, tcfg, tree, images


@pytest.fixture(scope="module", params=["maskrcnn", "yolov4"])
def detector(request, tmp_path_factory):
    from poet_tpu.engine.serving import ExportedPoseServer as JServer, export_model as jexport
    from poet_tpu_torch.engine.serving import ExportedPoseServer, PoseServer, export_model
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    root = tmp_path_factory.mktemp(request.param)
    jcfg, tcfg, tree, images = (_rcnn if request.param == "maskrcnn" else _yolo)(root)
    B, H, W = images.shape[:3]
    jpath = jexport(jcfg, {"params": tree}, str(root / "jax"), batch_size=B, image_size=(H, W),
                    platforms=("cpu",))
    want = JServer(jpath).infer(images)
    model = load_jax_params(build_model(tcfg), tree).eval()
    live = PoseServer(tcfg, model, batch_size=B, image_size=(H, W), device="cpu")
    path = export_model(tcfg, model, str(root / "port"), batch_size=B, image_size=(H, W),
                        platforms=("cpu", "cuda"))
    server = ExportedPoseServer(path, device="cpu")
    return dict(kind=request.param, server=server, images=images, got=server.infer(images),
                live=live.infer(images), want=want)


def test_detector_artifact_matches_the_live_server(detector):
    got, live = detector["got"], detector["live"]
    assert set(got) == set(live) == {"translation", "rotation", "boxes", "classes", "n_boxes"}
    assert (got["n_boxes"] >= 2).all()
    for k in got:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
    assert detector["server"].meta["bbox_mode"] == "backbone"


def test_detector_artifact_holds_the_darknet_epilogue(detector):
    """The YOLO program calls the epilogue operator once for each of the
    mini cfg's five BN convs after the stem (its answers are the live
    server's, above); Mask R-CNN's ResNet-FPN never calls it."""
    graph = detector["server"].program.graph
    calls = [n for n in graph.nodes
             if n.op == "call_function" and "darknet_epilogue" in str(n.target)]
    assert len(calls) == (5 if detector["kind"] == "yolov4" else 0)


def test_detector_artifact_finds_jax_artifacts_detections(detector):
    got, want = detector["got"], detector["want"]
    H, W = detector["images"].shape[1:3]
    scale = np.array([W, H, W, H])
    np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
    for b in range(len(got["n_boxes"])):
        n = int(want["n_boxes"][b])
        used = set()
        for j in range(n):
            cand = [i for i in range(n) if i not in used
                    and got["classes"][b, i] == want["classes"][b, j]
                    and (np.abs(got["boxes"][b, i] - want["boxes"][b, j]) * scale).max()
                    < BOX_PX]
            assert cand, f"image {b}: JAX row {j} has no match in the port's artifact"
            used.add(cand[0])
    assert np.isfinite(got["translation"]).all() and np.isfinite(got["rotation"]).all()


def test_detector_artifact_stream(detector):
    server, images = detector["server"], detector["images"]
    frames = [images, images[::-1].copy()]
    streamed = list(server.stream(iter(frames)))
    assert len(streamed) == 2
    for k in detector["got"]:
        np.testing.assert_array_equal(streamed[0][k], detector["got"][k], err_msg=k)
    np.testing.assert_array_equal(streamed[1]["n_boxes"], detector["got"]["n_boxes"][::-1])
    with pytest.raises(ValueError, match="images only"):
        server.infer(images, boxes=np.zeros((len(images), 10, 4), np.float32))
