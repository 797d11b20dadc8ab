"""The port's data pipeline from files against `poet_tpu.data`, and its host
helpers against theirs: the numpy transforms against the PIL ones with the
same `Generator` (uint8-equal, the same draws), `PoseDataset` items and
`PoseDataLoader` batches on `tests/helpers.make_synthetic_dataset`,
`convert_bop_to_poet`'s JSON, the rcnn YAML reader against PyYAML, the
config's JSON round trip and the metric logger. All inputs come from seeds;
everything runs on the CPU.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from tests.helpers import make_synthetic_bop_dataset, make_synthetic_dataset
from tests.test_torch_modules import one_torch_thread  # noqa: F401


def _image(rng, h=45, w=61):
    """A smooth field plus noise, uint8 HWC."""
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 90 * np.sin(x / 6.0)[..., None] * np.cos(y / 5.0)[..., None] \
        * np.array([1.0, 0.6, -0.7])
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _as_array(img):
    return np.asarray(img)


OPS = ["Color", "Contrast", "Brightness", "Sharpness", "Blur", "GrayScale"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("seed", range(4))
def test_transform_matches_pil(op, seed):
    """Each op forced to fire (p=1) and left at its own p: uint8-equal to the
    JAX package's PIL op, and the generators left in the same state."""
    import poet_tpu.data.transforms as jt
    import poet_tpu_torch.data.transforms as pt

    img = _image(np.random.default_rng(100 + seed))
    for p in (1.0, None):
        kw = {} if p is None else {"p": p}
        g_j, g_p = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            want, _ = getattr(jt, op)(**kw)(img, None, g_j)
            got, _ = getattr(pt, op)(**kw)(img, None, g_p)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, _as_array(want))
        assert g_j.random() == g_p.random()


@pytest.mark.parametrize("factor", [0.0, 0.37, 1.0, 2.5, 19.7, 48.0])
def test_enhance_factors_and_blur_radii(factor):
    """The extrapolating factors of the reference's ranges, and the blur's
    three radii, on a small image (PIL's borders dominate)."""
    from PIL import ImageEnhance, ImageFilter

    import poet_tpu_torch.data.transforms as pt

    img = _image(np.random.default_rng(7), 9, 13)
    pil = Image.fromarray(img)
    for fn, enh in ((pt.enhance_color, ImageEnhance.Color),
                    (pt.enhance_contrast, ImageEnhance.Contrast),
                    (pt.enhance_brightness, ImageEnhance.Brightness),
                    (pt.enhance_sharpness, ImageEnhance.Sharpness)):
        np.testing.assert_array_equal(fn(img, factor), np.asarray(enh(pil).enhance(factor)))
    for radius in (1, 2, 3):
        np.testing.assert_array_equal(pt.gaussian_blur(img, radius), np.asarray(
            pil.filter(ImageFilter.GaussianBlur(radius=radius))))


@pytest.mark.parametrize("split,aug,gray", [("train", True, True), ("train", False, True),
                                            ("test", True, True)])
def test_compose_chain_matches(split, aug, gray):
    import poet_tpu.data.transforms as jt
    import poet_tpu_torch.data.transforms as pt

    target = {"boxes": np.asarray([[3.0, 4.0, 30.0, 25.0], [10.0, 12.0, 50.0, 40.0]],
                                  np.float32)}
    jchain = jt.make_pose_estimation_transform(split, aug, gray)
    pchain = pt.make_pose_estimation_transform(split, aug, gray)
    for seed in range(12):
        img = _image(np.random.default_rng(seed))
        want = jchain(img, target, np.random.default_rng(seed))
        got = pchain(img, target, np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1]["boxes"], want[1]["boxes"])


def test_jitter_boxes_match():
    import poet_tpu.data.transforms as jt
    import poet_tpu_torch.data.transforms as pt

    boxes = np.random.default_rng(0).uniform(0.1, 0.5, (6, 4)).astype(np.float32)
    np.testing.assert_array_equal(pt.jitter_boxes(boxes, np.random.default_rng(5), 0.7),
                                  jt.jitter_boxes(boxes, np.random.default_rng(5), 0.7))


def _configs(data, bbox_mode="gt", aug=True, gray=True):
    from poet_tpu.config import PoETConfig as JConfig

    from poet_tpu_torch.config import PoETConfig

    cfgs = []
    for cfg in (JConfig(), PoETConfig()):
        cfg.data.dataset_path = data
        cfg.data.rgb_augmentation, cfg.data.grayscale = aug, gray
        cfg.model.bbox_mode = bbox_mode
        cfg.model.num_queries = 4
        cfgs.append(cfg)
    return cfgs


def _assert_targets_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "relative_quaternions":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")), n_train=10, n_test=4)


@pytest.mark.parametrize("split,bbox_mode", [("train", "gt"), ("train", "jitter"),
                                             ("test", "gt")])
def test_dataset_items_match(synthetic, split, bbox_mode):
    from poet_tpu.data.dataset import build_dataset as jbuild

    from poet_tpu_torch.data.dataset import build_dataset

    jcfg, pcfg = _configs(synthetic, bbox_mode)
    jds, pds = jbuild(split, jcfg), build_dataset(split, pcfg)
    assert pds.ids == jds.ids
    for i in range(len(pds)):
        for seed in range(3):
            want = jds.__getitem__(i, rng=np.random.default_rng((seed, i)))
            got = pds.__getitem__(i, rng=np.random.default_rng((seed, i)))
            np.testing.assert_array_equal(got[0], want[0])
            _assert_targets_equal(got[1], want[1])
        assert pds.file_name(pds.ids[i]) == jds.file_name(jds.ids[i])


def test_loader_batches_match(synthetic):
    from poet_tpu.data.dataset import build_dataset as jbuild
    from poet_tpu.data.loader import PoseDataLoader as JLoader

    from poet_tpu_torch.data.dataset import build_dataset
    from poet_tpu_torch.data.loader import PoseDataLoader

    jcfg, pcfg = _configs(synthetic, "jitter")
    kw = dict(batch_size=4, num_queries=4, shuffle=True, drop_last=True, seed=3,
              num_workers=2, with_jitter=True)
    jl, pl = JLoader(jbuild("train", jcfg), **kw), PoseDataLoader(build_dataset("train", pcfg), **kw)
    assert pl.steps_per_epoch() == jl.steps_per_epoch() == 2
    for epoch in (0, 1):
        for got, want in zip(pl.epoch(epoch), jl.epoch(epoch), strict=True):
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            np.testing.assert_array_equal(got[1], np.asarray(want[1]))
            _assert_targets_equal(got[2], want[2])


def test_caches_give_the_same_items(synthetic):
    """The byte cache and the decoded cache change nothing; the decoded one
    decodes each image once."""
    from poet_tpu_torch.data import dataset as dmod

    _, pcfg = _configs(synthetic, aug=False, gray=False)
    plain = dmod.build_dataset("test", pcfg)
    pcfg.data.cache_mode, pcfg.data.decoded_cache_mb = True, 64
    cached = dmod.build_dataset("test", pcfg)
    calls = []
    real = dmod.decode_image
    dmod.decode_image = lambda blob, ch=3: calls.append(1) or real(blob, ch)
    try:
        for _ in range(2):
            for i in range(len(plain)):
                a = plain.__getitem__(i, rng=np.random.default_rng(i))
                b = cached.__getitem__(i, rng=np.random.default_rng(i))
                np.testing.assert_array_equal(a[0], b[0])
    finally:
        dmod.decode_image = real
    assert len(calls) == 2 * len(plain) + len(plain)     # plain: twice, cached: once
    assert len(cached.cache) == len(plain)


def test_synthetic_background_raises(synthetic):
    """`synt_background` names a directory: a missing one raises
    FileNotFoundError (os.listdir's), as in JAX's dataset; an existing one
    gives JAX's background list (its files, in os.listdir order). The
    compositing itself: tests/test_torch_synt.py."""
    from poet_tpu.data.dataset import build_dataset as jbuild

    from poet_tpu_torch.data.dataset import build_dataset

    jcfg, pcfg = _configs(synthetic)
    for cfg, build in ((jcfg, jbuild), (pcfg, build_dataset)):
        cfg.data.synt_background = os.path.join(synthetic, "no_such_directory")
        with pytest.raises(FileNotFoundError):
            build("train", cfg)
        cfg.data.synt_background = os.path.join(synthetic, "annotations")
    got = build_dataset("train", pcfg).synthetic_background
    assert got == jbuild("train", jcfg).synthetic_background and len(got) >= 2


# ---------------------------------------------------------------- converters
def _bop_scene(root, scene, n, boxes, vis, ids):
    d = os.path.join(root, "test", scene)
    os.makedirs(os.path.join(d, "rgb"))
    for i in range(n):
        Image.new("RGB", (640, 480)).save(os.path.join(d, "rgb", f"{i:06d}.png"))
    eye = list(np.eye(3).reshape(-1))
    gt = {str(i): [{"obj_id": o, "cam_R_m2c": eye, "cam_t_m2c": [10.0 * j, 5.0, 500.0 + i]}
                   for j, o in enumerate(ids[i])] for i in range(n)}
    info = {str(i): [{"bbox_obj": b, "visib_fract": v} for b, v in zip(boxes[i], vis[i])]
            for i in range(n)}
    cam = {str(i): {"cam_K": [1066.8, 0, 312.99, 0, 1067.5, 241.31, 0, 0, 1]} for i in range(n)}
    for name, obj in (("scene_gt", gt), ("scene_gt_info", info), ("scene_camera", cam)):
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(obj, f)


@pytest.mark.parametrize("case", ["clamp", "keyframes", "lmo", "synthetic"])
def test_convert_bop_to_poet_matches(tmp_path, case):
    """tests/test_data.py's converter fixtures (clamping and the visibility
    filter, the keyframe split, the LM-O id map) and the BOP-layout helper."""
    from poet_tpu.data import converters as jc

    from poet_tpu_torch.data import converters as pc

    root = str(tmp_path / "bop")
    kw = {}
    if case == "clamp":
        _bop_scene(root, "000048", 2, [[[-10, 20, 50, 60], [600, 440, 80, 80]],
                                       [[100, 100, 600, 30]]],
                   [[0.9, 0.02], [1.0]], [[1, 5], [1]])
    elif case == "keyframes":
        _bop_scene(root, "000048", 4, [[[10, 10, 30, 30]]] * 4, [[1.0]] * 4, [[1]] * 4)
        kw = {"keyframes": ["0048/000001", "0048/000003"]}
    elif case == "lmo":
        _bop_scene(root, "000002", 1, [[[10, 10, 30, 30], [50, 50, 30, 30]]], [[1.0, 1.0]],
                   [[5, 3]])
        kw = {"obj_id_map": pc.LMO_ID_MAP, "class_names": pc.LMO_CLASSES}
    else:
        make_synthetic_bop_dataset(root, n_scenes=2, n_imgs=3)
    want = jc.convert_bop_to_poet(root, ["test"], ["real"], str(tmp_path / "j.json"), **kw)
    got = pc.convert_bop_to_poet(root, ["test"], ["real"], str(tmp_path / "p.json"), **kw)
    assert got == want
    with open(tmp_path / "j.json") as fj, open(tmp_path / "p.json") as fp:
        assert json.load(fp) == json.load(fj)
    assert pc.load_keyframes() == jc.load_keyframes()


# ---------------------------------------------------------------- the rcnn YAML
@pytest.mark.parametrize("name", ["ycbv_rcnn.yaml", "lmo_rcnn.yaml"])
def test_rcnn_yaml_matches_pyyaml(name):
    import yaml

    from poet_tpu_torch.models import REPO_ROOT
    from poet_tpu_torch.utils import rcnn_yaml

    path = os.path.join(REPO_ROOT, "configs", name)
    with open(path) as f:
        assert rcnn_yaml.load(path) == yaml.safe_load(f)


def test_rcnn_yaml_subset_and_refusals():
    import yaml

    from poet_tpu_torch.utils import rcnn_yaml

    text = ("# c\na:\n  b: 1   # trailing\n  c: [1, 2, x]\n  d:\n  - [3]\n  - name\n"
            "e: -2.5\nf: 'q # not a comment'\ng: true\nh:\ni: \"s\"\n")
    assert rcnn_yaml.loads(text) == yaml.safe_load(text)
    for bad in ("a: {b: 1}\n", "a: &x 1\n", "---\na: 1\n", "a:\n  - b: 1\n"):
        with pytest.raises(ValueError):
            rcnn_yaml.loads(bad)


def test_build_model_reads_the_rcnn_yaml():
    """The label map sets the detector's classes (LM-O: 9), anchor_sizes and
    input_resize reach the config; --inference builds the detector."""
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.models import REPO_ROOT, build_model, read_rcnn_yaml
    from poet_tpu_torch.models.backbone import MaskRCNNDetectorBackbone

    cfg = PoETConfig()
    cfg.backbone.cfg_path = os.path.join(REPO_ROOT, "configs", "lmo_rcnn.yaml")
    assert read_rcnn_yaml(cfg) == 9
    assert cfg.backbone.anchor_sizes == ((32,), (64,), (128,), (256,), (512,))
    assert cfg.backbone.input_resize == (480, 640)
    cfg.model.enc_layers = cfg.model.dec_layers = 1
    cfg.runtime.inference = True
    model = build_model(cfg)
    assert isinstance(model.backbone, MaskRCNNDetectorBackbone)
    assert model.backbone.roi_heads["box_predictor"].cls_score.weight.shape[0] == 9


# ---------------------------------------------------------------- config, metrics
def test_config_json_round_trip_and_shared_fields():
    from poet_tpu.config import PoETConfig as JConfig

    from poet_tpu_torch.config import PoETConfig

    cfg = PoETConfig()
    cfg.backbone.anchor_sizes = ((32,), (64, 96))
    cfg.runtime.export_image_size = (96, 128)
    assert PoETConfig.from_json(cfg.to_json()) == cfg
    # every field the two share has the same default, but the export's
    # platforms: the port's artifact serves the CPU and the card, JAX's the
    # CPU and the TPU
    jd, pd = JConfig().to_dict(), PoETConfig().to_dict()
    assert (jd["runtime"]["export_platforms"], pd["runtime"]["export_platforms"]) \
        == (("cpu", "tpu"), ("cpu", "cuda"))
    for section, fields in pd.items():
        for k, v in fields.items():
            if k in jd.get(section, {}) and k not in ("enc_deform_impl", "dec_deform_impl",
                                                      "export_platforms"):
                assert jd[section][k] == v, f"{section}.{k}"


def test_metric_logger_lines(capsys):
    from poet_tpu_torch.engine.metrics import MetricLogger, SmoothedValue

    logger = MetricLogger(device="cpu")
    logger.add_meter("lr", SmoothedValue(1, "{value:.6f}"))
    for i in logger.log_every(range(3), 2, "Epoch: [0]"):
        logger.update(lr=1e-4, loss=float(i))
    out = capsys.readouterr().out
    assert "Epoch: [0] [0/3]" in out and "Epoch: [0] [2/3]" in out
    assert "max mem" not in out                           # no card: no peak memory field
    assert logger.meters["loss"].global_avg == pytest.approx(1.0)
