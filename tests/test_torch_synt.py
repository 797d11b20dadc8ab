"""'synt' compositing (`synt_background`) of the port's `PoseDataset`
against `poet_tpu.data.dataset`'s, and its two image operations against PIL.

* `native.resize_bicubic` against PIL's default `Image.resize` (bicubic,
  reducing_gap=None) for downscales, upscales, one axis only, the same
  size and empty inputs (all black), byte for byte; `native.paste_rgba`
  against `bg.paste(img, (0, 0), img)` with alpha 0, 255 and between;
* a tiny 'train_synt' split of 48x64 RGBA PNGs (alpha 0 in one band, 255 in
  another, random elsewhere) and one RGB image of type 'real', composited
  onto a background directory of the committed JPEG fixtures (480x640 down
  to 37x53) and PNGs (RGB, RGBA, gray, and a 3x4 one, whose crops are often
  empty): every item over 24 seeds byte-equal to JAX's image and equal
  targets, with and without the augmentations and the decoded cache; the
  seeds' draws, replayed, cover both flips, crops and empty crops;
* one epoch of `PoseDataLoader` batches against JAX's.
"""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from poet_tpu_torch import native
from tests.test_torch_data_files import _assert_targets_equal
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
H, W, N_SYNT, SEEDS = 48, 64, 4, 24


# ---------------------------------------------------------------- image ops
@pytest.mark.parametrize("src,dst", [((480, 640), (48, 64)), ((37, 53), (48, 64)),
                                     ((120, 160), (97, 31)), ((48, 30), (48, 64)),
                                     ((20, 64), (48, 64)), ((48, 64), (48, 64)),
                                     ((0, 53), (48, 64)), ((37, 0), (5, 7)), ((0, 0), (3, 3)),
                                     ((1, 1), (40, 2)), ((333, 7), (2, 500))])
def test_resize_matches_pil(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    arr = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    pil = Image.fromarray(arr) if all(src) else Image.new("RGB", src[::-1])
    want = np.asarray(pil.resize(dst[::-1]))
    got = native.resize_bicubic(arr, dst[1], dst[0])
    np.testing.assert_array_equal(got, want)
    if not all(src):
        assert not got.any()                       # an empty crop resizes to black


def test_paste_matches_pil():
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 256, (31, 45, 3)).astype(np.uint8)
    img = rng.integers(0, 256, (31, 45, 4)).astype(np.uint8)
    img[..., 3] = rng.choice(np.array([0, 1, 127, 128, 254, 255], np.uint8), (31, 45))
    want = Image.fromarray(bg)
    rgba = Image.fromarray(img, "RGBA")
    want.paste(rgba, (0, 0), rgba)
    np.testing.assert_array_equal(native.paste_rgba(bg, img), np.asarray(want))


# ---------------------------------------------------------------- the split
def _png(path, arr, mode=None):
    Image.fromarray(arr, mode).save(path)


@pytest.fixture(scope="module")
def synt(tmp_path_factory):
    """(dataset root, background directory)."""
    root = tmp_path_factory.mktemp("synt")
    rng = np.random.default_rng(16)
    os.makedirs(root / "train" / "000001" / "rgb")
    os.makedirs(root / "annotations")
    images, anns = [], []
    for i in range(N_SYNT + 1):
        name = f"000001/rgb/{i:06d}.png"
        rgba = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        rgba[:, :16, 3] = 0
        rgba[:, 16:32, 3] = 255
        kind = "synt" if i < N_SYNT else "real"
        _png(root / "train" / name, rgba if kind == "synt" else rgba[..., :3])
        images.append({"id": i, "file_name": name, "width": W, "height": H, "type": kind,
                       "intrinsics": [100.0, 0, W / 2, 0, 100.0, H / 2, 0, 0, 1]})
        for _ in range(int(rng.integers(1, 4))):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            q *= np.sign(np.linalg.det(q))
            anns.append({"id": len(anns), "image_id": i, "iscrowd": 0,
                         "bbox": [float(rng.uniform(0, 40)), float(rng.uniform(0, 30)),
                                  float(rng.uniform(5, 20)), float(rng.uniform(5, 15))],
                         "category_id": int(rng.integers(1, 4)),
                         "relative_pose": {"position": rng.normal(size=3).tolist(),
                                           "rotation": q.reshape(-1).tolist()}})
    with open(root / "annotations" / "train_synt.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}, f)
    bg = root / "backgrounds"
    os.makedirs(bg / "a_directory")                    # skipped: not a file
    for name in ("background_480x640", "baseline_420_120x160", "baseline_444_37x53",
                 "gray_37x53", "progressive_420_48x64"):
        shutil.copy(os.path.join(FIXTURES, name + ".jpg"), bg / (name + ".jpg"))
    _png(bg / "rgb.png", rng.integers(0, 256, (50, 70, 3)).astype(np.uint8))
    _png(bg / "rgba.png", rng.integers(0, 256, (30, 90, 4)).astype(np.uint8), "RGBA")
    _png(bg / "gray.png", rng.integers(0, 256, (64, 48)).astype(np.uint8))
    _png(bg / "tiny.png", rng.integers(0, 256, (3, 4, 3)).astype(np.uint8))
    return str(root), str(bg)


def _configs(root, bg, aug, cache_mb):
    from poet_tpu.config import PoETConfig as JConfig

    from poet_tpu_torch.config import PoETConfig

    cfgs = []
    for cfg in (JConfig(), PoETConfig()):
        cfg.data.dataset_path, cfg.data.synt_background = root, bg
        cfg.data.rgb_augmentation = cfg.data.grayscale = aug
        cfg.data.decoded_cache_mb = cache_mb
        cfg.model.num_queries = 4
        cfgs.append(cfg)
    return cfgs


def _draws(seed, i, backgrounds):
    """What `_get_background` does for item i under this seed: the draws of
    the item's generator replayed in JAX's order."""
    rng = np.random.default_rng((seed, i))
    path = backgrounds[int(rng.integers(0, len(backgrounds)))]
    with open(path, "rb") as f:
        w, h = native.image_size(f.read())
    events = set()
    if rng.random() < 0.5:
        events.add("flip_tb")
    elif rng.random() < 0.5:
        events.add("flip_lr")
    if rng.random() < 0.5:
        left, top = int(rng.integers(0, w + 1)), int(rng.integers(0, h + 1))
        right, bottom = int(rng.integers(left, w + 1)), int(rng.integers(top, h + 1))
        events.add("empty_crop" if right == left or bottom == top else "crop")
    return events


@pytest.mark.parametrize("aug,cache_mb", [(True, 0), (False, 64)])
def test_items_match_jax(synt, aug, cache_mb):
    from poet_tpu.data.dataset import build_dataset as jbuild

    from poet_tpu_torch.data.dataset import build_dataset

    root, bg = synt
    jcfg, pcfg = _configs(root, bg, aug, cache_mb)
    jds, pds = jbuild("train_synt", jcfg), build_dataset("train_synt", pcfg)
    assert pds.synthetic_background == jds.synthetic_background
    assert len(pds.synthetic_background) == 9
    events = set()
    for seed in range(SEEDS):
        for i in range(len(pds)):
            want = jds.__getitem__(i, rng=np.random.default_rng((seed, i)))
            got = pds.__getitem__(i, rng=np.random.default_rng((seed, i)))
            np.testing.assert_array_equal(got[0], np.asarray(want[0]),
                                          err_msg=f"seed {seed} item {i}")
            _assert_targets_equal(got[1], want[1])
            if i < N_SYNT:
                events |= _draws(seed, i, pds.synthetic_background)
    assert events == {"flip_tb", "flip_lr", "crop", "empty_crop"}
    if cache_mb:
        assert sum(k[1] == "BG" for k in pds._decoded_cache) == 9


def test_loader_batches_match_jax(synt):
    from poet_tpu.data.dataset import build_dataset as jbuild
    from poet_tpu.data.loader import PoseDataLoader as JLoader

    from poet_tpu_torch.data.dataset import build_dataset
    from poet_tpu_torch.data.loader import PoseDataLoader

    root, bg = synt
    jcfg, pcfg = _configs(root, bg, True, 0)
    kw = dict(batch_size=2, num_queries=4, shuffle=True, drop_last=True, seed=5,
              num_workers=2)
    jl = JLoader(jbuild("train_synt", jcfg), **kw)
    pl = PoseDataLoader(build_dataset("train_synt", pcfg), **kw)
    n = 0
    for got, want in zip(pl.epoch(1), jl.epoch(1), strict=True):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        _assert_targets_equal(got[2], want[2])
        n += 1
    assert n == 2
