"""Pose-estimation dataset: COCO-style JSON + PNG files -> padded numpy
targets. Counterpart of `poet_tpu/data/dataset.py` (`PoseDataset`,
`build_dataset`, `load_image_rgb_f32`), with the port's PNG decoder
(`poet_tpu_torch/native`) and numpy transforms (`data/transforms.py`) in
place of libpng and PIL.

Parity targets (the reference's): data_utils/torchvision_datasets/coco.py
(plain JSON instead of pycocotools, the in-RAM byte cache sharded by local
rank) and data_utils/pose_dataset.py (ProcessPoseData: box xywh -> xyxy
clamp, degenerate-box filter, relative pose with derived quaternions,
per-object intrinsics; split -> path map; box jitter). The decoded-image
cache is the JAX package's extension (`decoded_cache_mb`).

'synt' images (an image entry with "type": "synt") are RGBA renders. With
`synthetic_background` (a directory) each is pasted with its alpha onto a
background file drawn at random (`_get_background`, as
`poet_tpu/data/dataset.py:189-230`: the file list in `os.listdir` order, and
from the item's generator in JAX's order the file's index, a top-bottom
flip or else a left-right one, a crop at four random integers, then PIL's
default bicubic resize to the image's size; the resize and the paste are
Pillow's arithmetic in C, `native.resize_bicubic` / `native.paste_rgba`).
Decoded backgrounds share the decoded-image cache and its byte budget.
Without a background directory a 'synt' image is read as RGB (its alpha
dropped), as JAX's `convert("RGB")` does.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from poet_tpu_torch.data.transforms import (
    Compose,
    image_hw,
    jitter_boxes,
    make_pose_estimation_transform,
)
from poet_tpu_torch.native import (  # noqa: F401  (load_image_rgb_f32: JAX's module has it)
    decode_image,
    load_image_rgb_f32,
    paste_rgba,
    resize_bicubic,
)
from poet_tpu_torch.utils.quaternions import quat2rot_np, rot2quat_np


class PoseDataset:
    """COCO-style 6D pose dataset. Args mirror the reference's
    pose_dataset.py:39-59; `__getitem__(idx, rng)` returns (uint8-derived
    float32 (H, W, 3) image in [0, 1], target dict)."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        synthetic_background: Optional[str] = None,
        transforms: Optional[Compose] = None,
        jitter: bool = False,
        jitter_probability: float = 0.5,
        jitter_std: float = 0.02,
        cache_mode: bool = False,
        decoded_cache_mb: int = 0,
        local_rank: int = 0,
        local_size: int = 1,
    ):
        self.root = str(img_folder)
        with open(ann_file) as f:
            coco = json.load(f)
        self.images: Dict[int, dict] = {img["id"]: img for img in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {i: [] for i in self.images}
        for ann in coco["annotations"]:
            if ann["image_id"] in self.anns_by_image:
                self.anns_by_image[ann["image_id"]].append(ann)
        self.categories = coco.get("categories", [])
        self.ids = sorted(self.images.keys())
        self._transforms = transforms
        self.jitter = jitter
        self.jitter_probability = jitter_probability
        self.jitter_std = jitter_std

        self.cache_mode = cache_mode
        self.local_rank = local_rank
        self.local_size = local_size
        self.cache: Dict[str, bytes] = {}
        if cache_mode:
            self._cache_images()
        # decoded uint8 pixels up to a byte budget, filled on first decode and
        # never evicted (epochs read every image once, so a prefix cache is as
        # good as LRU); stored read-only: every transform returns a new array
        self._decoded_cache: Dict[tuple, np.ndarray] = {}
        self._decoded_budget = int(decoded_cache_mb) * (1 << 20)
        self._decoded_bytes = 0
        self.synthetic_background = None
        if synthetic_background is not None:
            self.synthetic_background = [
                os.path.join(synthetic_background, f) for f in os.listdir(synthetic_background)
                if os.path.isfile(os.path.join(synthetic_background, f))]

    def __len__(self):
        return len(self.ids)

    def file_name(self, image_id: int) -> str:
        return self.images[image_id]["file_name"]

    def _cache_images(self):
        """In-RAM byte cache sharded by local rank (the reference's coco.py:66-73)."""
        for index, img_id in enumerate(self.ids):
            if index % self.local_size != self.local_rank:
                continue
            path = self.images[img_id]["file_name"]
            with open(os.path.join(self.root, path), "rb") as f:
                self.cache[path] = f.read()

    def _get_blob(self, path: str) -> bytes:
        if self.cache_mode:
            if path not in self.cache:
                with open(os.path.join(self.root, path), "rb") as f:
                    self.cache[path] = f.read()
            return self.cache[path]
        with open(os.path.join(self.root, path), "rb") as f:
            return f.read()

    def _cached(self, key: tuple, decode) -> np.ndarray:
        """`decode()` through the decoded cache, under its byte budget."""
        arr = self._decoded_cache.get(key)
        if arr is None:
            arr = decode()
            if self._decoded_bytes + arr.nbytes <= self._decoded_budget:
                arr.setflags(write=False)
                # a dict assignment is atomic under the GIL: a racing worker at
                # worst decodes the same image twice
                self._decoded_cache[key] = arr
                self._decoded_bytes += arr.nbytes
        return arr

    def _get_image(self, path: str, channels: int = 3) -> np.ndarray:
        """(H, W, channels) uint8 of one image file, through the decoded cache."""
        return self._cached((path, channels),
                            lambda: decode_image(self._get_blob(path), channels))

    def _get_background(self, width: int, height: int, rng) -> np.ndarray:
        """A random background flipped, cropped and resized to (height, width, 3)
        (JAX's `_get_background`; the reference's coco.py:83-104)."""
        path = self.synthetic_background[int(rng.integers(0, len(self.synthetic_background)))]

        def decode():
            with open(path, "rb") as f:
                return decode_image(f.read(), 3)

        bg = self._cached((path, "BG"), decode)
        h, w = bg.shape[:2]
        if rng.random() < 0.5:
            bg = bg[::-1]
        elif rng.random() < 0.5:
            bg = bg[:, ::-1]
        if rng.random() < 0.5:
            left = int(rng.integers(0, w + 1))
            top = int(rng.integers(0, h + 1))
            right = int(rng.integers(left, w + 1))
            bottom = int(rng.integers(top, h + 1))
            bg = bg[top:bottom, left:right]
        return resize_bicubic(bg, width, height)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img_id = self.ids[idx]
        info = self.images[img_id]
        anno = [a for a in self.anns_by_image[img_id] if a.get("iscrowd", 0) == 0]
        if info.get("type") == "synt" and self.synthetic_background is not None:
            rgba = self._get_image(info["file_name"], 4)
            img = paste_rgba(self._get_background(rgba.shape[1], rgba.shape[0], rng), rgba)
        else:
            img = self._get_image(info["file_name"])
        target = self._process(img, anno, img_id, info)
        if self._transforms is not None:
            img, target = self._transforms(img, target, rng)
        if self.jitter:
            target["jitter_boxes"] = jitter_boxes(
                np.asarray(target["boxes"], np.float32),
                rng, self.jitter_probability, self.jitter_std,
            )
        return img, target

    def _process(self, image, anno, image_id, info):
        """ProcessPoseData parity (the reference's pose_dataset.py:109-256)."""
        h, w = image_hw(image)
        boxes = np.asarray([a["bbox"] for a in anno], np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]                       # xywh -> xyxy
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        classes = np.asarray([a["category_id"] for a in anno], np.int64)

        rel_position = rel_rotation = rel_quaternion = None
        if anno and "relative_pose" in anno[0]:
            rp = anno[0]["relative_pose"]
            if "position" in rp:
                rel_position = np.asarray(
                    [a["relative_pose"]["position"] for a in anno], np.float32)
            if "rotation" in rp:
                rel_rotation = np.asarray(
                    [a["relative_pose"]["rotation"] for a in anno], np.float32).reshape(-1, 3, 3)
                rel_quaternion = rot2quat_np(rel_rotation).astype(np.float32)
            elif "quaternions" in rp:
                rel_quaternion = np.asarray(
                    [a["relative_pose"]["quaternions"] for a in anno], np.float32)
                rel_rotation = quat2rot_np(rel_quaternion).astype(np.float32)

        intrinsics = None
        if anno and "intrinsics" in anno[0]:
            intrinsics = np.asarray([a["intrinsics"] for a in anno], np.float32)
        elif "intrinsics" in info and anno:
            intrinsics = np.tile(np.asarray(info["intrinsics"], np.float32)[None],
                                 (len(anno), 1))

        # degenerate-box filter (the reference's pose_dataset.py:202-220)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        target = {
            "boxes": boxes[keep],
            "labels": classes[keep],
            "image_id": image_id,
            "orig_size": np.asarray([int(h), int(w)]),
        }
        if rel_position is not None:
            target["relative_position"] = rel_position[keep]
        if rel_rotation is not None:
            target["relative_rotation"] = rel_rotation[keep]
        if rel_quaternion is not None:
            target["relative_quaternions"] = rel_quaternion[keep]
        if intrinsics is not None:
            target["intrinsics"] = intrinsics[keep]
        return target


# split -> (image directory, annotation file) under the dataset root
# (the reference's pose_dataset.py:320-345)
SPLITS = {
    "train": ("train", "train.json"),
    "train_synt": ("train", "train_synt.json"),
    "train_pbr": ("train", "train_pbr.json"),
    "test": ("test_all", "test.json"),
    "keyframes": ("test_all", "keyframes.json"),
    "keyframes_bop": ("test_all", "keyframes_bop.json"),
    "val": ("val", "val.json"),
}


def build_dataset(image_set: str, cfg, local_rank: int = 0, local_size: int = 1) -> PoseDataset:
    """The dataset of a split under `cfg.data.dataset_path`."""
    root = Path(cfg.data.dataset_path)
    if not root.exists():
        raise FileNotFoundError(f"dataset path {root} does not exist")
    img_dir, ann = SPLITS[image_set]
    return PoseDataset(
        str(root / img_dir),
        str(root / "annotations" / ann),
        synthetic_background=cfg.data.synt_background,
        transforms=make_pose_estimation_transform(
            image_set, cfg.data.rgb_augmentation, cfg.data.grayscale),
        jitter=(cfg.model.bbox_mode == "jitter"),
        jitter_probability=cfg.data.jitter_probability,
        cache_mode=cfg.data.cache_mode,
        decoded_cache_mb=cfg.data.decoded_cache_mb,
        local_rank=local_rank,
        local_size=local_size,
    )
