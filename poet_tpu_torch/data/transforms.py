"""Host-side image transforms in numpy, on uint8 HWC arrays, with no PIL.

Counterpart of `poet_tpu/data/transforms.py`, which runs the reference's
PIL augmentations (`data_utils/transforms.py:241-362`). Each class here
computes what its PIL operation computes, to the byte, and draws from the
numpy `Generator` exactly as the JAX package's does, so the same seed gives
the same image:

  * `ImageEnhance.X(img).enhance(f)` is `Image.blend(degenerate, img, f)`:
    in1 + f * (in2 - in1) in float32 (PIL's float alpha), truncated to uint8,
    clipped to [0, 255] when f lies outside [0, 1] (the factor ranges reach
    20-50, so extrapolation is the common case): `native.blend`;
  * `convert("L")` is fixed-point luma, (19595 R + 38470 G + 7471 B +
    0x8000) >> 16: `native.luma`;
  * Contrast's degenerate is the L mean rounded half up; Color's is L
    replicated; Brightness's is black;
  * Sharpness's degenerate is `ImageFilter.SMOOTH` (3x3, 1 1 1 / 1 5 1 / 1 1
    1, over 13) in float32, rounded, with the border pixels copied;
  * `GaussianBlur(r)` is Pillow's extended box blur: three passes of a box
    of fractional radius (Gwosdek et al.) in 24-bit fixed point, rounded to
    uint8 after each pass, rows first, then columns, edges extended;
  * JAX's chain keeps a PIL uint8 image between operations, so every
    operation here returns uint8 too.

The per-pixel loops (blend, luma, the box blur, SMOOTH) are one C call each
(`native/image_ops.cpp`), which the loader's worker threads run without the
GIL.

Randomness is explicit (numpy Generator), as in the JAX package:
`RGBAugmentation` draws `random()`, then `uniform()` only when it fires;
`Blur` draws `random()`, then `integers()`; `GrayScale` draws `random()`.
"""

from __future__ import annotations

import numpy as np

from poet_tpu_torch import native


def image_hw(img: np.ndarray):
    """(height, width) of an HWC (or HW) array."""
    return int(img.shape[0]), int(img.shape[1])


def enhance_color(img: np.ndarray, factor: float) -> np.ndarray:
    return native.blend(native.luma(img), img, factor)


def enhance_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    lum = native.luma(img)
    mean = int(int(lum.sum(dtype=np.int64)) / lum.size + 0.5)   # ImageStat's mean, rounded
    return native.blend(np.uint8(mean), img, factor)


def enhance_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return native.blend(np.uint8(0), img, factor)


_SMOOTH = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float64)


def smooth(img: np.ndarray) -> np.ndarray:
    """PIL's img.filter(ImageFilter.SMOOTH): the 3x3 kernel / 13, each weight
    a float32, summed in float32 from 0.5 in PIL's order (the row below
    first, each row's three taps left to right), truncated and clipped (so
    rounded); the border rows and columns keep their pixels. One C call
    (`native/image_ops.cpp`)."""
    if img.shape[0] < 3 or img.shape[1] < 3:
        return img.copy()
    return native.smooth3x3(img, (_SMOOTH / 13.0).astype(np.float32))


def enhance_sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    return native.blend(smooth(img), img, factor)


def _box_radius(radius: float, passes: int = 3) -> float:
    """Pillow's _gaussian_blur_radius: the extended box's fractional radius
    for a Gaussian of standard deviation `radius` over `passes` boxes, in
    its float32 / double mix."""
    f32 = np.float32
    sigma2 = f32(f32(radius) * f32(radius)) / f32(passes)
    L = f32(np.sqrt(12.0 * float(sigma2) + 1.0))
    l = f32(np.floor((float(L) - 1.0) / 2.0))
    a = f32((f32(2) * l + f32(1)) * (l * (l + f32(1)) - f32(3) * sigma2))
    a = f32(a / (f32(6) * (sigma2 - (l + f32(1)) * (l + f32(1)))))
    return float(f32(l + a))


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """PIL's img.filter(ImageFilter.GaussianBlur(radius)) on an (H, W, C)
    uint8 image: `passes` extended-box passes along the rows, then along the
    columns, each in 24-bit fixed point rounded to uint8, edges extended
    (one C call, `native/image_ops.cpp:box_blur`)."""
    if radius == 0:
        return img.copy()
    return native.box_blur(img, _box_radius(radius, passes), passes)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, target, rng):
        for t in self.transforms:
            img, target = t(img, target, rng)
        return img, target


class RGBAugmentation:
    """Parity: the reference's transforms.py:241-254."""

    def __init__(self, function, p=0.5, factor_range=(0, 1)):
        self.function = function
        self.p = p
        self.factor_range = factor_range

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            factor = rng.uniform(*self.factor_range)
            return self.function(img, factor), target
        return img, target


class Color(RGBAugmentation):
    def __init__(self, p=0.2, factor_range=(0.0, 20.0)):
        super().__init__(enhance_color, p, factor_range)


class Contrast(RGBAugmentation):
    def __init__(self, p=0.2, factor_range=(0.2, 25.0)):
        super().__init__(enhance_contrast, p, factor_range)


class Brightness(RGBAugmentation):
    def __init__(self, p=0.2, factor_range=(0.1, 6.0)):
        super().__init__(enhance_brightness, p, factor_range)


class Sharpness(RGBAugmentation):
    def __init__(self, p=0.2, factor_range=(0.0, 50.0)):
        super().__init__(enhance_sharpness, p, factor_range)


class Blur:
    """Gaussian blur with an integer radius in [1, 3]. Parity: the
    reference's transforms.py:301-311."""

    def __init__(self, p=0.3, factor_range=(1, 3)):
        self.p = p
        self.factor_range = factor_range

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            radius = int(rng.integers(self.factor_range[0], self.factor_range[1] + 1))
            return gaussian_blur(img, radius), target
        return img, target


class GrayScale:
    """PIL's convert("L") with p=0.15: an (H, W) image, re-expanded to three
    channels by ToArray. Parity: the reference's transforms.py:257-267."""

    def __init__(self, p=0.15):
        self.p = p

    def __call__(self, img, target, rng):
        if rng.random() < self.p:
            return native.luma(img), target
        return img, target


class ToArray:
    """uint8 -> float32 HWC in [0, 1], a gray image re-expanded to three
    channels (the reference's ToTensor + To3DImage)."""

    def __call__(self, img, target, rng):
        arr = np.asarray(img)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        return arr, target


class Normalize:
    """Identity pixel normalization + box xyxy -> cxcywh normalized. Parity:
    the reference's transforms.py:328-344 with mean 0 / std 1."""

    def __call__(self, img, target, rng):
        if target is None:
            return img, None
        target = dict(target)
        h, w = img.shape[0], img.shape[1]
        if "boxes" in target and len(target["boxes"]):
            b = np.asarray(target["boxes"], dtype=np.float32)
            cxcywh = np.stack(
                [(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                 b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1,
            )
            target["boxes"] = cxcywh / np.array([w, h, w, h], dtype=np.float32)
        return img, target


def make_pose_estimation_transform(image_set: str, use_rgb_augmentation=False,
                                   use_grayscale=False) -> Compose:
    """Split-dependent pipeline. Parity: the reference's
    pose_dataset.py:259-317 (grayscale is skipped for test-like splits)."""
    steps = []
    if image_set in ("train", "train_synt", "train_pbr") and use_rgb_augmentation:
        steps += [Blur(), Sharpness(), Contrast(), Brightness(), Color()]
    if use_grayscale and image_set not in ("keyframes", "keyframes_bop", "test"):
        steps.append(GrayScale())
    steps += [ToArray(), Normalize()]
    return Compose(steps)


def jitter_boxes(boxes_cxcywh: np.ndarray, rng, probability=0.5, std=0.02) -> np.ndarray:
    """Truncated-normal centre jitter and w/h scale, per box with
    `probability`. Parity: the reference's pose_dataset.py:69-87."""
    from scipy.stats import truncnorm

    out = boxes_cxcywh.copy()
    for box in out:
        if rng.random() < probability:
            cxa, cxb = -box[2] / (2 * std), box[2] / (2 * std)
            cya, cyb = -box[3] / (2 * std), box[3] / (2 * std)
            wa, wb = -0.3 / std, 0.3 / std
            ha, hb = -0.3 / std, 0.3 / std
            box[0] = truncnorm.rvs(cxa, cxb, loc=box[0], scale=std, random_state=rng)
            box[1] = truncnorm.rvs(cya, cyb, loc=box[1], scale=std, random_state=rng)
            box[2] = box[2] * (1 + truncnorm.rvs(wa, wb, loc=0, scale=std, random_state=rng))
            box[3] = box[3] * (1 + truncnorm.rvs(ha, hb, loc=0, scale=std, random_state=rng))
    return out
