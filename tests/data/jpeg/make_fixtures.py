"""Writes the JPEG fixtures of this directory with PIL (12.1.0 made the
committed ones): each `<name>.jpg` and, beside it, `<name>.png` holding the
pixels PIL decodes from it (`convert("RGB")`), the reference the port's
decoder is held to; `background_480x640.jpg` has only its pixels' sha256 in
`digests.json` (a PNG of it would be large); `cmyk_16x16.jpg` has none (no
decoder of the port converts CMYK). Run from the repository root:

    python tests/data/jpeg/make_fixtures.py
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (height, width, mode, PIL save options)
FIXTURES = {
    "baseline_444_37x53": (37, 53, "RGB", {"subsampling": 0, "quality": 90}),
    "baseline_420_37x53": (37, 53, "RGB", {"subsampling": 2, "quality": 75}),
    "baseline_422_53x37": (53, 37, "RGB", {"subsampling": 1, "quality": 75}),
    "baseline_420_120x160": (120, 160, "RGB", {"subsampling": 2, "quality": 85}),
    "gray_37x53": (37, 53, "L", {"quality": 75}),
    "progressive_420_48x64": (48, 64, "RGB", {"subsampling": 2, "progressive": True}),
    "restart_420_64x48": (64, 48, "RGB", {"subsampling": 2, "restart_marker_blocks": 2}),
    "background_480x640": (480, 640, "RGB", {"subsampling": 2, "quality": 60}),
    "cmyk_16x16": (16, 16, "CMYK", {}),
}


def image(rng, h, w):
    """(h, w, 3) uint8: a coarse random colour grid upsampled bilinearly, plus
    a little noise, so every kind of block and chroma detail occurs."""
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    smooth = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    return np.clip(smooth + rng.integers(-12, 13, smooth.shape), 0, 255).astype(np.uint8)


def main():
    rng = np.random.default_rng(16)
    digests = {}
    for name, (h, w, mode, opts) in FIXTURES.items():
        im = Image.fromarray(image(rng, h, w)).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "JPEG", **opts)
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(buf.getvalue())
        if mode == "CMYK":
            continue
        pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        digests[name] = hashlib.sha256(pixels.tobytes()).hexdigest()
        if not name.startswith("background"):
            Image.fromarray(pixels).save(os.path.join(HERE, name + ".png"))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
