"""The port's image decoder: PNG files to uint8 arrays, with no PIL.

Counterpart of the decode half of `poet_tpu/native/imagepipe.cpp` and of the
PIL fallback in `poet_tpu/data/dataset.py:load_image_rgb_f32`: the same
pixels as PIL's `Image.open(f).convert("RGB")` / `convert("RGBA")` for the
PNG kinds the datasets hold (8- and 16-bit gray, RGB and RGBA, gray with
alpha, palette with or without `tRNS`; gray and palette also at 1, 2 and 4
bits):

  * gray is replicated to three channels; 1-, 2- and 4-bit gray is scaled to
    0..255; 16-bit gray is clipped to 255, as PIL's "I;16" converts;
  * 16-bit RGB, RGBA and gray+alpha keep the high byte of each sample;
  * palette indices are looked up in PLTE, their alpha in `tRNS` (255 past
    its end, which may come before the palette's);
  * for RGB the alpha is dropped (PIL does not composite), for RGBA a
    missing alpha is 255, or 0 where a gray or RGB pixel equals `tRNS`'s
    colour key.

Python's `zlib` inflates the concatenated IDAT data and one C call
(`png_unfilter.cpp`) undoes the row filters of the whole image, outside the
GIL. Every chunk's CRC is checked. The same library holds Pillow's box blur
and 3x3 smoothing filter for the augmentations (`image_ops.cpp`,
`data/transforms.py`); it is built with g++ into the gitignored
`build/poet_tpu_torch/`, keyed by a hash of its sources and flags.
What it cannot decode raises `ValueError`: an interlaced (Adam7) PNG, a JPEG
(that waits for nvJPEG, ROADMAP A.1), any other format, a corrupt file.
There is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = tuple(os.path.join(_HERE, f) for f in ("png_unfilter.cpp", "image_ops.cpp"))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "poet_tpu_torch")
# no fused multiply-add: smooth3x3 rounds each product, as Pillow's build does
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths the PNG specification allows)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library is built: keyed by its sources and flags."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_BUILD_DIR, f"poet_native_{digest.hexdigest()[:16]}.so")


def _load():
    """Build (once per set of sources) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                cmd = ["g++", *_CXX_FLAGS, *_SOURCES, "-o", tmp]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)    # atomic: a concurrent build never sees a partial file
            lib = ctypes.CDLL(so)
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            lib.box_blur.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                             ctypes.c_int]
            lib.box_blur.restype = ctypes.c_int
            lib.smooth3x3.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            lib.smooth3x3.restype = ctypes.c_int
            lib.luma.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64]
            lib.luma.restype = ctypes.c_int
            lib.blend.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float]
            lib.blend.restype = ctypes.c_int
            _lib = lib
    return _lib


def box_blur(img: np.ndarray, radius: float, passes: int) -> np.ndarray:
    """Pillow's box passes (`image_ops.cpp:box_blur`) on a copy of an
    (H, W, C) uint8 image."""
    out = np.array(img, dtype=np.uint8, order="C", copy=True)
    h, w, c = out.shape
    _load().box_blur(out.ctypes.data, h, w, c, radius, passes)
    return out


def smooth3x3(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Pillow's 3x3 filter rounded from 0.5 (`image_ops.cpp:smooth3x3`) of an
    (H, W, C) uint8 image; `kernel` the 9 float32 weights, row-major."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    k = np.ascontiguousarray(kernel, dtype=np.float32).reshape(9)
    out = np.empty_like(src)
    h, w, c = src.shape
    _load().smooth3x3(src.ctypes.data, out.ctypes.data, h, w, c, k.ctypes.data)
    return out


def luma(img: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of an (H, W, 3) uint8 image (`image_ops.cpp:luma`)."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty(src.shape[:2], np.uint8)
    _load().luma(src.ctypes.data, out.ctypes.data, out.size)
    return out


def blend(degenerate: np.ndarray, img: np.ndarray, alpha: float) -> np.ndarray:
    """PIL's Image.blend(degenerate, img, alpha) of an (H, W, C) uint8 image
    (`image_ops.cpp:blend`); `degenerate` a uint8 scalar, an (H, W) gray
    image or an image like `img`."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    ndim = np.ndim(degenerate)
    deg = np.ascontiguousarray(degenerate, dtype=np.uint8).reshape(-1 if ndim else 1)
    deg_c = 0 if ndim == 0 else (1 if ndim == 2 else src.shape[2])
    if ndim and np.shape(degenerate)[:2] != src.shape[:2]:
        raise ValueError(f"degenerate {deg.shape} does not match the image {src.shape}")
    out = np.empty_like(src)
    _load().blend(deg.ctypes.data, deg_c, src.ctypes.data, out.ctypes.data,
                  src.shape[0] * src.shape[1], src.shape[2], float(alpha))
    return out


def probe() -> bool:
    """True when the library builds and loads here (g++ is there)."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _chunks(blob: bytes):
    """(type, data) of each chunk after the signature, CRCs checked."""
    pos, n = len(_PNG_SIGNATURE), len(blob)
    while pos + 8 <= n:
        length, ctype = struct.unpack(">I4s", blob[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > n:
            raise ValueError(f"PNG chunk {ctype!r} runs past the end of the file")
        data = blob[pos + 8:end]
        (crc,) = struct.unpack(">I", blob[end:end + 4])
        if zlib.crc32(ctype + data) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC: the file is corrupt")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG ends without an IEND chunk")


def png_size(blob: bytes):
    """(width, height) from a PNG's header, without decoding it."""
    _check_png(blob)
    if blob[12:16] != b"IHDR":
        raise ValueError("PNG does not start with IHDR")
    return struct.unpack(">II", blob[16:24])


def _check_png(blob: bytes) -> None:
    if blob[:len(_PNG_SIGNATURE)] == _PNG_SIGNATURE:
        return
    if blob[:3] == b"\xff\xd8\xff":
        raise ValueError("JPEG images are not decoded by the port yet: they wait for the "
                         "nvJPEG decoder (ROADMAP A.1); the BOP test images are PNG")
    raise ValueError("not a PNG file (the port decodes PNG only)")


def _unpack_bits(data: np.ndarray, height: int, width: int, depth: int) -> np.ndarray:
    """(height, row bytes) samples of `depth` < 8 bits -> (height, width)."""
    if depth == 8:
        return data[:, :width]
    bits = np.unpackbits(data, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width]


def decode_image(blob: bytes, channels: int = 3) -> np.ndarray:
    """A PNG file's bytes -> (H, W, channels) uint8, channels 3 (RGB) or 4
    (RGBA), as PIL's convert("RGB") / convert("RGBA") gives."""
    if channels not in (3, 4):
        raise ValueError(f"channels must be 3 or 4, not {channels}")
    _check_png(blob)
    header, palette, trns, idat = None, None, None, []
    for ctype, data in _chunks(blob):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = data
        elif ctype == b"IDAT":
            idat.append(data)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported by the port's decoder")
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is not valid")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    samples = _COLOR_TYPES[color][0]
    row_bytes = (width * samples * depth + 7) // 8
    bpp = max(1, samples * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG pixel data does not inflate: {e}") from e
    out = np.empty((height, row_bytes), np.uint8)
    rc = _load().png_unfilter(raw, len(raw), out.ctypes.data, height, row_bytes, bpp)
    if rc == -1:
        raise ValueError(f"PNG pixel data is short: {len(raw)} bytes for {height} rows of "
                         f"{row_bytes}")
    if rc != 0:
        raise ValueError(f"PNG row {-2 - rc} has an unknown filter type")

    if depth == 16:
        wide = out.view(">u2").reshape(height, width, samples)
        key = (np.frombuffer(trns, ">u2") if trns is not None and color in (0, 2) else None)
        if color == 0:            # PIL's "I;16", converted by clipping
            pix = np.minimum(wide, 255).astype(np.uint8)
        else:                     # PIL's "RGB;16B", "RGBA;16B", "LA;16B": the high byte
            pix = (wide >> 8).astype(np.uint8)
        keyed = (wide == key).all(-1) if key is not None else None
    else:
        pix = _unpack_bits(out, height, width * samples, depth).reshape(height, width, samples)
        key = (np.frombuffer(trns, ">u2") if trns is not None and color in (0, 2) else None)
        keyed = (pix == key.astype(np.uint8)).all(-1) if key is not None else None
        if color == 0 and depth < 8:
            pix = pix * np.uint8(255 // ((1 << depth) - 1))

    if color == 3:
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alpha), 3] = alpha
        return table[pix[..., 0], :channels]
    if color in (0, 4):           # gray, gray + alpha
        rgb = np.repeat(pix[..., :1], 3, axis=2)
        alpha = pix[..., 1] if color == 4 else None
    else:                         # RGB, RGBA
        rgb = pix[..., :3]
        alpha = pix[..., 3] if color == 6 else None
    if channels == 3:
        return np.ascontiguousarray(rgb)
    if alpha is None:
        alpha = np.full((height, width), 255, np.uint8)
        if keyed is not None:
            alpha[keyed] = 0
    return np.concatenate([rgb, alpha[..., None]], axis=2)


def load_image_rgb_f32(path: str) -> np.ndarray:
    """One image file -> (H, W, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        blob = f.read()
    return decode_image(blob, 3).astype(np.float32) / 255.0
