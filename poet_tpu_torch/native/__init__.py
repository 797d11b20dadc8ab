"""The port's image decoder: PNG and JPEG files to uint8 arrays, with no PIL.

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
and 3x3 smoothing filter for the augmentations, and its bicubic resize and
alpha paste for 'synt' compositing (`image_ops.cpp`, `data/transforms.py`,
`data/dataset.py`); it is built with g++ into the gitignored
`build/poet_tpu_torch/`, keyed by a hash of its sources and flags.

A JPEG is decoded by a second library, built the same way at the first
JPEG from the first route that builds here (`jpeg_route()`): "libjpeg",
`jpeg_decode.cpp` on the system libjpeg (JAX's settings: RGB out, gray
upconverted, the default IDCT and fancy upsampling: PIL's pixels); else
"nvjpeg", `jpeg_nvjpeg.cpp` on the CUDA toolkit's nvJPEG (a decode on
cuda:LOCAL_RANK, its own IDCT and upsampling: within a few units of PIL's
pixels); else None, and a JPEG raises naming the builds' errors. An RGBA
output has alpha 255. Each machine's route is in the README.
What cannot be decoded raises `ValueError`: an interlaced (Adam7) PNG, a
CMYK or YCCK JPEG (libjpeg converts neither to RGB, and neither does the
JAX package's native decoder), any other format, a corrupt file. There is
no fallback.

The batch entry points of `poet_tpu/native/__init__.py` sit on these
decoders: `probe_image` (height, width and the natural channel count),
`decode_batch_f32` (same-sized files into one (N, H, W, 3) f32 batch on
worker threads; the decoders run outside the GIL) and `u8_to_f32` (x / 255
in f32). `lapjv` is the host's float64 Jonker-Volgenant solver, the port's
copy of `poet_tpu/native/lapjv.cpp`, built the same way at first use.
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
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = tuple(os.path.join(_HERE, f) for f in ("png_unfilter.cpp", "image_ops.cpp"))
_CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
# JPEG route -> (sources, g++ flags after them): the first that builds is taken
_JPEG_ROUTES = {
    "libjpeg": ((os.path.join(_HERE, "jpeg_decode.cpp"),), ("-ljpeg",)),
    "nvjpeg": ((os.path.join(_HERE, "jpeg_nvjpeg.cpp"),),
               (f"-I{_CUDA_HOME}/include", f"-L{_CUDA_HOME}/lib64",
                f"-Wl,-rpath,{_CUDA_HOME}/lib64", "-lnvjpeg", "-lcudart")),
}
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "poet_tpu_torch")
# no fused multiply-add: smooth3x3 rounds each product, as Pillow's build does
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> (samples per pixel, the bit depths the PNG specification allows)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}

_lock = threading.Lock()
_lib = None
_jpeg = None              # (route, library), or the RuntimeError of the builds
_lapjv = None
# x / 255 in f32 for every byte: the f32 division rounds once, as JAX's table
_U8_F32 = np.arange(256, dtype=np.float32) / np.float32(255)


def library_path(sources=_SOURCES, libs=(), name="poet_native") -> str:
    """Where a library is built: keyed by its sources, the headers beside
    them and its flags."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + tuple(libs)).encode())
    headers = sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE) if f.endswith(".h"))
    for src in tuple(sources) + tuple(headers):
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def _build(sources, libs=(), name="poet_native") -> ctypes.CDLL:
    """Build `sources` with g++ (once per set of sources and flags) and load
    the library; RuntimeError with g++'s output when the build fails."""
    so = library_path(sources, libs, name)
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *_CXX_FLAGS, *sources, "-o", tmp, *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:                    # no g++ at all
            os.unlink(tmp)
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):             # g++ removes it when the link fails
                os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)    # atomic: a concurrent build never sees a partial file
    return ctypes.CDLL(so)


def _load():
    """Build (once per set of sources) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = _build(_SOURCES)
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
            lib.resize_bicubic.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.resize_bicubic.restype = ctypes.c_int
            lib.paste_rgba.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.paste_rgba.restype = ctypes.c_int
            _lib = lib
    return _lib


def _load_jpeg():
    """(route, library) of the first JPEG route that builds here, built at
    first use; raises the RuntimeError of the builds (again at every call)
    where none does."""
    global _jpeg
    if _jpeg is None:
        with _lock:
            if _jpeg is None:
                errors = []
                for route, (sources, libs) in _JPEG_ROUTES.items():
                    try:
                        lib = _build(sources, libs, f"poet_{route}")
                    except RuntimeError as e:
                        errors.append(f"{route}: {e}")
                        continue
                    lib.jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
                        ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_char_p]
                    lib.jpeg_probe.restype = ctypes.c_int
                    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_char_p]
                    lib.jpeg_decode.restype = ctypes.c_int
                    lib.jpeg_lib_version.restype = ctypes.c_int
                    if route == "nvjpeg":        # the process's card (cuda:LOCAL_RANK)
                        lib.jpeg_set_device(int(os.environ.get("LOCAL_RANK", "0")))
                    _jpeg = (route, lib)
                    break
                else:
                    _jpeg = RuntimeError("\n".join(errors))
    if isinstance(_jpeg, RuntimeError):
        raise _jpeg
    return _jpeg


def jpeg_route():
    """How this machine decodes JPEG: "libjpeg" (`jpeg_decode.cpp` on the
    system library), "nvjpeg" (`jpeg_nvjpeg.cpp` on the CUDA toolkit's
    nvJPEG, where libjpeg is missing) or None (neither builds)."""
    try:
        return _load_jpeg()[0]
    except RuntimeError:
        return None


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's default `Image.resize((width, height))` of an (H, W, 3) uint8
    image (`image_ops.cpp:resize_bicubic`; H or W may be 0: all black)."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"resize_bicubic takes an (H, W, 3) image, not {src.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"height and width must be > 0, not {(width, height)}")
    out = np.empty((height, width, 3), np.uint8)
    _load().resize_bicubic(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data,
                           height, width)
    return out


def paste_rgba(bg: np.ndarray, img: np.ndarray) -> np.ndarray:
    """PIL's `bg.paste(img, (0, 0), img)` of an (H, W, 4) RGBA image onto an
    (H, W, 3) RGB one of its size (`image_ops.cpp:paste_rgba`), on a copy."""
    out = np.array(bg, dtype=np.uint8, order="C", copy=True)
    src = np.ascontiguousarray(img, dtype=np.uint8)
    if out.ndim != 3 or out.shape[2] != 3 or src.shape != out.shape[:2] + (4,):
        raise ValueError(f"paste_rgba takes an RGB image and an RGBA one of its size, not "
                         f"{out.shape} and {src.shape}")
    _load().paste_rgba(out.ctypes.data, src.ctypes.data, out.shape[0] * out.shape[1])
    return out


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
    if _format(blob) != "png":
        raise ValueError("not a PNG file")
    if blob[12:16] != b"IHDR":
        raise ValueError("PNG does not start with IHDR")
    return struct.unpack(">II", blob[16:24])


def image_size(blob: bytes):
    """(width, height) of a PNG or JPEG file from its header."""
    if _format(blob) == "png":
        return png_size(blob)
    h, w, _ = _probe_jpeg(blob)
    return w, h


def _format(blob: bytes) -> str:
    if blob[:len(_PNG_SIGNATURE)] == _PNG_SIGNATURE:
        return "png"
    if blob[:len(_JPEG_SIGNATURE)] == _JPEG_SIGNATURE:
        return "jpeg"
    raise ValueError("not a PNG or JPEG file (the port decodes those two)")


def _jpeg_lib():
    try:
        return _load_jpeg()[1]
    except RuntimeError as e:
        raise ValueError(f"no JPEG route builds on this machine (libjpeg: jpeglib.h and "
                         f"libjpeg.so; nvJPEG: the CUDA toolkit's nvjpeg.h): {e}") from e


def _probe_jpeg(blob: bytes):
    """(height, width, components) from a JPEG's header."""
    lib = _jpeg_lib()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(200)
    if lib.jpeg_probe(blob, len(blob), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                      msg) != 0:
        raise ValueError(f"JPEG header: {msg.value.decode(errors='replace')}")
    return h.value, w.value, c.value


def _decode_jpeg(blob: bytes, channels: int) -> np.ndarray:
    h, w, _ = _probe_jpeg(blob)
    out = np.empty((h, w, channels), np.uint8)
    msg = ctypes.create_string_buffer(200)
    rc = _jpeg_lib().jpeg_decode(blob, len(blob), out.ctypes.data, h, w, channels, msg)
    if rc != 0:
        raise ValueError(f"JPEG decode failed: {msg.value.decode(errors='replace')}"
                         if rc == -1 else f"JPEG decodes to another size than its header's "
                         f"{w}x{h}")
    return out


def _unpack_bits(data: np.ndarray, height: int, width: int, depth: int) -> np.ndarray:
    """(height, row bytes) samples of `depth` < 8 bits -> (height, width)."""
    if depth == 8:
        return data[:, :width]
    bits = np.unpackbits(data, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[:, :width]


def decode_image(blob: bytes, channels: int = 3) -> np.ndarray:
    """A PNG or JPEG file's bytes -> (H, W, channels) uint8, channels 3 (RGB)
    or 4 (RGBA), as PIL's convert("RGB") / convert("RGBA") gives."""
    if channels not in (3, 4):
        raise ValueError(f"channels must be 3 or 4, not {channels}")
    if _format(blob) == "jpeg":
        return _decode_jpeg(blob, channels)
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


def probe_image(blob: bytes) -> Tuple[int, int, int]:
    """(height, width, channels) from a PNG's or JPEG's header: channels 4
    for a PNG with an alpha channel or a `tRNS` chunk, else 3 (as JAX's
    `native.probe_image`)."""
    if _format(blob) == "jpeg":
        h, w, _ = _probe_jpeg(blob)
        return h, w, 3
    w, h = png_size(blob)
    alpha = blob[25] in (4, 6)                  # IHDR's colour type: gray or RGB + alpha
    for ctype, _ in _chunks(blob):
        if ctype == b"tRNS":
            alpha = True
        if ctype in (b"tRNS", b"IDAT"):          # tRNS comes before the pixel data
            break
    return h, w, 4 if alpha else 3


def u8_to_f32(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1], exactly x / 255."""
    return _U8_F32[np.asarray(arr, dtype=np.uint8)]


def decode_batch_f32(blobs: List[bytes], height: int, width: int,
                     out: Optional[np.ndarray] = None,
                     n_threads: Optional[int] = None) -> np.ndarray:
    """Same-sized PNG or JPEG files -> one (N, height, width, 3) float32 batch
    in [0, 1] (RGB, x / 255), decoded on `n_threads` worker threads (default:
    one per file, at most the CPU count). `out`, when given, is filled and
    returned. Raises `ValueError` naming the first file that does not decode
    or has another size."""
    n = len(blobs)
    if out is None:
        out = np.empty((n, height, width, 3), dtype=np.float32)
    elif (out.shape != (n, height, width, 3) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous float32 array of shape "
                         f"{(n, height, width, 3)}, got {out.dtype} {out.shape}")

    def one(i):
        img = decode_image(blobs[i], 3)
        if img.shape[:2] != (height, width):
            raise ValueError(f"{img.shape[1]}x{img.shape[0]}, not {width}x{height}")
        out[i] = _U8_F32[img]

    if n:
        workers = max(1, min(n, n_threads or os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as pool:
            futures = [pool.submit(one, i) for i in range(n)]
        for i, fut in enumerate(futures):
            if fut.exception() is not None:
                raise ValueError(f"batch decode failed at image {i}: {fut.exception()}")
    return out


def _load_lapjv():
    global _lapjv
    if _lapjv is None:
        with _lock:
            if _lapjv is None:
                lib = _build((os.path.join(_HERE, "lapjv.cpp"),), name="poet_lapjv")
                lib.lapjv.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
                lib.lapjv.restype = ctypes.c_double
                lib.lapjv_batch.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                            ctypes.c_void_p]
                lib.lapjv_batch.restype = None
                _lapjv = lib
    return _lapjv


def lapjv(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of a square (n, n) or batched (b, n, n) cost
    matrix, solved in float64 on the host. Returns col_of_row, int32 (n,) or
    (b, n): the column assigned to each row."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    if cost.ndim not in (2, 3) or cost.shape[-1] != cost.shape[-2]:
        raise ValueError(f"lapjv takes a square (n, n) or (b, n, n) cost, got {cost.shape}")
    lib = _load_lapjv()
    n = cost.shape[-1]
    out = np.zeros(cost.shape[:-1], dtype=np.int32)
    if cost.ndim == 2:
        lib.lapjv(cost.ctypes.data, n, out.ctypes.data)
    else:
        lib.lapjv_batch(cost.ctypes.data, cost.shape[0], n, out.ctypes.data)
    return out


# libzstd, bound through ctypes with no header: the sonames tried in order
ZSTD_LIBRARIES = ("libzstd.so.1",)
_zstd = None
# ZSTD_getFrameContentSize's two sentinels
_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


class _ZstdBuffer(ctypes.Structure):
    """ZSTD_inBuffer and ZSTD_outBuffer: {pointer, size, pos}."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def zstd_library() -> ctypes.CDLL:
    """The system's libzstd (the first of ZSTD_LIBRARIES that loads), bound
    once. ImportError naming the library when none loads: there is no other
    zstd route."""
    global _zstd
    if _zstd is not None:
        return _zstd
    with _lock:
        if _zstd is None:
            errors = []
            for name in ZSTD_LIBRARIES:
                try:
                    lib = ctypes.CDLL(name)
                    break
                except OSError as e:
                    errors.append(f"{name}: {e}")
            else:
                raise ImportError("libzstd is not available (tried " + "; ".join(errors) +
                                  "): the orbax checkpoint reader decompresses with it")
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            lib.ZSTD_versionNumber.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorName.argtypes = [size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
            lib.ZSTD_decompress.restype = size_t
            lib.ZSTD_createDCtx.restype = vp
            lib.ZSTD_freeDCtx.argtypes = [vp]
            lib.ZSTD_freeDCtx.restype = size_t
            lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_ZstdBuffer),
                                                  ctypes.POINTER(_ZstdBuffer)]
            lib.ZSTD_decompressStream.restype = size_t
            _zstd = lib
    return _zstd


def zstd_version() -> str:
    """libzstd's version, e.g. '1.5.5'."""
    v = zstd_library().ZSTD_versionNumber()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def zstd_library_path() -> str:
    """The file the loaded libzstd was mapped from (its soname where the
    process's map does not say)."""
    zstd_library()
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if "libzstd" in os.path.basename(path):
                    return path
    except OSError:
        pass
    return ZSTD_LIBRARIES[0]


def _zstd_check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def zstd_decompress(frame: bytes, size_hint: Optional[int] = None) -> bytes:
    """Decompress one or more zstd frames. With `size_hint` (the decoded
    size, known from the caller's metadata) in one call into a buffer of that
    size, which the frames must fill exactly; without it by streaming, as a
    frame need not state its size. ValueError on any libzstd error or a
    truncated frame."""
    lib = zstd_library()
    src = bytes(frame)
    if size_hint is None:
        size = lib.ZSTD_getFrameContentSize(src, len(src))
        if size not in (_ZSTD_CONTENTSIZE_UNKNOWN, _ZSTD_CONTENTSIZE_ERROR):
            size_hint = size
    if size_hint is not None:
        out = ctypes.create_string_buffer(max(int(size_hint), 1))
        n = _zstd_check(lib, lib.ZSTD_decompress(out, size_hint, src, len(src)), "decompress")
        if n != size_hint:
            raise ValueError(f"zstd frame holds {n} bytes, expected {size_hint}")
        return out.raw[:n]
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        src_buf = ctypes.create_string_buffer(src, len(src))
        inp = _ZstdBuffer(ctypes.cast(src_buf, ctypes.c_void_p), len(src), 0)
        parts, cap = [], max(4 * len(src), 1 << 16)
        ret = 1
        while inp.pos < inp.size or ret != 0:
            dst = ctypes.create_string_buffer(cap)
            out = _ZstdBuffer(ctypes.cast(dst, ctypes.c_void_p), cap, 0)
            ret = _zstd_check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(out),
                                                             ctypes.byref(inp)), "stream")
            parts.append(dst.raw[:out.pos])
            if ret != 0 and inp.pos == inp.size and out.pos < cap:   # wants input: none left
                raise ValueError("zstd frame is truncated")
            cap *= 2
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDCtx(dctx)
