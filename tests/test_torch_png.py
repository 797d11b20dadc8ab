"""The port's PNG decoder (`poet_tpu_torch/native`) against PIL, byte for byte.

Fixtures are written inside each test: by PIL for every kind it can write
(8-bit gray, RGB, RGBA, gray+alpha, 1-bit, 16-bit gray, palettes of 1, 2, 4
and 8 bits with a `tRNS` shorter than the palette, colour-key `tRNS`; PIL
filters each row adaptively and splits large IDAT data into chunks), and by
`chip_smoke.encode_png` (every row filter in turn, IDAT in small chunks) for
the kinds PIL reads but does not write: 16-bit RGB, RGBA and gray+alpha.
PIL's `convert("RGB")` / `convert("RGBA")` of the same bytes is the
reference. What the decoder cannot decode must raise.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from chip_smoke import encode_png
from poet_tpu_torch.native import decode_image, load_image_rgb_f32, png_size
from tests.test_torch_modules import one_torch_thread  # noqa: F401

H, W = 37, 53


def _pil_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _assert_like_pil(blob: bytes):
    ref = Image.open(io.BytesIO(blob))
    for channels, mode in ((3, "RGB"), (4, "RGBA")):
        want = np.asarray(ref.convert(mode))
        got = decode_image(blob, channels)
        assert got.dtype == np.uint8 and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)


def _pil_fixture(kind: str, rng) -> bytes:
    u8 = lambda *s: rng.integers(0, 256, s).astype(np.uint8)  # noqa: E731
    if kind == "L":
        return _pil_png(Image.fromarray(u8(H, W)))
    if kind == "RGB":
        return _pil_png(Image.fromarray(u8(H, W, 3)))
    if kind == "RGBA":
        return _pil_png(Image.fromarray(u8(H, W, 4), "RGBA"))
    if kind == "LA":
        return _pil_png(Image.fromarray(u8(H, W, 2), "LA"))
    if kind == "1":
        return _pil_png(Image.fromarray(u8(H, W) > 127))
    if kind == "I;16":
        return _pil_png(Image.fromarray(rng.integers(0, 1 << 16, (H, W)).astype(np.uint16)))
    if kind.startswith("P"):               # P2, P4, P16, P256: palette sizes -> 1/2/4/8 bits
        n = int(kind[1:])
        im = Image.fromarray(rng.integers(0, n, (H, W)).astype(np.uint8), "P")
        im.putpalette(u8(3 * n).tolist())
        alpha = bytes(u8(max(1, n // 2)).tolist())       # tRNS shorter than the palette
        return _pil_png(im, transparency=alpha)
    if kind == "L key":
        a = u8(H, W)
        return _pil_png(Image.fromarray(a), transparency=int(a[3, 4]))
    if kind == "RGB key":
        a = u8(H, W, 3)
        return _pil_png(Image.fromarray(a), transparency=tuple(int(x) for x in a[3, 4]))
    if kind == "RGB multi-IDAT":           # > 64 KiB of noise: PIL writes several IDATs
        return _pil_png(Image.fromarray(u8(160, 200, 3)))
    raise KeyError(kind)


PIL_KINDS = ["L", "RGB", "RGBA", "LA", "1", "I;16", "P2", "P4", "P16", "P256", "L key",
             "RGB key", "RGB multi-IDAT"]


@pytest.mark.parametrize("kind", PIL_KINDS)
def test_decoder_matches_pil_on_pil_files(kind):
    rng = np.random.default_rng(PIL_KINDS.index(kind))
    blob = _pil_fixture(kind, rng)
    _assert_like_pil(blob)
    assert png_size(blob) == ((W, H) if kind != "RGB multi-IDAT" else (200, 160))


# (colour type, depth, samples): every filter on every fifth row, IDAT in
# 97-byte chunks
ENCODED_KINDS = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3),
                 (2, 16, 3), (4, 8, 2), (4, 16, 2), (6, 8, 4), (6, 16, 4), (3, 2, 1),
                 (3, 8, 1)]


@pytest.mark.parametrize("color,depth,samples", ENCODED_KINDS)
def test_decoder_matches_pil_on_every_filter(color, depth, samples):
    rng = np.random.default_rng(color * 100 + depth)
    top = (1 << depth) - 1
    shape = (H, W) if samples == 1 else (H, W, samples)
    pixels = rng.integers(0, top + 1, shape).astype(np.uint16 if depth == 16 else np.uint8)
    palette = trns = None
    if color == 3:
        palette = rng.integers(0, 256, (top + 1, 3))
        trns = bytes(rng.integers(0, 256, (top + 1) // 2 + 1).astype(np.uint8).tolist())
    blob = encode_png(pixels, depth, color, chunk=97, palette=palette, trns=trns)
    assert blob.count(b"IDAT") > 1
    _assert_like_pil(blob)


def test_decoder_matches_the_written_pixels():
    """A smooth field plus noise, as chip_smoke writes its dataset."""
    from chip_smoke import cli_image

    arr = cli_image(np.random.default_rng(0), 96, 128)
    blob = encode_png(arr, chunk=1 << 12)
    np.testing.assert_array_equal(decode_image(blob), arr)
    np.testing.assert_array_equal(decode_image(blob, 4)[..., :3], arr)
    assert (decode_image(blob, 4)[..., 3] == 255).all()


def test_load_image_rgb_f32_matches_jax(tmp_path):
    from poet_tpu.data.dataset import load_image_rgb_f32 as jax_load

    rng = np.random.default_rng(3)
    path = tmp_path / "im.png"
    path.write_bytes(_pil_png(Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8))))
    got = load_image_rgb_f32(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_load(str(path)))


def _corrupt_crc(blob: bytes) -> bytes:
    i = blob.index(b"IDAT")
    (length,) = struct.unpack(">I", blob[i - 4:i])
    crc_at = i + 4 + length
    return blob[:crc_at] + bytes([blob[crc_at] ^ 0xFF]) + blob[crc_at + 1:]


def test_bad_crc_raises():
    blob = encode_png(np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        decode_image(_corrupt_crc(blob))


def test_corrupt_pixel_data_raises():
    """IDAT data that does not inflate, and data too short for the image."""
    def png(data, w=5, h=4):
        chunks = [b"IHDR" + struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0), b"IDAT" + data,
                  b"IEND"]
        return b"\x89PNG\r\n\x1a\n" + b"".join(
            struct.pack(">I", len(c) - 4) + c + struct.pack(">I", zlib.crc32(c)) for c in chunks)

    with pytest.raises(ValueError, match="inflate"):
        decode_image(png(b"not zlib data"))
    with pytest.raises(ValueError, match="short"):
        decode_image(png(zlib.compress(bytes(10))))


def test_interlaced_raises():
    blob = bytearray(encode_png(np.zeros((4, 5, 3), np.uint8)))
    ihdr = blob.index(b"IHDR")
    blob[ihdr + 16] = 1                                      # the interlace byte
    crc = zlib.crc32(bytes(blob[ihdr:ihdr + 17]))
    blob[ihdr + 17:ihdr + 21] = struct.pack(">I", crc)
    with pytest.raises(ValueError, match="interlaced"):
        decode_image(bytes(blob))


def test_jpeg_and_other_formats_raise():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "JPEG")
    with pytest.raises(ValueError, match="nvJPEG.*A.1"):
        decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_image(b"GIF89a" + bytes(20))


def test_bad_filter_type_raises():
    """A filter byte past 4 names its row."""
    raw = bytes([0, 1, 2, 3, 7, 5, 6, 7])                     # row 1 has filter 7
    data = zlib.compress(raw)
    chunks = [b"IHDR" + struct.pack(">IIBBBBB", 3, 2, 8, 0, 0, 0, 0), b"IDAT" + data, b"IEND"]
    blob = b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(c) - 4) + c + struct.pack(">I", zlib.crc32(c)) for c in chunks)
    with pytest.raises(ValueError, match="row 1"):
        decode_image(blob)
