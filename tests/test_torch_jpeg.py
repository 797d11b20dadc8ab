"""The port's JPEG decoder (`poet_tpu_torch/native`, the libjpeg route on
this machine) against `poet_tpu.native.decode_image` and PIL, byte for byte.

The fixtures of tests/data/jpeg/ (written with PIL 12.1.0 by its
`make_fixtures.py`): baseline 4:4:4, 4:2:0 and 4:2:2, gray, progressive,
restart markers, odd sizes (37x53, 53x37), each with a PNG of PIL's pixels
beside it; a 480x640 background known by its pixels' digest; a CMYK file.
Then JPEGs PIL writes here at other qualities and sizes; the route's choice
(libjpeg first, then nvJPEG, else a JPEG raises); `image_size` of both
formats. The nvJPEG route runs only where libjpeg is missing (the card's
machine): tests/test_torch_card.py.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from poet_tpu_torch import native
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
NAMES = ["baseline_444_37x53", "baseline_420_37x53", "baseline_422_53x37",
         "baseline_420_120x160", "gray_37x53", "progressive_420_48x64", "restart_420_64x48"]


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_native():
    from poet_tpu import native as jn

    assert jn.imagepipe_available()
    return jn


def test_route_here_is_libjpeg():
    assert native.jpeg_route() == "libjpeg"


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_like_pil_and_jax(name, jax_native):
    blob = _read(name + ".jpg")
    want = np.asarray(Image.open(os.path.join(FIXTURES, name + ".png")).convert("RGB"))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")), want)
    for channels, mode in ((3, "RGB"), (4, "RGBA")):
        got = native.decode_image(blob, channels)
        assert got.dtype == np.uint8 and got.shape == want.shape[:2] + (channels,)
        np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(blob)).convert(mode)))
        np.testing.assert_array_equal(got, jax_native.decode_image(blob, channels))
    assert native.image_size(blob) == (want.shape[1], want.shape[0])


def test_background_fixture_digest(jax_native):
    """The 480x640 background (no PNG of it is committed): its pixels'
    digest, equal to PIL's and to JAX's decode."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    blob = _read("background_480x640.jpg")
    got = native.decode_image(blob)
    assert got.shape == (480, 640, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == digests["background_480x640"]
    np.testing.assert_array_equal(got, jax_native.decode_image(blob))
    for name in NAMES:
        assert hashlib.sha256(native.decode_image(_read(name + ".jpg")).tobytes()
                              ).hexdigest() == digests[name]


def test_cmyk_raises_as_jax(jax_native):
    blob = _read("cmyk_16x16.jpg")
    with pytest.raises(ValueError, match="color conversion"):
        native.decode_image(blob)
    with pytest.raises(ValueError):
        jax_native.decode_image(blob)


@pytest.mark.parametrize("opts", [{"quality": 5}, {"quality": 100, "subsampling": 0},
                                  {"quality": 95, "subsampling": 2, "optimize": True},
                                  {"progressive": True, "subsampling": 1},
                                  {"restart_marker_rows": 1, "subsampling": 2}])
@pytest.mark.parametrize("hw", [(1, 1), (7, 300), (96, 17), (481, 641)])
def test_pil_written_jpeg_matches_pil(opts, hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    arr = np.clip(rng.normal(128, 60, hw + (3,)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **opts)
    blob = buf.getvalue()
    np.testing.assert_array_equal(native.decode_image(blob),
                                  np.asarray(Image.open(io.BytesIO(blob)).convert("RGB")))


def test_image_size_of_both_formats():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((5, 9, 3), np.uint8)).save(buf, "PNG")
    assert native.image_size(buf.getvalue()) == (9, 5)
    assert native.image_size(_read("baseline_422_53x37.jpg")) == (37, 53)
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        native.image_size(b"BM" + bytes(40))


def test_route_choice(monkeypatch):
    """libjpeg first, nvJPEG where libjpeg does not build, and where neither
    builds a JPEG raises with both builds' errors (a PNG still decodes)."""
    libjpeg, nvjpeg = native._JPEG_ROUTES["libjpeg"], native._JPEG_ROUTES["nvjpeg"]
    assert list(native._JPEG_ROUTES) == ["libjpeg", "nvjpeg"]
    assert nvjpeg[0][0].endswith("jpeg_nvjpeg.cpp") and "-lnvjpeg" in nvjpeg[1]
    broken = (libjpeg[0], ("-lno_such_jpeg_library",))
    # a route that does not build gives way to the next; nvjpeg.h is not here
    for routes, want in (({"broken": broken, "libjpeg": libjpeg}, "libjpeg"),
                         ({"libjpeg": broken, "nvjpeg": nvjpeg}, None)):
        monkeypatch.setattr(native, "_jpeg", None)
        monkeypatch.setattr(native, "_JPEG_ROUTES", routes)
        assert native.jpeg_route() == want
    with pytest.raises(ValueError, match="(?s)no JPEG route builds.*libjpeg:.*nvjpeg:"):
        native.decode_image(_read("gray_37x53.jpg"))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((2, 3, 3), np.uint8)).save(buf, "PNG")
    assert native.decode_image(buf.getvalue()).shape == (2, 3, 3)


# the nvJPEG route's host half (native/jpeg_color.h) fed libjpeg's own
# component planes (raw_data_out: after the IDCT, before upsampling and
# colour conversion)
_RAW_HARNESS = r"""
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <vector>
#include <jpeglib.h>
#include "jpeg_color.h"

struct Err { jpeg_error_mgr mgr; jmp_buf jump; };
static void on_error(j_common_ptr c) { longjmp(reinterpret_cast<Err*>(c->err)->jump, 1); }

extern "C" int raw_to_rgb(const uint8_t* blob, long size, uint8_t* out, int channels) {
  jpeg_decompress_struct cinfo;
  Err err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = on_error;
  std::vector<std::vector<uint8_t>> planes(3), dense(3);
  if (setjmp(err.jump)) { jpeg_destroy_decompress(&cinfo); return -1; }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = cinfo.jpeg_color_space;
  jpeg_start_decompress(&cinfo);
  const int n = cinfo.num_components;
  int pw[3], rows[3];
  for (int c = 0; c < n; ++c) {
    jpeg_component_info* k = &cinfo.comp_info[c];
    pw[c] = k->width_in_blocks * DCTSIZE;
    rows[c] = k->v_samp_factor * DCTSIZE;
    planes[c].resize((size_t)pw[c] * rows[c] * cinfo.total_iMCU_rows);
  }
  for (JDIMENSION r = 0; r < cinfo.total_iMCU_rows; ++r) {
    std::vector<JSAMPROW> ptrs[3];
    JSAMPARRAY arrays[3];
    for (int c = 0; c < n; ++c) {
      for (int i = 0; i < rows[c]; ++i)
        ptrs[c].push_back(planes[c].data() + ((size_t)r * rows[c] + i) * pw[c]);
      arrays[c] = ptrs[c].data();
    }
    jpeg_read_raw_data(&cinfo, arrays, cinfo.max_v_samp_factor * DCTSIZE);
  }
  int dw[3], dh[3];
  for (int c = 0; c < n; ++c) {
    dw[c] = cinfo.comp_info[c].downsampled_width;
    dh[c] = cinfo.comp_info[c].downsampled_height;
    dense[c].resize((size_t)dw[c] * dh[c]);
    for (int y = 0; y < dh[c]; ++y)
      for (int x = 0; x < dw[c]; ++x) dense[c][(size_t)y * dw[c] + x] = planes[c][(size_t)y * pw[c] + x];
  }
  const int hf = n == 3 ? cinfo.max_h_samp_factor / cinfo.comp_info[1].h_samp_factor : 1;
  const int vf = n == 3 ? cinfo.max_v_samp_factor / cinfo.comp_info[1].v_samp_factor : 1;
  jpeg_color::to_rgb(dense[0].data(), n == 3 ? dense[1].data() : nullptr,
                     n == 3 ? dense[2].data() : nullptr, cinfo.image_width, cinfo.image_height,
                     dw[1], dh[1], hf, vf, n == 3 && jpeg_color::rgb_coded(blob, size), out,
                     channels);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
"""


@pytest.fixture(scope="module")
def raw_harness(tmp_path_factory):
    import ctypes
    import subprocess

    d = tmp_path_factory.mktemp("harness")
    src, so = d / "raw.cpp", d / "raw.so"
    src.write_text(_RAW_HARNESS)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", f"-I{os.path.dirname(native.__file__)}",
                    str(src), "-o", str(so), "-ljpeg"], check=True)
    lib = ctypes.CDLL(str(so))
    lib.raw_to_rgb.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
    return lib


def _pil_jpeg(rng, hw, **opts):
    arr = np.clip(rng.normal(128, 60, hw + (3,)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["fixtures", "4:4:4", "4:2:2", "4:2:0", "4:1:1", "gray",
                                  "narrow"])
def test_nvjpeg_route_host_arithmetic_matches_libjpeg(raw_harness, case):
    """jpeg_color.h's upsampling and colour conversion on libjpeg's planes
    give libjpeg's RGB bit for bit (the nvJPEG route's pixels then differ
    from PIL's by nvJPEG's IDCT alone): the fixtures, each subsampling PIL
    writes at odd sizes, gray, and widths of 1 to 4 columns (whose chroma
    is replicated, not filtered, at 1 or 2 columns)."""
    rng = np.random.default_rng(len(case))
    if case == "fixtures":
        blobs = [_read(n + ".jpg") for n in NAMES] + [_read("background_480x640.jpg")]
    elif case == "gray":
        blobs = [_read("gray_37x53.jpg")]
        for hw in ((1, 1), (9, 17)):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, hw).astype(np.uint8)).save(buf, "JPEG")
            blobs.append(buf.getvalue())
    elif case == "narrow":
        blobs = [_pil_jpeg(rng, (h, w), subsampling=s) for h in (1, 5, 17) for w in (1, 2, 3, 4, 5)
                 for s in ("4:2:0", "4:2:2")]
    else:
        blobs = [_pil_jpeg(rng, hw, subsampling=case) for hw in ((37, 53), (8, 8), (33, 7))]
    for blob in blobs:
        want = native.decode_image(blob, 4)
        got = np.empty_like(want)
        assert raw_harness.raw_to_rgb(blob, len(blob), got.ctypes.data, 4) == 0
        np.testing.assert_array_equal(got, want, err_msg=f"{case} {want.shape}")
