// JPEG decode on the system libjpeg, for the port's data pipeline
// (poet_tpu_torch/native/__init__.py:decode_image), with the JAX package's
// settings (poet_tpu/native/imagepipe.cpp:decode_jpeg): the output colour
// space JCS_RGB (libjpeg upconverts grayscale), libjpeg's default IDCT
// (JDCT_ISLOW) and fancy upsampling, no scaling. PIL's JPEG plugin decodes
// with the same defaults, so the pixels equal PIL's convert("RGB") on a
// libjpeg of the same lineage (libjpeg-turbo on both sides). An RGBA output
// gets alpha 255, as convert("RGBA") gives. A colour space libjpeg cannot
// convert to RGB (CMYK, YCCK) fails, as it does in the JAX package.
//
// One ctypes call per image, without the GIL. Built on its own by
// poet_tpu_torch/native/__init__.py with `-ljpeg`, so a machine without
// libjpeg still builds the PNG library.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorManager {
  jpeg_error_mgr mgr;
  jmp_buf jump;
  char* message;  // the caller's JMSG_LENGTH_MAX bytes
};

void error_exit(j_common_ptr cinfo) {
  ErrorManager* e = reinterpret_cast<ErrorManager*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, e->message);
  longjmp(e->jump, 1);
}

}  // namespace

extern "C" {

// The libjpeg version this library was compiled against (JPEG_LIB_VERSION).
int jpeg_lib_version() { return JPEG_LIB_VERSION; }

// `message`: the caller's JMSG_LENGTH_MAX (200) bytes for libjpeg's error.

// Header only: fills h, w and the number of components. Returns 0, or -1
// with libjpeg's message in `message`.
int jpeg_probe(const uint8_t* blob, int64_t size, int* h, int* w, int* components,
               char* message) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  err.message = message;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = error_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob), static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  *components = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// out: (h, w, channels) uint8, channels 3 (RGB) or 4 (RGB, alpha 255).
// Returns 0; -1 with libjpeg's message; -2 when the image is not h x w.
int jpeg_decode(const uint8_t* blob, int64_t size, uint8_t* out, int h, int w, int channels,
                char* message) {
  jpeg_decompress_struct cinfo;
  ErrorManager err;
  err.message = message;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = error_exit;
  std::vector<uint8_t> rgb;  // before setjmp: no object with a destructor after it
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob), static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w || static_cast<int>(cinfo.output_height) != h) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const int64_t row = static_cast<int64_t>(w) * channels;
  if (channels == 4) rgb.resize(static_cast<size_t>(w) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<int64_t>(cinfo.output_scanline) * row;
    JSAMPROW line = channels == 3 ? dst : rgb.data();
    jpeg_read_scanlines(&cinfo, &line, 1);
    if (channels == 4) {
      for (int x = 0; x < w; ++x) {
        std::memcpy(dst + 4 * x, rgb.data() + 3 * x, 3);
        dst[4 * x + 3] = 0xFF;
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
