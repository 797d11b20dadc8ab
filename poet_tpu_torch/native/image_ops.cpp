// Pillow's blur filters on uint8 HWC images, for the port's augmentations
// (poet_tpu_torch/data/transforms.py), with Pillow's arithmetic to the byte:
//
//   * box_blur: the passes of ImageFilter.GaussianBlur (Pillow's
//     ImagingBoxBlur, libImaging/BoxBlur.c): `passes` box passes along the
//     rows, then `passes` along the columns, each pixel the 24-bit
//     fixed-point sum of the 2r + 1 nearest samples (weight ww) and the two
//     next ones (weight fw), edges extended, rounded to uint8 after every
//     pass; the caller gives the box's fractional radius;
//   * smooth3x3: ImageFilter.SMOOTH (1 1 1 / 1 5 1 / 1 1 1, over 13): float
//     weights, summed in float from 0.5 in Pillow's order (the row below
//     first, each row's taps left to right), truncated and clipped; the
//     border rows and columns keep their pixels;
//   * luma: convert("L"), (19595 R + 38470 G + 7471 B + 0x8000) >> 16;
//   * blend: Image.blend(degenerate, img, alpha), the ImageEnhance step:
//     in1 + alpha * (in2 - in1) in float, clipped to [0, 255], truncated;
//     the degenerate image a constant, a gray image or an image like img.
//
// One ctypes call per image, without the GIL: the loader's worker threads
// run in parallel (the same work in numpy took 10x longer and held the GIL
// between its array operations). Built with png_unfilter.cpp into one
// library by poet_tpu_torch/native/__init__.py, with -ffp-contract=off so no
// multiply-add is fused (Pillow's build rounds each product).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// One pass over `n` samples `stride` bytes apart in `line`, in place. `pad`
// holds n + 2r + 2 bytes: the line with its edges extended by r + 1.
void box_line(uint8_t* line, int n, int64_t stride, int r, uint32_t ww, uint32_t fw,
              uint8_t* pad) {
  for (int j = 0; j < n + 2 * r + 2; ++j) {
    const int i = j - r - 1;
    pad[j] = line[(int64_t)(i < 0 ? 0 : (i >= n ? n - 1 : i)) * stride];
  }
  const uint8_t* p = pad + r + 1;  // p[i]: sample i, for i in [-r - 1, n + r]
  uint32_t acc = 0;
  for (int i = -r; i <= r; ++i) acc += p[i];  // the window of x = 0
  for (int x = 0; x < n; ++x) {
    const uint32_t bulk = acc * ww + (p[x - r - 1] + p[x + r + 1]) * fw;
    line[(int64_t)x * stride] = (uint8_t)((bulk + (1u << 23)) >> 24);
    acc += p[x + r + 1] - p[x - r];  // slide to x + 1
  }
}

}  // namespace

extern "C" {

// img: (h, w, c) uint8, blurred in place. radius: the box's fractional
// radius (Pillow's _gaussian_blur_radius of the Gaussian's). Returns 0.
int box_blur(uint8_t* img, int h, int w, int c, float radius, int passes) {
  const int r = (int)radius;
  const uint32_t ww = (uint32_t)((float)(1 << 24) / (radius * 2.0f + 1.0f));
  const uint32_t fw = ((1u << 24) - (uint32_t)(r * 2 + 1) * ww) / 2;
  const int64_t row = (int64_t)w * c;
  std::vector<uint8_t> pad((size_t)((w > h ? w : h) + 2 * r + 2));
  for (int p = 0; p < passes; ++p)  // along the rows
    for (int y = 0; y < h; ++y)
      for (int ch = 0; ch < c; ++ch) box_line(img + y * row + ch, w, c, r, ww, fw, pad.data());
  for (int p = 0; p < passes; ++p)  // along the columns
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch)
        box_line(img + (int64_t)x * c + ch, h, row, r, ww, fw, pad.data());
  return 0;
}

// in, out: (h, w, c) uint8, distinct. k: the 9 float weights, row-major.
int smooth3x3(const uint8_t* in, uint8_t* out, int h, int w, int c, const float* k) {
  const int64_t row = (int64_t)w * c;
  std::memcpy(out, in, (size_t)(h * row));
  for (int y = 1; y < h - 1; ++y)
    for (int x = 1; x < w - 1; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float ss = 0.5f;
        for (int kr = 0; kr < 3; ++kr) {  // kernel row kr on image row y + 1 - kr
          const uint8_t* s = in + (int64_t)(y + 1 - kr) * row + (int64_t)x * c + ch;
          const float t = (float)s[-c] * k[3 * kr] + (float)s[0] * k[3 * kr + 1];
          ss += t + (float)s[c] * k[3 * kr + 2];
        }
        out[y * row + (int64_t)x * c + ch] =
            ss <= 0.0f ? 0 : (ss >= 255.0f ? 255 : (uint8_t)ss);
      }
  return 0;
}

// rgb: n pixels of 3 bytes; out: n bytes.
int luma(const uint8_t* rgb, uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i, rgb += 3)
    out[i] = (uint8_t)((rgb[0] * 19595u + rgb[1] * 38470u + rgb[2] * 7471u + 0x8000u) >> 16);
  return 0;
}

// img, out: n pixels of c bytes. deg: deg_c bytes a pixel: 0 (the constant
// deg[0]), 1 (a gray image, its byte for every channel) or c.
int blend(const uint8_t* deg, int deg_c, const uint8_t* img, uint8_t* out, int64_t n, int c,
          float alpha) {
  for (int64_t i = 0; i < n; ++i)
    for (int ch = 0; ch < c; ++ch) {
      const int a = deg[deg_c == 0 ? 0 : (deg_c == 1 ? i : i * c + ch)];
      const int b = img[i * c + ch];
      const float t = (float)a + alpha * (float)(b - a);
      out[i * c + ch] = t <= 0.0f ? 0 : (t >= 255.0f ? 255 : (uint8_t)t);
    }
  return 0;
}

}  // extern "C"
