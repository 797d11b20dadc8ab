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
//     the degenerate image a constant, a gray image or an image like img;
//   * resize_bicubic: Image.resize(size) of an RGB image, PIL's default
//     (bicubic, a = -0.5, reducing_gap=None; Pillow's ImagingResample,
//     libImaging/Resample.c): a horizontal pass over the rows the vertical
//     pass reads, then the vertical pass, each skipped where its size does
//     not change; each output sample a window of the filter's support
//     scaled by the downscale factor, its double coefficients normalized to
//     their sum and rounded to 22-bit fixed point, summed from 2^21 and
//     clipped after every pass; an empty input (a crop with right == left
//     or bottom == top) gives an all-black image, as PIL 12.1.0 does;
//   * paste_rgba: bg.paste(img, (0, 0), img) of an RGBA image onto an RGB
//     one of its size (Pillow's paste_mask_RGBA): each channel
//     DIV255(bg (255 - a) + img a), DIV255(v) = ((v + 128) >> 8) + v + 128
//     >> 8.
//
// One ctypes call per image, without the GIL: the loader's worker threads
// run in parallel (the same work in numpy took 10x longer and held the GIL
// between its array operations). Built with png_unfilter.cpp into one
// library by poet_tpu_torch/native/__init__.py, with -ffp-contract=off so no
// multiply-add is fused (Pillow's build rounds each product).

#include <cmath>
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

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow's precompute_coeffs and normalize_coeffs_8bpc for the box
// [0, in_size) resampled to out_size: per output sample its first input
// sample and count (bounds) and ksize fixed-point weights (kk).
int coefficients(int in_size, int out_size, std::vector<int>& bounds,
                 std::vector<int32_t>& kk) {
  const float in0 = 0.0f, in1 = (float)in_size;
  const double scale = (double)(in1 - in0) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  const int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> k((size_t)ksize);
  bounds.assign((size_t)out_size * 2, 0);
  kk.assign((size_t)out_size * ksize, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    double ww = 0.0;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = 0; x < ksize; ++x) {
      const double v = x < xmax ? k[x] : 0.0;
      kk[(size_t)xx * ksize + x] =
          v < 0 ? (int)(-0.5 + v * (1 << kPrecisionBits)) : (int)(0.5 + v * (1 << kPrecisionBits));
    }
    bounds[(size_t)xx * 2] = xmin;
    bounds[(size_t)xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int v) {
  const int s = v >> kPrecisionBits;
  return s < 0 ? 0 : (s > 255 ? 255 : (uint8_t)s);
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

// in: (in_h, in_w, 3) uint8; out: (out_h, out_w, 3). Returns 0.
int resize_bicubic(const uint8_t* in, int in_h, int in_w, uint8_t* out, int out_h, int out_w) {
  std::vector<int> bx, by;
  std::vector<int32_t> kx, ky;
  const int ksx = coefficients(in_w, out_w, bx, kx);
  const int ksy = coefficients(in_h, out_h, by, ky);
  const bool horizontal = out_w != in_w, vertical = out_h != in_h;
  if (!horizontal && !vertical) {
    std::memcpy(out, in, (size_t)in_h * in_w * 3);
    return 0;
  }
  // the rows the vertical pass reads
  const int y_first = by[0], y_last = by[(size_t)out_h * 2 - 2] + by[(size_t)out_h * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = in_w;
  if (horizontal) {
    const int rows = vertical ? y_last - y_first : out_h;
    const int first = vertical ? y_first : 0;
    uint8_t* dst = vertical ? (tmp.resize((size_t)rows * out_w * 3), tmp.data()) : out;
    for (int y = 0; y < rows; ++y) {
      const uint8_t* line = in + (int64_t)(y + first) * in_w * 3;
      for (int xx = 0; xx < out_w; ++xx) {
        const int xmin = bx[(size_t)xx * 2], xmax = bx[(size_t)xx * 2 + 1];
        const int32_t* k = &kx[(size_t)xx * ksx];
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* p = line + (int64_t)(x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        uint8_t* o = dst + ((int64_t)y * out_w + xx) * 3;
        o[0] = clip8(s0);
        o[1] = clip8(s1);
        o[2] = clip8(s2);
      }
    }
    if (!vertical) return 0;
    src = tmp.data();
    src_w = out_w;
    for (int yy = 0; yy < out_h; ++yy) by[(size_t)yy * 2] -= y_first;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = by[(size_t)yy * 2], ymax = by[(size_t)yy * 2 + 1];
    const int32_t* k = &ky[(size_t)yy * ksy];
    for (int xx = 0; xx < src_w; ++xx) {
      int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* p = src + ((int64_t)(y + ymin) * src_w + xx) * 3;
        s0 += p[0] * k[y];
        s1 += p[1] * k[y];
        s2 += p[2] * k[y];
      }
      uint8_t* o = out + ((int64_t)yy * src_w + xx) * 3;
      o[0] = clip8(s0);
      o[1] = clip8(s1);
      o[2] = clip8(s2);
    }
  }
  return 0;
}

// bg: n pixels of RGB, blended in place with img: n pixels of RGBA.
int paste_rgba(uint8_t* bg, const uint8_t* img, int64_t n) {
  for (int64_t i = 0; i < n; ++i, bg += 3, img += 4) {
    const unsigned a = img[3];
    for (int ch = 0; ch < 3; ++ch) {
      const unsigned t = bg[ch] * (255 - a) + img[ch] * a + 128;
      bg[ch] = (uint8_t)(((t >> 8) + t) >> 8);
    }
  }
  return 0;
}

}  // extern "C"
