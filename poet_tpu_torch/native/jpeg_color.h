// The host half of the nvJPEG route (jpeg_nvjpeg.cpp): libjpeg's arithmetic
// from the decoded component planes to RGB, so that the route's pixels differ
// from libjpeg's (and PIL's) by nvJPEG's IDCT alone. Plain C++ with no CUDA:
// tests/test_torch_jpeg.py builds it against libjpeg's own planes
// (raw_data_out) and holds it to libjpeg's RGB bit for bit.
//
//   * chroma upsampling as libjpeg-turbo's jdsample.c with fancy upsampling
//     on: h2v1 and h2v2 "fancy" (triangle) filters where the downsampled
//     width exceeds 2, h1v2 fancy, replication otherwise; the rows above the
//     first and below the last chroma row are those rows themselves
//     (jdmainct.c's context pointers);
//   * YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables, clamped; a
//     JPEG whose components are RGB (jdapimin.c:default_decompress_parms: an
//     Adobe marker with transform 0, or component ids 'R', 'G', 'B' without
//     a JFIF marker) is copied;
//   * gray replicated to RGB; an RGBA output gets alpha 255.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace jpeg_color {

// jdcolor.c:build_ycc_rgb_table (SCALEBITS 16)
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline const ColorTables& tables() {
  static const ColorTables t;
  return t;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One chroma plane (cw x ch) upsampled by (hf, vf) into out (cw hf x ch vf),
// as libjpeg-turbo's jdsample.c with do_fancy_upsampling: h2v1 / h2v2 fancy
// where cw > 2, h1v2 fancy, replication otherwise; the row above the first
// and below the last are themselves.
inline void upsample(const uint8_t* in, int cw, int ch, int hf, int vf, std::vector<uint8_t>& out) {
  const int ow = cw * hf;
  out.assign((size_t)ow * ch * vf, 0);
  const bool fancy_h = hf == 2 && cw > 2;
  for (int r = 0; r < ch; ++r) {
    const uint8_t* row = in + (int64_t)r * cw;
    for (int v = 0; v < vf; ++v) {
      uint8_t* o = out.data() + ((int64_t)r * vf + v) * ow;
      if (vf == 2 && (hf == 1 || fancy_h)) {
        // the nearer row (this one) 3/4, the next nearer (above for v = 0,
        // below for v = 1) 1/4
        const uint8_t* other = in + (int64_t)(v == 0 ? (r > 0 ? r - 1 : 0)
                                                     : (r + 1 < ch ? r + 1 : r)) * cw;
        if (hf == 1) {  // h1v2_fancy_upsample
          const int bias = v == 0 ? 1 : 2;
          for (int x = 0; x < cw; ++x) o[x] = (uint8_t)((row[x] * 3 + other[x] + bias) >> 2);
        } else {  // h2v2_fancy_upsample
          int this_sum = row[0] * 3 + other[0], next_sum = row[1] * 3 + other[1];
          *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
          *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 2; x < cw; ++x) {
            next_sum = row[x] * 3 + other[x];
            *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
        }
      } else if (fancy_h) {  // h2v1_fancy_upsample
        int in0 = row[0];
        *o++ = (uint8_t)in0;
        *o++ = (uint8_t)((in0 * 3 + row[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; ++x) {
          const int t = row[x] * 3;
          *o++ = (uint8_t)((t + row[x - 1] + 1) >> 2);
          *o++ = (uint8_t)((t + row[x + 1] + 2) >> 2);
        }
        const int last = row[cw - 1];
        *o++ = (uint8_t)((last * 3 + row[cw - 2] + 1) >> 2);
        *o++ = (uint8_t)last;
      } else {  // replication (h2v1 / h2v2 / int upsample)
        for (int x = 0; x < cw; ++x)
          for (int k = 0; k < hf; ++k) o[x * hf + k] = row[x];
      }
    }
  }
}

// libjpeg's choice of colour space for 3 components (jdapimin.c):
// YCbCr after a JFIF marker; else an Adobe marker's transform (0: RGB);
// else the component ids ('R', 'G', 'B': RGB).
inline bool rgb_coded(const uint8_t* b, int64_t n) {
  bool jfif = false, adobe = false;
  int transform = 1, ids[3] = {1, 2, 3};
  for (int64_t p = 2; p + 4 <= n;) {
    if (b[p] != 0xFF) break;
    const int marker = b[p + 1];
    if (marker == 0xFF) {
      ++p;
      continue;
    }
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
      p += 2;
      continue;
    }
    const int64_t len = ((int64_t)b[p + 2] << 8) | b[p + 3];
    const uint8_t* seg = b + p + 4;
    if (p + 2 + len > n) break;
    if (marker == 0xE0 && len >= 7 && std::memcmp(seg, "JFIF", 4) == 0) jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(seg, "Adobe", 5) == 0) {
      adobe = true;
      transform = seg[11];
    }
    if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 && marker != 0xC8 &&
        marker != 0xCC && len >= 17) {
      for (int c = 0; c < 3; ++c) ids[c] = seg[6 + 3 * c];
    }
    if (marker == 0xDA) break;  // start of scan: every header read
    p += 2 + len;
  }
  if (jfif) return false;
  if (adobe) return transform == 0;
  return ids[0] == 'R' && ids[1] == 'G' && ids[2] == 'B';
}

// y: (h, w); cb, cr: (ch, cw) planes upsampled by (hf, vf), or nullptr for
// gray. out: (h, w, channels), channels 3 or 4 (alpha 255).
inline void to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w, int h, int cw,
                   int ch, int hf, int vf, bool rgb, uint8_t* out, int channels) {
  std::vector<uint8_t> u, v;
  if (cb != nullptr) {
    upsample(cb, cw, ch, hf, vf, u);
    upsample(cr, cw, ch, hf, vf, v);
  }
  const int uw = cw * hf;
  const ColorTables& t = tables();
  for (int r = 0; r < h; ++r) {
    for (int x = 0; x < w; ++x) {
      const int yy = y[(int64_t)r * w + x];
      uint8_t* o = out + ((int64_t)r * w + x) * channels;
      if (cb == nullptr) {
        o[0] = o[1] = o[2] = (uint8_t)yy;
      } else {
        const int b = u[(int64_t)r * uw + x], c = v[(int64_t)r * uw + x];
        if (rgb) {
          o[0] = (uint8_t)yy;
          o[1] = (uint8_t)b;
          o[2] = (uint8_t)c;
        } else {
          o[0] = clamp255(yy + t.cr_r[c]);
          o[1] = clamp255(yy + (int)((t.cb_g[b] + t.cr_g[c]) >> 16));
          o[2] = clamp255(yy + t.cb_b[b]);
        }
      }
      if (channels == 4) o[3] = 0xFF;
    }
  }
}

}  // namespace jpeg_color
