// PNG row unfiltering for the port's image decoder (poet_tpu_torch/native).
//
// A PNG's pixels are zlib-deflated rows, each led by one filter-type byte
// (PNG specification, section 9): 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth,
// each predicting a byte from its left neighbour a (the byte `bpp` bytes
// earlier: one whole pixel, 1 byte at most for depths under 8 bits), the byte
// above b and the byte above-left c. Python's zlib inflates the data (it
// releases the GIL on large inputs); this routine undoes the filters of the
// whole image in one call, which ctypes makes without the GIL, so the
// loader's worker threads decode in parallel. A per-row Python loop would hold
// the GIL and serialize them.
//
// Built by poet_tpu_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC png_unfilter.cpp
// into build/poet_tpu_torch/, keyed by a hash of this source.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// raw: height rows of (1 + row_bytes) bytes, filter byte first; out: height x
// row_bytes bytes. Returns 0, -1 when raw is shorter than that, or -2 - y for
// an unknown filter type on row y.
int png_unfilter(const uint8_t* raw, int64_t raw_len, uint8_t* out, int64_t height,
                 int64_t row_bytes, int bpp) {
  if (raw_len < height * (row_bytes + 1)) return -1;
  const uint8_t* prev = nullptr;  // the unfiltered row above (none for row 0)
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (row_bytes + 1);
    const uint8_t filter = *src++;
    uint8_t* dst = out + y * row_bytes;
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;  // bytes with no left neighbour
    switch (filter) {
      case 0:
        std::memcpy(dst, src, (size_t)row_bytes);
        break;
      case 1:
        std::memcpy(dst, src, (size_t)lead);
        for (int64_t i = lead; i < row_bytes; ++i) dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
        break;
      case 2:
        if (prev == nullptr) {
          std::memcpy(dst, src, (size_t)row_bytes);
        } else {
          for (int64_t i = 0; i < row_bytes; ++i) dst[i] = (uint8_t)(src[i] + prev[i]);
        }
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          const int c = (i >= bpp && prev != nullptr) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return (int)(-2 - y);
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
