// JPEG decode through nvJPEG (the CUDA toolkit's decoder), the route of a
// machine that has nvJPEG and no libjpeg. Same C interface as
// jpeg_decode.cpp, so poet_tpu_torch/native/__init__.py takes whichever of
// the two builds (libjpeg first).
//
// nvJPEG decodes the components (IDCT on the device: NVJPEG_OUTPUT_YUV, the
// chroma planes at their own resolution; NVJPEG_OUTPUT_Y for gray); the
// planes come to the host, and jpeg_color.h does the rest with libjpeg's
// arithmetic (fancy chroma upsampling, the YCbCr -> RGB tables), so the
// pixels are PIL's but for nvJPEG's IDCT, which is not libjpeg's ISLOW: a
// sample may differ by a unit, which the colour conversion can carry to a
// few (chip_smoke.py measures the largest difference on the committed
// fixtures, tests/data/jpeg/). Only 1- and 3-component images decode: CMYK
// and YCCK fail, as on the libjpeg route and in the JAX package; an RGBA
// output gets alpha 255.
//
// Thread safe: one nvJPEG handle; decoder states, streams and device
// buffers in a pool, one taken per call and returned after it, so the
// loader's worker threads decode in parallel (each call outside the GIL).
// The decode runs on the device `jpeg_set_device` names (default 0).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_color.h"

namespace {

struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* buf = nullptr;  // device, `cap` bytes
  size_t cap = 0;
  int device = -1;
};

std::mutex mutex;
nvjpegHandle_t handle = nullptr;
int device = 0;
std::vector<Decoder*> pool;

int fail(char* message, const char* what, int code) {
  std::snprintf(message, 200, "%s failed (%d)", what, code);
  return -1;
}

// The shared handle, created once; nullptr with `message` set on failure.
nvjpegHandle_t get_handle(char* message) {
  std::lock_guard<std::mutex> lock(mutex);
  if (handle == nullptr) {
    nvjpegStatus_t s = nvjpegCreateSimple(&handle);
    if (s != NVJPEG_STATUS_SUCCESS) {
      handle = nullptr;
      fail(message, "nvjpegCreateSimple", (int)s);
    }
  }
  return handle;
}

Decoder* take(int dev, char* message) {
  {
    std::lock_guard<std::mutex> lock(mutex);
    for (size_t i = 0; i < pool.size(); ++i) {
      if (pool[i]->device == dev) {
        Decoder* d = pool[i];
        pool.erase(pool.begin() + i);
        return d;
      }
    }
  }
  Decoder* d = new Decoder();
  d->device = dev;
  nvjpegStatus_t s = nvjpegJpegStateCreate(handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete d;
    fail(message, "nvjpegJpegStateCreate", (int)s);
    return nullptr;
  }
  cudaError_t e = cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    nvjpegJpegStateDestroy(d->state);
    delete d;
    std::snprintf(message, 200, "cudaStreamCreate: %s", cudaGetErrorString(e));
    return nullptr;
  }
  return d;
}

void give_back(Decoder* d) {
  std::lock_guard<std::mutex> lock(mutex);
  pool.push_back(d);
}

}  // namespace

extern "C" {

// The nvJPEG version (major * 1000 + minor * 10 + patch), or -1.
int jpeg_lib_version() {
  int major = 0, minor = 0, patch = 0;
  if (nvjpegGetProperty(MAJOR_VERSION, &major) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(MINOR_VERSION, &minor) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(PATCH_LEVEL, &patch) != NVJPEG_STATUS_SUCCESS)
    return -1;
  return major * 1000 + minor * 10 + patch;
}

void jpeg_set_device(int dev) {
  std::lock_guard<std::mutex> lock(mutex);
  device = dev;
}

// `message`: the caller's 200 bytes for the error.

// Header only: fills h, w and the number of components. Returns 0 or -1.
int jpeg_probe(const uint8_t* blob, int64_t size, int* h, int* w, int* components,
               char* message) {
  nvjpegHandle_t hd = get_handle(message);
  if (hd == nullptr) return -1;
  int n = 0, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  nvjpegStatus_t s = nvjpegGetImageInfo(hd, blob, (size_t)size, &n, &css, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return fail(message, "nvjpegGetImageInfo", (int)s);
  *h = heights[0];
  *w = widths[0];
  *components = n;
  return 0;
}

// out: (h, w, channels) uint8 on the host, channels 3 or 4 (alpha 255).
// Returns 0; -1 with a message; -2 when the image is not h x w.
int jpeg_decode(const uint8_t* blob, int64_t size, uint8_t* out, int h, int w, int channels,
                char* message) {
  nvjpegHandle_t hd = get_handle(message);
  if (hd == nullptr) return -1;
  int n = 0, widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t css;
  nvjpegStatus_t s = nvjpegGetImageInfo(hd, blob, (size_t)size, &n, &css, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return fail(message, "nvjpegGetImageInfo", (int)s);
  if (heights[0] != h || widths[0] != w) return -2;
  if (n != 1 && n != 3) {
    std::snprintf(message, 200, "Unsupported color conversion request (%d components)", n);
    return -1;
  }
  int hf = 1, vf = 1;  // chroma upsampling factors
  if (n == 3) {
    switch (css) {
      case NVJPEG_CSS_444: break;
      case NVJPEG_CSS_422: hf = 2; break;
      case NVJPEG_CSS_420: hf = 2; vf = 2; break;
      case NVJPEG_CSS_440: vf = 2; break;
      case NVJPEG_CSS_411: hf = 4; break;
      case NVJPEG_CSS_410: hf = 4; vf = 2; break;
      default:
        std::snprintf(message, 200, "chroma subsampling %d is not decoded", (int)css);
        return -1;
    }
  }
  int dev;
  {
    std::lock_guard<std::mutex> lock(mutex);
    dev = device;
  }
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) {
    std::snprintf(message, 200, "cudaSetDevice(%d): %s", dev, cudaGetErrorString(e));
    return -1;
  }
  size_t offset[3] = {0, 0, 0}, bytes = 0;
  for (int c = 0; c < n; ++c) {
    offset[c] = bytes;
    bytes += (size_t)widths[c] * heights[c];
  }
  Decoder* d = take(dev, message);
  if (d == nullptr) return -1;
  if (d->cap < bytes) {
    if (d->buf != nullptr) cudaFree(d->buf);
    d->buf = nullptr;
    d->cap = 0;
    e = cudaMalloc(reinterpret_cast<void**>(&d->buf), bytes);
    if (e != cudaSuccess) {
      std::snprintf(message, 200, "cudaMalloc(%zu): %s", bytes, cudaGetErrorString(e));
      give_back(d);
      return -1;
    }
    d->cap = bytes;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  for (int c = 0; c < n; ++c) {
    img.channel[c] = d->buf + offset[c];
    img.pitch[c] = (size_t)widths[c];
  }
  std::vector<uint8_t> planes(bytes);
  s = nvjpegDecode(handle, d->state, blob, (size_t)size,
                   n == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img, d->stream);
  if (s == NVJPEG_STATUS_SUCCESS) {
    e = cudaMemcpyAsync(planes.data(), d->buf, bytes, cudaMemcpyDeviceToHost, d->stream);
    if (e == cudaSuccess) e = cudaStreamSynchronize(d->stream);
  }
  give_back(d);
  if (s != NVJPEG_STATUS_SUCCESS) return fail(message, "nvjpegDecode", (int)s);
  if (e != cudaSuccess) {
    std::snprintf(message, 200, "copy to the host: %s", cudaGetErrorString(e));
    return -1;
  }
  if (n == 3 && (widths[1] != widths[2] || heights[1] != heights[2] ||
                 widths[1] * hf < w || heights[1] * vf < h)) {
    std::snprintf(message, 200, "chroma planes %dx%d / %dx%d do not cover %dx%d", widths[1],
                  heights[1], widths[2], heights[2], w, h);
    return -1;
  }
  jpeg_color::to_rgb(planes.data(), n == 3 ? planes.data() + offset[1] : nullptr,
                     n == 3 ? planes.data() + offset[2] : nullptr, w, h, widths[1], heights[1],
                     hf, vf, n == 3 && jpeg_color::rgb_coded(blob, size), out, channels);
  return 0;
}

}  // extern "C"
