// Multi-scale RoIAlign, forward — CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/roi_align_pallas.py:_kernel (reached
// from multiscale_roi_align_pallas and its wide-box re-pool), the Mask R-CNN
// box head's pooling on the detect+pose path. It computes torchvision
// MultiScaleRoIAlign with aligned=False: each box pools a 7x7 grid of bins
// from the one pyramid level its scale selects, each bin the mean of 2x2
// bilinear samples.
//
// The geometry is NOT computed here. The wrapper
// (poet_tpu_torch/ops/roi_align_cuda.py) computes, in torch and shared with
// the plain version, each box's level and per sample of each axis the lower
// corner and the two corner weights (zero for a sample outside the map).
// The level choice (floor of a log2) and the cell a sample coordinate
// floors to are discontinuous, and nvcc contracts a*b+c into an FMA by
// default, so coordinates computed in-kernel could land in another cell or
// level than torch's on the CPU. This kernel only gathers and blends.
//
//   level_ptrs[l]  (B, H_l, W_l, C)   f32 or bf16, one pointer per level
//   level          (BR,)              int32, the box's level index
//   ylo, xlo       (BR, N)            int32, lower corner per sample, N = out * s
//   yw, xw         (BR, N, 2)         f32, weights of the lower and upper corner
//   out            (BR, out, out, C)  features' dtype, summed in f32, rounded once
//
// The TPU kernel's VMEM-resident pyramid, 8-aligned x-window and x-weight
// matmul exist because the TPU has no fast gather; they are not carried
// over, and so there are no x-window violators and no re-pool loop.
//
// What bounds it: bytes. The function reads the pyramid once (209 MB of
// bf16 at B=16, 480x640, C=256) and writes 401 MB of pooled bins
// (16 x 1000 x 7 x 7 x 256): ~182 us at 3.35 TB/s, against ~6.4 GFLOP of
// blending (~96 us at 67 TFLOP/s f32). The kernel reads 16 corner vectors
// per bin (4 samples x 4 corners), 16x the output bytes, from L2: boxes run
// image-major, so one image's 13 MB pyramid serves a run of neighbouring
// blocks out of the 50 MB L2. What the design does about it:
//   * one thread owns one bin and a 16-byte slice of its channels (8 bf16
//     or 4 f32), so a warp reads one corner's 256 bf16 channels as one
//     contiguous 512-byte row and stores the bin in one coalesced write;
//   * the per-sample geometry is a broadcast load shared by the warp, and
//     a sample outside the map (both weights zero) reads nothing;
//   * the f32 sum stays in registers and is stored once.
// Making it fast (reusing corners shared between neighbouring samples and
// bins in shared memory, TMA row loads) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define POET_ROI_MAX_LEVELS 8

namespace {

struct Levels {
  const void* ptr[POET_ROI_MAX_LEVELS];
  int h[POET_ROI_MAX_LEVELS];
  int w[POET_ROI_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc[0:VEC] += w * p[0:VEC]
template <typename T, int VEC>
struct Vec {
  static __device__ __forceinline__ void fma(const T* p, float w, float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += w * to_float(p[j]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(acc[j]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void fma(const float* p, float w, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(const __nv_bfloat16* p, float w, float* acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      acc[2 * j] += w * f.x;
      acc[2 * j + 1] += w * f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* acc) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// One thread per (box, oy, ox, c): c indexes a VEC-wide slice of the C
// channels. Consecutive threads walk c, then ox, so a warp covers the
// channels of one bin (C = 256 bf16) or of neighbouring bins.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
roi_align_fwd_kernel(Levels lv, int L, const int* __restrict__ level,
                     const int* __restrict__ ylo, const float2* __restrict__ yw,
                     const int* __restrict__ xlo, const float2* __restrict__ xw,
                     T* __restrict__ out, int R, int C, int out_size, int s, int64_t n_items) {
  const int chunks = C / VEC;
  const int N = out_size * s;
  const float inv_count = 1.f / (float)(s * s);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t bin = i / chunks;                 // (r * out + oy) * out + ox
    const int ox = (int)(bin % out_size);
    const int oy = (int)((bin / out_size) % out_size);
    const int64_t r = bin / ((int64_t)out_size * out_size);
    const int l = min(max(level[r], 0), L - 1);
    const int Hl = lv.h[l];
    const int Wl = lv.w[l];
    const int64_t b = r / R;
    const T* f = static_cast<const T*>(lv.ptr[l]) + b * Hl * Wl * C + c * VEC;

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    for (int ky = 0; ky < s; ++ky) {
      const int64_t ny = r * N + oy * s + ky;
      const float2 wy = yw[ny];
      if (wy.x == 0.f && wy.y == 0.f) continue;     // outside the map: reads nothing
      const int y0 = min(max(ylo[ny], 0), Hl - 2);
      const T* row0 = f + (int64_t)y0 * Wl * C;
      const T* row1 = row0 + (int64_t)Wl * C;
      for (int kx = 0; kx < s; ++kx) {
        const int64_t nx = r * N + ox * s + kx;
        const float2 wx = xw[nx];
        if (wx.x == 0.f && wx.y == 0.f) continue;
        const int x0 = min(max(xlo[nx], 0), Wl - 2);
        const int64_t o0 = (int64_t)x0 * C;
        const int64_t o1 = o0 + C;
        Vec<T, VEC>::fma(row0 + o0, wy.x * wx.x, acc);
        Vec<T, VEC>::fma(row0 + o1, wy.x * wx.y, acc);
        Vec<T, VEC>::fma(row1 + o0, wy.y * wx.x, acc);
        Vec<T, VEC>::fma(row1 + o1, wy.y * wx.y, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= inv_count;
    Vec<T, VEC>::store(out + bin * C + c * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const Levels& lv, int L, const int* level, const int* ylo, const float* yw,
            const int* xlo, const float* xw, void* out, int B, int R, int C, int out_size,
            int s, cudaStream_t stream) {
  const int64_t n_items = (int64_t)B * R * out_size * out_size * (C / VEC);
  if (n_items == 0) return;
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  roi_align_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      lv, L, level, ylo, reinterpret_cast<const float2*>(yw), xlo,
      reinterpret_cast<const float2*>(xw), static_cast<T*>(out), R, C, out_size, s, n_items);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   level_ptrs: host array of L device pointers, level l is (B, H_l, W_l, C)
//   level_hw:   host array of 2*L ints, (H_l, W_l) per level
//   dtype:      0 = float32, 1 = bfloat16
//   vec:        channels per thread, 1 or the 16-byte width (4 f32, 8 bf16)
int poet_roi_align_fwd(const void* const* level_ptrs, const int* level_hw, int L,
                       const void* level, const void* ylo, const void* yw, const void* xlo,
                       const void* xw, void* out, int dtype, int B, int R, int C,
                       int out_size, int sampling_ratio, int vec, void* stream) {
  if (L < 1 || L > POET_ROI_MAX_LEVELS) return -1;
  if (vec < 1 || C % vec != 0) return -2;
  if (out_size < 1 || sampling_ratio < 1) return -3;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 2 || lv.w[l] < 2) return -4;   // bilinear corners need 2x2
  }
  const int* lvl = static_cast<const int*>(level);
  const int* yl = static_cast<const int*>(ylo);
  const int* xl = static_cast<const int*>(xlo);
  const float* ywf = static_cast<const float*>(yw);
  const float* xwf = static_cast<const float*>(xw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = sampling_ratio;
  if (dtype == 0 && vec == 4) {
    launch<float, 4>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 1 && vec == 8) {
    launch<__nv_bfloat16, 8>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
