// Multi-scale deformable attention, forward — CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/deform_attn_pallas_v3.py:_fwd_kernel
// (reached through ms_deform_attn_fused_t2, the encoder's sampling core in
// poet_tpu/models/transformer.py). It ports the CONTRACT of
// poet_tpu/ops/deform_attn.py:ms_deform_attn_xla, not the TPU formulation:
// the v3 kernel's lane-major coordinates, its 128-query padding and its
// separable one-hot x/y mixes exist only because the TPU has no fast
// gather. Hopper has one, so this kernel gathers the four bilinear corners
// directly.
//
//   value  (B, S, H, D)        f32 or bf16, levels concatenated along S
//   loc    (B, Q, H, L, P, 2)  f32, normalized to [0, 1], (x, y) order
//   attn   (B, Q, H, L, P)     f32, already softmaxed over (L, P)
//   out    (B, Q, H * D)       value dtype, accumulated in f32
//
// Sampling: pixel = loc * size - 0.5 (grid_sample, align_corners=False),
// bilinear, zero padding outside the map. Each corner is bounds-checked on
// its own, and a point whose whole 2x2 footprint lies outside the map
// (including NaN coordinates and the dummy-query convention that puts
// reference points at -1 / -10) reads nothing.
//
// What bounds it: gather bytes. Per (b, q, h, l, p) the kernel reads 4
// corners x D values; at the flagship encoder shape (B=16, Q=S=1600,
// H=16, D=16, L=P=4) that is 16*1600*16*16*4*16*2 B = 0.84 GB of bf16
// corner reads per call against 13 MB of value (it lives in the 50 MB L2),
// so the traffic is L2 -> SM, not HBM. What the design does about it:
//   * one thread owns a 16-byte slice of one head's D channels (8 bf16 or
//     4 f32), so every corner read is one 16-byte vector load and the two
//     threads of a D=16 bf16 head together read one full 32-byte sector;
//   * the coordinate math and the attention weight are computed once per
//     (thread, point) in registers and folded into the 4 corner weights;
//     nothing is staged through device memory;
//   * the f32 accumulator stays in registers and is stored once, converted
//     to the value dtype in the same vector width.
// Making it fast (corner reuse across heads in shared memory, TMA, fusing
// the offset/softmax prologue) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define POET_MAX_LEVELS 8

namespace {

struct Levels {
  int h[POET_MAX_LEVELS];
  int w[POET_MAX_LEVELS];
  int start[POET_MAX_LEVELS];
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
struct Corner {
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
struct Corner<float, 4> {
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
struct Corner<__nv_bfloat16, 8> {
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

// One thread per (b, q, h, c): c indexes a VEC-wide slice of the D channels.
// Consecutive threads walk c, then h, so a warp covers the D channels of
// neighbouring heads of one query.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ attn, T* __restrict__ out, int S, int Q,
                          int H, int D, int L, int P, Levels lv, int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;  // elements between neighbouring tokens
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t bqh = i / chunks;  // ((b * Q + q) * H + h)
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    const float* loc_p = loc + bqh * L * P * 2;
    const float* att_p = attn + bqh * L * P;
    const T* v_bh = value + b * S * row + (int64_t)h * D + c * VEC;

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const T* v_l = v_bh + (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float x = loc_p[2 * k] * (float)Wl - 0.5f;
        const float y = loc_p[2 * k + 1] * (float)Hl - 0.5f;
        // the 2x2 footprint misses the map entirely (also false for NaN)
        if (!(x > -1.f && x < (float)Wl && y > -1.f && y < (float)Hl)) continue;
        const float a = att_p[k];
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float tx = x - x0f;
        const float ty = y - y0f;
        const int x0 = (int)x0f;  // in [-1, Wl - 1] after the check above
        const int y0 = (int)y0f;
        const float wy0 = (1.f - ty) * a;
        const float wy1 = ty * a;
        if (y0 >= 0) {
          const T* r = v_l + (int64_t)y0 * Wl * row;
          if (x0 >= 0) Corner<T, VEC>::fma(r + (int64_t)x0 * row, (1.f - tx) * wy0, acc);
          if (x0 + 1 < Wl) Corner<T, VEC>::fma(r + (int64_t)(x0 + 1) * row, tx * wy0, acc);
        }
        if (y0 + 1 < Hl) {
          const T* r = v_l + (int64_t)(y0 + 1) * Wl * row;
          if (x0 >= 0) Corner<T, VEC>::fma(r + (int64_t)x0 * row, (1.f - tx) * wy1, acc);
          if (x0 + 1 < Wl) Corner<T, VEC>::fma(r + (int64_t)(x0 + 1) * row, tx * wy1, acc);
        }
      }
    }
    Corner<T, VEC>::store(out + bqh * D + c * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const void* value, const float* loc, const float* attn, void* out, int B, int S,
            int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  const int64_t n_items = (int64_t)B * Q * H * (D / VEC);
  if (n_items == 0) return;
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  ms_deform_attn_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      n_items);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec: channels per thread, 1 or the 16-byte width (4 for f32, 8 for bf16)
int poet_ms_deform_attn_fwd(const void* value, const void* loc, const void* attn, void* out,
                            int dtype, int B, int S, int Q, int H, int D, int L, int P,
                            const int* level_hw, int vec, void* stream) {
  if (L < 1 || L > POET_MAX_LEVELS) return -1;
  if (vec < 1 || D % vec != 0) return -2;
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return -3;
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start > S) return -4;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch<float, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 8) {
    launch<__nv_bfloat16, 8>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
