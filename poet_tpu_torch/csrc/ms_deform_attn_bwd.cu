// Multi-scale deformable attention, adjoint — CUDA for Hopper (sm_90a).
//
// Three kernels, replacing the TPU's two adjoints in
// poet_tpu/ops/deform_attn_pallas_v3.py:
//   * ms_deform_attn_dvalue_kernel  replaces _bwd_dval_kernel (d_value) and
//   * ms_deform_attn_dloc_kernel    replaces _bwd_dloc_kernel (d_loc, d_attn),
//     the two-kernel adjoint _bwd_twokernel_core;
//   * ms_deform_attn_merged_kernel  replaces _bwd_kernel, the merged adjoint
//     _v3_bwd_impl_merged (all three gradients in one pass).
// Like the forward (ms_deform_attn_fwd.cu) they hold the contract of
// poet_tpu/ops/deform_attn.py:ms_deform_attn_xla and its gradient, not the
// TPU layouts (transposed locT/attnT, 128-query padding, one-hot mixes):
//
//   value  (B, S, H, D)        f32 or bf16            (d_loc kernel input)
//   loc    (B, Q, H, L, P, 2)  f32, normalized, (x, y)
//   attn   (B, Q, H, L, P)     f32
//   dout   (B, Q, H * D)       value dtype, read and converted to f32
//   d_value (B, S, H, D)       f32, accumulated here; the caller zeroes it
//                              and casts it to the value dtype
//   d_loc  (B, Q, H, L, P, 2)  f32, w.r.t. the NORMALIZED locations
//   d_attn (B, Q, H, L, P)     f32
//
// Sampling is the forward's: pixel = loc * size - 0.5, bilinear, zero
// padding. A point whose 2x2 footprint misses the map (or is NaN, or sits at
// the dummy -1 / -10 conventions) adds nothing to d_value and gets exactly 0
// in d_loc and d_attn. floor() has zero derivative, as under autodiff.
//
// d_value is a scatter. The TPU kernel carries the sum over its sequential
// query grid in a VMEM accumulator; Hopper's blocks run in no order, so each
// thread adds its corner contributions with atomics into an f32 buffer. At
// the flagship encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4) that is
// 6.55 M points x 4 corners x 16 channels = 419 M f32 adds per call into a
// 26 MB buffer that stays in the 50 MB L2: the bound is atomic throughput,
// not bytes. Hopper's 16-byte vector atomicAdd (float4, global memory) cuts
// the atomic count 4x (measured 3.8x faster than scalar atomics there); it
// takes every 4-channel slice, and D % 4 != 0 falls back to scalar atomics.
// The order of the sum changes from run to run.
//
// d_loc / d_attn is a gather, with the forward's four vector corner loads.
// Per point, each thread forms four partial dot products e_c = sum_d dout_d *
// v_c,d over its channels, the threads of one head reduce them with warp
// shuffles, and the first of them writes
//   d_attn = w00 e00 + w01 e01 + w10 e10 + w11 e11
//   d_x    = a * W_l * [(1-ty)(e01 - e00) + ty (e11 - e10)]
//   d_y    = a * H_l * [(1-tx)(e10 - e00) + tx (e11 - e01)]
// (corner cy,cx: 00 = (y0,x0), 01 = (y0,x0+1), 10 = (y0+1,x0), 11 = both+1;
// a corner outside the map counts as value 0). Nothing but the outputs is
// written to device memory.
//
// The merged kernel does both in one pass over the sampling points, with the
// d_loc kernel's thread layout: per point it computes the pixel coordinates,
// the corners and the bilinear weights once, gathers the four value corners
// for e_c, and adds corner_weight * a * dout into the f32 d_value buffer with
// the same float4 atomics. Value, dout and the coordinates are each read
// once (the pair reads dout and the coordinates twice, and computes the
// corner weights twice). Its d_value sum is unordered, like the scatter's.

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

// dst[0:VEC] = float(p[0:VEC]); one 16-byte load where VEC fills 16 bytes
template <typename T, int VEC>
struct Load {
  static __device__ __forceinline__ void f32(const T* p, float* dst) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = to_float(p[j]);
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void f32(const float* p, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void f32(const __nv_bfloat16* p, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  }
};

// four bf16 channels: one 8-byte load
template <>
struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void f32(const __nv_bfloat16* p, float* dst) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      dst[2 * j] = f.x;
      dst[2 * j + 1] = f.y;
    }
  }
};

// p[0:VEC] += w * g[0:VEC] in global memory. Groups of four channels go as
// one 16-byte atomic (p 16-byte aligned when VEC % 4 == 0).
template <int VEC>
__device__ __forceinline__ void scatter(float* p, float w, const float* g) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
      atomicAdd(reinterpret_cast<float4*>(p + j),
                make_float4(w * g[j], w * g[j + 1], w * g[j + 2], w * g[j + 3]));
#else  // the host pass only; this file is built for sm_90a alone
#pragma unroll
      for (int t = 0; t < 4; ++t) atomicAdd(p + j + t, w * g[j + t]);
#endif
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) atomicAdd(p + j, w * g[j]);
  }
}

// Pixel coordinates of one point. False when the 2x2 footprint misses the
// map entirely (also for NaN); otherwise x0, y0 in [-1, size - 1].
__device__ __forceinline__ bool point_coords(const float* loc2, int Hl, int Wl, int* x0,
                                             int* y0, float* tx, float* ty) {
  const float x = loc2[0] * (float)Wl - 0.5f;
  const float y = loc2[1] * (float)Hl - 0.5f;
  if (!(x > -1.f && x < (float)Wl && y > -1.f && y < (float)Hl)) return false;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  *tx = x - x0f;
  *ty = y - y0f;
  *x0 = (int)x0f;
  *y0 = (int)y0f;
  return true;
}

// ---------------------------------------------------------------- d_value
// One thread per (b, q, h, c): c indexes a VEC-wide slice of the D channels
// — 4, a 16-byte slice of the f32 accumulator, for both dtypes (for bf16 the
// forward's 16-byte slice of 8 channels measured 1.85x slower: half the
// threads, each issuing two atomics in turn). dout is read once; per in-map
// corner the thread adds corner_weight * a * dout into d_value.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_dvalue_kernel(const float* __restrict__ loc, const float* __restrict__ attn,
                             const T* __restrict__ dout, float* __restrict__ dvalue, int S,
                             int Q, int H, int D, int L, int P, Levels lv, int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t bqh = i / chunks;  // ((b * Q + q) * H + h)
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    const float* loc_p = loc + bqh * L * P * 2;
    const float* att_p = attn + bqh * L * P;
    float* dv_bh = dvalue + b * S * row + (int64_t)h * D + c * VEC;

    float g[VEC];
    Load<T, VEC>::f32(dout + bqh * D + c * VEC, g);

    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      float* dv_l = dv_bh + (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        int x0, y0;
        float tx, ty;
        if (!point_coords(loc_p + 2 * k, Hl, Wl, &x0, &y0, &tx, &ty)) continue;
        const float a = att_p[k];
        const float wy0 = (1.f - ty) * a;
        const float wy1 = ty * a;
        if (y0 >= 0) {
          float* r = dv_l + (int64_t)y0 * Wl * row;
          if (x0 >= 0) scatter<VEC>(r + (int64_t)x0 * row, (1.f - tx) * wy0, g);
          if (x0 + 1 < Wl) scatter<VEC>(r + (int64_t)(x0 + 1) * row, tx * wy0, g);
        }
        if (y0 + 1 < Hl) {
          float* r = dv_l + (int64_t)(y0 + 1) * Wl * row;
          if (x0 >= 0) scatter<VEC>(r + (int64_t)x0 * row, (1.f - tx) * wy1, g);
          if (x0 + 1 < Wl) scatter<VEC>(r + (int64_t)(x0 + 1) * row, tx * wy1, g);
        }
      }
    }
  }
}

// ---------------------------------------------------------- d_loc, d_attn
// G consecutive lanes share one (b, q, h): G is the power of two >= D / VEC
// (at most 32), so a group never straddles a warp. Lane r of a group takes
// the channel slices c = r, r + G, ... < D / VEC. All lanes of a group take
// the same branches (same point), so the shuffles use the group's mask.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_dloc_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                           const float* __restrict__ attn, const T* __restrict__ dout,
                           float* __restrict__ dloc, float* __restrict__ dattn, int S, int Q,
                           int H, int D, int L, int P, int G, Levels lv, int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;
  const int lane = threadIdx.x & 31;
  const unsigned group_mask =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane & ~(G - 1));
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(i % G);
    const int64_t bqh = i / G;
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    const float* loc_p = loc + bqh * L * P * 2;
    const float* att_p = attn + bqh * L * P;
    const T* v_bh = value + b * S * row + (int64_t)h * D;
    const T* do_p = dout + bqh * D;

    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const T* v_l = v_bh + (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        int x0, y0;
        float tx, ty;
        if (!point_coords(loc_p + 2 * k, Hl, Wl, &x0, &y0, &tx, &ty)) {
          if (r == 0) {
            dattn[bqh * L * P + k] = 0.f;
            dloc[(bqh * L * P + k) * 2] = 0.f;
            dloc[(bqh * L * P + k) * 2 + 1] = 0.f;
          }
          continue;
        }
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < Hl;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < Wl;
        const T* r0 = v_l + (int64_t)y0 * Wl * row;
        const T* r1 = v_l + (int64_t)(y0 + 1) * Wl * row;
        float e00 = 0.f, e01 = 0.f, e10 = 0.f, e11 = 0.f;
        for (int c = r; c < chunks; c += G) {
          float g[VEC], v[VEC];
          Load<T, VEC>::f32(do_p + c * VEC, g);
          const int64_t off = c * VEC;
          if (in_y0 && in_x0) {
            Load<T, VEC>::f32(r0 + (int64_t)x0 * row + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e00 += g[j] * v[j];
          }
          if (in_y0 && in_x1) {
            Load<T, VEC>::f32(r0 + (int64_t)(x0 + 1) * row + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e01 += g[j] * v[j];
          }
          if (in_y1 && in_x0) {
            Load<T, VEC>::f32(r1 + (int64_t)x0 * row + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e10 += g[j] * v[j];
          }
          if (in_y1 && in_x1) {
            Load<T, VEC>::f32(r1 + (int64_t)(x0 + 1) * row + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e11 += g[j] * v[j];
          }
        }
        for (int s = G >> 1; s > 0; s >>= 1) {
          e00 += __shfl_xor_sync(group_mask, e00, s);
          e01 += __shfl_xor_sync(group_mask, e01, s);
          e10 += __shfl_xor_sync(group_mask, e10, s);
          e11 += __shfl_xor_sync(group_mask, e11, s);
        }
        if (r == 0) {
          const float a = att_p[k];
          dattn[bqh * L * P + k] = (1.f - ty) * ((1.f - tx) * e00 + tx * e01) +
                                   ty * ((1.f - tx) * e10 + tx * e11);
          dloc[(bqh * L * P + k) * 2] =
              a * (float)Wl * ((1.f - ty) * (e01 - e00) + ty * (e11 - e10));
          dloc[(bqh * L * P + k) * 2 + 1] =
              a * (float)Hl * ((1.f - tx) * (e10 - e00) + tx * (e11 - e01));
        }
      }
    }
  }
}

// ------------------------------------------------ merged: all three at once
// The d_loc kernel's layout (G lanes per (b, q, h), lane r takes the channel
// slices r, r + G, ...), with VEC = 4 channels per slice for both dtypes: a
// 16-byte slice of the f32 d_value buffer, one float4 atomic per corner (as
// the scatter). Per point and slice the lane loads dout and the in-map value
// corners once, adds w_c * a * dout into d_value and dout . v_c into e_c.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_merged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                             const float* __restrict__ attn, const T* __restrict__ dout,
                             float* __restrict__ dvalue, float* __restrict__ dloc,
                             float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                             int P, int G, Levels lv, int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;
  const int lane = threadIdx.x & 31;
  const unsigned group_mask =
      (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane & ~(G - 1));
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(i % G);
    const int64_t bqh = i / G;
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    const float* loc_p = loc + bqh * L * P * 2;
    const float* att_p = attn + bqh * L * P;
    const T* v_bh = value + b * S * row + (int64_t)h * D;
    float* dv_bh = dvalue + b * S * row + (int64_t)h * D;
    const T* do_p = dout + bqh * D;

    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const int64_t lvl = (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        int x0, y0;
        float tx, ty;
        if (!point_coords(loc_p + 2 * k, Hl, Wl, &x0, &y0, &tx, &ty)) {
          if (r == 0) {
            dattn[bqh * L * P + k] = 0.f;
            dloc[(bqh * L * P + k) * 2] = 0.f;
            dloc[(bqh * L * P + k) * 2 + 1] = 0.f;
          }
          continue;
        }
        const float a = att_p[k];
        const float wy0 = (1.f - ty) * a;
        const float wy1 = ty * a;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < Hl;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < Wl;
        const int64_t o00 = lvl + ((int64_t)y0 * Wl + x0) * row;  // corner (y0, x0)
        const int64_t o01 = o00 + row;
        const int64_t o10 = o00 + (int64_t)Wl * row;
        const int64_t o11 = o10 + row;
        float e00 = 0.f, e01 = 0.f, e10 = 0.f, e11 = 0.f;
        for (int c = r; c < chunks; c += G) {
          const int64_t off = c * VEC;
          float g[VEC], v[VEC];
          Load<T, VEC>::f32(do_p + off, g);
          if (in_y0 && in_x0) {
            Load<T, VEC>::f32(v_bh + o00 + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e00 += g[j] * v[j];
            scatter<VEC>(dv_bh + o00 + off, (1.f - tx) * wy0, g);
          }
          if (in_y0 && in_x1) {
            Load<T, VEC>::f32(v_bh + o01 + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e01 += g[j] * v[j];
            scatter<VEC>(dv_bh + o01 + off, tx * wy0, g);
          }
          if (in_y1 && in_x0) {
            Load<T, VEC>::f32(v_bh + o10 + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e10 += g[j] * v[j];
            scatter<VEC>(dv_bh + o10 + off, (1.f - tx) * wy1, g);
          }
          if (in_y1 && in_x1) {
            Load<T, VEC>::f32(v_bh + o11 + off, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) e11 += g[j] * v[j];
            scatter<VEC>(dv_bh + o11 + off, tx * wy1, g);
          }
        }
        for (int s = G >> 1; s > 0; s >>= 1) {
          e00 += __shfl_xor_sync(group_mask, e00, s);
          e01 += __shfl_xor_sync(group_mask, e01, s);
          e10 += __shfl_xor_sync(group_mask, e10, s);
          e11 += __shfl_xor_sync(group_mask, e11, s);
        }
        if (r == 0) {
          dattn[bqh * L * P + k] = (1.f - ty) * ((1.f - tx) * e00 + tx * e01) +
                                   ty * ((1.f - tx) * e10 + tx * e11);
          dloc[(bqh * L * P + k) * 2] =
              a * (float)Wl * ((1.f - ty) * (e01 - e00) + ty * (e11 - e10));
          dloc[(bqh * L * P + k) * 2 + 1] =
              a * (float)Hl * ((1.f - tx) * (e10 - e00) + tx * (e11 - e01));
        }
      }
    }
  }
}

int64_t grid_for(int64_t n_items, int threads) {
  int64_t blocks = (n_items + threads - 1) / threads;
  return blocks > ((int64_t)1 << 20) ? ((int64_t)1 << 20) : blocks;  // grid-stride beyond
}

template <typename T, int VEC>
void launch_dvalue(const float* loc, const float* attn, const void* dout, float* dvalue, int B,
                   int S, int Q, int H, int D, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const int64_t n_items = (int64_t)B * Q * H * (D / VEC);
  if (n_items == 0) return;
  ms_deform_attn_dvalue_kernel<T, VEC><<<(unsigned)grid_for(n_items, 256), 256, 0, stream>>>(
      loc, attn, static_cast<const T*>(dout), dvalue, S, Q, H, D, L, P, lv, n_items);
}

template <typename T, int VEC>
void launch_dloc(const void* value, const float* loc, const float* attn, const void* dout,
                 float* dloc, float* dattn, int B, int S, int Q, int H, int D, int L, int P,
                 const Levels& lv, cudaStream_t stream) {
  const int chunks = D / VEC;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const int64_t n_items = (int64_t)B * Q * H * G;
  if (n_items == 0) return;
  ms_deform_attn_dloc_kernel<T, VEC><<<(unsigned)grid_for(n_items, 256), 256, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout), dloc, dattn, S, Q,
      H, D, L, P, G, lv, n_items);
}

template <typename T, int VEC>
void launch_merged(const void* value, const float* loc, const float* attn, const void* dout,
                   float* dvalue, float* dloc, float* dattn, int B, int S, int Q, int H, int D,
                   int L, int P, const Levels& lv, cudaStream_t stream) {
  const int chunks = D / VEC;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const int64_t n_items = (int64_t)B * Q * H * G;
  if (n_items == 0) return;
  ms_deform_attn_merged_kernel<T, VEC><<<(unsigned)grid_for(n_items, 256), 256, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout), dvalue, dloc,
      dattn, S, Q, H, D, L, P, G, lv, n_items);
}

// level table from host (H_l, W_l) pairs; 0 or a negative argument code
int make_levels(const int* level_hw, int L, int S, Levels* lv) {
  if (L < 1 || L > POET_MAX_LEVELS) return -1;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    if (lv->h[l] < 1 || lv->w[l] < 1) return -3;
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start > S ? -4 : 0;
}

}  // namespace

extern "C" {

// Each returns 0 on success, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16 (of value and dout)
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec: channels per thread, 1 or 4 for d_value and the merged kernel (a
//        16-byte f32 slice of the accumulator, one float4 atomic per corner,
//        for either dtype); 1 or the 16-byte width of the value (4 f32, 8
//        bf16) for d_loc

// d_value += adjoint of the sampling (d_value zeroed by the caller, f32).
int poet_ms_deform_attn_bwd_dvalue(const void* loc, const void* attn, const void* dout,
                                   void* dvalue, int dtype, int B, int S, int Q, int H, int D,
                                   int L, int P, const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dv = static_cast<float*>(dvalue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_dvalue<float, 4>(locf, attf, dout, dv, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch_dvalue<float, 1>(locf, attf, dout, dv, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 4) {
    launch_dvalue<__nv_bfloat16, 4>(locf, attf, dout, dv, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch_dvalue<__nv_bfloat16, 1>(locf, attf, dout, dv, B, S, Q, H, D, L, P, lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

// d_loc (w.r.t. normalized locations) and d_attn, every element written.
int poet_ms_deform_attn_bwd_dloc(const void* value, const void* loc, const void* attn,
                                 const void* dout, void* dloc, void* dattn, int dtype, int B,
                                 int S, int Q, int H, int D, int L, int P, const int* level_hw,
                                 int vec, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_dloc<float, 4>(value, locf, attf, dout, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch_dloc<float, 1>(value, locf, attf, dout, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 8) {
    launch_dloc<__nv_bfloat16, 8>(value, locf, attf, dout, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch_dloc<__nv_bfloat16, 1>(value, locf, attf, dout, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

// The merged adjoint: d_value += (zeroed by the caller, f32), and every
// element of d_loc and d_attn written. vec: 1 or 4 channels per slice.
int poet_ms_deform_attn_bwd_merged(const void* value, const void* loc, const void* attn,
                                   const void* dout, void* dvalue, void* dloc, void* dattn,
                                   int dtype, int B, int S, int Q, int H, int D, int L, int P,
                                   const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dv = static_cast<float*>(dvalue);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch_merged<float, 4>(value, locf, attf, dout, dv, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch_merged<float, 1>(value, locf, attf, dout, dv, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 4) {
    launch_merged<__nv_bfloat16, 4>(value, locf, attf, dout, dv, dl, da, B, S, Q, H, D, L, P,
                                    lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch_merged<__nv_bfloat16, 1>(value, locf, attf, dout, dv, dl, da, B, S, Q, H, D, L, P,
                                    lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
