// The per-point body of the gather-route deformable-attention kernels
// (sm_90a): the level table, a sampling point's pixel coordinates, its
// footprint test, its four bilinear corners with their weights, and a
// point's d_attn / d_loc from its four corner dot products; and the slab
// routes' staging and shared-memory grant. A header:
// ms_deform_attn_fwd.cu (kernel 1, direct and slab routes),
// ms_deform_attn_bwd.cu (the d_value scatter, the d_loc/d_attn gather, the
// merged adjoint on its atomic and slab routes) and
// ms_deform_attn_fwd_variants.cu (the forward's ablations) include it, so
// all of them compute the one body below, and ops/cuda_build.py keys each
// library by this file too.
//
// Sampling is grid_sample's: pixel = loc * size - 0.5 (align_corners=False),
// bilinear, zero padding outside the map. The expression is left to nvcc,
// which contracts it into one FMA: kernel 1 has always computed it so, and
// the variants must stay bit-equal to it. A point whose whole 2x2 footprint
// misses the map (the dummy-query -1 / -10 conventions) reads nothing, adds
// nothing and gets exactly 0 in d_loc and d_attn.
//
// A point with a non-finite pixel coordinate (a NaN or infinite location, as
// a diverged sampling offset gives) follows the C1 rule, which every kernel
// that includes this header and the plain version
// (ops/deform_attn.py:ms_deform_attn_torch and its backward) share:
//   * forward: its (b, q, h) output row is NaN, all D channels, as in every
//     JAX formulation (ms_deform_attn_xla's bilinear weight is x - floor(x),
//     NaN for a NaN or infinite x); the kernels carry a per-(q, h) flag
//     through the point loop and read no corner for the point;
//   * adjoint: its d_attn and both of its d_loc coordinates are NaN, and it
//     adds nothing to d_value; every other entry is what it would be without
//     the flag. jax.grad of ms_deform_attn_xla also gives NaN d_attn, but
//     which d_value tokens turn NaN and whether d_loc's other coordinate is
//     NaN hang on the backend's cast of a NaN index to an integer (XLA on the
//     CPU clamps it to column 0): that part of the rule is the port's own,
//     stated in ROADMAP C1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

#define POET_MAX_LEVELS 8

namespace deform_point {

// (H_l, W_l) and the first token of each level in S. The kernels take it as
// a `const __grid_constant__` parameter: indexed by a runtime level it is
// read from the parameter bank, where a by-value struct parameter was first
// copied into a stack frame (local memory) and read from there.
struct Levels {
  int h[POET_MAX_LEVELS];
  int w[POET_MAX_LEVELS];
  int start[POET_MAX_LEVELS];
};

// The table from the host's (H_l, W_l) pairs: 0, or -1 (L outside [1, 8]),
// -3 (an empty level), -4 (the levels exceed S).
inline int make_levels(const int* level_hw, int L, int S, Levels* lv) {
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A sampling point's 2x2 footprint on its level.
struct Footprint {
  int t00;                          // token of corner (y0, x0) in the level: y0 * W + x0
  float tx, ty;                     // the point's fractions within the cell
  bool in_x0, in_x1, in_y0, in_y1;  // columns x0, x0 + 1 and rows y0, y0 + 1 in the map
};

// NaN for the C1 rule's output rows and gradients.
__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// The footprint of the point at normalized (lx, ly) on an Hl x Wl level.
// False when it misses the map entirely (also for a NaN or infinite
// coordinate); otherwise f is filled and x0, y0 lie in [-1, size - 1].
__device__ __forceinline__ bool footprint(float lx, float ly, int Hl, int Wl, Footprint* f) {
  const float x = lx * (float)Wl - 0.5f;
  const float y = ly * (float)Hl - 0.5f;
  if (!(x > -1.f && x < (float)Wl && y > -1.f && y < (float)Hl)) return false;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  f->tx = x - x0f;
  f->ty = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  f->t00 = y0 * Wl + x0;
  f->in_x0 = x0 >= 0;
  f->in_x1 = x0 + 1 < Wl;
  f->in_y0 = y0 >= 0;
  f->in_y1 = y0 + 1 < Hl;
  return true;
}

// For a point `footprint` refused: true when its pixel coordinate is NaN or
// infinite (the C1 rule), false when it lies off the map. Asked only on that
// path, so a point in the map costs nothing more.
__device__ __forceinline__ bool nonfinite(float lx, float ly, int Hl, int Wl) {
  return !(isfinite(lx * (float)Wl - 0.5f) && isfinite(ly * (float)Hl - 0.5f));
}

// d_attn and d_loc of a point that samples nothing: 0 off the map, NaN for a
// non-finite coordinate (the C1 rule).
__device__ __forceinline__ void miss_grads(bool is_nonfinite, float* d_attn, float* dx,
                                           float* dy) {
  const float g = is_nonfinite ? nan_f32() : 0.f;
  *d_attn = g;
  *dx = g;
  *dy = g;
}

// fn(c, token, weight) for each corner of the footprint that lies in the
// map, in the order c = 0 (y0, x0), 1 (y0, x0 + 1), 2 (y0 + 1, x0), 3
// (y0 + 1, x0 + 1); token is the corner's token in the level, weight its
// bilinear weight times the attention weight a. c is a constant in each
// call, so an array indexed by it stays in registers.
template <typename F>
__device__ __forceinline__ void for_each_corner(const Footprint& f, int Wl, float a, F&& fn) {
  const float wy0 = (1.f - f.ty) * a;
  const float wy1 = f.ty * a;
  if (f.in_y0) {
    if (f.in_x0) fn(0, f.t00, (1.f - f.tx) * wy0);
    if (f.in_x1) fn(1, f.t00 + 1, f.tx * wy0);
  }
  if (f.in_y1) {
    if (f.in_x0) fn(2, f.t00 + Wl, (1.f - f.tx) * wy1);
    if (f.in_x1) fn(3, f.t00 + Wl + 1, f.tx * wy1);
  }
}

// A point's gradients from e[c] = dout . value at corner c (0 for a corner
// outside the map): d_attn, and d_loc with respect to the NORMALIZED x, y
// (floor() has zero derivative, as under autodiff).
__device__ __forceinline__ void point_grads(const Footprint& f, float a, int Hl, int Wl,
                                            const float* e, float* d_attn, float* dx,
                                            float* dy) {
  *d_attn = (1.f - f.ty) * ((1.f - f.tx) * e[0] + f.tx * e[1]) +
            f.ty * ((1.f - f.tx) * e[2] + f.tx * e[3]);
  *dx = a * (float)Wl * ((1.f - f.ty) * (e[1] - e[0]) + f.ty * (e[3] - e[2]));
  *dy = a * (float)Hl * ((1.f - f.tx) * (e[2] - e[0]) + f.tx * (e[3] - e[1]));
}

// The slab routes' staging: the (S, D) values of one (b, h), whose token
// rows lie `row` elements apart in device memory, into shared memory packed
// densely (token t's channels at dst[t * D]). With `async16` (D * sizeof(T)
// a multiple of 16 and `src` 16-byte aligned) by 16-byte cp.async, which the
// caller waits for (mma_sm90::cp_async_wait_all) before a __syncthreads;
// otherwise element by element.
template <typename T>
__device__ __forceinline__ void stage_slab(const T* __restrict__ src, T* dst, int S, int D,
                                           int64_t row, bool async16) {
  if (async16) {
    const int per = D * (int)sizeof(T) / 16;  // 16-byte chunks per token
    for (int i = threadIdx.x; i < S * per; i += blockDim.x) {
      const int t = i / per;
      mma_sm90::cp_async16(reinterpret_cast<char*>(dst) + (int64_t)i * 16,
                           reinterpret_cast<const char*>(src + (int64_t)t * row) + (i - t * per) * 16,
                           true);
    }
    mma_sm90::cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
      const int t = i / D;
      dst[i] = src[(int64_t)t * row + (i - t * D)];
    }
  }
}

// The slab routes' launch: let `kernel` take `smem` bytes of dynamic shared
// memory on the current device. 0, -7 when smem exceeds the device's opt-in
// limit per block, or a cudaError_t. The attribute is set once per device
// and size (`granted`, the kernel's own array): a later call, one captured
// into a CUDA graph too, makes no attribute call.
constexpr int kMaxDevices = 64;

template <typename K>
inline int grant_smem(K kernel, size_t smem, size_t* granted) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return -7;
  if (dev >= kMaxDevices) return -8;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  return 0;
}

}  // namespace deform_point
