// The per-point body of the gather-route deformable-attention kernels
// (sm_90a): the level table, a sampling point's pixel coordinates, its
// footprint test, its four bilinear corners with their weights, and a
// point's d_attn / d_loc from its four corner dot products; the slab
// routes' staging and shared-memory grant; and the d_loc / d_attn walk of
// one (b, h) pair, a lane per sampling point (dloc_walk). A header:
// ms_deform_attn_fwd.cu (kernel 1, direct and slab routes),
// ms_deform_attn_bwd.cu (the d_value scatter, the d_loc/d_attn gather on
// its direct and slab routes, the merged adjoint on its atomic and slab
// routes), ms_deform_attn_dense.cu (the dense adjoint's d_loc / d_attn
// blocks walk with dloc_walk under their own corner rule) and
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

// dst[0:VEC] = float(p[0:VEC]); one vector load where VEC allows
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
struct Load<float, 8> {
  static __device__ __forceinline__ void f32(const float* p, float* dst) {
    Load<float, 4>::f32(p, dst);
    Load<float, 4>::f32(p + 4, dst + 4);
  }
};

// eight bf16 channels: one 16-byte load
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

// A sampling point's 2x2 footprint on its level.
struct Footprint {
  int t00;                          // token of corner (y0, x0) in the level: y0 * W + x0
  int y0;                           // the footprint's top row, in [-1, H - 1]
  float tx, ty;                     // the point's fractions within the cell
  bool in_x0, in_x1, in_y0, in_y1;  // columns x0, x0 + 1 and rows y0, y0 + 1 in the map
};

// NaN for the C1 rule's output rows and gradients.
__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// A point's pixel coordinate, loc * size - 0.5, rounded twice (__fmul_rn,
// __fsub_rn) as the plain versions and JAX compute it: nvcc would otherwise
// contract it into one FMA, and a point within an ulp of a cell edge would
// floor into the neighbouring cell (C8).
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, (float)size), 0.5f);
}

// The footprint of the point at normalized (lx, ly) on an Hl x Wl level.
// False when it misses the map entirely (also for a NaN or infinite
// coordinate); otherwise f is filled and x0, y0 lie in [-1, size - 1].
__device__ __forceinline__ bool footprint(float lx, float ly, int Hl, int Wl, Footprint* f) {
  const float x = pixel_coord(lx, Wl);
  const float y = pixel_coord(ly, Hl);
  if (!(x > -1.f && x < (float)Wl && y > -1.f && y < (float)Hl)) return false;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  f->tx = x - x0f;
  f->ty = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  f->t00 = y0 * Wl + x0;
  f->y0 = y0;
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
  return !(isfinite(pixel_coord(lx, Wl)) && isfinite(pixel_coord(ly, Hl)));
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

// ------------------------------------------------------ d_loc, d_attn walk
// The gather kernels' rule for a point's d_loc / d_attn: its footprint (1 in
// the map, 0 off it, -1 for a non-finite coordinate: the C1 rule) and
// point_grads. The dense one-hot adjoint (ms_deform_attn_dense.cu) walks with
// a rule of its own, the TPU one-hot kernel's corner terms and formula: each
// adjoint is held against its own JAX kernel.
struct GatherRule {
  static __device__ __forceinline__ int footprint(float lx, float ly, int Hl, int Wl,
                                                  Footprint* f) {
    if (deform_point::footprint(lx, ly, Hl, Wl, f)) return 1;
    return nonfinite(lx, ly, Hl, Wl) ? -1 : 0;
  }
  static __device__ __forceinline__ void grads(const Footprint& f, float a, int Hl, int Wl,
                                               const float* e, float* d_attn, float* dx,
                                               float* dy) {
    point_grads(f, a, Hl, Wl, e, d_attn, dx, dy);
  }
};

// One sampling point's d_attn and d_loc on one lane, by Rule: e_c = dout . v_c
// over all D channels at each in-map corner c (0 elsewhere), VEC channels a
// load (16 bytes where VEC fills them), each corner's chunks summed from
// `rot` on, then Rule::grads; 0 off the map, NaN for a non-finite
// coordinate. CH: D / VEC where the kernel was built for it (2: bf16, 4:
// f32 at D = 16), the dout row then held in registers and each corner's
// chunk loads independent of one another; 0: `chunks` at run time, a chunk
// at a time. Both sum in the same order. v: the level's token 0, tokens
// `vstride` elements apart (a staged slab: D; device memory: H D). d_loc:
// the point's (x, y), 8-byte aligned.
template <typename Rule, typename T, int VEC, int CH>
__device__ __forceinline__ void dloc_point(const T* v, int64_t vstride, const T* do_p, float lx,
                                           float ly, float a, int Hl, int Wl, int chunks,
                                           int rot, float* d_attn, float* d_loc) {
  Footprint f;
  const int kind = Rule::footprint(lx, ly, Hl, Wl, &f);
  if (kind != 1) {
    const float g = kind < 0 ? nan_f32() : 0.f;
    *d_attn = g;
    *reinterpret_cast<float2*>(d_loc) = make_float2(g, g);
    return;
  }
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (CH > 0) {
    float g[CH][VEC];
#pragma unroll
    for (int i = 0; i < CH; ++i) Load<T, VEC>::f32(do_p + (i + rot) % CH * VEC, g[i]);
    for_each_corner(f, Wl, 1.f, [&](int cc, int t, float) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        float vv[VEC];
        Load<T, VEC>::f32(v + (int64_t)t * vstride + (i + rot) % CH * VEC, vv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[cc] += g[i][j] * vv[j];
      }
    });
  } else {
    for (int i = 0; i < chunks; ++i) {
      const int c = i + rot < chunks ? i + rot : i + rot - chunks;
      float g[VEC];
      Load<T, VEC>::f32(do_p + c * VEC, g);
      for_each_corner(f, Wl, 1.f, [&](int cc, int t, float) {
        float vv[VEC];
        Load<T, VEC>::f32(v + (int64_t)t * vstride + c * VEC, vv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[cc] += g[j] * vv[j];
      });
    }
  }
  float dx, dy;
  Rule::grads(f, a, Hl, Wl, e, d_attn, &dx, &dy);
  *reinterpret_cast<float2*>(d_loc) = make_float2(dx, dy);
}

// The walk's chunks per point built in for D = 16 (the paper config's head
// width: 2 bf16 or 4 f32 16-byte chunks); other D count them at run time.
template <int VEC>
constexpr int kChunks16 = VEC > 1 ? 16 / VEC : 0;

// d_loc / d_attn of the points of one (b, h) pair, a lane per point: the
// block's threads take items it = q L P + k (k = l P + p) from first +
// threadIdx.x to last, blockDim.x apart, so a warp's 32 lanes hold 32
// consecutive points (two queries at L P = 16): their loc, attn, d_loc and
// d_attn are contiguous runs, their query's dout row one broadcast load a
// chunk, and no lane waits on another (no shuffle). v: the pair's token 0
// (tokens vstride apart, as dloc_point). Lane i starts at channel chunk
// i % chunks: a 16-byte shared load serves a quarter warp at a time, and
// D = 16 bf16 tokens (32 bytes, 8 banks) would otherwise put the quarter's
// eight lanes on four bank groups of the 32 banks; staggered, on eight.
template <typename Rule, typename T, int VEC, int CH>
__device__ __forceinline__ void dloc_walk(const T* v, int64_t vstride,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ attn,
                                          const T* __restrict__ dout, float* __restrict__ dloc,
                                          float* __restrict__ dattn, int64_t b, int h, int Q,
                                          int H, int D, int L, int P, const Levels& lv, int first,
                                          int last) {
  const int LP = L * P, chunks = D / VEC;
  const int rot = (int)(threadIdx.x & 31) % chunks;
  for (int it = first + (int)threadIdx.x; it < last; it += blockDim.x) {
    const int q = it / LP;
    const int k = it - q * LP;
    const int l = k / P;
    const int64_t bqh = (b * Q + q) * H + h;
    const int64_t o = bqh * LP + k;  // the point (b, q, h, k)
    dloc_point<Rule, T, VEC, CH>(v + (int64_t)lv.start[l] * vstride, vstride, dout + bqh * D,
                             loc[2 * o], loc[2 * o + 1], attn[o], lv.h[l], lv.w[l], chunks, rot,
                             dattn + o, dloc + 2 * o);
  }
}

// The slab routes' d_loc / d_attn block: stage the (b, h) pair's (S, D)
// value slab into `smem` (stage_slab, 16-byte cp.async where async16), then
// walk all of the pair's points from it.
template <typename Rule, typename T, int VEC, int CH>
__device__ __forceinline__ void dloc_slab_pair(const T* __restrict__ value,
                                               const float* __restrict__ loc,
                                               const float* __restrict__ attn,
                                               const T* __restrict__ dout,
                                               float* __restrict__ dloc, float* __restrict__ dattn,
                                               int64_t b, int h, int S, int Q, int H, int D,
                                               int L, int P, const Levels& lv, bool async16,
                                               unsigned char* smem) {
  T* slab = reinterpret_cast<T*>(smem);
  const int64_t row = (int64_t)H * D;
  stage_slab<T>(value + b * S * row + (int64_t)h * D, slab, S, D, row, async16);
  if (async16) mma_sm90::cp_async_wait_all();
  __syncthreads();
  dloc_walk<Rule, T, VEC, CH>(slab, D, loc, attn, dout, dloc, dattn, b, h, Q, H, D, L, P, lv, 0,
                              Q * L * P);
}

// The d_loc / d_attn block `blk` of a grid that cuts each (b, h) pair's
// n = Q L P points into runs of `span` (blk = (b H + h) * runs + run): its
// pair and its points [first, last).
struct DlocBlock {
  int64_t b;
  int h, first, last;
};

__device__ __forceinline__ DlocBlock dloc_block_of(int blk, int span, int n, int H) {
  const int runs = (n + span - 1) / span;
  const int bh = blk / runs;
  DlocBlock d;
  d.b = bh / H;
  d.h = bh - (int)d.b * H;
  d.first = (blk - bh * runs) * span;
  d.last = d.first + span < n ? d.first + span : n;
  return d;
}

// The gather's two kernels under Rule, each its own launch: the pair's
// (GatherRule, ms_deform_attn_bwd.cu) and the dense adjoint's staged d_loc /
// d_attn blocks (OneHotRule, ms_deform_attn_dense.cu).
constexpr int kDlocThreads = 256;      // DIRECT: points per block
constexpr int kDlocSlabThreads = 512;  // SLAB: threads per (b, h) block

// DIRECT route: a block per (b, h, kDlocThreads points), a lane per sampling
// point, the corners read from device memory (the L2). async16 is unused: the
// two routes' kernels share one signature.
template <typename Rule, typename T, int VEC, int CH>
__global__ void __launch_bounds__(kDlocThreads)
ms_deform_attn_dloc_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                           const float* __restrict__ attn, const T* __restrict__ dout,
                           float* __restrict__ dloc, float* __restrict__ dattn, int S, int Q,
                           int H, int D, int L, int P, const __grid_constant__ Levels lv,
                           bool async16) {
  const DlocBlock k = dloc_block_of(blockIdx.x, kDlocThreads, Q * L * P, H);
  const int64_t row = (int64_t)H * D;
  dloc_walk<Rule, T, VEC, CH>(value + k.b * S * row + (int64_t)k.h * D, row, loc, attn, dout,
                              dloc, dattn, k.b, k.h, Q, H, D, L, P, lv, k.first, k.last);
}

// SLAB route: one block per (b, h) (blockIdx.x = b * H + h) stages the pair's
// (S, D) value slab in shared memory, then its lanes walk the pair's Q x L x P
// sampling points, one point a lane. The block reads value once, loc / attn /
// dout and writes d_loc / d_attn in contiguous runs; its corner reads are
// 16-byte shared loads, whose bank conflicts (lanes on unrelated tokens) are
// what it pays instead of the L2's scattered sectors.
template <typename Rule, typename T, int VEC, int CH>
__global__ void __launch_bounds__(kDlocSlabThreads)
ms_deform_attn_dloc_slab_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ attn, const T* __restrict__ dout,
                                float* __restrict__ dloc, float* __restrict__ dattn, int S,
                                int Q, int H, int D, int L, int P,
                                const __grid_constant__ Levels lv, bool async16) {
  extern __shared__ __align__(16) unsigned char smem[];
  dloc_slab_pair<Rule, T, VEC, CH>(value, loc, attn, dout, dloc, dattn, blockIdx.x / H,
                                   (int)(blockIdx.x % H), S, Q, H, D, L, P, lv, async16, smem);
}

// One route's launch: the kernel built in for D = 16 or counting its chunks
// at run time; the slab route asks for S * D * sizeof(T) bytes of dynamic
// shared memory (grant_smem). 0, a negative code, or a cudaError_t.
template <typename Rule, bool SLAB, typename T, int VEC>
int launch_dloc(const void* value, const float* loc, const float* attn, const void* dout,
                float* dloc, float* dattn, int B, int S, int Q, int H, int D, int L, int P,
                const Levels& lv, cudaStream_t stream) {
  const int n = Q * L * P;
  const int64_t blocks = (int64_t)B * H * (SLAB ? 1 : (n + kDlocThreads - 1) / kDlocThreads);
  if (blocks == 0 || n == 0) return 0;
  const bool d16 = D == 16;
  auto kernel = SLAB ? (d16 ? ms_deform_attn_dloc_slab_kernel<Rule, T, VEC, kChunks16<VEC>>
                            : ms_deform_attn_dloc_slab_kernel<Rule, T, VEC, 0>)
                     : (d16 ? ms_deform_attn_dloc_kernel<Rule, T, VEC, kChunks16<VEC>>
                            : ms_deform_attn_dloc_kernel<Rule, T, VEC, 0>);
  const size_t smem = SLAB ? (size_t)S * D * sizeof(T) : 0;
  if (SLAB) {
    static size_t granted[2][kMaxDevices];  // per instantiation
    const int rc = grant_smem(kernel, smem, granted[d16]);
    if (rc != 0) return rc;
  }
  const bool async16 = (D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(value) % 16 == 0;
  kernel<<<(unsigned)blocks, SLAB ? kDlocSlabThreads : kDlocThreads, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout), dloc, dattn, S, Q, H,
      D, L, P, lv, async16);
  return (int)cudaGetLastError();
}

// The C entries' body: d_loc (w.r.t. the normalized locations) and d_attn on
// one route under Rule, every element written. dtype: 0 = float32, 1 =
// bfloat16 (of value and dout); vec: 1 or the 16-byte width of the value (4
// f32, 8 bf16). 0, a negative code for arguments the kernels do not take
// (-7: a slab over the device's opt-in limit per block), or a cudaError_t.
template <typename Rule, bool SLAB>
int dloc_entry(const void* value, const void* loc, const void* attn, const void* dout,
               void* dloc, void* dattn, int dtype, int B, int S, int Q, int H, int D, int L,
               int P, const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D < 1 || vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POET_DLOC(T, V) \
  return launch_dloc<Rule, SLAB, T, V>(value, locf, attf, dout, dl, da, B, S, Q, H, D, L, P, lv, s)
  if (dtype == 0 && vec == 4) POET_DLOC(float, 4);
  if (dtype == 0 && vec == 1) POET_DLOC(float, 1);
  if (dtype == 1 && vec == 8) POET_DLOC(__nv_bfloat16, 8);
  if (dtype == 1 && vec == 1) POET_DLOC(__nv_bfloat16, 1);
#undef POET_DLOC
  return -5;
}

}  // namespace deform_point
