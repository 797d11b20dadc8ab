// Multi-scale deformable attention, adjoint — CUDA for Hopper (sm_90a).
//
// Seven kernels, replacing the TPU's two adjoints in
// poet_tpu/ops/deform_attn_pallas_v3.py:
//   * ms_deform_attn_dvalue_kernel (the ATOMIC scatter) and
//     ms_deform_attn_dvalue_slab_kernel (the SLAB route, for few corner adds
//     per token: the decoder) replace _bwd_dval_kernel (d_value), and
//   * ms_deform_attn_dloc_slab_kernel (the SLAB route, for many corner reads
//     per token: the encoder) and ms_deform_attn_dloc_kernel (the DIRECT
//     route: the decoder), both in ms_deform_attn_point.cuh under its
//     GatherRule, replace _bwd_dloc_kernel (d_loc, d_attn),
//     the two-kernel adjoint _bwd_twokernel_core;
//   * ms_deform_attn_merged_slab_kernel (the SLAB route),
//     ms_deform_attn_merged_banded_kernel (the BANDED route, for slabs over
//     the shared-memory budget: the YOLO pyramid in bf16) and
//   * ms_deform_attn_merged_kernel (the ATOMIC route) replace _bwd_kernel,
//     the merged adjoint _v3_bwd_impl_merged (all three gradients in one
//     pass).
// Like the forward (ms_deform_attn_fwd.cu) they hold the contract of
// poet_tpu/ops/deform_attn.py:ms_deform_attn_xla and its gradient, not the
// TPU layouts (transposed locT/attnT, 128-query padding, one-hot mixes):
//
//   value  (B, S, H, D)        f32 or bf16
//   loc    (B, Q, H, L, P, 2)  f32, normalized, (x, y)
//   attn   (B, Q, H, L, P)     f32
//   dout   (B, Q, H * D)       value dtype, read and converted to f32
//   d_value (B, S, H, D)       f32 from the scatter and the atomic route
//                              (the caller zeroes it and casts it to the
//                              value dtype); the value dtype from the slab
//                              and banded routes, which write every row
//   d_loc  (B, Q, H, L, P, 2)  f32, w.r.t. the NORMALIZED locations
//   d_attn (B, Q, H, L, P)     f32
//
// Sampling is the forward's (csrc/ms_deform_attn_point.cuh): pixel = loc *
// size - 0.5, bilinear, zero padding. A point whose 2x2 footprint misses the
// map (or sits at the dummy -1 / -10 conventions) adds nothing to d_value and
// gets exactly 0 in d_loc and d_attn; a point with a NaN or infinite
// coordinate adds nothing to d_value and gets NaN in d_attn and in both d_loc
// coordinates (the header's C1 rule). floor() has zero derivative, as under
// autodiff. Trailing tokens past the levels get 0.
//
// d_value is a scatter. The scatter kernel and the atomic route add each
// corner's contribution into an f32 buffer in device memory with Hopper's
// 16-byte vector atomicAdd (float4; scalar where D % 4 != 0). At the flagship
// encoder shape (B=16, Q=S=1600, H=16, D=16, L=P=4) that is 6.55 M points x
// 4 corners x 4 slices = 105 M vector atomics per call into a 26 MB buffer
// resolved in the 50 MB L2: the bound is atomic throughput, not bytes.
//
// The SLAB route does what the TPU kernel does with its VMEM scratch. The
// TPU kernel's grid is (B, H // Hg, n_qt) and carries d_value of its (b,
// head group) in an f32 accumulator across the sequential query axis,
// writing it once. Here one block owns one (b, h) and walks all Q queries of
// the pair in a loop (the sequential axis): d_value[b, :, h, :] lives in
// shared memory as an f32 (S, D) slab (102 400 B at S = 1600, D = 16), is
// zeroed by the block, filled with red.shared.add.f32 (no global atomic),
// and written once to device memory in the value dtype with 16-byte stores:
// an f32 sum rounded once, as before, with no zeroed f32 buffer and no cast
// around the kernel. Where each staged token is read often enough (the
// encoder: 4 L P Q / S = 64 corner reads per token), the value slab of the
// pair is staged into shared memory too, by 16-byte cp.async issued before
// the accumulator is zeroed (51 200 B bf16 / 102 400 B f32: 153 600 B or
// 204 800 B in all, under the 232 448 B a block may opt into; one block per
// SM, 256 blocks in two waves at the flagship shape); at decoder size (Q =
// 10) value is read from the L2 directly. The route and the staging are the
// wrapper's rule (ops/deform_attn_cuda.py:plan_merged), from the budget.
//
// d_loc / d_attn is a gather, with the forward's four corner loads: per
// point the dot products e_c = sum_d dout_d * v_c,d at its corners, then
//   d_attn = w00 e00 + w01 e01 + w10 e10 + w11 e11
//   d_x    = a * W_l * [(1-ty)(e01 - e00) + ty (e11 - e10)]
//   d_y    = a * H_l * [(1-tx)(e10 - e00) + tx (e11 - e01)]
// (corner cy,cx: 00 = (y0,x0), 01 = (y0,x0+1), 10 = (y0+1,x0), 11 = both+1;
// a corner outside the map counts as value 0). It moves 183.5 MB at the
// flagship encoder (value, loc, attn, dout in; d_loc, d_attn out: 0.055 ms
// at 3.35 TB/s) and does 0.84 GFLOP: bytes bind it. Two routes, the
// wrapper's rule (ops/deform_attn_cuda.py:plan_dloc):
//   * SLAB (the encoder, 64 reads per token): a block per (b, h) stages the
//     pair's value slab in shared memory once (51 200 B bf16 / 102 400 B
//     f32 at S = 1600, D = 16), then a lane per sampling point
//     (deform_point::dloc_walk): each lane gathers its point's corners from
//     the slab with 16-byte shared loads over all D channels, so a query's
//     16 points read and write contiguous loc / attn / d_loc / d_attn runs
//     and nothing waits on a shuffle.
//   * DIRECT (the decoder, 0.4 reads per token; the YOLO pyramid in f32,
//     whose slab does not fit): the same walk, the corners read from the
//     L2, a block per (b, h, 256 points): every point of a query in flight
//     at once, where G lanes per (b, q, h) reducing channel slices with
//     shuffles walked them one after another (on an H100 at the decoder
//     0.0034 ms against 0.0217 for that mapping; at the encoder 0.2052
//     against 0.3953, where the slab route takes 0.1304).
//
// The merged kernels (both routes) do both in one pass over the sampling
// points, G lanes per (b, q, h) on channel slices whose partial e_c warp
// shuffles reduce (a point's d_value adds need its channels spread over
// lanes): per point the coordinates,
// the corners and the bilinear weights once, the in-map value corners
// gathered once for e_c, and corner_weight * a * dout added into d_value.
// The slab and banded routes read the same value bits in the same order, so
// their d_loc and d_attn are equal bit for bit; d_value's sum is unordered on
// every route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_point.cuh"

namespace {

using deform_point::Footprint;
using deform_point::Levels;
using deform_point::Load;

constexpr int kMergedSlabThreads = 1024;

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

// g[0:VEC] rotated left by rot (0 <= rot < VEC, VEC a power of two):
// gr[j] = g[(j + rot) % VEC], by a barrel of selects (no indexed registers)
template <int VEC>
__device__ __forceinline__ void rotate(const float* g, int rot, float* gr) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) gr[j] = g[j];
#pragma unroll
  for (int s = 1; s < VEC; s <<= 1) {
    const bool on = (rot & s) != 0;
    float t[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) t[j] = on ? gr[(j + s) & (VEC - 1)] : gr[j];
#pragma unroll
    for (int j = 0; j < VEC; ++j) gr[j] = t[j];
  }
}

// the mask of the G-lane group (G a power of two <= 32) that holds `lane`
__device__ __forceinline__ unsigned group_mask_of(int lane, int G) {
  return (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane & ~(G - 1));
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
                             int Q, int H, int D, int L, int P, const __grid_constant__ Levels lv,
                             int64_t n_items) {
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
        Footprint f;
        if (!deform_point::footprint(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl, &f)) continue;
        deform_point::for_each_corner(f, Wl, att_p[k], [&](int, int t, float w) {
          scatter<VEC>(dv_l + (int64_t)t * row, w, g);
        });
      }
    }
  }
}

// ---------------------------------------------------------- d_loc, d_attn
// Both routes are deform_point's ms_deform_attn_dloc_kernel (DIRECT) and
// ms_deform_attn_dloc_slab_kernel (SLAB) under deform_point::GatherRule,
// launched by deform_point::dloc_entry.

// ------------------------------------------------ merged: all three at once
// One sampling point k = l * P + p of one (b, q, h) (loc_p, att_p, dloc_p,
// dattn_p at the query's first point), lane r of its G-lane group (VEC
// channels per slice). Per slice the lane loads
// dout and the in-map value corners once (v: token 0's channels, tokens
// `vstride` elements apart), adds dout . v_c into e_c and hands
// corner_weight * a * dout, its channels rotated left by `rot` (see
// slab_add), to add(token, channel offset, weight, rotated dout); the
// group's first lane writes d_attn and d_loc (exactly 0 for a point off the
// map, NaN for a non-finite coordinate).
template <typename T, int VEC, typename Add>
__device__ __forceinline__ void merged_point(const T* v, int64_t vstride, const T* do_p,
                                             const float* loc_p, const float* att_p,
                                             float* dloc_p, float* dattn_p, int k, int Hl,
                                             int Wl, int lvl, int chunks, int r, int G,
                                             unsigned group_mask, int rot, Add&& add) {
  Footprint f;
  if (!deform_point::footprint(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl, &f)) {
    if (r == 0)
      deform_point::miss_grads(deform_point::nonfinite(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl),
                               dattn_p + k, dloc_p + 2 * k, dloc_p + 2 * k + 1);
    return;
  }
  const float a = att_p[k];
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = r; c < chunks; c += G) {
    const int off = c * VEC;
    float g[VEC], gr[VEC];
    Load<T, VEC>::f32(do_p + off, g);
    rotate<VEC>(g, rot, gr);
    deform_point::for_each_corner(f, Wl, a, [&](int cc, int t, float w) {
      const int64_t tok = lvl + t;
      float vv[VEC];
      Load<T, VEC>::f32(v + tok * vstride + off, vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[cc] += g[j] * vv[j];
      add(tok, off, w, gr);
    });
  }
  for (int s = G >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) e[cc] += __shfl_xor_sync(group_mask, e[cc], s);
  }
  if (r == 0) deform_point::point_grads(f, a, Hl, Wl, e, dattn_p + k, dloc_p + 2 * k,
                                        dloc_p + 2 * k + 1);
}

// ATOMIC route: G lanes per (b, q, h) over the whole grid, d_value added
// into the caller's zeroed f32 buffer with float4 atomics (the scatter's).
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_merged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                             const float* __restrict__ attn, const T* __restrict__ dout,
                             float* __restrict__ dvalue, float* __restrict__ dloc,
                             float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                             int P, int G, const __grid_constant__ Levels lv, int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;
  const unsigned group_mask = group_mask_of(threadIdx.x & 31, G);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(i % G);
    const int64_t bqh = i / G;
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    const T* v_bh = value + b * S * row + (int64_t)h * D;
    float* dv_bh = dvalue + b * S * row + (int64_t)h * D;
    for (int l = 0; l < L; ++l) {
      for (int p = 0; p < P; ++p) {
        merged_point<T, VEC>(v_bh, row, dout + bqh * D, loc + bqh * L * P * 2,
                             attn + bqh * L * P, dloc + bqh * L * P * 2, dattn + bqh * L * P,
                             l * P + p, lv.h[l], lv.w[l], lv.start[l], chunks, r, G, group_mask,
                             0, [&](int64_t tok, int off, float w, const float* g) {
                               scatter<VEC>(dv_bh + tok * row + off, w, g);
                             });
      }
    }
  }
}

// The slab route's d_value add: p[0:VEC] += w * g[0:VEC] into the f32 slab
// in shared memory, one f32 atomicAdd per channel (sm_90 has no shared f32
// add instruction: each compiles to a compare-and-swap loop). gr is dout
// rotated left by `rot`, and channel (j + rot) % VEC is added at step j: a
// warp's lanes at step j then hit different channels, and banks. Without
// the rotation the G-lane groups of a warp all add channel j of their
// tokens at once, and a D=16 f32 token spans 16 of the 32 banks, so the 32
// lanes meet on 2 G of them (at G = 2, 8 or more lanes to the busiest
// bank); with rot = the group's index in the warp mod VEC, two lanes at
// most share a bank (tests/test_torch_deform_attn_slab.py).
template <int VEC>
__device__ __forceinline__ void slab_add(float* p, float w, const float* gr, int rot) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) atomicAdd(p + ((j + rot) & (VEC - 1)), w * gr[j]);
}

// The slab routes' write-out: the f32 slab acc (`tokens` rows of D, packed)
// to `tokens` rows of d_value `row` elements apart, once, in T; 16 bytes (E
// values) per store where `store16` (D * sizeof(T) a multiple of 16 and dst
// 16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_slab(const float* acc, T* __restrict__ dst, int tokens,
                                           int D, int64_t row, bool store16) {
  if (store16) {
    constexpr int E = 16 / sizeof(T);
    const int per = D / E;
    for (int i = threadIdx.x; i < tokens * per; i += blockDim.x) {
      const int t = i / per;
      const float* a = acc + (int64_t)i * E;
      __align__(16) T vals[E];
#pragma unroll
      for (int j = 0; j < E; ++j) vals[j] = deform_point::from_float<T>(a[j]);
      *reinterpret_cast<uint4*>(dst + (int64_t)t * row + (i - t * per) * E) =
          *reinterpret_cast<const uint4*>(vals);
    }
  } else {
    for (int i = threadIdx.x; i < tokens * D; i += blockDim.x) {
      const int t = i / D;
      dst[(int64_t)t * row + (i - t * D)] = deform_point::from_float<T>(acc[i]);
    }
  }
}

// SLAB route: one block per (b, h) (blockIdx.x = b * H + h), its G-lane
// groups walking the pair's Q x L x P sampling points, point after point of
// one query, then the next query (a point per group at a time: at decoder
// size, Q = 10, the 160 points keep 320 lanes busy, where a group per query
// walked its 16 points one after another). VEC = 8 channels per lane where
// D allows (G = 2 at D = 16: half the lanes per point, so half the
// coordinate math and shuffles, of VEC = 4).
// Shared memory: the f32 d_value slab (S * D floats), then, with STAGE, the
// value slab (S * D values) at the next 16-byte boundary.
template <typename T, int VEC, bool STAGE>
__global__ void __launch_bounds__(kMergedSlabThreads)
ms_deform_attn_merged_slab_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                  const float* __restrict__ attn, const T* __restrict__ dout,
                                  T* __restrict__ dvalue, float* __restrict__ dloc,
                                  float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                                  int P, int G, const __grid_constant__ Levels lv, bool async16,
                                  bool store16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int h = (int)(blockIdx.x % H);
  const int64_t b = blockIdx.x / H;
  const int64_t row = (int64_t)H * D;
  const T* v_bh = value + b * S * row + (int64_t)h * D;
  const int n = S * D;
  T* slab = reinterpret_cast<T*>(smem + (((size_t)n * sizeof(float) + 15) & ~(size_t)15));
  if (STAGE) deform_point::stage_slab<T>(v_bh, slab, S, D, row, async16);  // lands while
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)                   // acc is zeroed
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n / 4) * 4 + threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
  if (STAGE && async16) mma_sm90::cp_async_wait_all();
  __syncthreads();

  const int chunks = D / VEC;
  const int r = threadIdx.x % G;
  const unsigned group_mask = group_mask_of(threadIdx.x & 31, G);
  const int rot = ((threadIdx.x & 31) / G) & (VEC - 1);
  const int LP = L * P;
  for (int it = threadIdx.x / G; it < Q * LP; it += blockDim.x / G) {
    const int q = it / LP;
    const int k = it - q * LP;
    const int l = k / P;
    const int64_t bqh = (b * Q + q) * H + h;
    merged_point<T, VEC>(STAGE ? slab : v_bh, STAGE ? (int64_t)D : row, dout + bqh * D,
                         loc + bqh * LP * 2, attn + bqh * LP, dloc + bqh * LP * 2,
                         dattn + bqh * LP, k, lv.h[l], lv.w[l], lv.start[l], chunks, r, G,
                         group_mask, rot, [&](int64_t tok, int off, float w, const float* gr) {
                           slab_add<VEC>(acc + tok * D + off, w, gr, rot);
                         });
  }
  __syncthreads();

  // d_value[b, :, h, :] once, in T: every row, the trailing pad tokens' 0 too
  store_slab<T>(acc, dvalue + b * S * row + (int64_t)h * D, S, D, row, store16);
}

// SLAB route of d_value: one block per (b, h, channel group), blockIdx.x =
// (b * H + h) * groups + gi, the group's DG channels gi DG .. gi DG + DG - 1.
// Its f32 d_value slab (S, DG) lives in shared memory (102 400 B at S =
// 1600, DG = 16: two blocks per SM), zeroed by the block; its G-lane groups
// (G = DG / VEC rounded up to a power of two) walk the pair's Q x L x P
// sampling points, a point per group at a time, and add corner_weight * a *
// dout into the slab with slab_add's rotated channel order (a corner of
// weight exactly 0 adds nothing and is skipped: each add is a compare-and-
// swap loop); then the block writes every row of its (b, h, group) once in
// the value dtype, 16 bytes a store where DG allows: no zeroed buffer, no
// cast. d_value needs no value slab and no cross-channel reduction, so the
// channels split freely. What bounds it is the shared adds' compare-and-swap
// loops: where each token takes many corner adds (the encoder, 64) the
// scatter's L2 atomics, which neighbouring queries' shared lines help,
// measured faster at a model's sampling locations, and the wrapper's rule
// (ops/deform_attn_cuda.py:plan_dvalue) keeps the slab for few adds per
// token (the decoder, 0.4), where the scatter's zeroed 26 MB buffer and
// cast cost more than its adds.
template <typename T, int VEC>
__global__ void __launch_bounds__(1024)
ms_deform_attn_dvalue_slab_kernel(const float* __restrict__ loc, const float* __restrict__ attn,
                                  const T* __restrict__ dout, T* __restrict__ dvalue, int S,
                                  int Q, int H, int D, int DG, int L, int P, int G,
                                  const __grid_constant__ Levels lv, bool store16) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int groups = D / DG;
  const int gi = (int)(blockIdx.x % groups);
  const int64_t bh = blockIdx.x / groups;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  const int n = S * DG;
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n / 4) * 4 + threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int chunks = DG / VEC;
  const int r = threadIdx.x % G;
  const int rot = ((threadIdx.x & 31) / G) & (VEC - 1);
  const int LP = L * P;
  for (int it = threadIdx.x / G; it < Q * LP; it += blockDim.x / G) {
    if (r >= chunks) continue;                   // the group's idle lanes (G > chunks)
    const int q = it / LP;
    const int k = it - q * LP;
    const int l = k / P;
    const int64_t bqh = (b * Q + q) * H + h;
    Footprint f;
    const int Wl = lv.w[l];
    if (!deform_point::footprint(loc[(bqh * LP + k) * 2], loc[(bqh * LP + k) * 2 + 1], lv.h[l],
                                 Wl, &f))
      continue;
    const float a = attn[bqh * LP + k];
    float* acc_l = acc + (int64_t)lv.start[l] * DG;
    for (int c = r; c < chunks; c += G) {
      const int off = c * VEC;
      float g[VEC], gr[VEC];
      Load<T, VEC>::f32(dout + bqh * D + gi * DG + off, g);
      rotate<VEC>(g, rot, gr);
      deform_point::for_each_corner(f, Wl, a, [&](int, int t, float w) {
        if (w != 0.f) slab_add<VEC>(acc_l + (int64_t)t * DG + off, w, gr, rot);
      });
    }
  }
  __syncthreads();

  // d_value[b, :, h, group] once, in T: every row, the trailing pad tokens' 0 too
  const int64_t row = (int64_t)H * D;
  T* dv = dvalue + b * S * row + (int64_t)h * D + gi * DG;
  if (store16) {  // DG * sizeof(T) a multiple of 16: 16 bytes (E values) per store
    constexpr int E = 16 / sizeof(T);
    const int per = DG / E;
    for (int i = threadIdx.x; i < S * per; i += blockDim.x) {
      const int t = i / per;
      const float* a = acc + (int64_t)i * E;
      __align__(16) T vals[E];
#pragma unroll
      for (int j = 0; j < E; ++j) vals[j] = deform_point::from_float<T>(a[j]);
      *reinterpret_cast<uint4*>(dv + (int64_t)t * row + (i - t * per) * E) =
          *reinterpret_cast<const uint4*>(vals);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int t = i / DG;
      dv[(int64_t)t * row + (i - t * DG)] = deform_point::from_float<T>(acc[i]);
    }
  }
}

// ------------------------------------------------ merged: the BANDED route
// For pyramids whose f32 (S, D) d_value slab exceeds the shared memory of a
// block (the YOLO pyramid: 6380 x 16 x 4 = 408 320 B): one block per (b, h),
// as the slab route, walks the pair's token rows in bands, one band after
// another. A band is whole rows of the concatenated levels (the host's plan,
// ops/deform_attn_cuda.py:plan_merged_bands); for each, the block zeroes an f32
// slab of the band's rows, walks the sampling points that reach the band, adds
// each in-map corner whose row lies in the band with slab_add, and writes the
// band's rows of d_value once, in the value dtype: no zeroed buffer in device
// memory, no cast, no global atomic. With STAGE the band's value rows are
// staged beside the slab, plus one halo row (the level's next row where the
// band ends inside a level), so every point whose home row the band holds
// finds both of its corner rows there.
//
// A point's d_loc / d_attn (its e_c over its four corners) are computed and
// written in exactly one band: the one holding its home row max(y0, 0) (a
// point whose top row is -1 belongs to the band of row 0); a point off the
// map, or with a non-finite coordinate, is written by the band that holds its
// level's row 0. A point whose two rows lie in two bands is walked in both,
// each adding the corners of its own rows. The e_c sums are the slab route's
// (merged_point's order), so the two routes give the same d_loc / d_attn bits.
//
// Which points a band walks: every point of the levels that start in it,
// then, for a level it continues, only the points an earlier band handed on
// (its carry list): a band that walks a point of a level going on past it,
// whose rows reach past it, appends the point to the list of the first later
// band holding one of those rows. Walking each band's levels whole instead
// cost the YOLO pyramid 4.04 ms against 3.19 (NVIDIA H100, PERF.md); sorting a
// level's points into a worklist first, so that a warp walks only points that
// reach the band, cost 3.24 (the sort's pass and the list's dependent reads
// outweigh the idle lanes it saves). What bounds the route is the shared
// adds, as on the slab route: slab_add's f32 atomicAdd (ATOMS.CAST.SPIN) ran
// several times faster than explicit 64- or 128-bit atomicCAS loops adding 2
// or 4 channels a swap, and an ordered walk (corners counted and ranked by
// token with integer atomics, each token summed by one owner in a fixed
// order) took 10.03 ms (PERF.md).
#define POET_MAX_BANDS 64

// Band i: the concatenated level tokens [start, end), whole rows of levels l0
// .. l1; value tokens [start, stage_end) staged (its rows and the halo row);
// slot: where it starts inside level l0, its carry list's index (else -1).
struct Bands {
  int n;
  int start[POET_MAX_BANDS];
  int end[POET_MAX_BANDS];
  int stage_end[POET_MAX_BANDS];
  int l0[POET_MAX_BANDS];
  int l1[POET_MAX_BANDS];
  int slot[POET_MAX_BANDS];
};

// The block's shared memory: a head of the carry lists' lengths (a count per
// band) and each level's rows in the current band ([r0, r1) per level), then
// the band's f32 slab, then (stage) its staged value rows at the next 16 bytes.
// The Python planner mirrors band_bytes.
constexpr size_t kBandHead = (POET_MAX_BANDS + 2 * POET_MAX_LEVELS) * sizeof(int);

__host__ __device__ __forceinline__ size_t band_slab_offset(int tokens, int D) {
  return kBandHead + (((size_t)tokens * D * sizeof(float) + 15) & ~(size_t)15);
}

__host__ __device__ __forceinline__ size_t band_bytes(int tokens, int staged, int D,
                                                      int value_size, bool stage) {
  return band_slab_offset(tokens, D) + (stage ? (size_t)staged * D * value_size : 0);
}

// One sampling point k of one (b, q, h) in the walk of band [t0, t1), lane r
// of its G-lane group (as merged_point): the level's rows in the band are
// [r0, r1). The point's e_c come from v (token tok at v + (tok - vfirst) *
// vstride) where the band holds its home row; each in-map corner whose row
// lies in the band goes to add(token - t0, channel offset, weight, rotated
// dout), once per channel slice. Where the level goes on past the band
// (`continues`) and the point has a row past it, lane 0 hands it on:
// carry(first token of the first such row).
template <typename T, int VEC, typename Add, typename Carry>
__device__ __forceinline__ void banded_point(const T* v, int64_t vstride, int vfirst, int t0,
                                             int r0, int r1, bool continues, const T* do_p,
                                             const float* loc_p, const float* att_p,
                                             float* dloc_p, float* dattn_p, int k, int Hl,
                                             int Wl, int lstart, int chunks, int r, int G,
                                             unsigned group_mask, int rot, Add&& add,
                                             Carry&& carry) {
  Footprint f;
  if (!deform_point::footprint(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl, &f)) {
    if (r == 0 && t0 <= lstart)   // the band that holds the level's row 0
      deform_point::miss_grads(deform_point::nonfinite(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl),
                               dattn_p + k, dloc_p + 2 * k, dloc_p + 2 * k + 1);
    return;
  }
  if (continues && r == 0) {
    const int after = f.y0 >= r1 ? f.y0 : (f.in_y1 && f.y0 + 1 >= r1 ? f.y0 + 1 : -1);
    if (after >= 0) carry(lstart + after * Wl);
  }
  const int home = max(f.y0, 0);
  const bool own = home >= r0 && home < r1;
  const bool top = f.in_y0 && f.y0 >= r0 && f.y0 < r1;
  const bool bottom = f.in_y1 && f.y0 + 1 >= r0 && f.y0 + 1 < r1;
  if (!(own || top || bottom)) return;
  const float a = att_p[k];
  float e[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = r; c < chunks; c += G) {
    const int off = c * VEC;
    float g[VEC], gr[VEC];
    Load<T, VEC>::f32(do_p + off, g);
    rotate<VEC>(g, rot, gr);
    deform_point::for_each_corner(f, Wl, a, [&](int cc, int t, float w) {
      const int tok = lstart + t;
      if (own) {
        float vv[VEC];
        Load<T, VEC>::f32(v + (int64_t)(tok - vfirst) * vstride + off, vv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[cc] += g[j] * vv[j];
      }
      if (cc < 2 ? top : bottom) add(tok - t0, off, w, gr);
    });
  }
  if (!own) return;
  for (int s = G >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) e[cc] += __shfl_xor_sync(group_mask, e[cc], s);
  }
  if (r == 0) deform_point::point_grads(f, a, Hl, Wl, e, dattn_p + k, dloc_p + 2 * k,
                                        dloc_p + 2 * k + 1);
}

// Each level's rows in band [t0, t1), [rows[2 l], rows[2 l + 1]) (empty for a
// level the band does not meet), into the block's head.
__device__ __forceinline__ void band_rows(int* rows, const Levels& lv, int L, int t0, int t1) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int n = lv.h[l] * lv.w[l];
    const int lo = min(max(t0 - lv.start[l], 0), n), hi = min(max(t1 - lv.start[l], 0), n);
    rows[2 * l] = lo / lv.w[l];
    rows[2 * l + 1] = hi / lv.w[l];
  }
}

// The rows past the levels (trailing pad tokens) of d_value[b, :, h, :]: 0.
template <typename T>
__device__ __forceinline__ void zero_pad_rows(T* dv_bh, int first, int S, int D, int64_t row) {
  for (int i = threadIdx.x; i < (S - first) * D; i += blockDim.x) {
    const int t = i / D;
    dv_bh[(int64_t)(first + t) * row + (i - t * D)] = deform_point::from_float<T>(0.f);
  }
}

// A band's start: stage its value rows (STAGE; cp.async lands while the slab
// is zeroed) and zero its f32 slab of n floats.
template <typename T, bool STAGE>
__device__ __forceinline__ void band_begin(const T* v_bh, T* slab, float* acc, int t0,
                                           int stage_end, int n, int D, int64_t row,
                                           bool async16) {
  if (STAGE) deform_point::stage_slab<T>(v_bh + (int64_t)t0 * row, slab, stage_end - t0, D, row,
                                         async16);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (n / 4) * 4 + threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
  if (STAGE && async16) mma_sm90::cp_async_wait_all();
}

// BANDED route: the slab route's walk (G-lane groups, a point per group at a
// time, slab_add's rotated channel order) band after band. A band walks
// afresh the points of the levels that start in it; the points of a level it
// continues come from its carry list: each band hands a point of a level that
// goes on past it to the first later band holding one of the point's rows
// (its lane 0 appends q L P + k to that band's list in `lists`, Q P entries a
// list, `slots` lists a block). So a point is walked in its level's first band
// and in the bands its rows lie in, and no band walks a whole level again.
template <typename T, int VEC, bool STAGE>
__global__ void __launch_bounds__(kMergedSlabThreads)
ms_deform_attn_merged_banded_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                    const float* __restrict__ attn, const T* __restrict__ dout,
                                    T* __restrict__ dvalue, float* __restrict__ dloc,
                                    float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                                    int P, int G, const __grid_constant__ Levels lv,
                                    const __grid_constant__ Bands bands, int* lists, int slots,
                                    bool async16, bool store16) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* list_n = reinterpret_cast<int*>(smem);
  int* rows = list_n + POET_MAX_BANDS;
  float* acc = reinterpret_cast<float*>(smem + kBandHead);
  const int h = (int)(blockIdx.x % H);
  const int64_t b = blockIdx.x / H;
  const int64_t row = (int64_t)H * D;
  const T* v_bh = value + b * S * row + (int64_t)h * D;
  T* dv_bh = dvalue + b * S * row + (int64_t)h * D;
  const int chunks = D / VEC;
  const int r = threadIdx.x % G;
  const unsigned group_mask = group_mask_of(threadIdx.x & 31, G);
  const int rot = ((threadIdx.x & 31) / G) & (VEC - 1);
  const int LP = L * P;
  const int64_t list_cap = (int64_t)Q * P;
  for (int i = threadIdx.x; i < bands.n; i += blockDim.x) list_n[i] = 0;
  zero_pad_rows<T>(dv_bh, bands.end[bands.n - 1], S, D, row);
  for (int bi = 0; bi < bands.n; ++bi) {
    const int t0 = bands.start[bi], t1 = bands.end[bi];
    T* slab = reinterpret_cast<T*>(smem + band_slab_offset(t1 - t0, D));
    band_begin<T, STAGE>(v_bh, slab, acc, t0, bands.stage_end[bi], (t1 - t0) * D, D, row,
                         async16);
    band_rows(rows, lv, L, t0, t1);
    __syncthreads();
    // the carried points of the level the band continues, then every point
    // of the levels that start in it, (q, k) in order
    const bool mid = bands.slot[bi] >= 0;
    const int carried = mid ? list_n[bi] : 0;
    const int* list = mid ? lists + ((int64_t)blockIdx.x * slots + bands.slot[bi]) * list_cap
                          : nullptr;
    const int lf = mid ? bands.l0[bi] + 1 : bands.l0[bi];
    const int nlp = (bands.l1[bi] - lf + 1) * P;
    const int items = carried + Q * nlp;
    for (int it = threadIdx.x / G; it < items; it += blockDim.x / G) {
      int q, k;
      if (it < carried) {
        q = list[it] / LP;
        k = list[it] - q * LP;
      } else {
        const int j = it - carried;
        q = j / nlp;
        k = lf * P + (j - q * nlp);
      }
      const int l = k / P;
      const int64_t bqh = (b * Q + q) * H + h;
      const int r0 = rows[2 * l], r1 = rows[2 * l + 1];
      banded_point<T, VEC>(STAGE ? slab : v_bh, STAGE ? (int64_t)D : row, STAGE ? t0 : 0, t0, r0,
                           r1, r1 < lv.h[l], dout + bqh * D, loc + bqh * LP * 2, attn + bqh * LP,
                           dloc + bqh * LP * 2, dattn + bqh * LP, k, lv.h[l], lv.w[l],
                           lv.start[l], chunks, r, G, group_mask, rot,
                           [&](int tok, int off, float w, const float* gr) {
                             slab_add<VEC>(acc + tok * D + off, w, gr, rot);
                           },
                           [&](int tok) {
                             int tb = bi + 1;
                             while (bands.end[tb] <= tok) ++tb;
                             const int pos = atomicAdd(list_n + tb, 1);
                             lists[((int64_t)blockIdx.x * slots + bands.slot[tb]) * list_cap +
                                   pos] = q * LP + k;
                           });
    }
    __syncthreads();
    store_slab<T>(acc, dv_bh + (int64_t)t0 * row, t1 - t0, D, row, store16);
    __syncthreads();
  }
}

int64_t grid_for(int64_t n_items, int threads) {
  int64_t blocks = (n_items + threads - 1) / threads;
  return blocks > ((int64_t)1 << 20) ? ((int64_t)1 << 20) : blocks;  // grid-stride beyond
}

// lanes per (b, q, h): the power of two >= D / VEC, at most 32
int group_lanes(int chunks) {
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  return G;
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
int launch_dvalue_slab(const float* loc, const float* attn, const void* dout, void* dvalue, int B,
                       int S, int Q, int H, int D, int DG, int L, int P, int threads,
                       const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (int64_t)B * H * (D / DG);
  if (blocks == 0) return 0;
  const size_t smem = (size_t)S * DG * sizeof(float);
  auto kernel = ms_deform_attn_dvalue_slab_kernel<T, VEC>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  const bool store16 = (DG * sizeof(T)) % 16 == 0 && (D * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dvalue) % 16 == 0;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      loc, attn, static_cast<const T*>(dout), static_cast<T*>(dvalue), S, Q, H, D, DG, L, P,
      group_lanes(DG / VEC), lv, store16);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
void launch_merged(const void* value, const float* loc, const float* attn, const void* dout,
                   float* dvalue, float* dloc, float* dattn, int B, int S, int Q, int H, int D,
                   int L, int P, const Levels& lv, cudaStream_t stream) {
  const int G = group_lanes(D / VEC);
  const int64_t n_items = (int64_t)B * Q * H * G;
  if (n_items == 0) return;
  ms_deform_attn_merged_kernel<T, VEC><<<(unsigned)grid_for(n_items, 256), 256, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout), dvalue, dloc,
      dattn, S, Q, H, D, L, P, G, lv, n_items);
}

// the slab route's shared memory: the f32 accumulator, then (stage) the
// value slab at the next 16-byte boundary
size_t merged_slab_bytes(int S, int D, size_t value_size, bool stage) {
  const size_t acc = ((size_t)S * D * sizeof(float) + 15) & ~(size_t)15;
  return stage ? acc + (size_t)S * D * value_size : (size_t)S * D * sizeof(float);
}

template <typename T, int VEC, bool STAGE>
int launch_merged_slab(const void* value, const float* loc, const float* attn, const void* dout,
                       void* dvalue, float* dloc, float* dattn, int B, int S, int Q, int H,
                       int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  if ((int64_t)B * H == 0) return 0;
  const size_t smem = merged_slab_bytes(S, D, sizeof(T), STAGE);
  auto kernel = ms_deform_attn_merged_slab_kernel<T, VEC, STAGE>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  const bool size16 = (D * sizeof(T)) % 16 == 0;
  const bool async16 = size16 && reinterpret_cast<uintptr_t>(value) % 16 == 0;
  const bool store16 = size16 && reinterpret_cast<uintptr_t>(dvalue) % 16 == 0;
  kernel<<<(unsigned)(B * H), kMergedSlabThreads, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout),
      static_cast<T*>(dvalue), dloc, dattn, S, Q, H, D, L, P, group_lanes(D / VEC), lv, async16,
      store16);
  return (int)cudaGetLastError();
}

// The banded route's bands from the host's token boundaries (bounds[0] = 0 <
// bounds[1] < ... < bounds[n] = the levels' tokens, each at the start of a row
// of a level), and the number of carry lists a block keeps (the bands that
// start inside a level): 0, or -9 for boundaries that are not.
int make_bands(const int* bounds, int n, const Levels& lv, int L, Bands* bd, int* slots) {
  if (n < 1 || n > POET_MAX_BANDS) return -9;
  const int s_lv = lv.start[L - 1] + lv.h[L - 1] * lv.w[L - 1];
  if (bounds[0] != 0 || bounds[n] != s_lv) return -9;
  bd->n = n;
  *slots = 0;
  for (int i = 0; i < n; ++i) {
    const int t0 = bounds[i], t1 = bounds[i + 1];
    if (t1 <= t0) return -9;
    int l0 = 0, l1 = 0;
    while (l0 + 1 < L && lv.start[l0 + 1] <= t0) ++l0;
    while (l1 + 1 < L && lv.start[l1 + 1] <= t1 - 1) ++l1;
    const int off0 = t0 - lv.start[l0], off1 = t1 - lv.start[l1];
    if (off0 % lv.w[l0] != 0 || off1 % lv.w[l1] != 0) return -9;
    bd->start[i] = t0;
    bd->end[i] = t1;
    bd->stage_end[i] = off1 < lv.h[l1] * lv.w[l1] ? t1 + lv.w[l1] : t1;  // the halo row
    bd->l0[i] = l0;
    bd->l1[i] = l1;
    bd->slot[i] = off0 > 0 ? (*slots)++ : -1;  // starts inside level l0: a carry list
  }
  return 0;
}

template <typename T, int VEC, bool STAGE>
int launch_merged_banded(const void* value, const float* loc, const float* attn,
                         const void* dout, void* dvalue, float* dloc, float* dattn, int B, int S,
                         int Q, int H, int D, int L, int P, const Levels& lv, const Bands& bd,
                         int* lists, int slots, cudaStream_t stream) {
  if ((int64_t)B * H == 0) return 0;
  size_t smem = 0;
  for (int i = 0; i < bd.n; ++i) {
    const size_t band = band_bytes(bd.end[i] - bd.start[i], bd.stage_end[i] - bd.start[i], D,
                                   sizeof(T), STAGE);
    smem = band > smem ? band : smem;
  }
  auto kernel = ms_deform_attn_merged_banded_kernel<T, VEC, STAGE>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  const bool size16 = (D * sizeof(T)) % 16 == 0;
  const bool async16 = size16 && reinterpret_cast<uintptr_t>(value) % 16 == 0;
  const bool store16 = size16 && reinterpret_cast<uintptr_t>(dvalue) % 16 == 0;
  kernel<<<(unsigned)(B * H), kMergedSlabThreads, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout),
      static_cast<T*>(dvalue), dloc, dattn, S, Q, H, D, L, P, group_lanes(D / VEC), lv, bd,
      lists, slots, async16, store16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16 (of value and dout)
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec: channels per thread, 1 or 4 for d_value and the merged kernels (a
//        16-byte f32 slice of the accumulator, for either dtype); 1 or the
//        16-byte width of the value (4 f32, 8 bf16) for d_loc

// d_value += adjoint of the sampling (d_value zeroed by the caller, f32).
int poet_ms_deform_attn_bwd_dvalue(const void* loc, const void* attn, const void* dout,
                                   void* dvalue, int dtype, int B, int S, int Q, int H, int D,
                                   int L, int P, const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
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

// d_value on its slab route: every row of d_value written in the value dtype
// (rows past the levels 0); `group` channels per block (D % group == 0),
// vec channels per lane (1, 4 or 8, group % vec == 0), `threads` per block
// (a multiple of 32, at most 1024). -7 when the (S, group) f32 slab exceeds
// the device's opt-in limit.
int poet_ms_deform_attn_bwd_dvalue_slab(const void* loc, const void* attn, const void* dout,
                                        void* dvalue, int dtype, int B, int S, int Q, int H,
                                        int D, int L, int P, const int* level_hw, int vec,
                                        int group, int threads, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (group < 1 || D % group != 0 || vec < 1 || group % vec != 0) return -2;
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return -3;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POET_DVALUE_SLAB(T, V)                                                                 \
  return launch_dvalue_slab<T, V>(locf, attf, dout, dvalue, B, S, Q, H, D, group, L, P, threads, \
                                  lv, s)
  if (dtype == 0 && vec == 8) {
    POET_DVALUE_SLAB(float, 8);
  } else if (dtype == 0 && vec == 4) {
    POET_DVALUE_SLAB(float, 4);
  } else if (dtype == 0 && vec == 1) {
    POET_DVALUE_SLAB(float, 1);
  } else if (dtype == 1 && vec == 8) {
    POET_DVALUE_SLAB(__nv_bfloat16, 8);
  } else if (dtype == 1 && vec == 4) {
    POET_DVALUE_SLAB(__nv_bfloat16, 4);
  } else if (dtype == 1 && vec == 1) {
    POET_DVALUE_SLAB(__nv_bfloat16, 1);
  }
#undef POET_DVALUE_SLAB
  return -5;
}

// d_loc (w.r.t. normalized locations) and d_attn, every element written,
// on the direct route (a block per (b, h, 256 points), the corners from
// device memory). vec: 1 or the 16-byte width of the value (4 f32, 8 bf16).
int poet_ms_deform_attn_bwd_dloc(const void* value, const void* loc, const void* attn,
                                 const void* dout, void* dloc, void* dattn, int dtype, int B,
                                 int S, int Q, int H, int D, int L, int P, const int* level_hw,
                                 int vec, void* stream) {
  return deform_point::dloc_entry<deform_point::GatherRule, false>(
      value, loc, attn, dout, dloc, dattn, dtype, B, S, Q, H, D, L, P, level_hw, vec, stream);
}

// The same on the slab route: a block per (b, h) on its value slab in shared
// memory (S * D * sizeof(value) bytes; -7 when that exceeds the device's
// opt-in limit per block), a lane per sampling point.
int poet_ms_deform_attn_bwd_dloc_slab(const void* value, const void* loc, const void* attn,
                                      const void* dout, void* dloc, void* dattn, int dtype,
                                      int B, int S, int Q, int H, int D, int L, int P,
                                      const int* level_hw, int vec, void* stream) {
  return deform_point::dloc_entry<deform_point::GatherRule, true>(
      value, loc, attn, dout, dloc, dattn, dtype, B, S, Q, H, D, L, P, level_hw, vec, stream);
}

// The merged adjoint's atomic route: d_value += (zeroed by the caller, f32),
// and every element of d_loc and d_attn written. vec: 1 or 4.
int poet_ms_deform_attn_bwd_merged(const void* value, const void* loc, const void* attn,
                                   const void* dout, void* dvalue, void* dloc, void* dattn,
                                   int dtype, int B, int S, int Q, int H, int D, int L, int P,
                                   const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
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

// The merged adjoint's slab route: every element of d_value (in the value
// dtype, rows past the levels 0), d_loc and d_attn written. vec: 1, 4 or 8;
// stage: 1 to stage the value slab in shared memory, 0 to read it from
// device memory. -7 when the slab exceeds the device's opt-in limit.
int poet_ms_deform_attn_bwd_merged_slab(const void* value, const void* loc, const void* attn,
                                        const void* dout, void* dvalue, void* dloc, void* dattn,
                                        int dtype, int B, int S, int Q, int H, int D, int L,
                                        int P, const int* level_hw, int vec, int stage,
                                        void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POET_MERGED_SLAB(T, V)                                                                \
  return stage ? launch_merged_slab<T, V, true>(value, locf, attf, dout, dvalue, dl, da, B, S, \
                                                Q, H, D, L, P, lv, s)                          \
               : launch_merged_slab<T, V, false>(value, locf, attf, dout, dvalue, dl, da, B,  \
                                                 S, Q, H, D, L, P, lv, s)
  if (dtype == 0 && vec == 8) {
    POET_MERGED_SLAB(float, 8);
  } else if (dtype == 0 && vec == 4) {
    POET_MERGED_SLAB(float, 4);
  } else if (dtype == 0 && vec == 1) {
    POET_MERGED_SLAB(float, 1);
  } else if (dtype == 1 && vec == 8) {
    POET_MERGED_SLAB(__nv_bfloat16, 8);
  } else if (dtype == 1 && vec == 4) {
    POET_MERGED_SLAB(__nv_bfloat16, 4);
  } else if (dtype == 1 && vec == 1) {
    POET_MERGED_SLAB(__nv_bfloat16, 1);
  }
#undef POET_MERGED_SLAB
  return -5;
}

// The merged adjoint's banded route: every element of d_value (in the value
// dtype, rows past the levels 0), d_loc and d_attn written. bounds: n_bands +
// 1 token boundaries (0, ..., the levels' tokens), each at the start of a row
// of a level (-9 otherwise); vec: 1, 4 or 8; stage: 1 to stage each band's
// value rows and halo row; lists: int32 scratch of list_len entries, at least
// B H Q P times the bands that start inside a level (the carry lists; -10
// otherwise). -7 when a band's shared memory exceeds the device's opt-in
// limit.
int poet_ms_deform_attn_bwd_merged_banded(const void* value, const void* loc, const void* attn,
                                          const void* dout, void* dvalue, void* dloc,
                                          void* dattn, int dtype, int B, int S, int Q, int H,
                                          int D, int L, int P, const int* level_hw, int vec,
                                          int stage, const int* bounds, int n_bands, void* lists,
                                          int64_t list_len, void* stream) {
  Levels lv;
  int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  Bands bd;
  int slots = 0;
  rc = make_bands(bounds, n_bands, lv, L, &bd, &slots);
  if (rc != 0) return rc;
  if (list_len < (int64_t)B * H * Q * P * slots) return -10;
  int* ls = static_cast<int*>(lists);
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POET_BANDED(T, V)                                                                  \
  return stage ? launch_merged_banded<T, V, true>(value, locf, attf, dout, dvalue, dl, da, B, S,  \
                                                  Q, H, D, L, P, lv, bd, ls, slots, s)          \
               : launch_merged_banded<T, V, false>(value, locf, attf, dout, dvalue, dl, da, B, \
                                                   S, Q, H, D, L, P, lv, bd, ls, slots, s)
  if (dtype == 0 && vec == 8) {
    POET_BANDED(float, 8);
  } else if (dtype == 0 && vec == 4) {
    POET_BANDED(float, 4);
  } else if (dtype == 0 && vec == 1) {
    POET_BANDED(float, 1);
  } else if (dtype == 1 && vec == 8) {
    POET_BANDED(__nv_bfloat16, 8);
  } else if (dtype == 1 && vec == 4) {
    POET_BANDED(__nv_bfloat16, 4);
  } else if (dtype == 1 && vec == 1) {
    POET_BANDED(__nv_bfloat16, 1);
  }
#undef POET_BANDED
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
