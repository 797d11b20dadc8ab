// Multi-scale deformable attention through a dense one-hot sampling matrix on
// the tensor cores — CUDA for Hopper (sm_90a).
//
// Two kernels, replacing the TPU kernels of poet_tpu/ops/deform_attn_pallas.py
// (the `enc_deform_impl` / `dec_deform_impl` = 'pallas' entry
// ms_deform_attn_pallas):
//   * ms_deform_attn_dense_fwd_kernel  replaces _fwd_kernel (_run_forward),
//   * ms_deform_attn_dense_bwd_kernel  replaces _bwd_kernel (_run_backward).
// They compute the contract of poet_tpu/ops/deform_attn.py:ms_deform_attn_xla
// and its gradient, the function the gather kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu) compute, with the TPU kernel's idea: per (b, h), a
// query tile and a level, the sampling is a matrix W (queries x the level's
// zero-bordered tokens, (Hl + 2) * (Wl + 2) rows) whose row q holds the 4 P
// bilinear x attention weights of query q at its corners, and
//
//   out_l = W @ Vpad_l          (forward)
//   dVpad_l = W^T @ dout        (the adjoint's d_value).
//
//   value  (B, S, H, D)        f32 or bf16, levels concatenated along S
//   loc    (B, Q, H, L, P, 2)  f32, normalized, (x, y)
//   attn   (B, Q, H, L, P)     f32
//   out    (B, Q, H * D)       value dtype, accumulated in f32
//   dout   (B, Q, H * D)       value dtype
//   d_value (B, S, H, D)       value dtype, summed in f32, every token row of
//                              the levels written (the caller zeroes rows past
//                              them)
//   d_loc  (B, Q, H, L, P, 2)  f32, w.r.t. the NORMALIZED locations
//   d_attn (B, Q, H, L, P)     f32
//
// Corner terms are the TPU kernel's (deform_attn_pallas.py:_corner_terms):
// pixel = loc * size - 0.5, x0 = (int)floor(x); the point takes part when x0
// and y0 lie in [-1, size], and its corners (y0 + {0, 1}, x0 + {0, 1}) then
// fall on real tokens or on the zero border. A point with a NaN or infinite
// coordinate follows the C1 rule of the gather kernels
// (csrc/ms_deform_attn_point.cuh) and of the plain version: it takes no part
// in any product (its corners are never built into W), its (b, q, h) output
// row is NaN, and its d_attn and both d_loc coordinates are NaN.
//
// What Hopper changes. A level's padded slab does not fit a block (5084 rows
// at the YOLO pyramid's (60, 80) level; the TPU kept it whole in VMEM), so the
// token axis is cut into chunks of KC = 64 padded rows. Per chunk the block
// builds the QT x KC one-hot tile in shared memory, stages the chunk's value
// (or, in the adjoint, its dout) rows as f32 with zeros for the border — no
// padded copy of the value exists in device memory — and multiplies on the
// tensor cores with mma.sync (the WMMA m16n16k8 TF32 shape). A chunk that no
// corner of the tile falls in is skipped, and so is a warp's row tile that
// none falls in.
//
// Precision. W's entries are f32 products; a TF32 (or bf16) tile would round
// them to 11 (8) bits. Each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), ~22 bits together: a bf16 value or dout is exact in TF32, so
// bf16 takes two products (W_hi V + W_lo V), f32 three (3xTF32: + W_hi V_lo).
// Against the plain f32 version that leaves ~2^-21 of each term. The tensor
// cores add each product into their accumulator with truncation at the
// accumulator's magnitude (measured: a d_value summed over all of a chunk's
// query tiles in one accumulator came out 2.6e-5 of its scale from the plain
// f32 version), so the small terms get an accumulator of their own and each
// tile's sums join the running total by f32 adds.
//
// Determinism. Each one-hot row is built by one thread in a fixed order of
// points and corners, and the adjoint's d_value sums over the query tiles in
// a loop inside the block (block = (b, h, token chunk)), in order, with no
// atomics: d_value is the same bits from run to run, as on the TPU's
// sequential grid. d_loc and d_attn need dout . v only at each point's four
// corners, so the adjoint's other blocks gather those (the TPU kernel formed
// the dense QT x S_pad product instead).
//
// What bounds them. The function's bytes (0.03 ms at the flagship encoder
// shape) against the dense product's operations: B H Q S_pad D 2 = 2.46e10
// flops there, 0.025 ms on the bf16 tensor cores, 3-4x that in the split
// products. The skipped chunks take most of it away; what remains is the
// one-hot construction (a pass over the tile's points per chunk) and the
// block barriers around each product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define POET_MAX_LEVELS 8

namespace {

using namespace nvcuda;

constexpr int QT = 64;        // queries per tile: 4 warps x 16 rows
constexpr int KC = 64;        // padded tokens per chunk
constexpr int DG = 64;        // channels per block; blocks cover D in groups
constexpr int THREADS = 128;
constexpr int W_LD = KC + 4;  // row stride (floats) of the one-hot tile

struct Levels {
  int h[POET_MAX_LEVELS];
  int w[POET_MAX_LEVELS];
  int start[POET_MAX_LEVELS];        // first token of the level in value
  int chunk0[POET_MAX_LEVELS + 1];   // first chunk of the level; [L] = all
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> struct IsF32 { static constexpr bool value = false; };
template <> struct IsF32<float> { static constexpr bool value = true; };

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

// One point's corner terms, as the TPU kernel forms them: HIT, MISS when x0
// or y0 lies outside [-1, size] (no corner then meets the zero-bordered
// level), NONFINITE for a NaN or infinite coordinate (C1).
struct Corners {
  int x0, y0;
  float tx, ty;
};

enum class Pt { MISS, HIT, NONFINITE };

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ Pt corner_terms(const float* loc2, int Hl, int Wl, Corners* c) {
  const float x = loc2[0] * (float)Wl - 0.5f;
  const float y = loc2[1] * (float)Hl - 0.5f;
  if (!(isfinite(x) && isfinite(y))) return Pt::NONFINITE;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  c->x0 = (int)x0f;  // saturates: far points fail the test below
  c->y0 = (int)y0f;
  c->tx = x - x0f;
  c->ty = y - y0f;
  return c->x0 >= -1 && c->x0 <= Wl && c->y0 >= -1 && c->y0 <= Hl ? Pt::HIT : Pt::MISS;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

// hi = tf32(x), lo = tf32(x - hi), elementwise over a fragment
template <typename Frag>
__device__ __forceinline__ void split(Frag& hi, Frag& lo) {
#pragma unroll
  for (int i = 0; i < hi.num_elements; ++i) {
    const float x = hi.x[i];
    const float h = wmma::__float_to_tf32(x);
    hi.x[i] = h;
    lo.x[i] = wmma::__float_to_tf32(x - h);
  }
}

// big[j] += A_hi @ B_j, small[j] += A_lo @ B_j (+ A_hi @ B_lo_j), for A (16 x 8)
// and B_j (8 x 16, from b + j * 16); B is split only for f32 operands (bf16
// ones are exact in TF32). The small terms keep an accumulator of their own:
// the tensor cores add into the accumulator with truncation at its own
// magnitude, which would drop them.
template <bool SPLIT_B, int NCT, typename FA>
__device__ __forceinline__ void mma_split(FA& a_hi, FA& a_lo, const float* b, int ldb,
                                          FragC* big, FragC* small) {
#pragma unroll
  for (int j = 0; j < NCT; ++j) {
    FragB b_hi, b_lo;
    wmma::load_matrix_sync(b_hi, b + j * 16, ldb);
    split(b_hi, b_lo);
    wmma::mma_sync(small[j], a_lo, b_hi, small[j]);
    if (SPLIT_B) wmma::mma_sync(small[j], a_hi, b_lo, small[j]);
    wmma::mma_sync(big[j], a_hi, b_hi, big[j]);
  }
}

// acc[j] += big[j] + small[j] in f32 on the SIMT pipes (round to nearest):
// one product tile's sums, started from zero, join the running total here,
// so the tensor cores' truncation acts on one tile's 8 steps, not on all.
template <int NCT>
__device__ __forceinline__ void add_tile(FragC* acc, const FragC* big, const FragC* small) {
#pragma unroll
  for (int j = 0; j < NCT; ++j)
#pragma unroll
    for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] += big[j].x[i] + small[j].x[i];
}

// Add query `q`'s weights on level (Hl, Wl) that fall in padded rows
// [k0, kend) into its one-hot row `wrow` (indexed from k0); true if any did.
// Rows past the chunk's width stay outside [k0, kend). `busy_col` (or null)
// flags the 16-row groups of the chunk that got a weight; `nonfinite` (or
// null) is set when a point's coordinate is not finite.
__device__ __forceinline__ bool scatter_row(const float* loc_q, const float* att_q, int l, int P,
                                            int Hl, int Wl, int k0, int kend, float* wrow,
                                            int* busy_col, bool* nonfinite) {
  const int Wp = Wl + 2;
  bool wrote = false;
  for (int p = 0; p < P; ++p) {
    const int k = l * P + p;
    Corners c;
    const Pt kind = corner_terms(loc_q + 2 * k, Hl, Wl, &c);
    if (kind != Pt::HIT) {
      if (nonfinite && kind == Pt::NONFINITE) *nonfinite = true;
      continue;
    }
    const float a = att_q[k];
    const int base = (c.y0 + 1) * Wp + (c.x0 + 1);
    const int idx[4] = {base, base + 1, base + Wp, base + Wp + 1};
    const float w[4] = {a * (1.f - c.tx) * (1.f - c.ty), a * c.tx * (1.f - c.ty),
                        a * (1.f - c.tx) * c.ty, a * c.tx * c.ty};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (idx[j] >= k0 && idx[j] < kend) {
        wrow[idx[j] - k0] += w[j];
        wrote = true;
        if (busy_col) busy_col[(idx[j] - k0) >> 4] = 1;
      }
    }
  }
  return wrote;
}

// Token of padded row k of a level, or -1 on the zero border.
__device__ __forceinline__ int token_of(int k, int Hl, int Wl, int start) {
  const int Wp = Wl + 2;
  const int py = k / Wp, px = k - (k / Wp) * Wp;
  if (py < 1 || py > Hl || px < 1 || px > Wl) return -1;
  return start + (py - 1) * Wl + (px - 1);
}

// Zero the QT x KC one-hot tile (the stride padding is never written).
__device__ __forceinline__ void clear_tile(float* wt) {
  for (int i = threadIdx.x; i < QT * KC / 4; i += THREADS) {
    const int r = i / (KC / 4), c = i - r * (KC / 4);
    reinterpret_cast<float4*>(wt + r * W_LD)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------- forward
// Block = (query tile, b * H + h, channel group), 128 threads. Threads
// 0..QT-1 each own one query's one-hot row; warp w multiplies query rows
// 16w..16w+15 by the chunk's value rows into NCT 16-column accumulators.
template <typename T, int NCT>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_dense_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ attn, T* __restrict__ out, int S,
                                int Q, int H, int D, int L, int P, Levels lv, int n_qt,
                                int n_bh) {
  constexpr int DW = NCT * 16;
  constexpr int V_LD = DW + 4;
  __shared__ __align__(32) float wt[QT * W_LD];  // one-hot tile, then the output tile
  __shared__ __align__(32) float vt[KC * V_LD];  // the chunk's value rows, f32
  __shared__ int busy[QT / 16];                  // row tile met a corner in this chunk
  __shared__ int nan_row[QT];                    // the query met a non-finite coordinate

  const int tid = threadIdx.x, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int bh = (blockIdx.x / n_qt) % n_bh;
  const int c0 = (blockIdx.x / n_qt / n_bh) * DG;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * QT;
  const int64_t row = (int64_t)H * D;
  const T* v_bh = value + (int64_t)b * S * row + (int64_t)h * D + c0;
  const int q = q0 + tid;
  const bool owner = tid < QT && q < Q;
  const int64_t bqh = ((int64_t)b * Q + (owner ? q : 0)) * H + h;
  const float* loc_q = loc + bqh * L * P * 2;
  const float* att_q = attn + bqh * L * P;

  FragC acc[NCT];
#pragma unroll
  for (int j = 0; j < NCT; ++j) wmma::fill_fragment(acc[j], 0.f);
  clear_tile(wt);
  if (tid < QT / 16) busy[tid] = 0;
  bool nonfinite = false;
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const int spl = (Hl + 2) * (Wl + 2);
    for (int k0 = 0; k0 < spl; k0 += KC) {
      const int kend = min(k0 + KC, spl);
      bool wrote = false;
      if (owner) {
        wrote = scatter_row(loc_q, att_q, l, P, Hl, Wl, k0, kend, wt + tid * W_LD, nullptr,
                            &nonfinite);
        if (wrote) busy[tid >> 4] = 1;
      }
      if (!__syncthreads_or(wrote)) continue;
      for (int i = tid; i < KC * DW; i += THREADS) {
        const int r = i / DW, d = i - r * DW;
        const int tok = k0 + r < kend ? token_of(k0 + r, Hl, Wl, lv.start[l]) : -1;
        vt[r * V_LD + d] =
            (tok >= 0 && c0 + d < D) ? to_float(v_bh[(int64_t)tok * row + d]) : 0.f;
      }
      __syncthreads();
      if (busy[warp]) {
        FragC big[NCT], small[NCT];
#pragma unroll
        for (int j = 0; j < NCT; ++j) {
          wmma::fill_fragment(big[j], 0.f);
          wmma::fill_fragment(small[j], 0.f);
        }
#pragma unroll 2
        for (int ks = 0; ks < KC / 8; ++ks) {
          FragA a_hi, a_lo;
          wmma::load_matrix_sync(a_hi, wt + warp * 16 * W_LD + ks * 8, W_LD);
          split(a_hi, a_lo);
          mma_split<IsF32<T>::value, NCT>(a_hi, a_lo, vt + ks * 8 * V_LD, V_LD, big, small);
        }
        add_tile<NCT>(acc, big, small);
      }
      __syncthreads();
      clear_tile(wt);
      if (tid < QT / 16) busy[tid] = 0;
      __syncthreads();
    }
  }
  if (tid < QT) nan_row[tid] = owner && nonfinite;
#pragma unroll
  for (int j = 0; j < NCT; ++j)
    wmma::store_matrix_sync(wt + warp * 16 * W_LD + j * 16, acc[j], W_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < QT * DW; i += THREADS) {
    const int r = i / DW, d = i - r * DW;
    if (q0 + r < Q && c0 + d < D)
      out[(((int64_t)b * Q + q0 + r) * H + h) * D + c0 + d] =
          from_float<T>(nan_row[r] ? nan_f32() : wt[r * W_LD + d]);
  }
}

// ---------------------------------------------------------------- adjoint
// One launch, two kinds of block.
// d_value blocks = (token chunk, b * H + h, channel group): a loop over the
// query tiles, in order, builds each tile's one-hot rows for the chunk and
// adds W^T @ dout into the accumulators of warp w (chunk rows 16w..16w+15);
// the chunk's real token rows are written once at the end.
template <typename T, int NCT>
__device__ __forceinline__ void dense_dvalue_block(const float* __restrict__ loc,
                                                   const float* __restrict__ attn,
                                                   const T* __restrict__ dout,
                                                   T* __restrict__ dvalue, int S, int Q, int H,
                                                   int D, int L, int P, const Levels& lv,
                                                   int blk, int n_chunks, int n_bh, float* wt,
                                                   float* gt, int* busy) {
  constexpr int DW = NCT * 16;
  constexpr int G_LD = DW + 4;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int chunk = blk % n_chunks;
  const int bh = (blk / n_chunks) % n_bh;
  const int c0 = (blk / n_chunks / n_bh) * DG;
  const int b = bh / H, h = bh - b * H;
  int l = 0;
  while (chunk >= lv.chunk0[l + 1]) ++l;
  const int Hl = lv.h[l], Wl = lv.w[l];
  const int spl = (Hl + 2) * (Wl + 2);
  const int k0 = (chunk - lv.chunk0[l]) * KC;
  const int kend = min(k0 + KC, spl);
  const int64_t row = (int64_t)H * D;

  FragC acc[NCT];
#pragma unroll
  for (int j = 0; j < NCT; ++j) wmma::fill_fragment(acc[j], 0.f);
  clear_tile(wt);
  if (tid < KC / 16) busy[tid] = 0;
  __syncthreads();

  for (int q0 = 0; q0 < Q; q0 += QT) {
    const int q = q0 + tid;
    bool wrote = false;
    if (tid < QT && q < Q) {
      const int64_t bqh = ((int64_t)b * Q + q) * H + h;
      wrote = scatter_row(loc + bqh * L * P * 2, attn + bqh * L * P, l, P, Hl, Wl, k0, kend,
                          wt + tid * W_LD, busy, nullptr);
    }
    if (!__syncthreads_or(wrote)) continue;
    for (int i = tid; i < QT * DW; i += THREADS) {
      const int r = i / DW, d = i - r * DW;
      gt[r * G_LD + d] =
          (q0 + r < Q && c0 + d < D)
              ? to_float(dout[(((int64_t)b * Q + q0 + r) * H + h) * D + c0 + d])
              : 0.f;
    }
    __syncthreads();
    if (busy[warp]) {
      FragC big[NCT], small[NCT];
#pragma unroll
      for (int j = 0; j < NCT; ++j) {
        wmma::fill_fragment(big[j], 0.f);
        wmma::fill_fragment(small[j], 0.f);
      }
#pragma unroll 2
      for (int ks = 0; ks < QT / 8; ++ks) {
        // W^T rows 16w.., columns (queries) 8 ks..: W is row-major by query
        FragAt a_hi, a_lo;
        wmma::load_matrix_sync(a_hi, wt + ks * 8 * W_LD + warp * 16, W_LD);
        split(a_hi, a_lo);
        mma_split<IsF32<T>::value, NCT>(a_hi, a_lo, gt + ks * 8 * G_LD, G_LD, big, small);
      }
      add_tile<NCT>(acc, big, small);
    }
    __syncthreads();
    clear_tile(wt);
    if (tid < KC / 16) busy[tid] = 0;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NCT; ++j)
    wmma::store_matrix_sync(wt + warp * 16 * W_LD + j * 16, acc[j], W_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < KC * DW; i += THREADS) {
    const int r = i / DW, d = i - r * DW;
    const int tok = k0 + r < kend ? token_of(k0 + r, Hl, Wl, lv.start[l]) : -1;
    if (tok >= 0 && c0 + d < D)
      dvalue[((int64_t)b * S + tok) * row + (int64_t)h * D + c0 + d] =
          from_float<T>(wt[r * W_LD + d]);
  }
}

// d_loc / d_attn blocks: G consecutive lanes share one (b, q, h) and take the
// channel slices r, r + G, ... of D / VEC, as the gather kernel of
// ms_deform_attn_bwd.cu, with the corner terms above: per point the group
// forms e_c = dout . v_c at the in-map corners and
//   d_attn = sum_c b_c e_c,
//   d_x = a * W_l * [(1-ty)(e01 - e00) + ty (e11 - e10)],
//   d_y = a * H_l * [(1-tx)(e10 - e00) + tx (e11 - e01)].
template <typename T, int VEC>
__device__ __forceinline__ void dense_dloc_item(const T* __restrict__ value,
                                                const float* __restrict__ loc,
                                                const float* __restrict__ attn,
                                                const T* __restrict__ dout,
                                                float* __restrict__ dloc,
                                                float* __restrict__ dattn, int S, int Q, int H,
                                                int D, int L, int P, int G, const Levels& lv,
                                                int64_t i, int64_t n_items) {
  if (i >= n_items) return;  // whole groups leave together: n_items is a multiple of G
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;
  const int lane = threadIdx.x & 31;
  const unsigned group_mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u)) << (lane & ~(G - 1));
  const int r = (int)(i % G);
  const int64_t bqh = i / G;
  const int h = (int)(bqh % H);
  const int64_t b = bqh / ((int64_t)Q * H);
  const float* loc_p = loc + bqh * L * P * 2;
  const float* att_p = attn + bqh * L * P;
  const T* v_bh = value + b * S * row + (int64_t)h * D;
  const T* do_p = dout + bqh * D;
  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l];
    const T* v_l = v_bh + (int64_t)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const int64_t o = bqh * L * P + k;
      Corners c;
      const Pt kind = corner_terms(loc_p + 2 * k, Hl, Wl, &c);
      if (kind != Pt::HIT) {
        if (r == 0) {
          const float g = kind == Pt::NONFINITE ? nan_f32() : 0.f;
          dattn[o] = g;
          dloc[2 * o] = g;
          dloc[2 * o + 1] = g;
        }
        continue;
      }
      const bool in_y0 = c.y0 >= 0 && c.y0 < Hl, in_y1 = c.y0 + 1 >= 0 && c.y0 + 1 < Hl;
      const bool in_x0 = c.x0 >= 0 && c.x0 < Wl, in_x1 = c.x0 + 1 >= 0 && c.x0 + 1 < Wl;
      const T* r0 = v_l + (int64_t)c.y0 * Wl * row;
      const T* r1 = r0 + (int64_t)Wl * row;
      float e00 = 0.f, e01 = 0.f, e10 = 0.f, e11 = 0.f;
      for (int cc = r; cc < chunks; cc += G) {
        const int64_t off = cc * VEC;
        float g[VEC], v[VEC];
        Load<T, VEC>::f32(do_p + off, g);
        if (in_y0 && in_x0) {
          Load<T, VEC>::f32(r0 + (int64_t)c.x0 * row + off, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) e00 += g[j] * v[j];
        }
        if (in_y0 && in_x1) {
          Load<T, VEC>::f32(r0 + (int64_t)(c.x0 + 1) * row + off, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) e01 += g[j] * v[j];
        }
        if (in_y1 && in_x0) {
          Load<T, VEC>::f32(r1 + (int64_t)c.x0 * row + off, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) e10 += g[j] * v[j];
        }
        if (in_y1 && in_x1) {
          Load<T, VEC>::f32(r1 + (int64_t)(c.x0 + 1) * row + off, v);
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
        const float tx = c.tx, ty = c.ty;
        dattn[o] = (1.f - tx) * (1.f - ty) * e00 + tx * (1.f - ty) * e01 +
                   (1.f - tx) * ty * e10 + tx * ty * e11;
        dloc[2 * o] = a * ((1.f - ty) * (e01 - e00) + ty * (e11 - e10)) * (float)Wl;
        dloc[2 * o + 1] = a * ((1.f - tx) * (e10 - e00) + tx * (e11 - e01)) * (float)Hl;
      }
    }
  }
}

template <typename T, int NCT, int VEC>
__global__ void __launch_bounds__(THREADS)
ms_deform_attn_dense_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ attn, const T* __restrict__ dout,
                                T* __restrict__ dvalue, float* __restrict__ dloc,
                                float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                                int P, int G, Levels lv, int n_dv_blocks, int n_bh,
                                int64_t n_items) {
  __shared__ __align__(32) float wt[QT * W_LD];           // one-hot tile, then d_value rows
  __shared__ __align__(32) float gt[QT * (NCT * 16 + 4)];  // the tile's dout rows, f32
  __shared__ int busy[KC / 16];                           // chunk row tile met a corner
  if ((int)blockIdx.x < n_dv_blocks) {
    dense_dvalue_block<T, NCT>(loc, attn, dout, dvalue, S, Q, H, D, L, P, lv, blockIdx.x,
                               lv.chunk0[L], n_bh, wt, gt, busy);
  } else {
    const int64_t i = (int64_t)(blockIdx.x - n_dv_blocks) * THREADS + threadIdx.x;
    dense_dloc_item<T, VEC>(value, loc, attn, dout, dloc, dattn, S, Q, H, D, L, P, G, lv, i,
                            n_items);
  }
}

// Level table with each level's first chunk; 0 or a negative argument code.
int make_levels(const int* level_hw, int L, int S, Levels* lv) {
  if (L < 1 || L > POET_MAX_LEVELS) return -1;
  int start = 0, chunk = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    if (lv->h[l] < 1 || lv->w[l] < 1) return -3;
    lv->start[l] = start;
    lv->chunk0[l] = chunk;
    start += lv->h[l] * lv->w[l];
    chunk += ((lv->h[l] + 2) * (lv->w[l] + 2) + KC - 1) / KC;
  }
  lv->chunk0[L] = chunk;
  return start > S ? -4 : 0;
}

template <typename T, int NCT>
void launch_fwd(const void* value, const float* loc, const float* attn, void* out, int B,
                int S, int Q, int H, int D, int L, int P, const Levels& lv,
                cudaStream_t stream) {
  const int n_qt = (Q + QT - 1) / QT, n_bh = B * H, n_groups = (D + DG - 1) / DG;
  const int64_t blocks = (int64_t)n_qt * n_bh * n_groups;
  if (blocks == 0) return;
  ms_deform_attn_dense_fwd_kernel<T, NCT><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      n_qt, n_bh);
}

template <typename T, int NCT, int VEC>
void launch_bwd(const void* value, const float* loc, const float* attn, const void* dout,
                void* dvalue, float* dloc, float* dattn, int B, int S, int Q, int H, int D,
                int L, int P, const Levels& lv, cudaStream_t stream) {
  const int n_bh = B * H, n_groups = (D + DG - 1) / DG;
  const int64_t n_dv = (int64_t)lv.chunk0[L] * n_bh * n_groups;
  const int chunks = D / VEC;
  int G = 1;
  while (G < chunks && G < 32) G <<= 1;
  const int64_t n_items = (int64_t)B * Q * H * G;
  const int64_t blocks = n_dv + (n_items + THREADS - 1) / THREADS;
  if (blocks == 0 || Q == 0) return;
  ms_deform_attn_dense_bwd_kernel<T, NCT, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout),
      static_cast<T*>(dvalue), dloc, dattn, S, Q, H, D, L, P, G, lv, (int)n_dv, n_bh, n_items);
}

template <typename T, int VEC>
void launch_bwd_nct(int nct, const void* value, const float* loc, const float* attn,
                    const void* dout, void* dvalue, float* dloc, float* dattn, int B, int S,
                    int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t s) {
  switch (nct) {
    case 1: launch_bwd<T, 1, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, s); break;
    case 2: launch_bwd<T, 2, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, s); break;
    case 3: launch_bwd<T, 3, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, s); break;
    default: launch_bwd<T, 4, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, s); break;
  }
}

// column tiles of 16 channels a block covers: D's first group, at most 4
int col_tiles(int D) { return ((D < DG ? D : DG) + 15) / 16; }

}  // namespace

extern "C" {

// Each returns 0 on success, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16 (of value, out, dout and d_value)
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec (adjoint): channels per lane of the d_loc / d_attn gather, 1 or the
//        16-byte width of the value (4 f32, 8 bf16)

int poet_ms_deform_attn_dense_fwd(const void* value, const void* loc, const void* attn,
                                  void* out, int dtype, int B, int S, int Q, int H, int D, int L,
                                  int P, const int* level_hw, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D < 1) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nct = col_tiles(D);
  if (dtype == 0) {
    switch (nct) {
      case 1: launch_fwd<float, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      case 2: launch_fwd<float, 2>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      case 3: launch_fwd<float, 3>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      default: launch_fwd<float, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
    }
  } else if (dtype == 1) {
    switch (nct) {
      case 1: launch_fwd<__nv_bfloat16, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      case 2: launch_fwd<__nv_bfloat16, 2>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      case 3: launch_fwd<__nv_bfloat16, 3>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
      default: launch_fwd<__nv_bfloat16, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s); break;
    }
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

// d_value: every token row of the levels written (the caller zeroes the rows
// past them); d_loc and d_attn: every element written.
int poet_ms_deform_attn_dense_bwd(const void* value, const void* loc, const void* attn,
                                  const void* dout, void* dvalue, void* dloc, void* dattn,
                                  int dtype, int B, int S, int Q, int H, int D, int L, int P,
                                  const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D < 1 || vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nct = col_tiles(D);
  if (dtype == 0 && vec == 4) {
    launch_bwd_nct<float, 4>(nct, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch_bwd_nct<float, 1>(nct, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 8) {
    launch_bwd_nct<__nv_bfloat16, 8>(nct, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch_bwd_nct<__nv_bfloat16, 1>(nct, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
