// Multi-scale deformable attention through a dense one-hot sampling matrix on
// the tensor cores — CUDA for Hopper (sm_90a).
//
// Three kernels, replacing the TPU kernels of poet_tpu/ops/deform_attn_pallas.py
// (the `enc_deform_impl` / `dec_deform_impl` = 'pallas' entry
// ms_deform_attn_pallas):
//   * ms_deform_attn_dense_fwd_kernel  replaces _fwd_kernel (_run_forward),
//   * ms_deform_attn_dense_bwd_kernel  and, for its d_loc / d_attn blocks on
//     a staged slab, ms_deform_attn_point.cuh's ms_deform_attn_dloc_slab_kernel
//     under OneHotRule replace _bwd_kernel (_run_backward).
// They compute the contract of poet_tpu/ops/deform_attn.py:ms_deform_attn_xla
// and its gradient, the function the gather kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu) compute, with the TPU kernel's idea: per (b, h) and
// a query tile the sampling is a matrix W (queries x tokens) whose row q
// holds the bilinear x attention weights of query q's points at their
// corners, and
//
//   out = W @ V            (forward)
//   dV  = W^T @ dout       (the adjoint's d_value).
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
// and y0 lie in [-1, size]; of its corners (y0 + {0, 1}, x0 + {0, 1}) those
// on a real token carry its weight, those on the TPU's zero border add 0 and
// are left out. A point with a NaN or infinite coordinate follows the C1 rule
// (csrc/ms_deform_attn_point.cuh, and the plain version): it takes part in no
// product, its (b, q, h) output row is NaN, and its d_attn and both d_loc
// coordinates are NaN.
//
// What bounds them. The function's bytes (0.03 ms at the flagship encoder)
// and the one-hot products on the tensor cores (B H Q S D 2 flops, 0.02 ms in
// bf16; the hi/lo split below takes 2-3 of them). The TPU kernel swept every
// token chunk for every query tile, a dense product; on Hopper that sweep,
// not the products, took the time (the design before this one: 2.15 ms, every
// point's corners recomputed for each chunk of its level, three block
// barriers and a full tile clear per chunk). So:
//
// Forward. A block is (query tile of QT = 64, b * H + h, channel group), 128
// threads, warp w owning query rows 16w..16w+15. Each thread computes the
// corner terms of a contiguous slice of the tile's points ONCE (two threads
// per query), counts its in-map corners per token chunk of KC = 64 tokens,
// and a block scan in (chunk, thread) order gives every corner its rank: a
// counting sort, with no atomics, that leaves each chunk's list in (q, p,
// corner) order. Only the occupied chunks are walked. For each, every warp
// builds its 16 rows of the QT x KC one-hot tile from its own segment of the
// list (lane r adds row r's entries in list order, the TPU's one-hot sum),
// multiplies it on the tensor cores (mma.sync m16n8k8, skipping 8-column
// steps no corner fell in) by the chunk's value rows, and zeroes exactly the
// cells it wrote. The value rows are staged by cp.async into a ring of two
// stages, the next occupied chunk's in flight during this one's product; one
// block barrier per chunk hands the ring on. mma.sync rather than wgmma:
// each warp runs its own 16-row product with nothing to wait for but its own
// corners, and a one-hot tile holds a few percent non-zeros, so the
// tensor-core rate is not what binds.
//
// Adjoint. Two kinds of block.
//   * d_value blocks (256 threads) = (b * H + h, unit, channel group): a unit is one level,
//     or a band of its tokens where the level has more than the lane groups
//     hold in registers (1280 at D = 16; the flagship's levels are whole, so
//     every point's corner terms are computed once). The block walks the
//     queries in tiles of 1024 / P, in order. Per tile each thread computes
//     its points' corner terms once; the tile's corners, in (point, corner)
//     order, are sorted by token: per-(token, warp) counts (int shared
//     atomics: a count does not depend on their order), a scan in (token,
//     warp) order, equal tokens within a round of 32 corners ranked by lane,
//     so each token's run lists its corners in (q, p, corner) order; the
//     tile's dout rows are staged once as f32. A lane group (D / 4 lanes,
//     four channels each) owns tokens of the unit, keeps their sums in
//     registers and adds each run in order. So every d_value element is an
//     f32 sum in (q, p, corner) order, fixed by the data alone: no float
//     atomic, in device or shared memory, and the same bits on every run, as
//     the TPU's sequential grid gave. What binds it: the ranking rounds and
//     the runs' dependent shared-memory loads, at two blocks an SM.
//   * d_loc / d_attn blocks: a lane per sampling point gathers dout . v at
//     its four corners (deform_point::dloc_walk, the pair's walk, with the
//     one-hot corner terms and formula below; the TPU kernel formed the
//     dense QT x S_pad product instead). By the pair's route rule
//     (ops/deform_attn_cuda.py:plan_dloc), the wrapper's choice: where it
//     stages (the encoder), a block per (b, h) stages its value slab and
//     walks the pair's points from it, in a kernel of its own
//     (the pair's slab kernel under OneHotRule, launched after the d_value
//     blocks)
//     free of the d_value blocks' register cap; elsewhere (the decoder; the
//     YOLO pyramid in f32) a block per (b, h, 256 points) reads the corners
//     from device memory inside the d_value blocks' launch.
// A d_value route on the tensor cores (W^T over 16-token groups x 64
// queries, hi/lo split, times the staged dout tile, into an f32 accumulator
// in shared memory) was built beside this one and measured several times
// slower (PERF.md), so it is not kept.
//
// Precision. W's entries are f32 products; a TF32 (or bf16) tile would round
// them to 11 (8) bits. Each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), ~22 bits together: a bf16 value or dout is exact in TF32, so
// bf16 takes two products (W_hi V + W_lo V), f32 three (3xTF32: + W_hi V_lo).
// The tensor cores add each product into their accumulator with truncation at
// the accumulator's magnitude, so the small terms get an accumulator of their
// own and each chunk's sums join the running total by f32 adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "ms_deform_attn_point.cuh"

namespace {

using deform_point::Footprint;
using deform_point::from_float;
using deform_point::Levels;
using deform_point::Load;
using deform_point::to_float;

constexpr int KC = 64;            // tokens per chunk: the one-hot tile's columns
constexpr int QT = 64;            // forward: queries per block, 4 warps x 16 rows
constexpr int FWD_THREADS = 128;
constexpr int W_LD = KC + 4;      // one-hot tile row stride (floats)
constexpr int NSTAGE = 2;         // the forward's ring of staged value chunks
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int MAX_UNITS = 64;
constexpr int MAXB = 8;           // forward: one-hot cells a lane keeps in registers
constexpr int TPG = 20;           // adjoint: tokens per lane group (their sums in registers)
constexpr int TILE_PTS = 1024;    // adjoint: points per d_value tile

template <typename T> struct IsF32 { static constexpr bool value = false; };
template <> struct IsF32<float> { static constexpr bool value = true; };

// The adjoint's d_value units: level, first token within the level, tokens.
struct Units {
  int level[MAX_UNITS];
  int t0[MAX_UNITS];
  int n[MAX_UNITS];
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

__device__ __forceinline__ Pt corner_terms(float2 loc, int Hl, int Wl, Corners* c) {
  const float x = deform_point::pixel_coord(loc.x, Wl);   // two roundings (C8)
  const float y = deform_point::pixel_coord(loc.y, Hl);
  if (!(isfinite(x) && isfinite(y))) return Pt::NONFINITE;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  c->x0 = (int)x0f;  // saturates: far points fail the test below
  c->y0 = (int)y0f;
  c->tx = x - x0f;
  c->ty = y - y0f;
  return c->x0 >= -1 && c->x0 <= Wl && c->y0 >= -1 && c->y0 <= Hl ? Pt::HIT : Pt::MISS;
}

// Corner j = (y0 + j / 2, x0 + j % 2) of a HIT point: false on the zero
// border, else its token within the level and its weight a * bx * by.
__device__ __forceinline__ bool corner_of(const Corners& c, float a, int j, int Hl, int Wl,
                                          int* tok, float* w) {
  const int x = c.x0 + (j & 1), y = c.y0 + (j >> 1);
  if (x < 0 || x >= Wl || y < 0 || y >= Hl) return false;
  *tok = y * Wl + x;
  *w = a * ((j & 1) ? c.tx : 1.f - c.tx) * ((j >> 1) ? c.ty : 1.f - c.ty);
  return true;
}

// A forward point record in shared memory: ((y0 + 1) << 16 | (x0 + 1)) of a
// HIT point (-1 otherwise), tx, ty, a.
__device__ __forceinline__ float4 pack_point(const Corners& c, float a) {
  return make_float4(__int_as_float(((c.y0 + 1) << 16) | (c.x0 + 1)), c.tx, c.ty, a);
}

__device__ __forceinline__ bool unpack_point(const float4& r, Corners* c) {
  const int code = __float_as_int(r.x);
  if (code < 0) return false;
  c->x0 = (code & 0xffff) - 1;
  c->y0 = (code >> 16) - 1;
  c->tx = r.y;
  c->ty = r.z;
  return true;
}

// c += a @ b for the split operands: big += a_hi b_hi, small += a_lo b_hi
// (+ a_hi b_lo when b is f32); b0 / b1 are the f32 values of the B fragment.
template <bool SPLIT_B>
__device__ __forceinline__ void mma_split(const uint32_t* ahi, const uint32_t* alo, float b0,
                                          float b1, float* big, float* small) {
  if (SPLIT_B) {
    uint32_t h0, l0, h1, l1;
    mma_sm90::split_tf32(b0, h0, l0);
    mma_sm90::split_tf32(b1, h1, l1);
    mma_sm90::mma_tf32_1688(small, alo, h0, h1);
    mma_sm90::mma_tf32_1688(small, ahi, l0, l1);
    mma_sm90::mma_tf32_1688(big, ahi, h0, h1);
  } else {  // bf16 values are exact in TF32
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    mma_sm90::mma_tf32_1688(small, alo, h0, h1);
    mma_sm90::mma_tf32_1688(big, ahi, h0, h1);
  }
}

// The hi/lo A fragment (m16n8k8) of the 16 x 8 tile at `a` (row stride ld).
__device__ __forceinline__ void load_a_split(const float* a, int ld, int g, int t,
                                             uint32_t* hi, uint32_t* lo) {
  mma_sm90::split_tf32(a[g * ld + t], hi[0], lo[0]);
  mma_sm90::split_tf32(a[(g + 8) * ld + t], hi[1], lo[1]);
  mma_sm90::split_tf32(a[g * ld + t + 4], hi[2], lo[2]);
  mma_sm90::split_tf32(a[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// four f32 values stored as one 16-byte (f32) or 8-byte (bf16) word
template <typename T> struct Store4;
template <> struct Store4<float> {
  static __device__ __forceinline__ void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Store4<__nv_bfloat16> {
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// ---------------------------------------------------------------- forward
// Shared memory: cstart (n_chunks + 1), occ (n_chunks), nan_row (QT), n_occ;
// cnt (n_chunks x 128 16-bit counts per (chunk, thread), then the running
// ends); the sorted corner list (QT L P 4 entries: f32 weights, and 16-bit
// cell | kstep << 13); then the point records, which the one-hot tile and the
// value ring overlay once the list is built. 55 KB at the flagship in bf16:
// four blocks an SM.
__host__ __device__ inline size_t fwd_int_words(int n_chunks) {
  return 2 * (size_t)n_chunks + 1 + QT + 1;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

inline size_t fwd_smem_bytes(int n_chunks, int LP, int DG, int itemsize) {
  const size_t pts = (size_t)QT * LP * 16;
  const size_t tiles = (size_t)QT * W_LD * 4 + (size_t)NSTAGE * KC * (DG + 8) * itemsize;
  return align16(fwd_int_words(n_chunks) * 4) + align16((size_t)n_chunks * FWD_THREADS * 2) +
         (size_t)QT * LP * 16 + align16((size_t)QT * LP * 8) + (pts > tiles ? pts : tiles);
}

template <typename T, int NT>
__global__ void __launch_bounds__(FWD_THREADS, 4)
ms_deform_attn_dense_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ attn, T* __restrict__ out, int S,
                                int Q, int H, int D, int L, int P,
                                const __grid_constant__ Levels lv, int S_lv, int n_chunks,
                                int n_qt, int n_bh, bool async16) {
  constexpr int DG = NT * 8;       // channels per block
  constexpr int V_LD = DG + 8;     // staged value row stride (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  int* cstart = reinterpret_cast<int*>(smem);
  int* occ = cstart + n_chunks + 1;
  int* nan_row = occ + n_chunks;
  int* n_occ_p = nan_row + QT;
  const int LP = L * P;
  unsigned char* p = smem + align16(fwd_int_words(n_chunks) * 4);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(p);
  p += align16((size_t)n_chunks * FWD_THREADS * 2);
  float* ent_w = reinterpret_cast<float*>(p);
  p += (size_t)QT * LP * 16;
  unsigned short* ent_c = reinterpret_cast<unsigned short*>(p);
  p += align16((size_t)QT * LP * 8);
  float4* pts = reinterpret_cast<float4*>(p);
  float* wt = reinterpret_cast<float*>(p);
  T* stage = reinterpret_cast<T*>(p + QT * W_LD * 4);
  __shared__ int wsum[FWD_THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int bh = (blockIdx.x / n_qt) % n_bh;
  const int c0 = (blockIdx.x / n_qt / n_bh) * DG;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * QT;
  // thread tid owns query row tid / 2 and the contiguous points [k_lo, k_hi)
  const int r_own = tid >> 1;
  const int PH = (LP + 1) >> 1;
  const int k_lo = (tid & 1) * PH, k_hi = min(LP, k_lo + PH);
  const bool live = q0 + r_own < Q;
  const int64_t bqh = ((int64_t)b * Q + (live ? q0 + r_own : 0)) * H + h;
  const float* loc_q = loc + bqh * LP * 2;
  const float* att_q = attn + bqh * LP;

  for (int i = tid; i < n_chunks * FWD_THREADS; i += FWD_THREADS) cnt[i] = 0;
  if (tid < QT) nan_row[tid] = 0;
  __syncthreads();

  // corner terms, once per point; in-map corners counted per (chunk, thread)
  if (live) {
    for (int k0 = k_lo; k0 < k_hi; k0 += 4) {
      float2 xy[4];
      float att[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // the loads first: four points' in flight at once
        const int k = min(k0 + u, k_hi - 1);
        xy[u] = reinterpret_cast<const float2*>(loc_q)[k];
        att[u] = att_q[k];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u;
        if (k >= k_hi) break;
        const int l = k / P, Hl = lv.h[l], Wl = lv.w[l];
        Corners c;
        const Pt kind = corner_terms(xy[u], Hl, Wl, &c);
        float4 rec = make_float4(__int_as_float(-1), 0.f, 0.f, 0.f);
        if (kind == Pt::NONFINITE) nan_row[r_own] = 1;
        if (kind == Pt::HIT) {
          rec = pack_point(c, att[u]);
          for (int j = 0; j < 4; ++j) {
            int tok;
            float w;
            if (corner_of(c, att[u], j, Hl, Wl, &tok, &w))
              ++cnt[((lv.start[l] + tok) / KC) * FWD_THREADS + tid];
          }
        }
        pts[r_own * LP + k] = rec;
      }
    }
  }
  __syncthreads();

  // exclusive scan of the counts in (chunk, thread) order: each thread sums a
  // contiguous segment of n_chunks counts, a block scan joins the segments
  {
    unsigned short* seg = cnt + tid * n_chunks;
    int s = 0;
    for (int j = 0; j < n_chunks; ++j) s += seg[j];
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int run = incl - s;
    for (int w = 0; w < warp; ++w) run += wsum[w];
    if (tid == FWD_THREADS - 1) cstart[n_chunks] = run + s;
    for (int j = 0; j < n_chunks; ++j) {
      const int v = seg[j];
      seg[j] = (unsigned short)run;
      run += v;
    }
  }
  __syncthreads();
  if (warp == 0) {  // chunk starts and the occupied chunks, in order
    int n = 0;
    for (int base = 0; base < n_chunks; base += 32) {
      const int c = base + lane;
      bool busy = false;
      if (c < n_chunks) {
        const int start = cnt[c * FWD_THREADS];
        const int end = c + 1 < n_chunks ? cnt[(c + 1) * FWD_THREADS] : cstart[n_chunks];
        cstart[c] = start;
        busy = end > start;
      }
      const unsigned m = __ballot_sync(0xffffffffu, busy);
      if (busy) occ[n + __popc(m & ((1u << lane) - 1))] = c;
      n += __popc(m);
    }
    if (lane == 0) *n_occ_p = n;
  }

  // place each corner at its rank: cnt[c][tid] ends as the end of this
  // thread's entries in chunk c
  if (live) {
    for (int k = k_lo; k < k_hi; ++k) {
      const int l = k / P, Hl = lv.h[l], Wl = lv.w[l];
      const float4 rec = pts[r_own * LP + k];
      Corners c;
      if (!unpack_point(rec, &c)) continue;
      for (int j = 0; j < 4; ++j) {
        int tok;
        float w;
        if (!corner_of(c, rec.w, j, Hl, Wl, &tok, &w)) continue;
        tok += lv.start[l];
        const int col = tok % KC;
        const int pos = cnt[(tok / KC) * FWD_THREADS + tid]++;
        ent_c[pos] = (unsigned short)((r_own * W_LD + col) | ((col >> 3) << 13));
        ent_w[pos] = w;
      }
    }
  }
  __syncthreads();

  // the one-hot tile overlays the point records from here: each warp clears
  // its 16 rows once; after each chunk it zeroes exactly the cells it wrote
  float* wrow = wt + warp * 16 * W_LD;
  for (int i = lane; i < 16 * W_LD / 4; i += 32)
    reinterpret_cast<float4*>(wrow)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  const int64_t row_stride = (int64_t)H * D;
  const T* v_bh = value + (int64_t)b * S * row_stride + (int64_t)h * D;
  auto stage_chunk = [&](int s, int c) {
    T* dst = stage + s * KC * V_LD;
    const int tok0 = c * KC;
    if (async16) {
      constexpr int EPP = 16 / sizeof(T);      // elements per 16-byte piece
      constexpr int PIECES = DG / EPP;
      for (int i = tid; i < KC * PIECES; i += FWD_THREADS) {
        const int r = i / PIECES, pc = i - r * PIECES;
        const int tok = tok0 + r, ch = c0 + pc * EPP;
        const bool ok = tok < S_lv && ch < D;
        mma_sm90::cp_async16(dst + r * V_LD + pc * EPP,
                             ok ? v_bh + tok * row_stride + ch : v_bh, ok);
      }
      mma_sm90::cp_async_commit();
    } else {
      for (int i = tid; i < KC * DG; i += FWD_THREADS) {
        const int r = i / DG, d = i - r * DG;
        const int tok = tok0 + r;
        dst[r * V_LD + d] = tok < S_lv && c0 + d < D ? v_bh[tok * row_stride + c0 + d]
                                                       : from_float<T>(0.f);
      }
    }
  };

  const int n_occ = *n_occ_p;
  const int g = lane >> 2, t4 = lane & 3;
  const int row = warp * 16 + (lane & 15);  // lanes 0-15 build the warp's rows
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (n_occ > 0) stage_chunk(0, occ[0]);
  for (int i = 0; i < n_occ; ++i) {
    const int c = occ[i];
    const unsigned short* ends = cnt + c * FWD_THREADS;
    int e_beg = 0, e_end = 0;
    if (lane < 16) {
      e_beg = row == 0 ? cstart[c] : ends[2 * row - 1];
      e_end = ends[2 * row + 1];
    }
    // row `row`'s corners in list order ((p, corner) order): the first MAXB
    // kept in registers for the zeroing, the rest reloaded
    int cell[MAXB];
    unsigned kbits = 0;
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      cell[j] = -1;
      if (e_beg + j < e_end) {
        const int en = ent_c[e_beg + j];
        cell[j] = en & 0x1fff;
        wt[cell[j]] += ent_w[e_beg + j];
        kbits |= 1u << (en >> 13);
      }
    }
    for (int e = e_beg + MAXB; e < e_end; ++e) {
      const int en = ent_c[e];
      wt[en & 0x1fff] += ent_w[e];
      kbits |= 1u << (en >> 13);
    }
    const unsigned kmask = __reduce_or_sync(0xffffffffu, kbits);
    if (async16) mma_sm90::cp_async_wait_all();
    __syncthreads();  // chunk i staged; every warp is past chunk i - 1's product
    if (i + 1 < n_occ) stage_chunk((i + 1) % NSTAGE, occ[i + 1]);
    if (kmask) {
      const T* vs = stage + (i % NSTAGE) * KC * V_LD;
      // even and odd k-steps in accumulators of their own: two chains of
      // mma.sync where one would wait on the other
      float big[2][NT][4], small[2][NT][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[h2][j][e] = small[h2][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        if ((kmask >> ks) & 1) {
          uint32_t ahi[4], alo[4];
          load_a_split(wrow + ks * 8, W_LD, g, t4, ahi, alo);
          const T* v0 = vs + (ks * 8 + t4) * V_LD + g;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_split<IsF32<T>::value>(ahi, alo, to_float(v0[j * 8]),
                                       to_float(v0[4 * V_LD + j * 8]), big[ks & 1][j],
                                       small[ks & 1][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] += (big[0][j][e] + big[1][j][e]) + (small[0][j][e] + small[1][j][e]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < MAXB; ++j)
      if (cell[j] >= 0) wt[cell[j]] = 0.f;
    for (int e = e_beg + MAXB; e < e_end; ++e) wt[ent_c[e] & 0x1fff] = 0.f;
    __syncwarp();
  }

  const int rA = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rA + (e >> 1) * 8, ch = c0 + j * 8 + 2 * t4 + (e & 1);
      if (q0 + r < Q && ch < D)
        out[(((int64_t)b * Q + q0 + r) * H + h) * D + ch] =
            from_float<T>(nan_row[r] ? nan_f32() : acc[j][e]);
    }
  }
}

// ---------------------------------------------------------------- adjoint
// The d_value blocks: queries per tile; tokens per unit (the lane groups'
// registers); their dynamic shared memory: per-(token, warp) counts and run
// starts (16 bits), the tile's corners (token and query row, weight), its
// runs (an f32 weight and a 16-bit query row per corner), its dout rows (f32,
// 4 floats of padding).
__host__ __device__ inline int dv_tile_queries(int P) {
  return TILE_PTS / P > 0 ? TILE_PTS / P : 1;
}

__host__ __device__ inline int dv_band_tokens(int DGP) { return BWD_THREADS / (DGP / 4) * TPG; }

// a tile's point slots: its points rounded up to a whole round per warp
__host__ __device__ inline int dv_tile_slots(int P) {
  return (dv_tile_queries(P) * P + BWD_THREADS - 1) / BWD_THREADS * BWD_THREADS;
}

inline size_t dv_smem_bytes(int band_max, int DGP, int P) {
  const size_t slots = dv_tile_slots(P);
  return align16((size_t)BWD_WARPS * band_max * 2) + align16(((size_t)band_max + 1) * 2) +
         slots * 32 + slots * 16 + align16(slots * 8) + (size_t)dv_tile_queries(P) * (DGP + 4) * 4;
}

// Which block of the d_value kind this is: (unit, b * H + h, channel group).
struct DvBlock {
  int b, h, c0, l, t0, nt;
};

__device__ __forceinline__ DvBlock dvalue_block_of(int blk, int n_units, int n_bh, int H,
                                                   int DGP, const Units& un) {
  DvBlock d;
  const int unit = blk % n_units;
  const int bh = (blk / n_units) % n_bh;
  d.c0 = (blk / n_units / n_bh) * DGP;
  d.b = bh / H;
  d.h = bh - d.b * H;
  d.l = un.level[unit];
  d.t0 = un.t0[unit];
  d.nt = un.n[unit];
  return d;
}

// A d_value block. Per tile of TILE_PTS points (in (q, p) order; warp w
// owns a contiguous run of them) each thread computes its points' corner
// terms once and keeps, per corner, its token within the unit (with the
// query row) and weight in shared memory. The tile's corners, enumerated in
// (point, corner) order, 32 to a round, are sorted by token: per-(token,
// warp) counts (int shared atomics: a count does not depend on their
// order), a scan in (token, warp) order, equal tokens within a round ranked
// by lane; so each token's run lists its corners in (q, p, corner) order, as
// (weight, query row). Lane group g
// (DGP / 4 lanes, four channels each) owns tokens g, g + NG, ... of the unit
// and adds each of their runs, in order, into sums held in registers.
template <typename T, int DGP>
__device__ __forceinline__ void dvalue_block(const float* __restrict__ loc,
                                             const float* __restrict__ attn,
                                             const T* __restrict__ dout, T* __restrict__ dvalue,
                                             int S, int Q, int H, int D, int L, int P,
                                             const Levels& lv, const Units& un, int n_units,
                                             int band_max, int blk, int n_bh, bool vec4,
                                             unsigned char* smem) {
  static_assert(BWD_WARPS == 8, "a token's per-warp counts are one 16-byte word");
  constexpr int LPE = DGP / 4, NG = BWD_THREADS / LPE, DT4 = (DGP + 4) / 4;
  const DvBlock k = dvalue_block_of(blk, n_units, n_bh, H, DGP, un);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / LPE, sub = tid - grp * LPE;
  const int Hl = lv.h[k.l], Wl = lv.w[k.l];
  const int qt = dv_tile_queries(P), npts = qt * P;
  const int R = dv_tile_slots(P) / BWD_WARPS;  // points per warp, <= 128
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);  // [token][warp]
  unsigned char* p = smem + align16((size_t)BWD_WARPS * band_max * 2);
  unsigned short* tstart = reinterpret_cast<unsigned short*>(p);   // nt + 1
  p += align16(((size_t)band_max + 1) * 2);
  int* ctok = reinterpret_cast<int*>(p);      // 32 R: token << 16 | query row, or -1
  p += (size_t)BWD_WARPS * R * 16;
  float* cw = reinterpret_cast<float*>(p);    // 32 R: weights
  p += (size_t)BWD_WARPS * R * 16;
  float* run_w = reinterpret_cast<float*>(p);                       // 32 R
  p += (size_t)BWD_WARPS * R * 16;
  unsigned short* run_q = reinterpret_cast<unsigned short*>(p);     // 32 R
  float* dt = reinterpret_cast<float*>(p + align16((size_t)BWD_WARPS * R * 8));
  const float4* dt4 = reinterpret_cast<const float4*>(dt);
  __shared__ int wsum[BWD_WARPS];

  float4 acc[TPG];
#pragma unroll
  for (int s = 0; s < TPG; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < Q; q0 += qt) {
    __syncthreads();  // the previous tile's runs are read
    for (int i = tid; i < k.nt; i += BWD_THREADS)  // a token's 8 counts: 16 bytes
      reinterpret_cast<uint4*>(cnt)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // the counts are zero
    for (int i = tid; i < min(qt, Q - q0) * (DGP / 4); i += BWD_THREADS) {
      const int r = i / (DGP / 4), d = (i - r * (DGP / 4)) * 4;
      const T* src = dout + (((int64_t)k.b * Q + q0 + r) * H + k.h) * D + k.c0 + d;
      float v[4];
      if (vec4 && k.c0 + d + 3 < D) {
        Load<T, 4>::f32(src, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = k.c0 + d + e < D ? to_float(src[e]) : 0.f;
      }
      reinterpret_cast<float4*>(dt + r * (DGP + 4))[d / 4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    float2 xy[4];
    float att[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {  // the loads first: the warp's points in flight at once
      const int j = warp * R + rr * 32 + lane, r = j / P, q = q0 + r;
      xy[rr] = make_float2(-1e9f, -1e9f);  // a MISS
      att[rr] = 0.f;
      if (rr * 32 < R && j < npts && q < Q) {
        const int64_t o = (((int64_t)k.b * Q + q) * H + k.h) * L * P + k.l * P + (j - r * P);
        xy[rr] = reinterpret_cast<const float2*>(loc)[o];
        att[rr] = attn[o];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {  // corner terms, once per point
      if (rr * 32 >= R) break;
      const int j = warp * R + rr * 32 + lane;
      const int r = j / P;
      int tk[4] = {-1, -1, -1, -1};
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      {
        Corners c;
        if (corner_terms(xy[rr], Hl, Wl, &c) == Pt::HIT) {
          const float a = att[rr];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int t;
            if (corner_of(c, a, e, Hl, Wl, &t, &w[e]) && t >= k.t0 && t < k.t0 + k.nt) {
              tk[e] = ((t - k.t0) << 16) | r;
              atomicAdd(reinterpret_cast<unsigned*>(cnt) + (t - k.t0) * (BWD_WARPS / 2) + warp / 2,
                        1u << (16 * (warp & 1)));
            }
          }
        }
      }
      reinterpret_cast<int4*>(ctok)[j] = make_int4(tk[0], tk[1], tk[2], tk[3]);
      reinterpret_cast<float4*>(cw)[j] = make_float4(w[0], w[1], w[2], w[3]);
    }
    const int rounds = R / 8;  // 4 R corners, 32 a round
    __syncthreads();
    {  // exclusive scan in (token, warp) order, a token's 8 counts at a time; run starts
      const int per = (k.nt + BWD_THREADS - 1) / BWD_THREADS;
      const int lo = min(k.nt, tid * per), hi = min(k.nt, lo + per);
      uint4* cnt4 = reinterpret_cast<uint4*>(cnt);
      int sum = 0;
      for (int i = lo; i < hi; ++i) {
        const uint4 c = cnt4[i];
        sum += (int)((c.x & 0xffff) + (c.x >> 16) + (c.y & 0xffff) + (c.y >> 16) +
                     (c.z & 0xffff) + (c.z >> 16) + (c.w & 0xffff) + (c.w >> 16));
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int run = incl - sum;
      for (int w = 0; w < warp; ++w) run += wsum[w];
      for (int i = lo; i < hi; ++i) {
        tstart[i] = (unsigned short)run;
        uint4 c = cnt4[i];
        unsigned* w4 = reinterpret_cast<unsigned*>(&c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // two 16-bit counts a word -> their offsets
          const unsigned lo16 = w4[e] & 0xffff, hi16 = w4[e] >> 16;
          w4[e] = (unsigned)run | ((unsigned)(run + lo16) << 16);
          run += lo16 + hi16;
        }
        cnt4[i] = c;
      }
      if (tid == BWD_THREADS - 1) tstart[k.nt] = (unsigned short)run;
    }
    __syncthreads();
    for (int u = 0; u < rounds; ++u) {  // each corner at its rank
      const int e = warp * R * 4 + u * 32 + lane;
      const int v = ctok[e], tok = v >= 0 ? v >> 16 : -1;
      const unsigned m = __match_any_sync(0xffffffffu, tok >= 0 ? tok : -1 - lane);
      const int lead = __ffs(m) - 1;
      int base = 0;
      if (tok >= 0 && lane == lead) {
        base = cnt[tok * BWD_WARPS + warp];
        cnt[tok * BWD_WARPS + warp] = (unsigned short)(base + __popc(m));
      }
      base = __shfl_sync(0xffffffffu, base, lead);
      if (tok >= 0) {
        const int at = base + __popc(m & ((1u << lane) - 1u));
        run_w[at] = cw[e];
        run_q[at] = (unsigned short)(v & 0xffff);
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < TPG; ++s) {  // each owned token's run, in order
      const int i = grp + s * NG;
      if (i >= k.nt) break;
      const int e1 = tstart[i + 1];
      float4 a = acc[s];
      for (int e = tstart[i]; e < e1; ++e) {
        const float w = run_w[e];
        const float4 d = dt4[run_q[e] * DT4 + sub];
        a.x += w * d.x;
        a.y += w * d.y;
        a.z += w * d.z;
        a.w += w * d.w;
      }
      acc[s] = a;
    }
  }
  const int64_t tok0 = (int64_t)k.b * S + lv.start[k.l] + k.t0;
#pragma unroll
  for (int s = 0; s < TPG; ++s) {
    const int i = grp + s * NG;
    if (i >= k.nt) break;
    const float v[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
    const int ch = k.c0 + sub * 4;
    T* dst = dvalue + ((tok0 + i) * H + k.h) * D + ch;
    if (vec4 && ch + 3 < D) {
      Store4<T>::put(dst, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ch + e < D) dst[e] = from_float<T>(v[e]);
    }
  }
}

// The d_loc / d_attn blocks' rule for deform_point::dloc_walk: the corner
// terms above (a point takes part when x0 and y0 lie in [-1, size]; its
// corners on the zero border count as value 0) and the TPU kernel's formula,
// with e_c = dout . v_c:
//   d_attn = sum_c b_c e_c,
//   d_x = a * [(1-ty)(e01 - e00) + ty (e11 - e10)] * W_l,
//   d_y = a * [(1-tx)(e10 - e00) + tx (e11 - e01)] * H_l.
struct OneHotRule {
  static __device__ __forceinline__ int footprint(float lx, float ly, int Hl, int Wl,
                                                  Footprint* f) {
    Corners c;
    const Pt kind = corner_terms(make_float2(lx, ly), Hl, Wl, &c);
    if (kind != Pt::HIT) return kind == Pt::NONFINITE ? -1 : 0;
    f->t00 = c.y0 * Wl + c.x0;
    f->tx = c.tx;
    f->ty = c.ty;
    f->in_x0 = c.x0 >= 0 && c.x0 < Wl;
    f->in_x1 = c.x0 + 1 < Wl;  // x0 >= -1
    f->in_y0 = c.y0 >= 0 && c.y0 < Hl;
    f->in_y1 = c.y0 + 1 < Hl;
    return 1;
  }
  static __device__ __forceinline__ void grads(const Footprint& f, float a, int Hl, int Wl,
                                               const float* e, float* d_attn, float* dx,
                                               float* dy) {
    const float tx = f.tx, ty = f.ty;
    *d_attn = (1.f - tx) * (1.f - ty) * e[0] + tx * (1.f - ty) * e[1] +
              (1.f - tx) * ty * e[2] + tx * ty * e[3];
    *dx = a * ((1.f - ty) * (e[1] - e[0]) + ty * (e[3] - e[2])) * (float)Wl;
    *dy = a * ((1.f - tx) * (e[2] - e[0]) + tx * (e[3] - e[1])) * (float)Hl;
  }
};

template <typename T, int DGP, int VEC>
__global__ void __launch_bounds__(BWD_THREADS, 2)
ms_deform_attn_dense_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                const float* __restrict__ attn, const T* __restrict__ dout,
                                T* __restrict__ dvalue, float* __restrict__ dloc,
                                float* __restrict__ dattn, int S, int Q, int H, int D, int L,
                                int P, const __grid_constant__ Levels lv,
                                const __grid_constant__ Units un, int n_units, int band_max,
                                int n_dv_blocks, int n_bh, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < n_dv_blocks) {
    dvalue_block<T, DGP>(loc, attn, dout, dvalue, S, Q, H, D, L, P, lv, un, n_units, band_max,
                         blockIdx.x, n_bh, vec4, smem);
  } else {  // a d_loc / d_attn block: (b, h, BWD_THREADS points) from device memory
    const deform_point::DlocBlock k = deform_point::dloc_block_of(
        blockIdx.x - n_dv_blocks, BWD_THREADS, Q * L * P, H);
    const int64_t row = (int64_t)H * D;
    deform_point::dloc_walk<OneHotRule, T, VEC, 0>(value + k.b * S * row + (int64_t)k.h * D,
                                                   row, loc, attn, dout, dloc, dattn, k.b, k.h, Q,
                                                   H, D, L, P, lv, k.first, k.last);
  }
}

// The d_loc / d_attn blocks on the staged slab are a kernel of their own:
// deform_point::ms_deform_attn_dloc_slab_kernel under OneHotRule (a block per
// (b, h), 512 threads), free of the d_value blocks' register cap and shared
// memory. On an H100 at the flagship encoder (bf16) the whole adjoint took
// 0.7198 ms so, against 0.7383-0.7607 with the staged blocks inside the
// d_value blocks' launch (256 threads, 128 registers, two blocks an SM); at
// the decoder the unstaged blocks inside that launch (0.0590 in all) beat a
// second launch (0.0635).

// ---------------------------------------------------------------- host side

// The adjoint's d_value units: each level whole, or cut into the fewest equal
// bands of at most the tokens the lane groups hold (dv_band_tokens). 0 or
// -9 (too many).
int make_units(const Levels& lv, int L, int DGP, Units* un, int* n_units, int* band_max) {
  const int per = dv_band_tokens(DGP);
  int n = 0, mx = 0;
  for (int l = 0; l < L; ++l) {
    const int nl = lv.h[l] * lv.w[l];
    const int bands = (nl + per - 1) / per;
    const int size = (nl + bands - 1) / bands;
    for (int t = 0; t < nl; t += size) {
      if (n == MAX_UNITS) return -9;
      un->level[n] = l;
      un->t0[n] = t;
      un->n[n] = nl - t < size ? nl - t : size;
      mx = un->n[n] > mx ? un->n[n] : mx;
      ++n;
    }
  }
  *n_units = n;
  *band_max = mx;
  return 0;
}

int levels_tokens(const Levels& lv, int L) {
  int s = 0;
  for (int l = 0; l < L; ++l) s += lv.h[l] * lv.w[l];
  return s;
}

// channels a block covers: min(D, 64) rounded up to 8, as 8-column tiles
int col_tiles(int D) { return ((D < 64 ? D : 64) + 7) / 8; }

// the power of two >= the column tiles (the template's NT; DGP = 8 NT)
int pow2_tiles(int D) {
  const int n = col_tiles(D);
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

template <typename T, int NT>
int launch_fwd(const void* value, const float* loc, const float* attn, void* out, int B, int S,
               int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  const int S_lv = levels_tokens(lv, L);
  const int n_chunks = (S_lv + KC - 1) / KC;
  const int n_qt = (Q + QT - 1) / QT, n_bh = B * H, n_groups = (D + NT * 8 - 1) / (NT * 8);
  const int64_t blocks = (int64_t)n_qt * n_bh * n_groups;
  if (blocks == 0) return 0;
  const size_t smem = fwd_smem_bytes(n_chunks, L * P, NT * 8, (int)sizeof(T));
  auto kernel = ms_deform_attn_dense_fwd_kernel<T, NT>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  const bool async16 = (D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(value) % 16 == 0;
  kernel<<<(unsigned)blocks, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv, S_lv,
      n_chunks, n_qt, n_bh, async16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_nt(int nt, const void* value, const float* loc, const float* attn, void* out,
                  int B, int S, int Q, int H, int D, int L, int P, const Levels& lv,
                  cudaStream_t s) {
  switch (nt) {
    case 1: return launch_fwd<T, 1>(value, loc, attn, out, B, S, Q, H, D, L, P, lv, s);
    case 2: return launch_fwd<T, 2>(value, loc, attn, out, B, S, Q, H, D, L, P, lv, s);
    case 4: return launch_fwd<T, 4>(value, loc, attn, out, B, S, Q, H, D, L, P, lv, s);
    default: return launch_fwd<T, 8>(value, loc, attn, out, B, S, Q, H, D, L, P, lv, s);
  }
}

// part: 0 = d_value and d_loc / d_attn blocks (a block per (b, h,
// BWD_THREADS points) from device memory), 1 = d_value blocks alone, 2 =
// d_loc / d_attn blocks alone.
template <typename T, int DGP, int VEC>
int launch_bwd(const void* value, const float* loc, const float* attn, const void* dout,
               void* dvalue, float* dloc, float* dattn, int B, int S, int Q, int H, int D, int L,
               int P, const Levels& lv, int part, cudaStream_t stream) {
  if (dv_tile_queries(P) * P > TILE_PTS) return -2;
  Units un;
  int n_units = 0, band_max = 0;
  const int rc = make_units(lv, L, DGP, &un, &n_units, &band_max);
  if (rc != 0) return rc;
  const int n_bh = B * H, n_groups = (D + DGP - 1) / DGP;
  const int64_t n_dv = part == 2 ? 0 : (int64_t)n_units * n_bh * n_groups;
  const int n_pts = Q * L * P;
  const int64_t n_dl =
      part == 1 ? 0 : (int64_t)n_bh * ((n_pts + BWD_THREADS - 1) / BWD_THREADS);
  if (n_dv + n_dl == 0) return 0;
  const size_t smem = n_dv ? dv_smem_bytes(band_max, DGP, P) : 0;
  auto kernel = ms_deform_attn_dense_bwd_kernel<T, DGP, VEC>;
  static size_t granted[deform_point::kMaxDevices];
  const int g = deform_point::grant_smem(kernel, smem, granted);
  if (g != 0) return g;
  kernel<<<(unsigned)(n_dv + n_dl), BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<const T*>(dout),
      static_cast<T*>(dvalue), dloc, dattn, S, Q, H, D, L, P, lv, un, n_units, band_max,
      (int)n_dv, n_bh,
      D % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % (4 * sizeof(T)) == 0 &&
          reinterpret_cast<uintptr_t>(dvalue) % (4 * sizeof(T)) == 0);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_dgp(int nt, const void* value, const float* loc, const float* attn,
                   const void* dout, void* dvalue, float* dloc, float* dattn, int B, int S, int Q,
                   int H, int D, int L, int P, const Levels& lv, int part, cudaStream_t s) {
  switch (nt) {
    case 1: return launch_bwd<T, 8, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, part, s);
    case 2: return launch_bwd<T, 16, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, part, s);
    case 4: return launch_bwd<T, 32, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, part, s);
    default: return launch_bwd<T, 64, VEC>(value, loc, attn, dout, dvalue, dloc, dattn, B, S, Q, H, D, L, P, lv, part, s);
  }
}

}  // namespace

extern "C" {

// Each returns 0 on success, a negative code for arguments the kernel does
// not take (-7: more shared memory than a block may opt into; -9: a level
// too large for the d_value units), or the cudaError_t of the launch
// (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16 (of value, out, dout and d_value)
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec (adjoint): channels per lane of the d_loc / d_attn gather, 1 or the
//        16-byte width of the value (4 f32, 8 bf16)
//   part (adjoint): 0 = every output; 1 = d_value only; 2 = d_loc and
//        d_attn only (the two kinds of block timed alone)

int poet_ms_deform_attn_dense_fwd(const void* value, const void* loc, const void* attn,
                                  void* out, int dtype, int B, int S, int Q, int H, int D, int L,
                                  int P, const int* level_hw, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D < 1 || P < 1) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = pow2_tiles(D);
  if (dtype == 0) return launch_fwd_nt<float>(nt, value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  if (dtype == 1)
    return launch_fwd_nt<__nv_bfloat16>(nt, value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  return -5;
}

// d_value: every token row of the levels written (the caller zeroes the rows
// past them); d_loc and d_attn: every element written.
int poet_ms_deform_attn_dense_bwd(const void* value, const void* loc, const void* attn,
                                  const void* dout, void* dvalue, void* dloc, void* dattn,
                                  int dtype, int B, int S, int Q, int H, int D, int L, int P,
                                  const int* level_hw, int vec, int part, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D < 1 || P < 1 || vec < 1 || D % vec != 0) return -2;
  if (part < 0 || part > 2) return -6;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = pow2_tiles(D);
  if (dtype == 0 && vec == 4)
    return launch_bwd_dgp<float, 4>(nt, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, part, s);
  if (dtype == 0 && vec == 1)
    return launch_bwd_dgp<float, 1>(nt, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, part, s);
  if (dtype == 1 && vec == 8)
    return launch_bwd_dgp<__nv_bfloat16, 8>(nt, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, part, s);
  if (dtype == 1 && vec == 1)
    return launch_bwd_dgp<__nv_bfloat16, 1>(nt, value, locf, attf, dout, dvalue, dl, da, B, S, Q, H, D, L, P, lv, part, s);
  return -5;
}

// The d_loc / d_attn blocks on the staged value slab (a block per (b, h),
// S * D * sizeof(value) bytes of shared memory: -7 over the device's opt-in
// limit), in a launch of their own; every element of d_loc and d_attn
// written. vec: 1 or the 16-byte width of the value (4 f32, 8 bf16).
int poet_ms_deform_attn_dense_dloc_slab(const void* value, const void* loc, const void* attn,
                                        const void* dout, void* dloc, void* dattn, int dtype,
                                        int B, int S, int Q, int H, int D, int L, int P,
                                        const int* level_hw, int vec, void* stream) {
  return deform_point::dloc_entry<OneHotRule, true>(value, loc, attn, dout, dloc, dattn, dtype, B,
                                                    S, Q, H, D, L, P, level_hw, vec, stream);
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
