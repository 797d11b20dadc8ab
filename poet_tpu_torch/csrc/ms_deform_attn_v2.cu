// Multi-scale deformable attention, forward, separable v2 contract — CUDA for
// Hopper (sm_90a), on a zero-bordered value slab that TMA stages into each
// CTA of a (b, h), by multicast where two CTAs form a cluster.
//
// Replaces the TPU kernel poet_tpu/ops/deform_attn_pallas_v2.py:_fwd_kernel
// (reached through ms_deform_attn_pallas_v2). That kernel keeps a padded
// value slab (B, H, sum Hp, max_Wp * D) resident in VMEM, with a 1-texel zero
// border around every level, and samples it with two one-hot matmuls (a y-mix
// over the rows, an x-mix reduced by a block-identity matrix): the border
// makes every corner of a point whose base lies in [-1, W] x [-1, H] land on
// data or on a zero, so no corner needs a bounds check. This kernel keeps the
// idea and drops the matmuls: Hopper gathers from shared memory directly.
//
//   value  (B, S, H, D)        f32 or bf16, levels concatenated along S
//   loc    (B, Q, H, L, P, 2)  f32, normalized to [0, 1], (x, y) order
//   attn   (B, Q, H, L, P)     f32
//   out    (B, Q, H * D)       value dtype, accumulated in f32
//
// Sampling: pixel = loc * size - 0.5, computed as two roundings
// (__fmul_rn, __fsub_rn) as JAX and grid_sample do: nvcc would otherwise
// contract it into one FMA and could floor a point on a cell edge into the
// neighbouring cell. A point counts when its base corner (floor x, floor y)
// lies in [-1, W - 1] x [-1, H - 1]; its padded base (base + 1) then lies in
// [0, W] x [0, H], and its four corners in the padded (H + 2) x (W + 2) level,
// on data or on the zero border. v2 also keeps a base of exactly W or H: all
// four of its corners read zeros there, so skipping it adds the same 0. Any
// other finite point is skipped. A point with a NaN or infinite coordinate
// reads nothing and makes its (b, q, h) output row NaN: the C1 rule of the
// gather kernels (csrc/ms_deform_attn_point.cuh) and of the plain version.
//
// Layout. The queries of one (b, h) are taken by n <= 8 CTAs, each CTA a
// chunk of queries, each thread one (query, 16-byte channel slice): 8 bf16
// or 4 f32 channels of the head. The padded levels of the (b, h) are staged
// into each CTA's shared memory in the value's dtype, row by padded row
// (cells of D values), each row at a pitch rounded up to 128 bytes (a TMA
// box's shared-memory destination must be 128-byte aligned). The rows are
// cut into BANDS (ops/deform_attn_v2_cuda.py:plan_v2): one band where the
// whole slab fits the 227 KB a block may use (the flagship pyramid, 62 KB
// in bf16; the YOLO pyramid, 223 KB in bf16), else bands within half of it,
// double-buffered. With one band a CTA takes its queries in passes of up to
// 1024 threads, and the plan gives a (b, h) as many CTAs as one wave of the
// card holds: one at B H = 256 (measured on the H100: every SM a CTA runs
// on receives the whole slab, multicast or not: 2-8 CTAs of a (b, h) took
// 0.1380-0.1791 ms at the encoder shape in bf16 where one took 0.1278,
// tools/bench_v2.py --ctas). With several bands a CTA takes one pass, its
// points kept in registers across the bands where L P <= 16, and a (b, h)
// as many CTAs as its queries need.
//
// Staging. One tiled tensor map per level over value viewed as
// (D, H, W_l, H_l, B) with its real strides, based at the level's first
// token; a box of (D, 1, W_l + 2, 1, 1) at (0, h, -1, y, b) lands padded row
// y + 1 of the level, its two border cells (and the whole rows y = -1 and
// y = H_l) filled with zeros by TMA's out-of-bounds fill. No thread computes
// a level, a divide or a border test. Where a (b, h) takes two CTAs they
// form a cluster, and each issues every other row box of a band with
// .multicast::cluster to both, so a band crosses the L2 once per cluster,
// not once per CTA (larger clusters, and clusters over several bands, ran
// slower than CTAs staging alone: tools/bench_v2.py --split). Completion is
// counted on one mbarrier per buffer, each CTA's expecting the whole band's
// bytes (a multicast write lands in every CTA); a cluster barrier before a
// buffer is staged again keeps one CTA from overwriting a buffer that a
// peer still reads. With two buffers, band k + 1 lands while band k is
// walked. Where TMA cannot describe the value (a head of D x itemsize not a
// multiple of 16 bytes, such as D = 6; a base off 16 bytes; a level of
// W + 2 > 256 cells) the plan stages by the CTA's threads instead, value by
// value with the border written as zeros, in clusters of one: a cell is
// then D values rounded up to 16 bytes, its channels past D zeros, and the
// output row is stored value by value.
//
// Walk. Each thread adds the corners of a band's rows to its f32
// accumulator in registers; a corner row belongs to exactly one band, so the
// two rows of a point may be added in two bands. A query's locations and
// weights are read 8 points at a time into registers (16-byte loads where
// L P allows), which keeps 12 loads in flight a thread; kept points (KEEP)
// hold their slab offsets and weights across the bands instead.
//
// What bounds it: at the flagship encoder shape the function must move ~105
// MB (value, locations, attention, output: 0.031 ms at 3.35 TB/s); the TPU
// kernel's two one-hot products per point are 0.17 ms of bf16 tensor-core
// work, which a gather does not do. A (b, h) slab of 60 KB (its boxes)
// crosses the L2 once: ~15 MB at that shape, where one staging per 256-query
// block moved ~108 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tma_sm90.cuh"

#define POET_MAX_LEVELS 8
#define POET_V2_MAX_BANDS 64
#define POET_V2_MAX_CLUSTER 8
#define POET_V2_KEEP 16        // points a thread keeps in registers across bands
#define POET_V2_CHUNK 8        // points a thread reads at once where it keeps none
#define POET_V2_ALIGN 128      // a TMA box's shared-memory destination
#define POET_V2_HEAD 128       // the two mbarriers, padded to POET_V2_ALIGN

namespace {

struct Maps {
  CUtensorMap level[POET_MAX_LEVELS];
};

struct Levels {
  int h[POET_MAX_LEVELS];
  int w[POET_MAX_LEVELS];
  int tok[POET_MAX_LEVELS];       // first token of the level in S
  int row_off[POET_MAX_LEVELS];   // first padded row of the level
  int byte_off[POET_MAX_LEVELS];  // its byte offset in the pitched slab
  int pitch[POET_MAX_LEVELS];     // bytes between the level's padded rows
};

// Band k holds padded rows [row[k], row[k + 1]) = slab bytes
// [byte[k], byte[k + 1]); its boxes bring tx[k] bytes.
struct Bands {
  int n;
  int row[POET_V2_MAX_BANDS + 1];
  int byte[POET_V2_MAX_BANDS + 1];
  int tx[POET_V2_MAX_BANDS];
};

struct Plan {
  int S, Q, H, D, L, P;
  int cell;       // bytes of a staged cell: D values, rounded up to 16 bytes
  bool tma;       // staged by TMA boxes; else by the CTA's threads (cluster of 1)
  int q_per_cta;  // queries of one CTA
  int cluster;    // CTAs of a cluster
  int buffers;    // 1 or 2
  int buf_bytes;  // bytes of one buffer
  bool vec4;      // a query's locations and weights read 16 bytes at a time
};

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void fma(const unsigned char* p, float w, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  static __device__ __forceinline__ void store_n(float* p, const float* acc, int n) {
    for (int j = 0; j < n; ++j) p[j] = acc[j];
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(const unsigned char* p, float w, float* acc) {
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
  static __device__ __forceinline__ void store_n(__nv_bfloat16* p, const float* acc, int n) {
    for (int j = 0; j < n; ++j) p[j] = __float2bfloat16_rn(acc[j]);
  }
};

// ---- PTX: the cluster barrier, TMA (shared addresses and mbarriers: tma_sm90.cuh)
using tma_sm90::mbar_expect_tx;
using tma_sm90::mbar_init;
using tma_sm90::mbar_wait;
using tma_sm90::shared_addr;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: release what it wrote, acquire
// what the others wrote
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ void tma_row(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        uint16_t mask, int h, int y, int b) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  const int zero = 0, left = -1;
  if (mask == 1) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
        "l"(desc), "r"(bar), "r"(zero), "r"(h), "r"(left), "r"(y), "r"(b)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%4, %5, %6, %7, %8}], [%2], %3;" ::"r"(dst),
        "l"(desc), "r"(bar), "h"(mask), "r"(zero), "r"(h), "r"(left), "r"(y), "r"(b)
        : "memory");
  }
}

// Warp 0 of each CTA: expect band k's bytes on the buffer's barrier, then
// issue this CTA's share of its row boxes (every n-th row) to every CTA.
__device__ __forceinline__ void stage_band(const Maps& maps, const Levels& lv, const Bands& bd,
                                           const Plan& pl, int k, unsigned char* bufs,
                                           uint64_t* bars, int h, int b) {
  if (threadIdx.x >= 32) return;
  const int j = k % pl.buffers;
  const uint32_t bar = shared_addr(&bars[j]);
  const uint32_t buf = shared_addr(bufs + j * pl.buf_bytes);
  if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)bd.tx[k]);
  __syncwarp();
  const int n = pl.cluster;
  const uint16_t mask = (uint16_t)((1u << n) - 1u);
  for (int r = bd.row[k] + (int)cluster_rank() + (int)threadIdx.x * n; r < bd.row[k + 1];
       r += 32 * n) {
    int l = 0;
    while (l + 1 < pl.L && r >= lv.row_off[l + 1]) ++l;
    const int pr = r - lv.row_off[l];  // padded row: real row pr - 1
    const uint32_t dst = buf + (uint32_t)(lv.byte_off[l] + pr * lv.pitch[l] - bd.byte[k]);
    tma_row(dst, &maps.level[l], bar, mask, h, pr - 1, b);
  }
}

template <typename T>
struct Bits;  // a value's bits: the threads' staging copies them
template <>
struct Bits<float> {
  using type = uint32_t;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};

// Every thread of the CTA, where TMA cannot describe the value (a head of
// D x itemsize not a multiple of 16 bytes, a base off 16 bytes, a level of
// W + 2 > 256 cells): band k's padded rows copied value by value, the border
// and a cell's channels past D written as zeros.
template <typename T>
__device__ __forceinline__ void copy_band(const T* __restrict__ value, const Levels& lv,
                                          const Bands& bd, const Plan& pl, int k,
                                          unsigned char* bufs, int h, int b) {
  using R = typename Bits<T>::type;
  const R* src = reinterpret_cast<const R*>(value);
  R* buf = reinterpret_cast<R*>(bufs + (k % pl.buffers) * pl.buf_bytes);
  const int dp = pl.cell / (int)sizeof(T);
  for (int r = bd.row[k]; r < bd.row[k + 1]; ++r) {
    int l = 0;
    while (l + 1 < pl.L && r >= lv.row_off[l + 1]) ++l;
    const int y = r - lv.row_off[l] - 1;
    R* dst = buf + (lv.byte_off[l] + (y + 1) * lv.pitch[l] - bd.byte[k]) / (int)sizeof(T);
    const bool in_y = y >= 0 && y < lv.h[l];
    const int64_t row0 = ((int64_t)b * pl.S + lv.tok[l] + (int64_t)y * lv.w[l]) * pl.H + h;
    for (int i = threadIdx.x; i < (lv.w[l] + 2) * dp; i += blockDim.x) {
      const int x = i / dp - 1;
      const int e = i - (x + 1) * dp;
      R v = 0;
      if (in_y && x >= 0 && x < lv.w[l] && e < pl.D) {
        v = src[(row0 + (int64_t)x * pl.H) * pl.D + e];
      }
      dst[i] = v;
    }
  }
}

// Band k into its buffer: by TMA (warp 0 issues, the buffer's mbarrier
// counts) or by every thread of the CTA (a __syncthreads in wait_band ends it).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ value, const Maps& maps,
                                      const Levels& lv, const Bands& bd, const Plan& pl, int k,
                                      unsigned char* bufs, uint64_t* bars, int h, int b) {
  if (pl.tma) {
    stage_band(maps, lv, bd, pl, k, bufs, bars, h, b);
  } else {
    copy_band<T>(value, lv, bd, pl, k, bufs, h, b);
  }
}

// every thread of the CTA: band k has landed in its buffer
__device__ __forceinline__ void wait_band(const Plan& pl, uint64_t* bars, int k) {
  if (pl.tma) {
    mbar_wait(shared_addr(&bars[k % pl.buffers]), (uint32_t)((k / pl.buffers) & 1));
  } else {
    __syncthreads();
  }
}

// One sampling point: its top corners' slab byte offset `top` (the bottom
// row's is `top` + the level's pitch), the rows' weights and tx; top = -1
// where the point reads nothing. Sets *nonfinite for a NaN or infinite
// coordinate.
struct Point {
  int top, bottom;
  float wt, wb, tx;
};

__device__ __forceinline__ Point make_point(const Levels& lv, int l, int cell, float lx, float ly,
                                            float a, bool* nonfinite) {
  Point pt{-1, -1, 0.f, 0.f, 0.f};
  const int Hl = lv.h[l];
  const int Wl = lv.w[l];
  const float x = __fsub_rn(__fmul_rn(lx, (float)Wl), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)Hl), 0.5f);
  // base outside [-1, W-1] x [-1, H-1] (NaN too): skip; a non-finite
  // coordinate also makes the row NaN (C1)
  if (!(x >= -1.f && x < (float)Wl && y >= -1.f && y < (float)Hl)) {
    *nonfinite |= !(isfinite(x) && isfinite(y));
    return pt;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float ty = y - y0f;
  pt.tx = x - x0f;
  pt.wt = (1.f - ty) * a;
  pt.wb = ty * a;
  pt.top = lv.byte_off[l] + ((int)y0f + 1) * lv.pitch[l] + ((int)x0f + 1) * cell;
  pt.bottom = pt.top + lv.pitch[l];
  return pt;
}

// add the point's corners whose row lies in the band [lo, hi) of the slab
template <typename T, int VEC>
__device__ __forceinline__ void add_point(const Point& pt, const unsigned char* band, int lo,
                                          int hi, int cell, float* acc) {
  if (pt.top >= lo && pt.top < hi) {
    const unsigned char* s = band + (pt.top - lo);
    Vec<T, VEC>::fma(s, (1.f - pt.tx) * pt.wt, acc);
    Vec<T, VEC>::fma(s + cell, pt.tx * pt.wt, acc);
  }
  if (pt.bottom >= lo && pt.bottom < hi) {
    const unsigned char* s = band + (pt.bottom - lo);
    Vec<T, VEC>::fma(s, (1.f - pt.tx) * pt.wb, acc);
    Vec<T, VEC>::fma(s + cell, pt.tx * pt.wb, acc);
  }
}

// Points [k0, k0 + POET_V2_CHUNK) of a query: their locations and weights
// read into registers at once (16-byte loads where vec4), then each added.
template <typename T, int VEC>
__device__ __forceinline__ void add_chunk(const Levels& lv, const Plan& pl, int k0,
                                          const float* loc_p, const float* att_p,
                                          const unsigned char* band, int lo, int hi, int cell,
                                          float* acc, bool* nonfinite) {
  const int LP = pl.L * pl.P;
  float lx[POET_V2_CHUNK], ly[POET_V2_CHUNK], a[POET_V2_CHUNK];
  if (pl.vec4 && k0 + POET_V2_CHUNK <= LP) {
    const float4* l4 = reinterpret_cast<const float4*>(loc_p + 2 * k0);
    const float4* a4 = reinterpret_cast<const float4*>(att_p + k0);
#pragma unroll
    for (int j = 0; j < POET_V2_CHUNK / 2; ++j) {
      const float4 v = __ldg(l4 + j);
      lx[2 * j] = v.x;
      ly[2 * j] = v.y;
      lx[2 * j + 1] = v.z;
      ly[2 * j + 1] = v.w;
    }
#pragma unroll
    for (int j = 0; j < POET_V2_CHUNK / 4; ++j) {
      const float4 v = __ldg(a4 + j);
      a[4 * j] = v.x;
      a[4 * j + 1] = v.y;
      a[4 * j + 2] = v.z;
      a[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < POET_V2_CHUNK; ++j) {
      if (k0 + j < LP) {
        const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_p) + k0 + j);
        lx[j] = xy.x;
        ly[j] = xy.y;
        a[j] = __ldg(att_p + k0 + j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < POET_V2_CHUNK; ++j) {
    if (k0 + j < LP) {
      const Point pt = make_point(lv, (k0 + j) / pl.P, cell, lx[j], ly[j], a[j], nonfinite);
      add_point<T, VEC>(pt, band, lo, hi, cell, acc);
    }
  }
}

template <typename T, int VEC, bool KEEP>
__global__ void __launch_bounds__(KEEP ? 512 : 1024)
ms_deform_attn_v2_kernel(const __grid_constant__ Maps maps, const T* __restrict__ value,
                         const float* __restrict__ loc,
                         const float* __restrict__ attn, T* __restrict__ out, const Levels lv,
                         const Bands bd, const Plan pl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* head =
      smem_raw + ((POET_V2_ALIGN - (shared_addr(smem_raw) & (POET_V2_ALIGN - 1))) &
                  (POET_V2_ALIGN - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(head);
  unsigned char* bufs = head + POET_V2_HEAD;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int cell = pl.cell;
  const int chunks = cell / 16;
  const int c = (int)threadIdx.x % chunks;
  const int per_group = (int)blockDim.x / chunks;  // queries a pass of the CTA takes
  const int q_first = blockIdx.x * pl.q_per_cta;
  const int q_end = min(pl.Q, q_first + pl.q_per_cta);
  const int LP = pl.L * pl.P;

  if (threadIdx.x == 0) {
    mbar_init(shared_addr(&bars[0]), 1);
    mbar_init(shared_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before a peer's box lands in it
  for (int k = 0; k < pl.buffers && k < bd.n; ++k) {
    stage<T>(value, maps, lv, bd, pl, k, bufs, bars, h, b);
  }

  // the CTA's queries in passes of per_group (one pass where the slab takes
  // several bands); a pass's points are read while band 0 lands
  for (int q0 = q_first; q0 < q_end; q0 += per_group) {
    const int q = q0 + (int)threadIdx.x / chunks;
    const bool active = (int)threadIdx.x < per_group * chunks && q < q_end;
    const int64_t bqh = ((int64_t)b * pl.Q + (active ? q : 0)) * pl.H + h;
    const float* loc_p = loc + bqh * LP * 2;
    const float* att_p = attn + bqh * LP;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    bool nonfinite = false;
    Point kept[KEEP ? POET_V2_KEEP : 1];
    if (KEEP) {  // L P <= 16: every point's offsets and weights in registers, once
      float2 xy[KEEP ? POET_V2_KEEP : 1];
      float a[KEEP ? POET_V2_KEEP : 1];
#pragma unroll
      for (int kp = 0; kp < (KEEP ? POET_V2_KEEP : 1); ++kp) {
        if (active && kp < LP) {
          xy[kp] = __ldg(reinterpret_cast<const float2*>(loc_p) + kp);
          a[kp] = __ldg(att_p + kp);
        }
      }
#pragma unroll
      for (int kp = 0; kp < (KEEP ? POET_V2_KEEP : 1); ++kp) {
        kept[kp] = Point{-1, -1, 0.f, 0.f, 0.f};
        if (active && kp < LP) {
          kept[kp] = make_point(lv, kp / pl.P, cell, xy[kp].x, xy[kp].y, a[kp], &nonfinite);
        }
      }
    }
    for (int k = 0; k < bd.n; ++k) {
      const int j = k % pl.buffers;
      if (q0 == q_first) wait_band(pl, bars, k);
      const unsigned char* band = bufs + j * pl.buf_bytes + c * 16;
      const int lo = bd.byte[k];
      const int hi = bd.byte[k + 1];
      if (active) {
        if (KEEP) {
#pragma unroll
          for (int kp = 0; kp < (KEEP ? POET_V2_KEEP : 1); ++kp) {
            add_point<T, VEC>(kept[kp], band, lo, hi, cell, acc);
          }
        } else {
          for (int k0 = 0; k0 < LP; k0 += POET_V2_CHUNK) {
            add_chunk<T, VEC>(lv, pl, k0, loc_p, att_p, band, lo, hi, cell, acc, &nonfinite);
          }
        }
      }
      if (k + pl.buffers < bd.n) {
        cluster_sync();  // every CTA of the cluster is done with buffer j
        stage<T>(value, maps, lv, bd, pl, k + pl.buffers, bufs, bars, h, b);
      }
    }
    if (nonfinite) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __int_as_float(0x7fc00000);
    }
    if (active && pl.D * (int)sizeof(T) % 16 == 0) {
      Vec<T, VEC>::store(out + bqh * pl.D + c * VEC, acc);
    } else if (active) {  // a narrow head: its row is off 16 bytes, its last slice partial
      Vec<T, VEC>::store_n(out + bqh * pl.D + c * VEC, acc, min(VEC, pl.D - c * VEC));
    }
  }
  if (q_first >= q_end) {  // a CTA without queries still waits for what lands in it
    for (int k = 0; k < bd.n; ++k) {
      wait_band(pl, bars, k);
      if (k + pl.buffers < bd.n) {
        cluster_sync();
        stage<T>(value, maps, lv, bd, pl, k + pl.buffers, bufs, bars, h, b);
      }
    }
  }
  cluster_sync();  // no CTA leaves while a box it issued may still land in a peer
}

// ---- host: the plan check, the launch (the encoder: tma_sm90.cuh) ----
using tma_sm90::EncodeTiled;
using tma_sm90::encoder;

// the launch configurations whose cluster occupancy was checked, and the
// shared memory granted each kernel, per device (ctypes releases the
// interpreter lock: two threads may launch at once)
struct Checked {
  const void* kernel;
  int device, smem, threads, cluster;
};
Checked g_checked[64];
int g_n_checked = 0;
struct Granted {
  const void* kernel;
  int device, smem;
};
Granted g_granted[16];
int g_n_granted = 0;
std::mutex g_checked_mutex;

// Before a plan's first launch: the kernel's dynamic shared memory raised to
// at least `smem` (never lowered: an earlier plan may need more), then
// cudaOccupancyMaxActiveClusters for the plan. 0, a cudaError_t, or -20
// when the plan's cluster cannot be scheduled.
int check_plan(const void* kernel, const cudaLaunchConfig_t& cfg, int smem, int threads,
               int cluster) {
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> lock(g_checked_mutex);
  for (int i = 0; i < g_n_checked; ++i) {
    const Checked& c = g_checked[i];
    if (c.kernel == kernel && c.device == device && c.smem == smem && c.threads == threads &&
        c.cluster == cluster) {
      return 0;
    }
  }
  int g = 0;
  while (g < g_n_granted && !(g_granted[g].kernel == kernel && g_granted[g].device == device)) {
    ++g;
  }
  if (g == g_n_granted || g_granted[g].smem < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (g == g_n_granted && g_n_granted < 16) ++g_n_granted;
    if (g < 16) g_granted[g] = Granted{kernel, device, smem};
  }
  int active = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return -20;
  if (g_n_checked < 64) g_checked[g_n_checked++] = Checked{kernel, device, smem, threads, cluster};
  return 0;
}

template <typename T, int VEC, bool KEEP>
int launch(const Maps& maps, const void* value, const float* loc, const float* attn, void* out,
           int B,
           const Levels& lv, const Bands& bd, const Plan& pl, int clusters, int threads,
           int smem, cudaStream_t stream) {
  auto kernel = ms_deform_attn_v2_kernel<T, VEC, KEEP>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster * clusters, pl.H, B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = check_plan(reinterpret_cast<const void*>(kernel), cfg, smem, threads,
                            pl.cluster);
  if (rc != 0) return rc;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, maps, static_cast<const T*>(value), loc,
                                           attn, static_cast<T*>(out), lv, bd, pl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-20: the cluster cannot be scheduled; -21: no tensor-map encoder in
// libcuda; -22: libcuda refused a level's tensor map), or a
// cudaError_t otherwise.
//   dtype: 0 = float32, 1 = bfloat16
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   band_rows: host array of n_bands + 1 ints, the first padded row of each
//     band and then the total: the bands must tile the padded rows in order
//   buffers: 1, or 2 (band k + 1 staged while band k is walked)
//   cluster: CTAs of a cluster; clusters: clusters per (b, h); q_per_cta:
//     queries of one CTA; threads: per CTA, q_per_cta x the cell's 16-byte
//     slices (D x itemsize rounded up to 16 bytes, / 16) rounded up to a
//     warp; keep: each thread keeps its points in registers across bands
//   tma: 1 = the slab staged by TMA (D x itemsize a multiple of 16 bytes,
//     D <= 256, value 16-byte aligned, every W_l + 2 <= 256); 0 = by the
//     CTA's threads, in clusters of one
int poet_ms_deform_attn_v2_fwd(const void* value, const void* loc, const void* attn, void* out,
                               int dtype, int B, int S, int Q, int H, int D, int L, int P,
                               const int* level_hw, const int* band_rows, int n_bands,
                               int buffers, int cluster, int clusters, int q_per_cta,
                               int threads, int keep, int tma, void* stream) {
  if (L < 1 || L > POET_MAX_LEVELS) return -1;
  const int elem = dtype == 0 ? 4 : 2;
  const int cell = (D * elem + 15) / 16 * 16;  // a staged cell
  if (dtype < 0 || dtype > 1 || D < 1 || (uintptr_t)out % 16 != 0) return -2;
  if (tma && (cell != D * elem || D > 256 || (uintptr_t)value % 16 != 0)) return -2;
  if (n_bands < 1 || n_bands > POET_V2_MAX_BANDS || buffers < 1 || buffers > 2) return -5;
  if (cluster < 1 || cluster > POET_V2_MAX_CLUSTER || clusters < 1 || q_per_cta < 1) return -5;
  if (!tma && cluster != 1) return -5;
  if ((int64_t)cluster * clusters * q_per_cta < Q) return -5;
  const int chunks = cell / 16;
  if (threads < chunks || threads % 32 != 0 || threads > (keep ? 512 : 1024)) return -8;
  // several passes of a CTA over its queries only where the slab is one band
  if (n_bands > 1 && threads < q_per_cta * chunks) return -8;
  if (keep && L * P > POET_V2_KEEP) return -8;
  Levels lv;
  int start = 0, rows = 0, bytes = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1 || (tma && lv.w[l] + 2 > 256)) return -3;
    lv.tok[l] = start;
    lv.row_off[l] = rows;
    lv.byte_off[l] = bytes;
    lv.pitch[l] = (lv.w[l] + 2) * cell;
    lv.pitch[l] = (lv.pitch[l] + POET_V2_ALIGN - 1) / POET_V2_ALIGN * POET_V2_ALIGN;
    start += lv.h[l] * lv.w[l];
    rows += lv.h[l] + 2;
    bytes += (lv.h[l] + 2) * lv.pitch[l];
  }
  if (start > S) return -4;
  Bands bd;
  bd.n = n_bands;
  if (band_rows[0] != 0 || band_rows[n_bands] != rows) return -7;
  int max_band = 0;
  for (int k = 0; k <= n_bands; ++k) {
    const int r = band_rows[k];
    if (k > 0 && r <= band_rows[k - 1]) return -7;
    int l = 0;
    while (l + 1 < L && r >= lv.row_off[l + 1]) ++l;
    bd.row[k] = r;
    bd.byte[k] = r == rows ? bytes : lv.byte_off[l] + (r - lv.row_off[l]) * lv.pitch[l];
    if (k > 0 && bd.byte[k] - bd.byte[k - 1] > max_band) max_band = bd.byte[k] - bd.byte[k - 1];
  }
  for (int k = 0; k < n_bands; ++k) {  // a band's boxes: its rows, unpitched
    bd.tx[k] = 0;
    for (int r = bd.row[k]; r < bd.row[k + 1]; ++r) {
      int l = 0;
      while (l + 1 < L && r >= lv.row_off[l + 1]) ++l;
      bd.tx[k] += (lv.w[l] + 2) * cell;
    }
  }
  const int64_t smem = POET_V2_ALIGN + POET_V2_HEAD + (int64_t)buffers * max_band;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > optin) return -6;
  if ((int64_t)B * Q * H == 0) return 0;

  Maps maps = {};
  EncodeTiled encode = tma ? encoder() : nullptr;
  if (tma && encode == nullptr) return -21;
  const char* base = static_cast<const char*>(value);
  for (int l = 0, tok = 0; tma && l < L; tok += lv.h[l] * lv.w[l], ++l) {
    const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)lv.w[l],
                                (cuuint64_t)lv.h[l], (cuuint64_t)B};
    const cuuint64_t strides[4] = {(cuuint64_t)cell, (cuuint64_t)H * cell,
                                   (cuuint64_t)lv.w[l] * H * cell, (cuuint64_t)S * H * cell};
    const cuuint32_t box[5] = {(cuuint32_t)D, 1, (cuuint32_t)(lv.w[l] + 2), 1, 1};
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    const CUresult r = encode(
        &maps.level[l],
        dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
        const_cast<char*>(base + (int64_t)tok * H * cell), dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -22;
  }
  const bool vec4 = (L * P) % 4 == 0 && ((uintptr_t)loc | (uintptr_t)attn) % 16 == 0;
  Plan pl{S, Q, H, D, L, P, cell, tma != 0, q_per_cta, cluster, buffers, max_band, vec4};
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = (int)smem;
  if (dtype == 0) {
    return keep ? launch<float, 4, true>(maps, value, locf, attf, out, B, lv, bd, pl, clusters,
                                         threads, sm, s)
                : launch<float, 4, false>(maps, value, locf, attf, out, B, lv, bd, pl, clusters,
                                          threads, sm, s);
  }
  return keep ? launch<__nv_bfloat16, 8, true>(maps, value, locf, attf, out, B, lv, bd, pl,
                                               clusters, threads, sm, s)
              : launch<__nv_bfloat16, 8, false>(maps, value, locf, attf, out, B, lv, bd, pl,
                                                clusters, threads, sm, s);
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
