// Ablations of the deformable-attention forward kernel — CUDA for Hopper
// (sm_90a), to find where its time goes.
//
// Replaces the TPU probe scripts/bench_v3_variants.py:build_variant (its
// `fwd_kernel`), which ablated the TPU forward kernel (base, unroll, qt256,
// noy, nox, bf16y, treey). It takes the per-point body of the port's forward
// kernel from the header both include, csrc/ms_deform_attn_point.cuh (the
// coordinates, the footprint test, the corners and their weights), and
// kernel 1's direct-route layout (csrc/ms_deform_attn_fwd.cu, the bf16,
// 8-channel path), and maps each TPU ablation onto the gather design with
// one template parameter:
//
//   BASE    the forward kernel's arithmetic: its output is bit-identical to
//           kernel 1's direct route;
//   UNROLL  L = P = 4 as constants, the level and point loops unrolled
//           (the TPU version unrolled its head loop);
//   QT256   two queries per thread, half the threads (the TPU version
//           halved its grid steps);
//   TREEY   one partial sum per level, added pairwise at the end (a
//           summation order);
//   BF16Y   the corner sums in packed bf16, __hfma2, the weight rounded
//           to bf16 (approximate);
//   NOY     the bilinear weight arithmetic dropped: each in-map corner is
//           weighted by the attention weight alone;
//   NOX     no gather: every corner reads its level's token 0, so what is
//           left is the arithmetic and the loop, without the L2 traffic.
//
// BASE, UNROLL and QT256 do the same arithmetic per query as the forward
// kernel; TREEY sums in another order. Their plain version is the forward
// kernel's (ops/deform_attn.py:ms_deform_attn_torch); NOY, NOX and BF16Y
// have plain definitions of their own (tools/bench_v3_variants.py). Because
// the body is the header's, the ablations measure the live kernel. Like
// kernel 1, the kernel takes its level table as a __grid_constant__
// parameter (UNROLL no longer differs from BASE in where the table lives).
//
// value (B, S, H, D) bf16 with D % 8 == 0 and 16-byte rows; loc (B, Q, H,
// L, P, 2) f32; attn (B, Q, H, L, P) f32; out (B, Q, H * D) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_point.cuh"

namespace {

using deform_point::Footprint;
using deform_point::Levels;

typedef __nv_bfloat16 T;
constexpr int VEC = 8;

enum Variant { BASE = 0, UNROLL = 1, QT256 = 2, TREEY = 3, BF16Y = 4, NOY = 5, NOX = 6 };

// acc[0:8] += w * p[0:8] (the forward kernel's Corner<__nv_bfloat16, 8>)
__device__ __forceinline__ void corner_fma(const T* p, float w, float* acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    acc[2 * j] += w * f.x;
    acc[2 * j + 1] += w * f.y;
  }
}

__device__ __forceinline__ void corner_hfma2(const T* p, float w, __nv_bfloat162* acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const __nv_bfloat162 w2 = __bfloat162bfloat162(__float2bfloat16_rn(w));
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = __hfma2(h2[j], w2, acc[j]);
}

__device__ __forceinline__ void store8(T* p, const float* acc) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The corners of one point into an accumulator: the header's body for BASE
// / UNROLL / QT256 / TREEY; the ablations change what each corner adds.
// True when the point's coordinate is not finite: the caller then stores a
// NaN row, as kernel 1 does (the header's C1 rule).
template <int V, typename Acc>
__device__ __forceinline__ bool sample_point(const T* v_l, int64_t row, int Hl, int Wl, float lx,
                                             float ly, float a, Acc* acc) {
  Footprint f;
  if (!deform_point::footprint(lx, ly, Hl, Wl, &f)) return deform_point::nonfinite(lx, ly, Hl, Wl);
  deform_point::for_each_corner(f, Wl, a, [&](int, int t, float w) {
    if constexpr (V == NOY) {         // no weight arithmetic: the attention weight alone
      corner_fma(v_l + (int64_t)t * row, a, acc);
    } else if constexpr (V == NOX) {  // no gather: the level's token 0
      corner_fma(v_l, w, acc);
    } else if constexpr (V == BF16Y) {
      corner_hfma2(v_l + (int64_t)t * row, w, acc);
    } else {
      corner_fma(v_l + (int64_t)t * row, w, acc);
    }
  });
  return false;
}

// acc[0:8] = NaN where the query met a non-finite coordinate
__device__ __forceinline__ void nan_row(bool nonfinite, float* acc) {
  if (nonfinite) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = deform_point::nan_f32();
  }
}

// One query's 8 channels of one head: the forward kernel's level and point
// loops (UNROLL: over the constants L = P = 4).
template <int V>
__device__ __forceinline__ void sample_query(const T* v_bh, const float* loc_p,
                                             const float* att_p, int64_t row, int L, int P,
                                             const Levels& lv, T* out_p) {
  if constexpr (V == BF16Y) {
    __nv_bfloat162 acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = __float2bfloat162_rn(0.f);
    bool nonfinite = false;
    for (int l = 0; l < L; ++l) {
      const T* v_l = v_bh + (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        nonfinite |= sample_point<V>(v_l, row, lv.h[l], lv.w[l], loc_p[2 * k], loc_p[2 * k + 1],
                                     att_p[k], acc);
      }
    }
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h2[j] = nonfinite ? __float2bfloat162_rn(deform_point::nan_f32()) : acc[j];
    *reinterpret_cast<uint4*>(out_p) = raw;
  } else if constexpr (V == TREEY) {
    float part[POET_MAX_LEVELS][VEC];
    bool nonfinite = false;
#pragma unroll
    for (int l = 0; l < POET_MAX_LEVELS; ++l) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[l][j] = 0.f;
      if (l < L) {
        const T* v_l = v_bh + (int64_t)lv.start[l] * row;
        for (int p = 0; p < P; ++p) {
          const int k = l * P + p;
          nonfinite |= sample_point<V>(v_l, row, lv.h[l], lv.w[l], loc_p[2 * k],
                                       loc_p[2 * k + 1], att_p[k], part[l]);
        }
      }
    }
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc[j] = ((part[0][j] + part[1][j]) + (part[2][j] + part[3][j])) +
               ((part[4][j] + part[5][j]) + (part[6][j] + part[7][j]));
    nan_row(nonfinite, acc);
    store8(out_p, acc);
  } else if constexpr (V == UNROLL) {  // L = P = 4, checked by the entry
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    bool nonfinite = false;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const T* v_l = v_bh + (int64_t)lv.start[l] * row;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = l * 4 + p;
        nonfinite |=
            sample_point<V>(v_l, row, Hl, Wl, loc_p[2 * k], loc_p[2 * k + 1], att_p[k], acc);
      }
    }
    nan_row(nonfinite, acc);
    store8(out_p, acc);
  } else {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    bool nonfinite = false;
    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const T* v_l = v_bh + (int64_t)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        nonfinite |=
            sample_point<V>(v_l, row, Hl, Wl, loc_p[2 * k], loc_p[2 * k + 1], att_p[k], acc);
      }
    }
    nan_row(nonfinite, acc);
    store8(out_p, acc);
  }
}

// One thread per (b, q, h, c) as in the forward kernel; QT256: per (b, q
// pair, h, c), the two queries 2 qp and 2 qp + 1.
template <int V>
__global__ void __launch_bounds__(256)
ms_deform_attn_fwd_variant_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                  const float* __restrict__ attn, T* __restrict__ out, int S,
                                  int Q, int H, int D, int L, int P,
                                  const __grid_constant__ Levels lv, int64_t n_items) {
  constexpr int QPT = V == QT256 ? 2 : 1;
  const int chunks = D / VEC;
  const int QG = (Q + QPT - 1) / QPT;  // query groups
  const int64_t row = (int64_t)H * D;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t gh = i / chunks;  // ((b * QG + qg) * H + h)
    const int h = (int)(gh % H);
    const int qg = (int)((gh / H) % QG);
    const int64_t b = gh / ((int64_t)QG * H);
    const T* v_bh = value + b * S * row + (int64_t)h * D + c * VEC;
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      const int q = qg * QPT + s;
      if (q >= Q) break;
      const int64_t bqh = (b * Q + q) * H + h;
      sample_query<V>(v_bh, loc + bqh * L * P * 2, attn + bqh * L * P, row, L, P, lv,
                      out + bqh * D + c * VEC);
    }
  }
}

template <int V>
void launch(const void* value, const float* loc, const float* attn, void* out, int B, int S,
            int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  constexpr int QPT = V == QT256 ? 2 : 1;
  const int64_t n_items = (int64_t)B * ((Q + QPT - 1) / QPT) * H * (D / VEC);
  if (n_items == 0) return;
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  ms_deform_attn_fwd_variant_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      n_items);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch otherwise.
//   variant: 0 base, 1 unroll, 2 qt256, 3 treey, 4 bf16y, 5 noy, 6 nox
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
int poet_ms_deform_attn_fwd_variant(const void* value, const void* loc, const void* attn,
                                    void* out, int variant, int B, int S, int Q, int H, int D,
                                    int L, int P, const int* level_hw, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D % VEC != 0) return -2;
  if (variant == UNROLL && (L != 4 || P != 4)) return -6;
  const float* lf = static_cast<const float*>(loc);
  const float* af = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BASE: launch<BASE>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case UNROLL: launch<UNROLL>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case QT256: launch<QT256>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case TREEY: launch<TREEY>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case BF16Y: launch<BF16Y>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case NOY: launch<NOY>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    case NOX: launch<NOX>(value, lf, af, out, B, S, Q, H, D, L, P, lv, s); break;
    default: return -5;
  }
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
