// Ablations of the deformable-attention forward kernel — CUDA for Hopper
// (sm_90a), to find where its time goes, on the route the encoder takes: a
// value slab staged into shared memory.
//
// Replaces the TPU probe scripts/bench_v3_variants.py:build_variant (its
// `fwd_kernel`), which ablated the TPU forward kernel (base, unroll, qt256,
// noy, nox, bf16y, treey). It takes the per-point body of the port's forward
// kernel from the header both include, csrc/ms_deform_attn_point.cuh (the
// coordinates, the footprint test, the corners and their weights), and the
// layout of kernel 1's slab route (csrc/ms_deform_attn_fwd.cu: a CTA per
// (b, h), its (S, D) value slab in shared memory at a pitch of D, the CTA's
// threads taking the queries in passes, one (q, 8-channel slice) a thread),
// which plan_forward (ops/deform_attn_cuda.py) gives the encoder. Each TPU
// ablation maps onto that design with one template parameter:
//
//   BASE    the forward kernel's arithmetic and addressing: its output is
//           bit-identical to kernel 1's (whose two routes are bit-equal);
//   UNROLL  L = P = 4 as constants, the level and point loops unrolled
//           (the TPU version unrolled its head loop);
//   QT256   two queries per thread (the TPU version halved its grid steps);
//   TREEY   one partial sum per level, added pairwise at the end (a
//           summation order);
//   BF16Y   the corner sums in packed bf16, __hfma2, the weight rounded
//           to bf16 (approximate);
//   NOY     the bilinear weight arithmetic dropped: each in-map corner is
//           weighted by the attention weight alone;
//   NOX     every corner reads its level's token 0 in shared memory, a
//           broadcast: what is left is the arithmetic and the loop.
// So base - nox is the corner reads from shared memory, base - noy the
// weight arithmetic, and the staging is timed alone by the two stagings.
//
// Staging. By TMA (the default): one tiled tensor map over value viewed as
// (D, H, S, B) with its real strides, boxes of one head's D channels by up
// to 256 tokens (plan_slab: as few boxes as that allows, each 128-byte
// aligned in shared memory, the tail box's tokens past S zero-filled into
// padding); thread 0 issues them, one mbarrier counts the slab's bytes, and
// every thread waits on it. Or by kernel 1's 16-byte cp.async from every
// thread (deform_point::stage_slab), to time the two stagings in one call.
// TMA needs 16-byte rows and base (D % 8 == 0, which the entry takes) and
// D <= 256 (a box's extent); a slab over the shared memory a block may use
// is refused (the flagship pyramid's S = 1600 at D = 16 stages 51 968 B,
// the YOLO pyramid's S = 6380 204 800 B in bf16).
//
// BASE, UNROLL and QT256 do the same arithmetic per query as the forward
// kernel; TREEY sums in another order. Their plain version is the forward
// kernel's (ops/deform_attn.py:ms_deform_attn_torch); NOY, NOX and BF16Y
// have plain definitions of their own (tools/bench_v3_variants.py). The
// level table is a __grid_constant__ parameter, as in kernel 1.
//
// What bounds it: the bytes the function moves (value, locations,
// attention, output: 0.0313 ms at the flagship encoder shape at 3.35 TB/s);
// each staged token is read 4 L P Q / S = 64 times there from shared memory.
//
// value (B, S, H, D) bf16 with D % 8 == 0 and a 16-byte aligned base; loc
// (B, Q, H, L, P, 2) f32; attn (B, Q, H, L, P) f32; out (B, Q, H * D) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_point.cuh"
#include "tma_sm90.cuh"

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

// Slab staging: a box of up to 256 tokens, the boxes as few and as even as
// that allows, each box's token count rounded up so that every box lands
// 128-byte aligned (tools/bench_v3_variants.py:plan_slab mirrors it).
// The tail box's tokens past S are out of bounds: TMA fills them with zeros
// in the padding after the slab.
struct SlabPlan {
  int box_tokens, n_boxes, slab_bytes, smem;
};

constexpr int kThreads = 512;
constexpr int kMaxBox = 256;     // a TMA box's extent in one dimension
constexpr int kAlign = 128;      // a box's shared-memory destination

inline SlabPlan plan_slab(int S, int D) {
  const int row = D * (int)sizeof(T);
  int align = kAlign;            // tokens a box is rounded to: 128 / gcd(128, row)
  for (int r = row; align > 1 && r % 2 == 0; r /= 2) align /= 2;
  const int n = (S + kMaxBox - 1) / kMaxBox;
  int box = (S + n - 1) / n;
  box = (box + align - 1) / align * align;
  SlabPlan p;
  p.box_tokens = box;
  p.n_boxes = (S + box - 1) / box;
  p.slab_bytes = p.n_boxes * box * row;
  p.smem = kAlign + p.slab_bytes + 16;   // alignment slack, the slab, the mbarrier
  return p;
}

// One CTA per (b, h) (blockIdx.x = b * H + h): the pair's (S, D) value slab
// staged into shared memory (TMA: thread 0 issues the boxes, one mbarrier
// counts the slab's bytes; or kernel 1's 16-byte cp.async by every thread),
// then the CTA's threads take the queries in passes, one (q, 8-channel
// slice) a thread (QT256: two queries), as kernel 1's slab route does.
template <int V>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_fwd_variant_kernel(const __grid_constant__ CUtensorMap value_map,
                                  const T* __restrict__ value, const float* __restrict__ loc,
                                  const float* __restrict__ attn, T* __restrict__ out, int S,
                                  int Q, int H, int D, int L, int P,
                                  const __grid_constant__ Levels lv, int box_tokens, int n_boxes,
                                  bool tma) {
  extern __shared__ unsigned char smem_raw[];
  using tma_sm90::shared_addr;
  unsigned char* base =
      smem_raw + ((kAlign - (shared_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  T* slab = reinterpret_cast<T*>(base);
  const int box_bytes = box_tokens * D * (int)sizeof(T);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + n_boxes * box_bytes);
  const int h = (int)(blockIdx.x % H);
  const int b = (int)(blockIdx.x / H);
  const int64_t row = (int64_t)H * D;
  if (tma) {
    if (threadIdx.x == 0) {
      tma_sm90::mbar_init(shared_addr(bar), 1);
      tma_sm90::fence_mbarrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_sm90::mbar_expect_tx(shared_addr(bar), (uint32_t)(n_boxes * box_bytes));
      for (int k = 0; k < n_boxes; ++k) {
        tma_sm90::tma_load_4d(shared_addr(base + k * box_bytes), &value_map, shared_addr(bar), 0,
                              h, k * box_tokens, b);
      }
    }
    tma_sm90::mbar_wait(shared_addr(bar), 0);
  } else {
    deform_point::stage_slab<T>(value + (int64_t)b * S * row + (int64_t)h * D, slab, S, D, row,
                                true);
    mma_sm90::cp_async_wait_all();
    __syncthreads();
  }

  constexpr int QPT = V == QT256 ? 2 : 1;
  const int chunks = D / VEC;
  const int QG = (Q + QPT - 1) / QPT;  // query groups
  for (int i = threadIdx.x; i < QG * chunks; i += blockDim.x) {
    const int qg = i / chunks;
    const int c = i - qg * chunks;
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      const int q = qg * QPT + s;
      if (q >= Q) break;
      const int64_t bqh = ((int64_t)b * Q + q) * H + h;
      sample_query<V>(slab + c * VEC, loc + bqh * L * P * 2, attn + bqh * L * P, D, L, P, lv,
                      out + bqh * D + c * VEC);
    }
  }
}

template <int V>
int launch(const CUtensorMap& map, const void* value, const float* loc, const float* attn,
           void* out, int B, int S, int Q, int H, int D, int L, int P, const Levels& lv,
           const SlabPlan& sp, bool tma, cudaStream_t stream) {
  auto kernel = ms_deform_attn_fwd_variant_kernel<V>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, (size_t)sp.smem, granted);
  if (rc != 0) return rc;
  kernel<<<(unsigned)(B * H), kThreads, sp.smem, stream>>>(
      map, static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      sp.box_tokens, sp.n_boxes, tma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-7: the staged slab exceeds the device's shared memory a block may
// opt into; -8: D > 256, more than a TMA box's extent; -21: no tensor-map
// encoder in libcuda; -22: libcuda refused the value's tensor map), or the
// cudaError_t of the launch otherwise.
//   variant: 0 base, 1 unroll, 2 qt256, 3 treey, 4 bf16y, 5 noy, 6 nox
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   staging: 0 by TMA, 1 by 16-byte cp.async (kernel 1's slab route)
int poet_ms_deform_attn_fwd_variant(const void* value, const void* loc, const void* attn,
                                    void* out, int variant, int B, int S, int Q, int H, int D,
                                    int L, int P, const int* level_hw, int staging,
                                    void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (D % VEC != 0 || reinterpret_cast<uintptr_t>(value) % 16 != 0) return -2;
  if (variant == UNROLL && (L != 4 || P != 4)) return -6;
  if (staging != 0 && staging != 1) return -5;
  if (D > kMaxBox) return -8;
  const SlabPlan sp = plan_slab(S, D);
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (sp.smem > optin) return -7;
  if ((int64_t)B * Q * H == 0) return 0;
  CUtensorMap map = {};
  const bool tma = staging == 0;
  if (tma) {
    tma_sm90::EncodeTiled encode = tma_sm90::encoder();
    if (encode == nullptr) return -21;
    // value (B, S, H, D) as (D, H, S, B) innermost first; a box: one head's
    // D channels of box_tokens tokens of one batch row
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)H * D * sizeof(T),
                                   (cuuint64_t)S * H * D * sizeof(T)};
    const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)sp.box_tokens, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(value), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return -22;
    }
  }
  const float* lf = static_cast<const float*>(loc);
  const float* af = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case BASE: return launch<BASE>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case UNROLL:
      return launch<UNROLL>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case QT256:
      return launch<QT256>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case TREEY:
      return launch<TREEY>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case BF16Y:
      return launch<BF16Y>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case NOY: return launch<NOY>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
    case NOX: return launch<NOX>(map, value, lf, af, out, B, S, Q, H, D, L, P, lv, sp, tma, s);
  }
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
