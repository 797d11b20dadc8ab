// Multi-scale deformable attention, forward, separable v2 contract — CUDA for
// Hopper (sm_90a), on a zero-bordered value slab in shared memory.
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
// Layout: one block per (query chunk, h, b). The block stages the padded
// levels of its (b, h), packed densely level after level (cells of D values,
// row-major within a level, not v2's max_Wp * D rectangle), into dynamic
// shared memory in the value's dtype (bf16 stays exact; the sum is f32).
// The padded rows are cut into row BANDS, each within a shared-memory budget
// given by the caller (the flagship pyramid pads to 1880 cells, 60 160 B in
// bf16, and fits one band; the YOLO pyramid's 6922 cells take several): the
// block stages band after band, and each thread adds the corners of the
// band's rows to its f32 accumulator in registers. Each corner row belongs to
// exactly one band, so the two rows of a point may be added in two bands.
//
// Each thread owns one (query, 16-byte channel slice): 8 bf16 or 4 f32
// channels of one head (scalar channels when D or the pointer does not
// allow 16 bytes). Its corner reads are 16-byte shared-memory loads.
//
// What bounds it: at the flagship encoder shape the function must move ~105
// MB (value, locations, attention, output: 0.031 ms at 3.35 TB/s); the TPU
// kernel's two one-hot products per point are 0.17 ms of bf16 tensor-core
// work, which a gather does not do. The kernel's own cost is the staging of
// each (b, h) slab once per query chunk and the per-point coordinate math,
// repeated per band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define POET_MAX_LEVELS 8
#define POET_V2_MAX_BANDS 64

namespace {

struct Levels {
  int h[POET_MAX_LEVELS];
  int w[POET_MAX_LEVELS];
  int start[POET_MAX_LEVELS];     // first token of the level in S
  int row_off[POET_MAX_LEVELS];   // first padded row of the level
  int cell_off[POET_MAX_LEVELS];  // first padded cell of the level
};

// Band k holds padded rows [row[k], row[k + 1]) = cells [cell[k], cell[k + 1]).
struct Bands {
  int n;
  int row[POET_V2_MAX_BANDS + 1];
  int cell[POET_V2_MAX_BANDS + 1];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive values: copy, zero, acc += w * p, store
template <typename T, int VEC>
struct Vec {
  static __device__ __forceinline__ void copy(T* d, const T* s) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = s[j];
  }
  static __device__ __forceinline__ void zero(T* d) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = from_float<T>(0.f);
  }
  static __device__ __forceinline__ void fma(const T* p, float w, float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += w * to_float(p[j]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(acc[j]);
  }
};

template <typename T>
struct Vec16 {  // 16 bytes: 4 f32 or 8 bf16
  static __device__ __forceinline__ void copy(T* d, const T* s) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  }
  static __device__ __forceinline__ void zero(T* d) {
    *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void copy(float* d, const float* s) { Vec16<float>::copy(d, s); }
  static __device__ __forceinline__ void zero(float* d) { Vec16<float>::zero(d); }
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
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void copy(__nv_bfloat16* d, const __nv_bfloat16* s) {
    Vec16<__nv_bfloat16>::copy(d, s);
  }
  static __device__ __forceinline__ void zero(__nv_bfloat16* d) { Vec16<__nv_bfloat16>::zero(d); }
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

template <typename T, int VEC>
__global__ void __launch_bounds__(1024)
ms_deform_attn_v2_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                         const float* __restrict__ attn, T* __restrict__ out, int S, int Q,
                         int H, int D, int L, int P, Levels lv, Bands bd, int q_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);
  const int chunks = D / VEC;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q = blockIdx.x * q_chunk + (int)threadIdx.x / chunks;
  const int c = (int)threadIdx.x % chunks;
  const bool active = (int)threadIdx.x < q_chunk * chunks && q < Q;
  const int64_t row = (int64_t)H * D;  // elements between neighbouring tokens
  const T* v_bh = value + (int64_t)b * S * row + (int64_t)h * D;
  const int64_t bqh = ((int64_t)b * Q + q) * H + h;
  const float* loc_p = loc + bqh * L * P * 2;
  const float* att_p = attn + bqh * L * P;

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  bool nonfinite = false;

  for (int k = 0; k < bd.n; ++k) {
    const int cell0 = bd.cell[k];
    const int n_items = (bd.cell[k + 1] - cell0) * chunks;
    if (k > 0) __syncthreads();  // every thread is done with the last band
    for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
      const int cell = cell0 + i / chunks;
      const int cc = i % chunks;
      int l = 0;
      while (l + 1 < L && cell >= lv.cell_off[l + 1]) ++l;
      const int Wp = lv.w[l] + 2;
      const int local = cell - lv.cell_off[l];
      const int py = local / Wp;
      const int px = local - py * Wp;
      T* dst = slab + (int64_t)(cell - cell0) * D + cc * VEC;
      if (py >= 1 && py <= lv.h[l] && px >= 1 && px <= lv.w[l]) {
        const int64_t tok = lv.start[l] + (int64_t)(py - 1) * lv.w[l] + (px - 1);
        Vec<T, VEC>::copy(dst, v_bh + tok * row + cc * VEC);
      } else {
        Vec<T, VEC>::zero(dst);
      }
    }
    __syncthreads();
    if (!active) continue;
    const int row0 = bd.row[k];
    const int row1 = bd.row[k + 1];
    for (int l = 0; l < L; ++l) {
      const int Hl = lv.h[l];
      const int Wl = lv.w[l];
      const int Wp = Wl + 2;
      for (int p = 0; p < P; ++p) {
        const int kp = l * P + p;
        const float x = __fsub_rn(__fmul_rn(loc_p[2 * kp], (float)Wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(loc_p[2 * kp + 1], (float)Hl), 0.5f);
        // base outside [-1, W-1] x [-1, H-1] (NaN too): skip; a non-finite
        // coordinate also makes the row NaN (C1)
        if (!(x >= -1.f && x < (float)Wl && y >= -1.f && y < (float)Hl)) {
          nonfinite |= !(isfinite(x) && isfinite(y));
          continue;
        }
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float tx = x - x0f;
        const float ty = y - y0f;
        const int pr = lv.row_off[l] + (int)y0f + 1;  // padded row of the top corners
        const int base = lv.cell_off[l] + ((int)y0f + 1) * Wp + (int)x0f + 1 - cell0;
        const float a = att_p[kp];
        if (pr >= row0 && pr < row1) {
          const float w = (1.f - ty) * a;
          const T* s = slab + (int64_t)base * D + c * VEC;
          Vec<T, VEC>::fma(s, (1.f - tx) * w, acc);
          Vec<T, VEC>::fma(s + D, tx * w, acc);
        }
        if (pr + 1 >= row0 && pr + 1 < row1) {
          const float w = ty * a;
          const T* s = slab + (int64_t)(base + Wp) * D + c * VEC;
          Vec<T, VEC>::fma(s, (1.f - tx) * w, acc);
          Vec<T, VEC>::fma(s + D, tx * w, acc);
        }
      }
    }
  }
  if (nonfinite) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __int_as_float(0x7fc00000);
  }
  if (active) Vec<T, VEC>::store(out + bqh * D + c * VEC, acc);
}

template <typename T, int VEC>
int launch(const void* value, const float* loc, const float* attn, void* out, int B, int S,
           int Q, int H, int D, int L, int P, const Levels& lv, const Bands& bd, int q_chunk,
           int smem_bytes, cudaStream_t stream) {
  const int chunks = D / VEC;
  const int threads = ((q_chunk * chunks + 31) / 32) * 32;
  if (threads > 1024) return -8;
  auto kernel = ms_deform_attn_v2_kernel<T, VEC>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Q + q_chunk - 1) / q_chunk, H, B);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv, bd,
      q_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or a cudaError_t otherwise.
//   dtype: 0 = float32, 1 = bfloat16
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec: channels per thread, 1 or the 16-byte width (4 for f32, 8 for bf16)
//   band_rows: host array of n_bands + 1 ints, the first padded row of each
//     band and then the total: the bands must tile the padded rows in order
//   smem_budget: bytes of shared memory a band may take; at most the
//     device's opt-in limit per block
//   q_chunk: queries per block
int poet_ms_deform_attn_v2_fwd(const void* value, const void* loc, const void* attn, void* out,
                               int dtype, int B, int S, int Q, int H, int D, int L, int P,
                               const int* level_hw, int vec, const int* band_rows, int n_bands,
                               int smem_budget, int q_chunk, void* stream) {
  if (L < 1 || L > POET_MAX_LEVELS) return -1;
  if (vec < 1 || D % vec != 0) return -2;
  if (n_bands < 1 || n_bands > POET_V2_MAX_BANDS || q_chunk < 1) return -5;
  Levels lv;
  int start = 0, rows = 0, cells = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return -3;
    lv.start[l] = start;
    lv.row_off[l] = rows;
    lv.cell_off[l] = cells;
    start += lv.h[l] * lv.w[l];
    rows += lv.h[l] + 2;
    cells += (lv.h[l] + 2) * (lv.w[l] + 2);
  }
  if (start > S) return -4;
  // the bands: padded rows -> cells, in order, each within the budget
  const int elem = dtype == 0 ? 4 : 2;
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem_budget < 1 || smem_budget > optin) return -6;
  Bands bd;
  bd.n = n_bands;
  if (band_rows[0] != 0 || band_rows[n_bands] != rows) return -7;
  int max_cells = 0;
  for (int k = 0; k <= n_bands; ++k) {
    const int r = band_rows[k];
    if (k > 0 && r <= band_rows[k - 1]) return -7;
    int l = 0;
    while (l + 1 < L && r >= lv.row_off[l + 1]) ++l;
    bd.row[k] = r;
    bd.cell[k] = r == rows ? cells : lv.cell_off[l] + (r - lv.row_off[l]) * (lv.w[l] + 2);
    if (k > 0 && bd.cell[k] - bd.cell[k - 1] > max_cells) max_cells = bd.cell[k] - bd.cell[k - 1];
  }
  const int64_t smem = (int64_t)max_cells * D * elem;
  if (smem > smem_budget) return -7;
  if ((int64_t)B * Q * H == 0) return 0;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = (int)smem;
  if (dtype == 0 && vec == 4) {
    return launch<float, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, bd, q_chunk, sm, s);
  } else if (dtype == 0 && vec == 1) {
    return launch<float, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, bd, q_chunk, sm, s);
  } else if (dtype == 1 && vec == 8) {
    return launch<__nv_bfloat16, 8>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, bd, q_chunk,
                                    sm, s);
  } else if (dtype == 1 && vec == 1) {
    return launch<__nv_bfloat16, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, bd, q_chunk,
                                    sm, s);
  }
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
