// Multi-scale deformable attention, forward — CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/deform_attn_pallas_v3.py:_fwd_kernel
// (reached through ms_deform_attn_fused_t2, the encoder's sampling core in
// poet_tpu/models/transformer.py). It ports the CONTRACT of
// poet_tpu/ops/deform_attn.py:ms_deform_attn_xla, not the TPU formulation:
// the v3 kernel's lane-major coordinates, its 128-query padding and its
// separable one-hot x/y mixes exist only because the TPU has no fast
// gather. Hopper has one, so this kernel gathers the four bilinear corners
// directly.
//
//   value  (B, S, H, D)        f32 or bf16, levels concatenated along S
//   loc    (B, Q, H, L, P, 2)  f32, normalized to [0, 1], (x, y) order
//   attn   (B, Q, H, L, P)     f32, already softmaxed over (L, P)
//   out    (B, Q, H * D)       value dtype, accumulated in f32
//
// Sampling (csrc/ms_deform_attn_point.cuh, shared with the adjoints and the
// variants): pixel = loc * size - 0.5 (grid_sample, align_corners=False),
// bilinear, zero padding outside the map. Each corner is bounds-checked on
// its own, and a point whose whole 2x2 footprint lies outside the map
// (including NaN coordinates and the dummy-query convention that puts
// reference points at -1 / -10) reads nothing.
//
// What bounds it: gather bytes. Per (b, q, h, l, p) the kernel reads 4
// corners x D values; at the flagship encoder shape (B=16, Q=S=1600,
// H=16, D=16, L=P=4) that is 16*1600*16*16*4*16*2 B = 0.84 GB of bf16
// corner reads per call against 13 MB of value, so the traffic is from the
// L2 (or shared memory) to the SMs, not HBM. Two routes, chosen by the
// wrapper's rule on (S, D, dtype, Q) (ops/deform_attn_cuda.py:plan_forward):
//   * DIRECT (ms_deform_attn_fwd_kernel): every corner read is a 16-byte
//     load from the L2. One thread owns a 16-byte slice of one head's D
//     channels (8 bf16 or 4 f32), so the two threads of a D=16 bf16 head
//     together read one full 32-byte sector. Where a (b, h) serves few
//     queries (the decoder, Q = 10: each token is read 0.4 times) nothing
//     would pay for staging.
//   * SLAB (ms_deform_attn_fwd_slab_kernel): one block owns one (b, h),
//     stages its (S, D) value slab into shared memory once with 16-byte
//     cp.async (51 200 B bf16 / 102 400 B f32 at S = 1600, D = 16: two
//     blocks fit an SM, 256 blocks one wave at the flagship shape), then
//     walks all Q queries of the pair; every corner read is a 16-byte
//     shared-memory load. At the encoder shape each staged token is read
//     4 L P Q / S = 64 times: the TPU kernel keeps the same slab resident in
//     VMEM across its query grid (its index map ignores q).
// Both routes do the same arithmetic in the same order (the thread layout
// stays: a 16-byte channel slice per thread, the f32 accumulator in
// registers, stored once in the value dtype), so their outputs are equal
// bit for bit. The level table is a __grid_constant__ parameter on both,
// read from the parameter bank and not from a stack frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ms_deform_attn_point.cuh"

namespace {

using deform_point::Footprint;
using deform_point::Levels;

constexpr int kSlabThreads = 512;

// acc[0:VEC] += w * p[0:VEC]; p in device or shared memory
template <typename T, int VEC>
struct Corner {
  static __device__ __forceinline__ void fma(const T* p, float w, float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += w * deform_point::to_float(p[j]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = deform_point::from_float<T>(acc[j]);
  }
};

template <>
struct Corner<float, 4> {
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
struct Corner<__nv_bfloat16, 8> {
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

// One (b, q, h) and channel slice: the sum over its L x P points into acc.
// v: the slice's channels of token 0, tokens `stride` elements apart (H D in
// device memory, D in a slab).
template <typename T, int VEC>
__device__ __forceinline__ void sample_query(const T* v, int64_t stride, const float* loc_p,
                                             const float* att_p, int L, int P, const Levels& lv,
                                             float* acc) {
  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l];
    const int Wl = lv.w[l];
    const T* v_l = v + (int64_t)lv.start[l] * stride;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      Footprint f;
      if (!deform_point::footprint(loc_p[2 * k], loc_p[2 * k + 1], Hl, Wl, &f)) continue;
      deform_point::for_each_corner(f, Wl, att_p[k], [&](int, int t, float w) {
        Corner<T, VEC>::fma(v_l + (int64_t)t * stride, w, acc);
      });
    }
  }
}

// DIRECT: one thread per (b, q, h, c), c a VEC-wide slice of the D
// channels. Consecutive threads walk c, then h, so a warp covers the D
// channels of neighbouring heads of one query.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ attn, T* __restrict__ out, int S, int Q,
                          int H, int D, int L, int P, const __grid_constant__ Levels lv,
                          int64_t n_items) {
  const int chunks = D / VEC;
  const int64_t row = (int64_t)H * D;  // elements between neighbouring tokens
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t bqh = i / chunks;  // ((b * Q + q) * H + h)
    const int h = (int)(bqh % H);
    const int64_t b = bqh / ((int64_t)Q * H);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    sample_query<T, VEC>(value + b * S * row + (int64_t)h * D + c * VEC, row,
                         loc + bqh * L * P * 2, attn + bqh * L * P, L, P, lv, acc);
    Corner<T, VEC>::store(out + bqh * D + c * VEC, acc);
  }
}

// SLAB: one block per (b, h) (blockIdx.x = b * H + h). The block stages the
// pair's value slab, then its threads walk (q, c) items, c fastest, as the
// direct kernel's threads do.
template <typename T, int VEC>
__global__ void __launch_bounds__(kSlabThreads)
ms_deform_attn_fwd_slab_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                               const float* __restrict__ attn, T* __restrict__ out, int S,
                               int Q, int H, int D, int L, int P,
                               const __grid_constant__ Levels lv, bool async16) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);
  const int h = (int)(blockIdx.x % H);
  const int64_t b = blockIdx.x / H;
  const int64_t row = (int64_t)H * D;
  deform_point::stage_slab<T>(value + b * S * row + (int64_t)h * D, slab, S, D, row, async16);
  if (async16) mma_sm90::cp_async_wait_all();
  __syncthreads();

  const int chunks = D / VEC;
  for (int i = threadIdx.x; i < Q * chunks; i += blockDim.x) {
    const int q = i / chunks;
    const int c = i - q * chunks;
    const int64_t bqh = (b * Q + q) * H + h;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    sample_query<T, VEC>(slab + c * VEC, D, loc + bqh * L * P * 2, attn + bqh * L * P, L, P,
                         lv, acc);
    Corner<T, VEC>::store(out + bqh * D + c * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const void* value, const float* loc, const float* attn, void* out, int B, int S,
            int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  const int64_t n_items = (int64_t)B * Q * H * (D / VEC);
  if (n_items == 0) return;
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  ms_deform_attn_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      n_items);
}

template <typename T, int VEC>
int launch_slab(const void* value, const float* loc, const float* attn, void* out, int B, int S,
                int Q, int H, int D, int L, int P, const Levels& lv, cudaStream_t stream) {
  if ((int64_t)B * Q * H == 0) return 0;
  const size_t smem = (size_t)S * D * sizeof(T);
  auto kernel = ms_deform_attn_fwd_slab_kernel<T, VEC>;
  static size_t granted[deform_point::kMaxDevices];  // per instantiation
  const int rc = deform_point::grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  const bool async16 = (D * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(value) % 16 == 0;
  kernel<<<(unsigned)(B * H), kSlabThreads, smem, stream>>>(
      static_cast<const T*>(value), loc, attn, static_cast<T*>(out), S, Q, H, D, L, P, lv,
      async16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns 0 on success, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   dtype: 0 = float32, 1 = bfloat16
//   level_hw: host array of 2*L ints, (H_l, W_l) per level
//   vec: channels per thread, 1 or the 16-byte width (4 for f32, 8 for bf16)

// The direct route: corners gathered from device memory.
int poet_ms_deform_attn_fwd(const void* value, const void* loc, const void* attn, void* out,
                            int dtype, int B, int S, int Q, int H, int D, int L, int P,
                            const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    launch<float, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 8) {
    launch<__nv_bfloat16, 8>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

// The slab route: a block per (b, h) on its value slab in shared memory
// (S * D * sizeof(value) bytes; -7 when that exceeds the device's opt-in
// limit per block).
int poet_ms_deform_attn_fwd_slab(const void* value, const void* loc, const void* attn,
                                 void* out, int dtype, int B, int S, int Q, int H, int D, int L,
                                 int P, const int* level_hw, int vec, void* stream) {
  Levels lv;
  const int rc = deform_point::make_levels(level_hw, L, S, &lv);
  if (rc != 0) return rc;
  if (vec < 1 || D % vec != 0) return -2;
  const float* locf = static_cast<const float*>(loc);
  const float* attf = static_cast<const float*>(attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) {
    return launch_slab<float, 4>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 0 && vec == 1) {
    return launch_slab<float, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 8) {
    return launch_slab<__nv_bfloat16, 8>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  } else if (dtype == 1 && vec == 1) {
    return launch_slab<__nv_bfloat16, 1>(value, locf, attf, out, B, S, Q, H, D, L, P, lv, s);
  }
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
