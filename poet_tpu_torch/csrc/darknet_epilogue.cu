// The darknet body's conv epilogue, FrozenBN + activation in one pass — CUDA
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the BN and mish that follow
// each of poet_tpu/models/yolov4.py:DarknetBody's convolutions into one
// pass (and the reference PoET ran mish through the fused mish-cuda op).
// The port's eager PyTorch ran them as ~20 launches a conv: the fold's
// per-channel ops, then two full passes for the BN and eleven for mish.
// This kernel is that whole tail after cuDNN's conv (no bias), for every
// conv with a FrozenBN that the stem kernel does not take:
//
//   x     (B, H, W, C)  channels-last contiguous, f32 or bf16, C % 8 == 0
//   weight, bias, mean, var (C,)  f32, FrozenBatchNorm's buffers; eps
//   out   (B, H, W, C)  x's dtype
//   inv = weight * rsqrt(var + eps), off = bias - mean * inv, each rounded
//   to x's dtype as FrozenBatchNorm.forward rounds them;
//   out = act(x * inv + off) in f32 (none, the one-exp mish, leaky 0.1;
//   activations.cuh), rounded once at the store.
// In f32 every step is the plain version's (separate IEEE products and
// sums, precise expf), so the result is its up to expf's last bits; in
// bf16 the plain version rounds after each of its ~13 passes and this
// kernel once.
//
// What bounds it: bytes. Each element is read once and written once (4
// bytes in bf16), against ~30 f32 instructions of mish an element, under
// the card's ~35 an element at 3.35 TB/s. What the design does about it:
//   * 16-byte loads and stores, 8 bf16 (4 f32) consecutive channels a
//     thread, neighbouring threads on neighbouring vectors;
//   * each block computes the fold of all C channels once, into shared
//     memory (2 C floats), so no per-channel launch or host work remains;
//     a thread reads its vector's scale and offset as float4s;
//   * a grid-stride loop over a grid sized to the SMs (as many blocks as
//     are resident at once, fewer for a small map), the channel of the
//     next vector advanced by a running remainder, not a division;
//   * the activation a template argument: no branch in the loop.
// One launch a conv, on the caller's stream; no allocation, no sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"

namespace {

using namespace poet_act;

constexpr int THREADS = 256;
constexpr int MAX_C = 4096;        // 32 KB of fold in shared memory

template <typename T> struct Lanes;
// 16 bytes of T as f32 values and back; round(v) is v rounded to T
template <> struct Lanes<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 store(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};
template <> struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);             // the lower address's element
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&b);
  }
  __device__ __forceinline__ static void load(const uint4& r, float* v) {
    unpack(r.x, v); unpack(r.y, v + 2); unpack(r.z, v + 4); unpack(r.w, v + 6);
  }
  __device__ __forceinline__ static uint4 store(const float* v) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS) darknet_epilogue_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ out, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ mean,
    const float* __restrict__ var, float eps, int C, int64_t n_vec) {
  using L = Lanes<T>;
  extern __shared__ __align__(16) float fold[];   // inv[C], then off[C]
  float* inv = fold;
  float* off = fold + C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    // FrozenBatchNorm.forward's fold, op by op on the card (torch.rsqrt is
    // rsqrtf there), then rounded to the activation dtype
    const float s = __fmul_rn(weight[c], rsqrtf(__fadd_rn(var[c], eps)));
    inv[c] = L::round(s);
    off[c] = L::round(__fsub_rn(bias[c], __fmul_rn(mean[c], s)));
  }
  __syncthreads();

  const int per_pixel = C / L::N;                 // vectors a pixel
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int step = (int)(stride % per_pixel);
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int cv = (int)(i % per_pixel);
  for (; i < n_vec; i += stride) {
    float v[L::N];
    L::load(x[i], v);
    const float4* s4 = reinterpret_cast<const float4*>(inv + cv * L::N);
    const float4* o4 = reinterpret_cast<const float4*>(off + cv * L::N);
#pragma unroll
    for (int k = 0; k < L::N / 4; ++k) {
      const float4 s = s4[k], o = o4[k];
      v[4 * k + 0] = activate(ACT, __fadd_rn(__fmul_rn(v[4 * k + 0], s.x), o.x));
      v[4 * k + 1] = activate(ACT, __fadd_rn(__fmul_rn(v[4 * k + 1], s.y), o.y));
      v[4 * k + 2] = activate(ACT, __fadd_rn(__fmul_rn(v[4 * k + 2], s.z), o.z));
      v[4 * k + 3] = activate(ACT, __fadd_rn(__fmul_rn(v[4 * k + 3], s.w), o.w));
    }
    out[i] = L::store(v);
    cv += step;
    if (cv >= per_pixel) cv -= per_pixel;
  }
}

// The grid: as many blocks as are resident at once on the card (each
// instantiation's occupancy at the largest fold, found once a device), no
// more than the vectors need.
template <typename T, int ACT>
int launch(const void* x, void* out, const float* w, const float* b, const float* m,
           const float* v, float eps, int C, int64_t n_vec, cudaStream_t st) {
  auto kernel = darknet_epilogue_kernel<T, ACT>;
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES];               // blocks at once, 0 until found
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return -4;
  if (resident[dev] == 0) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, THREADS, 2 * MAX_C * sizeof(float))) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return -7;
    resident[dev] = sms * per_sm;
  }
  const int64_t need = (n_vec + THREADS - 1) / THREADS;
  const int grid = (int)(need < resident[dev] ? need : resident[dev]);
  kernel<<<grid, THREADS, 2 * C * sizeof(float), st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), w, b, m, v, eps, C, n_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int by_act(int act, const void* x, void* out, const float* w, const float* b, const float* m,
           const float* v, float eps, int C, int64_t n_vec, cudaStream_t st) {
  switch (act) {
    case ACT_NONE: return launch<T, ACT_NONE>(x, out, w, b, m, v, eps, C, n_vec, st);
    case ACT_MISH: return launch<T, ACT_MISH>(x, out, w, b, m, v, eps, C, n_vec, st);
    case ACT_LEAKY: return launch<T, ACT_LEAKY>(x, out, w, b, m, v, eps, C, n_vec, st);
  }
  return -6;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   x, out (n / C pixels, C) contiguous device memory, dtype 0 f32 / 1 bf16,
//   16-byte aligned; weight, bias, mean, var (C,) f32; act 0 none, 2 mish,
//   3 leaky
int poet_darknet_epilogue(const void* x, void* out, const void* weight, const void* bias,
                          const void* mean, const void* var, float eps, int dtype, int64_t n,
                          int C, int act, void* stream) {
  if (n < 1 || C < 8 || C % 8 != 0 || n % C != 0) return -1;
  if (C > MAX_C) return -2;
  if (!aligned16(x) || !aligned16(out)) return -3;
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return by_act<__nv_bfloat16>(act, x, out, w, b, m, v, eps, C, n / 8, st);
  if (dtype == 0) return by_act<float>(act, x, out, w, b, m, v, eps, C, n / 4, st);
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
