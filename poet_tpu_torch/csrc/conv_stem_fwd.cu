// Fused small-C "stem" convolution, forward — CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/conv_stem_pallas.py:_kernel (reached
// from conv_stem_pallas), the darknet body's entry convolutions on the
// YOLOv4-CSP detect+pose path (3x3/1 3->32, 3x3/2 32->64, 3x3/1 32->64 at
// 480x640 and 240x320) and the ResNet 7x7/2 stem's function. It computes
// conv_stem_pallas's contract, not its TPU layout:
//
//   x     (B, H, W, C)   NHWC, f32 or bf16
//   w     (kh, kw, C, F) HWIO, x's dtype (FrozenBN already folded in)
//   bias  (F,)           f32, or null
//   out   (B, Ho, Wo, F) f32 or bf16, Ho = (H + pt + pb - kh) / s + 1
//   out = act(sum over (ky, kx, c) of x_pad[oy*s + ky, ox*s + kx, c] * w[ky, kx, c, f]
//             + bias[f]), summed in f32, the activation in f32 (none, relu,
//             the one-exp mish of models/yolov4.py, leaky 0.1), rounded once.
//
// The TPU kernel's stride-phase staging, (8, 128) paddings and per-row MXU
// dot exist because XLA's lane layouts punish a small C; none of that is
// carried over.
//
// What bounds it: operations, at f32 FMA rate. At B=16, 480x640 the 3x3/2
// 32->64 layer is 45.3 GFLOP against 472 MB of input and output bf16 bytes:
// 0.68 ms at 67 TFLOP/s f32, 0.14 ms at the memory rate, 0.05 ms at the bf16
// tensor-core rate. This kernel runs its sums as f32 FMAs in the SIMT cores,
// so the f32 rate is its own ceiling; the tensor cores (mma.sync / wgmma on
// an im2col tile in shared memory) are later work. What the design does:
//   * one block per tile of 8 x 16 output pixels of one image and a chunk of
//     up to 64 output channels; the input tile and its halo
//     ((8-1)*s + kh rows, (16-1)*s + kw columns, all C) are staged once in
//     shared memory, zero outside the image, with 16-byte loads where C and
//     the pointer allow and scalar loads otherwise (C = 3);
//   * the chunk's folded weights (K = kh*kw*C rows of the chunk's channels,
//     at most 288 x 64 bf16 = 36 KB on the path) sit in shared memory too;
//   * a thread owns 8 consecutive output channels of 4 pixels: per tap it
//     reads one 8-channel weight vector and 4 input values, 32 FMAs into
//     registers; the epilogue (bias, activation, one rounding) stays in
//     registers and each pixel's 8 channels go out in one 16-byte store
//     (bf16; two for f32), the 8 threads of a pixel writing 128 contiguous
//     bytes at F = 64.
// A shared-memory request above 48 KB is granted with cudaFuncSetAttribute;
// one above the card's 227 KB is refused (the wrapper raises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // output rows per tile
constexpr int TW = 16;             // output columns per tile
constexpr int SLOTS = 32;          // pixel slots of a block; a thread owns NP pixels
constexpr int NP = TH * TW / SLOTS;
constexpr int MAX_SMEM = 232448;   // bytes a block may use on sm_90

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_MISH = 2, ACT_LEAKY = 3 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_LEAKY) return v > 0.f ? v : __fmul_rn(0.1f, v);
  if (ACT == ACT_MISH) {
    // x * tanh(softplus(x)) as 1 - 2 / ((1 + e^x)^2 + 1), x clamped at 25,
    // each operation rounded on its own as in the plain version
    const float e = expf(fminf(v, 25.f));
    const float p = __fadd_rn(1.f, e);
    const float t = __fsub_rn(1.f, __fdiv_rn(2.f, __fadd_rn(__fmul_rn(p, p), 1.f)));
    return v > 25.f ? v : __fmul_rn(v, t);
  }
  return v;
}

// n consecutive elements between global and shared memory: one 16-byte move
// for a full vector, element by element otherwise
template <typename T, int N>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  if (N * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if (N * sizeof(T) == 32) {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = src[j];
  }
}

template <typename T, int N>
__device__ __forceinline__ void zero_vec(T* dst) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = from_float<T>(0.f);
}

template <typename T, int N>
__device__ __forceinline__ void load_float(const T* p, float* v) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_float(p[j]);
}

template <>
__device__ __forceinline__ void load_float<__nv_bfloat16, 8>(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_float<float, 8>(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = from_float<T>(v[j]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 8>(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <>
__device__ __forceinline__ void store_vec<float, 8>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

struct Geometry {
  int B, H, W, C, F, kh, kw, s, pt, pl, Ho, Wo;
  int chunk;        // output channels of a block (CH)
  int n_chunks;
  int rows_in, cols_in;
};

// Block: SLOTS x (CH / FV) threads; thread t owns channel group t % (CH / FV)
// (FV channels) of the NP pixels slot + SLOTS * p, slot = t / (CH / FV), of
// the 8 x 16 tile. VIN = input elements per staging move (16 bytes, or 1).
template <typename Tin, typename Tout, int FV, int VIN, int ACT>
__global__ void __launch_bounds__(256)
conv_stem_fwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                     const float* __restrict__ bias, Tout* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = g.C, F = g.F, s = g.s;
  const int K = g.kh * g.kw * C;
  const int b = blockIdx.z / g.n_chunks;
  const int f0 = (blockIdx.z % g.n_chunks) * g.chunk;
  const int CH = min(g.chunk, F - f0);             // this block's channels
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * s - g.pt, ix0 = ox0 * s - g.pl;

  const int in_elems = g.rows_in * g.cols_in * C;
  Tin* in_tile = reinterpret_cast<Tin*>(smem);
  const size_t w_off = ((size_t)in_elems * sizeof(Tin) + 15) / 16 * 16;
  Tin* w_tile = reinterpret_cast<Tin*>(smem + w_off);   // (K, g.chunk)

  // stage the input tile and its halo, zero outside the image
  const int cv = C / VIN;
  const int n_in = g.rows_in * g.cols_in * cv;
  const Tin* xb = x + (int64_t)b * g.H * g.W * C;
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    const int c = (e % cv) * VIN;
    const int pix = e / cv;
    const int col = pix % g.cols_in, row = pix / g.cols_in;
    const int iy = iy0 + row, ix = ix0 + col;
    Tin* dst = in_tile + (size_t)pix * C + c;
    if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
      copy_vec<Tin, VIN>(dst, xb + ((int64_t)iy * g.W + ix) * C + c);
    } else {
      zero_vec<Tin, VIN>(dst);
    }
  }
  // stage the chunk's weights, FV channels per move
  const int gw = CH / FV;
  for (int e = threadIdx.x; e < K * gw; e += blockDim.x) {
    const int k = e / gw, j = (e % gw) * FV;
    copy_vec<Tin, FV>(w_tile + (size_t)k * g.chunk + j, w + (int64_t)k * F + f0 + j);
  }
  __syncthreads();

  const int groups = g.chunk / FV;
  const int grp = threadIdx.x % groups;
  const int slot = threadIdx.x / groups;
  if (grp >= gw || slot >= SLOTS) return;

  int base[NP];                                    // tile offset of each pixel's window
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int pix = slot + SLOTS * p;
    base[p] = ((pix / TW) * s * g.cols_in + (pix % TW) * s) * C;
  }
  float acc[NP][FV];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < FV; ++j) acc[p][j] = 0.f;

  const Tin* wt = w_tile + grp * FV;
  for (int ky = 0; ky < g.kh; ++ky) {
    for (int kx = 0; kx < g.kw; ++kx) {
      const int tap = (ky * g.cols_in + kx) * C;
      const Tin* wk = wt + (size_t)(ky * g.kw + kx) * C * g.chunk;
      for (int c = 0; c < C; ++c) {
        float wv[FV];
        load_float<Tin, FV>(wk + (size_t)c * g.chunk, wv);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float xv = to_float(in_tile[base[p] + tap + c]);
#pragma unroll
          for (int j = 0; j < FV; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
        }
      }
    }
  }

  float bv[FV];
#pragma unroll
  for (int j = 0; j < FV; ++j) bv[j] = bias ? bias[f0 + grp * FV + j] : 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int pix = slot + SLOTS * p;
    const int oy = oy0 + pix / TW, ox = ox0 + pix % TW;
    if (oy >= g.Ho || ox >= g.Wo) continue;        // the ragged last tiles
    float v[FV];
#pragma unroll
    for (int j = 0; j < FV; ++j) v[j] = activate<ACT>(__fadd_rn(acc[p][j], bv[j]));
    store_vec<Tout, FV>(out + (((int64_t)b * g.Ho + oy) * g.Wo + ox) * F + f0 + grp * FV, v);
  }
}

template <typename Tin, typename Tout, int FV, int VIN, int ACT>
int launch(const void* x, const void* w, const float* bias, void* out, const Geometry& g,
           size_t smem, cudaStream_t stream) {
  auto kernel = conv_stem_fwd_kernel<Tin, Tout, FV, VIN, ACT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Wo + TW - 1) / TW, (g.Ho + TH - 1) / TH, g.B * g.n_chunks);
  const int threads = SLOTS * (g.chunk / FV);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const Tin*>(x),
                                          static_cast<const Tin*>(w), bias,
                                          static_cast<Tout*>(out), g);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout, int FV, int VIN>
int by_act(int act, const void* x, const void* w, const float* bias, void* out,
           const Geometry& g, size_t smem, cudaStream_t st) {
  switch (act) {
    case ACT_NONE: return launch<Tin, Tout, FV, VIN, ACT_NONE>(x, w, bias, out, g, smem, st);
    case ACT_RELU: return launch<Tin, Tout, FV, VIN, ACT_RELU>(x, w, bias, out, g, smem, st);
    case ACT_MISH: return launch<Tin, Tout, FV, VIN, ACT_MISH>(x, w, bias, out, g, smem, st);
    case ACT_LEAKY: return launch<Tin, Tout, FV, VIN, ACT_LEAKY>(x, w, bias, out, g, smem, st);
  }
  return -6;
}

template <typename Tin, typename Tout>
int by_vec(int fv, int vin, int act, const void* x, const void* w, const float* bias,
           void* out, const Geometry& g, size_t smem, cudaStream_t st) {
  constexpr int V16 = 16 / sizeof(Tin);
  if (fv == 8 && vin == V16) return by_act<Tin, Tout, 8, V16>(act, x, w, bias, out, g, smem, st);
  if (fv == 8 && vin == 1) return by_act<Tin, Tout, 8, 1>(act, x, w, bias, out, g, smem, st);
  if (fv == 1 && vin == V16) return by_act<Tin, Tout, 1, V16>(act, x, w, bias, out, g, smem, st);
  if (fv == 1 && vin == 1) return by_act<Tin, Tout, 1, 1>(act, x, w, bias, out, g, smem, st);
  return -5;
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   in_dtype, out_dtype: 0 = float32, 1 = bfloat16 (w is in_dtype)
//   bias:   (F,) float32, or null
//   act:    0 none, 1 relu, 2 mish, 3 leaky (slope 0.1)
//   fv:     output channels per thread, 8 (F % 8 == 0, 16-byte aligned w and
//           out) or 1
//   vin:    input elements per staging move, the 16-byte width (C divisible
//           by it, x 16-byte aligned) or 1
int poet_conv_stem_fwd(const void* x, const void* w, const void* bias, void* out, int in_dtype,
                       int out_dtype, int B, int H, int W, int C, int F, int kh, int kw,
                       int stride, int pt, int pl, int Ho, int Wo, int act, int fv, int vin,
                       void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || kh < 1 || kw < 1) return -1;
  if (stride < 1 || pt < 0 || pl < 0 || Ho < 1 || Wo < 1) return -2;
  if (fv != 1 && (fv != 8 || F % 8 != 0)) return -3;
  if (vin != 1 && C % vin != 0) return -3;
  Geometry g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.F = F; g.kh = kh; g.kw = kw; g.s = stride;
  g.pt = pt; g.pl = pl; g.Ho = Ho; g.Wo = Wo;
  g.chunk = fv == 8 ? (F < 64 ? F : 64) : (F < 8 ? F : 8);
  g.n_chunks = (F + g.chunk - 1) / g.chunk;
  g.rows_in = (TH - 1) * stride + kh;
  g.cols_in = (TW - 1) * stride + kw;
  if ((int64_t)B * g.n_chunks > 65535) return -4;
  const size_t elem = in_dtype == 0 ? 4 : 2;
  const size_t in_bytes = ((size_t)g.rows_in * g.cols_in * C * elem + 15) / 16 * 16;
  const size_t smem = in_bytes + (size_t)kh * kw * C * g.chunk * elem;
  if (smem > MAX_SMEM) return -7;   // the tile and the weights do not fit
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return by_vec<float, float>(fv, vin, act, x, w, bf, out, g, smem, st);
  if (in_dtype == 0 && out_dtype == 1)
    return by_vec<float, __nv_bfloat16>(fv, vin, act, x, w, bf, out, g, smem, st);
  if (in_dtype == 1 && out_dtype == 0)
    return by_vec<__nv_bfloat16, float>(fv, vin, act, x, w, bf, out, g, smem, st);
  if (in_dtype == 1 && out_dtype == 1)
    return by_vec<__nv_bfloat16, __nv_bfloat16>(fv, vin, act, x, w, bf, out, g, smem, st);
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
