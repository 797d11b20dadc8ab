// Probe: what does a bf16 tensor-core contraction cost as a function of its
// depth K, when the operands are resident and the products are chained?
// CUDA for Hopper (sm_90a), hand-written mma.sync (inline PTX).
//
// Replaces the TPU probe scripts/bench_kpad.py:bench_k (its local `kernel`),
// which asked whether the TPU's matrix unit charges for K = 128 when the
// contraction is shallower. On Hopper, mma.sync m16n8k16 pads K to 16 (and
// wgmma has a depth of 16 bf16), so the question here is the cost of K < 16
// and of K that is not a multiple of 16 (the stem conv's K = 27).
//
// The function, for each of G repeats (all equal):
//   acc = 0;  for i < R:  a_i = a + bf16(acc[:, :K] * 1e-30);  acc += a_i @ b
//   out = acc (f32)
// with a (M, K) and b (K, N) bf16 (K <= N, as the feedback needs), f32
// accumulation. The feedback makes each product depend on the last, and
// the compiler cannot fold it away; numerically a_i == a.
//
// Layout: a block owns a strip of 16 rows and all N columns; its N / 32
// warps own 32 columns each (4 m16n8 tiles). b's fragments for the warp's
// columns stay in registers for the whole launch (K padded to 16 with
// zeros); a_i lives in shared memory (two buffers, row stride K + 8 bf16 so
// the fragment loads meet no bank conflict). Each step: the warps that own
// columns < K write a_i from their accumulators, one barrier, then every
// warp loads a_i's fragments and issues its K/16 x 4 products. The grid is
// persistent: each block walks (strip, repeat) tasks, and only the last
// repeat of a strip writes its output.
//
// Fragment layouts of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"), with g = lane / 4, t = lane % 4:
//   A (16x16, row): reg0 = A[g][2t, 2t+1], reg1 = A[g+8][2t, 2t+1],
//                   reg2 = A[g][2t+8, 2t+9], reg3 = A[g+8][2t+8, 2t+9]
//   B (16x8, col):  reg0 = B[2t, 2t+1][g], reg1 = B[2t+8, 2t+9][g]
//   C (16x8, f32):  c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (the lower column or row index in the low 16 bits of a register).
//
// What bounds it: the tensor cores, 2 M N K R G flops at 989 TFLOP/s bf16
// (dense, H100 SXM); mma.sync reaches a fraction of that which wgmma does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;     // rows per strip
constexpr int NT = 4;      // m16n8 tiles per warp: 32 columns

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KT>
__global__ void __launch_bounds__(512)
probe_kpad_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  float* __restrict__ out, int M, int N, int K, int R, int G) {
  constexpr int KP = KT * 16;      // K padded to the mma depth
  constexpr int LD = KP + 8;       // a_i row stride in shared memory (bf16)
  __shared__ __align__(16) __nv_bfloat16 ai[2][BM * LD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col0 = warp * 32;      // the warp's first column

  // b's fragments for the warp's columns, rows >= K zero
  uint32_t bf[KT][NT][2];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = col0 + nt * 8 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = kt * 16 + half * 8 + 2 * t;
        const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
        const __nv_bfloat16 lo = k < K ? b[(int64_t)k * N + n] : z;
        const __nv_bfloat16 hi = k + 1 < K ? b[(int64_t)(k + 1) * N + n] : z;
        bf[kt][nt][half] = pack2(lo, hi);
      }
    }
  }
  // does this warp own columns < K (it writes the feedback)?
  const bool writer = col0 < K;
  const int strips = M / BM;
  const int64_t tasks = (int64_t)strips * G;

  for (int64_t task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int strip = (int)(task % strips);
    const int rep = (int)(task / strips);
    const int m0 = strip * BM;
    __syncthreads();               // the last task's readers are done
    // both buffers: a, zero past K
    for (int i = threadIdx.x; i < BM * KP; i += blockDim.x) {
      const int r = i / KP;
      const int k = i % KP;
      const __nv_bfloat16 v = k < K ? a[(int64_t)(m0 + r) * K + k] : __float2bfloat16_rn(0.f);
      ai[0][r * LD + k] = v;
      ai[1][r * LD + k] = v;
    }
    // the writer lanes' own a values, at their accumulator positions
    __nv_bfloat16 av[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8;
        const int k = col0 + nt * 8 + 2 * t + (e & 1);
        av[nt][e] = writer && k < K ? a[(int64_t)(m0 + r) * K + k] : __float2bfloat16_rn(0.f);
      }
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    __syncthreads();

    for (int i = 0; i < R; ++i) {
      __nv_bfloat16* buf = ai[i & 1];
      // a_i = a + bf16(acc[:, :K] * 1e-30), written by the owners of acc[:, :K]
      if (writer) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e >> 1) * 8;
            const int k = col0 + nt * 8 + 2 * t + (e & 1);
            if (k < K) buf[r * LD + k] = __hadd(av[nt][e], __float2bfloat16_rn(acc[nt][e] * 1e-30f));
          }
        }
      }
      __syncthreads();
      // acc += a_i @ b over the padded depth
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t af[4];
        const __nv_bfloat16* p = buf + kt * 16 + 2 * t;
        af[0] = *reinterpret_cast<const uint32_t*>(p + g * LD);
        af[1] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD);
        af[2] = *reinterpret_cast<const uint32_t*>(p + g * LD + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(p + (g + 8) * LD + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], af, bf[kt][nt][0], bf[kt][nt][1]);
      }
      // the next step writes the other buffer, which every warp finished
      // reading before this step's barrier
    }
    if (rep == G - 1) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = col0 + nt * 8 + 2 * t;
        float* o0 = out + (int64_t)(m0 + g) * N + n;
        float* o1 = out + (int64_t)(m0 + g + 8) * N + n;
        *reinterpret_cast<float2*>(o0) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(o1) = make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

template <int KT>
int launch(const void* a, const void* b, void* out, int M, int N, int K, int R, int G,
           cudaStream_t stream) {
  auto kernel = probe_kpad_kernel<KT>;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, N, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return -6;
  const int64_t tasks = (int64_t)(M / BM) * G;
  const int64_t full = (int64_t)sms * per_sm;
  const int blocks = (int)(tasks < full ? tasks : full);
  kernel<<<blocks, N, 0, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                   static_cast<const __nv_bfloat16*>(b),
                                   static_cast<float*>(out), M, N, K, R, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or a cudaError_t otherwise. a (M, K) and b (K, N) bf16 row-major,
// out (M, N) f32. M % 16 == 0, N % 32 == 0, N <= 512 (a thread per column), 1 <= K <= min(N, 128),
// R >= 1, G >= 1.
int poet_probe_kpad(const void* a, const void* b, void* out, int M, int N, int K, int R, int G,
                    void* stream) {
  if (M < BM || M % BM != 0) return -1;
  if (N < 32 || N % 32 != 0 || N > 512) return -2;
  if (K < 1 || K > 128 || K > N) return -3;
  if (R < 1 || G < 1) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((K + 15) / 16) {
    case 1: return launch<1>(a, b, out, M, N, K, R, G, s);
    case 2: return launch<2>(a, b, out, M, N, K, R, G, s);
    case 3: return launch<3>(a, b, out, M, N, K, R, G, s);
    case 4: return launch<4>(a, b, out, M, N, K, R, G, s);
    case 5: return launch<5>(a, b, out, M, N, K, R, G, s);
    case 6: return launch<6>(a, b, out, M, N, K, R, G, s);
    case 7: return launch<7>(a, b, out, M, N, K, R, G, s);
    case 8: return launch<8>(a, b, out, M, N, K, R, G, s);
  }
  return -3;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
