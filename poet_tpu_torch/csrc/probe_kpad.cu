// Probe: what does a bf16 tensor-core contraction cost as a function of its
// depth K, when the operands are resident and the products are chained?
// CUDA for Hopper (sm_90a): wgmma.mma_async (csrc/wgmma_sm90.cuh) on b held
// in shared memory, staged once per CTA by TMA (csrc/tma_sm90.cuh).
//
// Replaces the TPU probe scripts/bench_kpad.py:bench_k (its local `kernel`),
// which asked whether the TPU's matrix unit charges for K = 128 when the
// contraction is shallower. On Hopper the question belongs to wgmma, whose
// depth is 16 bf16: what K < 16 costs, and K that is not a multiple of 16
// (the stem conv's K = 27).
//
// The function, for each of G repeats (all equal):
//   acc = 0;  for i < R:  a_i = a + bf16(acc[:, :K] * 1e-30);  acc += a_i @ b
//   out = acc (f32)
// with a (M, K) and b (K, N) bf16 (K <= N, as the feedback needs), f32
// accumulation. The feedback makes each product depend on the last, and
// the compiler cannot fold it away; numerically a_i == a.
//
// Layout. b (K, N) row-major is an MN-major B operand: a TMA box of 64
// columns by KP rows (K padded to 16; rows >= K and columns >= N land as
// zeros by the out-of-bounds fill) lands each 64-column block under the
// 128-byte swizzle, the blocks KP x 128 bytes apart (the descriptor's LBO),
// 8-row atoms 1024 apart (its SBO); b stays resident for the whole launch
// (K x N x 2 <= 128 KB), as the TPU kernel's VMEM operands do. A task is (a
// 64-row strip, a repeat), and the grid walks the tasks persistently, one
// CTA an SM; only the last repeat of a strip writes its output. The strip's
// a values (rows past M and columns past K as zeros: the last strip of
// M = 960 has none, M % 16 == 0 allows up to 48) are staged by the CTA's
// threads once per task into shared memory, in the K-major core-matrix
// layout wgmma reads: a (M, K) rows are K x 2 bytes apart (54 at K = 27),
// which TMA cannot describe. The CTA's warpgroups each own WG_N = 256 (two
// warpgroups at N = 512) or 128 (four) columns of the accumulator, WG_N / 2
// f32 registers a thread.
//
// The feedback without a block barrier: wgmma's accumulator is, per 8
// columns, mma.sync's C layout, so the A register fragment of k-slice kk is
// the packed accumulator chunks 2 kk and 2 kk + 1 of the same thread.
// Warpgroup 0 owns the columns < K: it builds a_i in registers from its
// accumulator and the staged a, issues its KP / 16 products in the
// register-A form, and writes a_i to one of two shared buffers for the
// other warpgroups (fence.proxy.async, then a named barrier of the CTA's
// threads, bar.sync 1); they read a_i from that buffer in the shared-A form.
// Per step, in every warpgroup: wgmma.fence after the A registers are
// written, the KP / 16 products into one accumulator, commit, then
// wait_group 0 before the next feedback: that drain is the one dependence
// the TPU script built in on purpose (scripts/bench_kpad.py:38-44). The
// buffers alternate by step; warpgroup 0 writes a buffer only after the
// barrier of the step before, which the readers reach after their products
// on that buffer have completed.
//
// What bounds it: the tensor cores, 2 M N K R G flops at 989 TFLOP/s bf16
// (dense, H100 SXM). At M = 960 the 15 strips x G repeats are 7.5 tasks an
// SM at G = 66 (the last wave half full) and 10 at G = 88.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BM = 64;          // rows of a strip: one wgmma's M
constexpr int BLOCK_N = 64;     // columns of a TMA box of b: 128 bytes
constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle's atom

// Byte offset of (row m, column k) in a 64 x KP K-major core-matrix layout:
// core matrices of 8 rows x 8 columns (128 contiguous bytes), along K 128
// bytes apart (LBO), the groups of 8 rows KP x 16 bytes apart (SBO).
template <int KP>
__device__ __forceinline__ int a_offset(int m, int k) {
  return (m >> 3) * (KP * 16) + (k >> 3) * 128 + (m & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// the warpgroup's product over the padded depth: register A (warpgroup 0)
// or shared A
template <int WG_N>
__device__ __forceinline__ void mma_rs(float* acc, const uint32_t* a, uint64_t b_desc) {
  if constexpr (WG_N == 256) {
    wgmma_sm90::m64n256k16_rs<1>(acc, a, b_desc, 1);
  } else {
    wgmma_sm90::m64n128k16_rs<1>(acc, a, b_desc, 1);
  }
}

template <int WG_N>
__device__ __forceinline__ void mma_ss(float* acc, uint64_t a_desc, uint64_t b_desc) {
  if constexpr (WG_N == 256) {
    wgmma_sm90::m64n256k16_ss<0, 1>(acc, a_desc, b_desc, 1);
  } else {
    wgmma_sm90::m64n128k16_ss<0, 1>(acc, a_desc, b_desc, 1);
  }
}

template <int KT, int WG_N>
__global__ void __launch_bounds__(WG_N == 256 ? 256 : 512, 1)
probe_kpad_kernel(const __grid_constant__ CUtensorMap b_map, const __nv_bfloat16* __restrict__ a,
                  float* __restrict__ out, int M, int N, int K, int R, int G) {
  constexpr int KP = KT * 16;               // K padded to the wgmma depth
  constexpr int NREG = WG_N / 2;            // accumulator registers a thread
  constexpr int A_BYTES = BM * KP * 2;      // one 64 x KP bf16 operand
  constexpr int BLOCK_BYTES = KP * BLOCK_N * 2;
  extern __shared__ unsigned char smem_raw[];
  using tma_sm90::shared_addr;
  unsigned char* smem =
      smem_raw + ((SMEM_ALIGN - (shared_addr(smem_raw) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
  const int n_wg = (int)blockDim.x / 128;
  const int n_blocks = n_wg * WG_N / BLOCK_N;       // b's column blocks, padded
  unsigned char* b_s = smem;                        // n_blocks x BLOCK_BYTES
  unsigned char* a_s = b_s + n_blocks * BLOCK_BYTES;  // the strip's a
  unsigned char* ai_s = a_s + A_BYTES;              // a_i, two buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(ai_s + 2 * A_BYTES);

  // b, once per CTA: the blocks that hold columns < N by TMA, the rest zero
  const int tma_blocks = (N + BLOCK_N - 1) / BLOCK_N;
  if (threadIdx.x == 0) {
    tma_sm90::mbar_init(shared_addr(bar), 1);
    tma_sm90::fence_mbarrier_init();
  }
  for (int i = tma_blocks * BLOCK_BYTES / 16 + (int)threadIdx.x; i < n_blocks * BLOCK_BYTES / 16;
       i += blockDim.x) {
    reinterpret_cast<uint4*>(b_s)[i] = make_uint4(0, 0, 0, 0);
  }
  tma_sm90::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_sm90::mbar_expect_tx(shared_addr(bar), (uint32_t)(tma_blocks * BLOCK_BYTES));
    for (int j = 0; j < tma_blocks; ++j) {
      tma_sm90::tma_load_2d(shared_addr(b_s + j * BLOCK_BYTES), &b_map, shared_addr(bar),
                            j * BLOCK_N, 0);
    }
  }
  tma_sm90::mbar_wait(shared_addr(bar), 0);

  const int wg = (int)threadIdx.x / 128;
  const int w = ((int)threadIdx.x / 32) % 4;        // warp of the warpgroup: rows 16 w ..
  const int lane = (int)threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // b's columns for this warpgroup: on from its first column block
  const uint32_t b_wg = shared_addr(b_s + wg * (WG_N / BLOCK_N) * BLOCK_BYTES);
  const int strips = (M + BM - 1) / BM;
  const int64_t tasks = (int64_t)strips * G;

  for (int64_t task = blockIdx.x; task < tasks; task += gridDim.x) {
    const int strip = (int)(task % strips);
    const int rep = (int)(task / strips);
    const int m0 = strip * BM;
    __syncthreads();                                // the last task's readers are done
    for (int i = threadIdx.x; i < BM * KP; i += blockDim.x) {
      const int m = i / KP;
      const int k = i - m * KP;
      const __nv_bfloat16 v = m0 + m < M && k < K ? a[(int64_t)(m0 + m) * K + k]
                                                  : __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat16*>(a_s + a_offset<KP>(m, k)) = v;
    }
    __syncthreads();
    float acc[NREG];
#pragma unroll
    for (int j = 0; j < NREG; ++j) acc[j] = 0.f;

    for (int i = 0; i < R; ++i) {
      unsigned char* buf = ai_s + (i & 1) * A_BYTES;
      if (wg == 0) {
        // a_i's fragments: chunk pairs of the accumulator, columns >= K zero
        uint32_t af[KT][4];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int m = 16 * w + g + 8 * (r & 1);
            const int k = 16 * kk + 8 * (r >> 1) + 2 * t;
            const int off = a_offset<KP>(m, k);
            const __nv_bfloat162 base = *reinterpret_cast<const __nv_bfloat162*>(a_s + off);
            const __nv_bfloat162 sum = __hadd2(
                base, __floats2bfloat162_rn(acc[8 * kk + 2 * r] * 1e-30f,
                                            acc[8 * kk + 2 * r + 1] * 1e-30f));
            uint32_t u = *reinterpret_cast<const uint32_t*>(&sum);
            if (k >= K) u &= 0xFFFF0000u;
            if (k + 1 >= K) u &= 0x0000FFFFu;
            af[kk][r] = u;
            if (n_wg > 1) *reinterpret_cast<uint32_t*>(buf + off) = u;
          }
        }
        if (n_wg > 1) tma_sm90::fence_proxy_async();
        const uint64_t b_desc =
            wgmma_sm90::make_desc(b_wg, BLOCK_BYTES, 1024, wgmma_sm90::kSwizzle128B);
        wgmma_sm90::fence_operands<NREG>(acc);
        wgmma_sm90::fence();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {   // k-slice kk: 16 rows of b, 2048 bytes on
          mma_rs<WG_N>(acc, af[kk], b_desc + kk * (2048 >> 4));
        }
        wgmma_sm90::commit();
        if (n_wg > 1) named_bar_sync(1, blockDim.x);  // a_i is in buf
        wgmma_sm90::wait<0>();
        wgmma_sm90::fence_operands<NREG>(acc);
      } else {
        named_bar_sync(1, blockDim.x);
        const uint64_t a_desc =
            wgmma_sm90::make_desc(shared_addr(buf), 128, KP * 16, wgmma_sm90::kSwizzleNone);
        const uint64_t b_desc =
            wgmma_sm90::make_desc(b_wg, BLOCK_BYTES, 1024, wgmma_sm90::kSwizzle128B);
        wgmma_sm90::fence_operands<NREG>(acc);
        wgmma_sm90::fence();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {   // a_i's k-slice kk: two core matrices, 256 bytes on
          mma_ss<WG_N>(acc, a_desc + kk * (256 >> 4), b_desc + kk * (2048 >> 4));
        }
        wgmma_sm90::commit();
        wgmma_sm90::wait<0>();
        wgmma_sm90::fence_operands<NREG>(acc);
      }
    }
    if (rep == G - 1) {
      const int r0 = m0 + 16 * w + g;
#pragma unroll
      for (int c = 0; c < NREG / 4; ++c) {
        const int n = wg * WG_N + 8 * c + 2 * t;
        if (n >= N) continue;
        if (r0 < M) {
          *reinterpret_cast<float2*>(out + (int64_t)r0 * N + n) =
              make_float2(acc[4 * c], acc[4 * c + 1]);
        }
        if (r0 + 8 < M) {
          *reinterpret_cast<float2*>(out + (int64_t)(r0 + 8) * N + n) =
              make_float2(acc[4 * c + 2], acc[4 * c + 3]);
        }
      }
    }
  }
}

// bytes of dynamic shared memory a launch takes: b's blocks, the strip's a,
// the two a_i buffers, the mbarrier, and the slack of the 1024-byte alignment
int smem_bytes(int kp, int n_blocks) {
  return SMEM_ALIGN + n_blocks * kp * BLOCK_N * 2 + 3 * BM * kp * 2 + 16;
}

template <int KT, int WG_N>
int launch(const CUtensorMap& b_map, const void* a, void* out, int M, int N, int K, int R, int G,
           cudaStream_t stream) {
  auto kernel = probe_kpad_kernel<KT, WG_N>;
  const int n_wg = (N + WG_N - 1) / WG_N;
  const int threads = 128 * n_wg;
  const int smem = smem_bytes(KT * 16, n_wg * WG_N / BLOCK_N);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return -6;
  const int64_t tasks = (int64_t)((M + BM - 1) / BM) * G;
  const int64_t full = (int64_t)sms * per_sm;
  const int blocks = (int)(tasks < full ? tasks : full);
  kernel<<<blocks, threads, smem, stream>>>(b_map, static_cast<const __nv_bfloat16*>(a),
                                            static_cast<float*>(out), M, N, K, R, G);
  return (int)cudaGetLastError();
}

template <int WG_N>
int launch_k(const CUtensorMap& b_map, const void* a, void* out, int M, int N, int K, int R,
             int G, cudaStream_t s) {
  switch ((K + 15) / 16) {
    case 1: return launch<1, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 2: return launch<2, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 3: return launch<3, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 4: return launch<4, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 5: return launch<5, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 6: return launch<6, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 7: return launch<7, WG_N>(b_map, a, out, M, N, K, R, G, s);
    case 8: return launch<8, WG_N>(b_map, a, out, M, N, K, R, G, s);
  }
  return -3;
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-5: wg_n not 128 or 256, -7: b not 16-byte aligned, -21: no
// tensor-map encoder in libcuda, -22: libcuda refused b's tensor map), or a
// cudaError_t otherwise. a (M, K) and b (K, N) bf16 row-major, out (M, N)
// f32. M % 16 == 0, N % 32 == 0, N <= 512, 1 <= K <= min(N, 128), R >= 1,
// G >= 1; wg_n: the accumulator columns of a warpgroup, 256 (two warpgroups
// at N = 512, m64n256k16) or 128 (four, m64n128k16).
int poet_probe_kpad(const void* a, const void* b, void* out, int M, int N, int K, int R, int G,
                    int wg_n, void* stream) {
  if (M < 16 || M % 16 != 0) return -1;
  if (N < 32 || N % 32 != 0 || N > 512) return -2;
  if (K < 1 || K > 128 || K > N) return -3;
  if (R < 1 || G < 1) return -4;
  if (wg_n != 128 && wg_n != 256) return -5;
  if (reinterpret_cast<uintptr_t>(b) % 16 != 0) return -7;
  tma_sm90::EncodeTiled encode = tma_sm90::encoder();
  if (encode == nullptr) return -21;
  // b as (N, K) innermost first; a box of 64 columns x K padded to 16 rows
  const int kp = (K + 15) / 16 * 16;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BLOCK_N, (cuuint32_t)kp};
  const cuuint32_t unit[2] = {1, 1};
  CUtensorMap b_map;
  const CUresult r = encode(&b_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(b),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -22;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wg_n == 256 ? launch_k<256>(b_map, a, out, M, N, K, R, G, s)
                     : launch_k<128>(b_map, a, out, M, N, K, R, G, s);
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
