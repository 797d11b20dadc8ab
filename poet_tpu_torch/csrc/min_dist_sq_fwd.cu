// Min squared distance (the ADD-S nearest-neighbour search) — CUDA for
// Hopper (sm_90a), the ranking on the tensor cores (mma.sync TF32).
//
// Replaces the TPU kernel poet_tpu/ops/nn_pallas.py:_kernel (reached from
// min_dist_sq_pallas), the nearest-neighbour search of the ADD-S metric:
//
//   gt   (P, N, 3)  f32, P poses of one model cloud under the gt transforms
//   est  (P, M, 3)  f32, the same cloud under the predicted transforms
//   out  (P, N)     f32, out[p, n] = min_m |gt[p, n] - est[p, m]|^2
//
// The (P, N, M) distance matrix is never formed, and nothing is padded in
// memory: the tails are bounds-checked.
//
// Ranking. For one gt point g, |g - e|^2 = |g|^2 + s(g, e) with
//   s(g, e) = |e|^2 - 2 g.e = [gx, gy, gz, 1] . [-2ex, -2ey, -2ez, |e|^2],
// a product of depth 4, and |g|^2 does not change which e wins. So the
// kernel ranks the est points by s on the tensor cores, with
// mma.sync TF32 in the 3xTF32 split (hi = tf32(v), lo = tf32(v - hi) on
// both sides): the small products A_hi B_lo + A_lo B_hi are one m16n8k8
// product, [A_hi | A_lo] . [B_lo ; B_hi], into an accumulator of their own
// started from zero, which then seeds the big product A_hi B_hi, an
// m16n8k4 of depth 4 exactly, so that the tensor cores' truncating adds
// meet the small terms once, at the result's magnitude. s then has about
// f32 accuracy (a few 2^-23 of |e|^2 + 2|g||e|).
//
// Result. The winner's distance is recomputed in the direct difference
// form (gx-ex)^2 + (gy-ey)^2 + (gz-ez)^2, so the result keeps the direct
// form's properties: it cannot go negative (the contract's max(0, .) is the
// identity), it is exactly 0 for a duplicated point, and it has no
// cancellation on uncentred clouds. A near-tie that the ranking resolves the
// other way changes the result by at most the ranking's error, a few 2^-23
// of max |gt|^2 (the plain version agrees within 2e-6 of it). nvcc contracts
// the recompute into FMAs: it agrees with the plain version to rounding.
//
// NaN. A `<` comparison never selects a NaN, so NaN is carried on its own:
// the block sets a flag while it stages the est points (a NaN est point makes
// its pose's whole row NaN, as min.NaN / jnp.minimum / torch.amin do), and
// each gt point is checked as it is stored (a NaN gt point makes its own
// entry NaN).
//
// What bounds it: operations. At the BOP shape (P=64, N=M=15000: 1.44e10
// pairs) the cross term is 3 TF32 products of depth 4 per pair, 24 flops:
// 0.70 ms at the 495 TFLOP/s TF32 peak; the direct form on the f32 pipes
// would need 7 instructions per pair, 3.0 ms of issue. What the design does:
//   * a block is 8 warps and 256 gt points of one pose; a warp owns two m16
//     tiles (32 gt points), whose hi/lo A fragments sit in registers for the
//     whole kernel, so each B fragment loaded from shared memory serves two
//     tiles. Every block streams and converts its pose's whole est cloud,
//     so a block of 256 gt points halves that cost against 128 (phase 15:
//     2.56 ms with 128, 2.43 with 256);
//   * est points stream through shared memory in tiles of 256: the raw
//     coordinates arrive by cp.async while the previous tile is ranked, and
//     each point's [-2e, |e|^2] and its hi/lo split are computed once per
//     point when the tile is converted, not once per gt row;
//   * per n8 tile a warp issues one k8 and one k4 mma per m16 tile, two
//     tensor instructions where the plain split takes three k4. Every
//     product's result then goes through a min, and min, compare and select
//     run at half the FMA rate: the kernel takes the min of a thread's 8
//     columns in a group of 4 n8 tiles per row (7 FMNMX), then one
//     compare-and-select of (min, group index) against the running best,
//     ~1.25 such instructions per pair (phase 15: 2.88 ms with groups of 2
//     tiles, ~1.5 per pair; 2.65 with 4);
//   * at the end the 4 threads that share a row each recompute the direct
//     distance of their 8 winning columns, and warp shuffles merge them;
//   * the grid is (ceil(N / 256), P): 3776 blocks at the BOP shape, about 7
//     waves of 4 resident blocks per SM on 132 SMs, so the last partial wave
//     costs at most one block in ~29 per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMTiles = 2;                           // m16 tiles per warp
constexpr int kRowsPerBlock = kWarps * kMTiles * 16;
constexpr int kTile = 256;                           // est points per stage
constexpr int kGroup = 4;                            // n8 tiles per compare-and-select
constexpr float kFar = 3.0e38f;                      // s of a padding column

// the direct difference form (nvcc contracts it into a multiply and two FMAs)
__device__ __forceinline__ float direct(float gx, float gy, float gz, const float* e) {
  const float dx = gx - e[0], dy = gy - e[1], dz = gz - e[2];
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads, 4)
min_dist_sq_kernel(const float* __restrict__ gt, const float* __restrict__ est,
                   float* __restrict__ out, int N, int M) {
  __shared__ __align__(16) float raw[kTile * 3];     // the next tile's coordinates
  __shared__ __align__(16) uint32_t b_hi[kTile * 4];  // [-2e, |e|^2], tf32 hi
  __shared__ __align__(16) uint32_t b_lo[kTile * 4];  // and lo
  __shared__ int est_nan;

  const int p = blockIdx.y;
  const float* g = gt + (size_t)p * N * 3;
  const float* e = est + (size_t)p * M * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kMTiles * 16;

  // A fragments: a0 = A[gq][tq], a1 = A[gq + 8][tq], A = [gx, gy, gz, 1]
  uint32_t a_hi[kMTiles][2], a_lo[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + mt * 16 + gq + 8 * h;
      // a point past N ranks zeros and is never stored
      const float v = tq == 3 ? 1.f : (n < N ? g[(size_t)n * 3 + tq] : 0.f);
      split_tf32(v, a_hi[mt][h], a_lo[mt][h]);
    }

  if (threadIdx.x == 0) est_nan = 0;
  auto fetch = [&](int t0) {                         // raw <- est[t0 .. t0 + kTile)
    const int count = min(kTile, M - t0) * 3;
    for (int i = threadIdx.x; i < count; i += kThreads) cp_async4(raw + i, e + (size_t)t0 * 3 + i);
    cp_async_commit();
  };
  auto convert = [&](int count) {                    // raw -> b_hi, b_lo
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      float v[4] = {0.f, 0.f, 0.f, kFar};
      if (j < count) {
        const float x = raw[3 * j], y = raw[3 * j + 1], z = raw[3 * j + 2];
        if (isnan(x) || isnan(y) || isnan(z)) est_nan = 1;
        v[0] = -2.f * x; v[1] = -2.f * y; v[2] = -2.f * z;
        v[3] = x * x + y * y + z * z;
      }
      uint4 hi, lo;
      split_tf32(v[0], hi.x, lo.x);
      split_tf32(v[1], hi.y, lo.y);
      split_tf32(v[2], hi.z, lo.z);
      split_tf32(v[3], hi.w, lo.w);
      reinterpret_cast<uint4*>(b_hi)[j] = hi;
      reinterpret_cast<uint4*>(b_lo)[j] = lo;
    }
  };

  float best[kMTiles][2];
  int best_n0[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mt][h] = INFINITY;
      best_n0[mt][h] = -1;
    }

  fetch(0);
  cp_async_wait_all();
  __syncthreads();
  convert(min(kTile, M));
  __syncthreads();
  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int next = t0 + kTile;
    if (next < M) fetch(next);                       // arrives while this tile is ranked
    const int ntiles = (min(kTile, M - t0) + 8 * kGroup - 1) / (8 * kGroup) * kGroup;
#pragma unroll 2
    for (int j = 0; j < ntiles; j += kGroup) {
      uint32_t bh[kGroup], bl[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int slot = ((j + u) * 8 + gq) * 4 + tq;  // B[tq][gq] of n8 tile j + u
        bh[u] = b_hi[slot];
        bl[u] = b_lo[slot];
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        // the k8 product [A_hi | A_lo] . [B_lo ; B_hi] is the small terms
        const uint32_t a8[4] = {a_hi[mt][0], a_hi[mt][1], a_lo[mt][0], a_lo[mt][1]};
        float s[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float sml[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32_1688(sml, a8, bl[u], bh[u]);
          mma_tf32_1684(s[u], a_hi[mt], bh[u], sml);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = fminf(s[0][2 * h], s[0][2 * h + 1]);
#pragma unroll
          for (int u = 1; u < kGroup; ++u) v = fminf(v, fminf(s[u][2 * h], s[u][2 * h + 1]));
          const bool better = v < best[mt][h];
          best[mt][h] = fminf(best[mt][h], v);
          best_n0[mt][h] = better ? t0 + j * 8 : best_n0[mt][h];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();                                 // b_* consumed, raw arrived
    if (next < M) {
      convert(min(kTile, M - next));
      __syncthreads();
    }
  }

  // the winners' direct distances, merged over the 4 threads of a row
  const bool any_nan = est_nan != 0;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + mt * 16 + gq + 8 * h;
      const int nc = n < N ? n : N - 1;
      const float gx = g[(size_t)nc * 3], gy = g[(size_t)nc * 3 + 1], gz = g[(size_t)nc * 3 + 2];
      float d = INFINITY;
      if (best_n0[mt][h] >= 0) {
#pragma unroll
        for (int c = 0; c < 2 * kGroup; ++c) {
          const int m = best_n0[mt][h] + (c >> 1) * 8 + 2 * tq + (c & 1);
          if (m < M) d = fminf(d, direct(gx, gy, gz, e + (size_t)m * 3));
        }
      }
      d = fminf(d, __shfl_xor_sync(0xffffffffu, d, 1));
      d = fminf(d, __shfl_xor_sync(0xffffffffu, d, 2));
      if (tq == 0 && n < N) {
        const bool nan = any_nan || isnan(gx) || isnan(gy) || isnan(gz);
        out[(size_t)p * N + n] = nan ? NAN : d;
      }
    }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   gt (P, N, 3), est (P, M, 3), out (P, N): contiguous f32 device memory
int poet_min_dist_sq_fwd(const void* gt, const void* est, void* out, int P, int N, int M,
                         void* stream) {
  if (P < 1 || N < 1 || M < 1) return -1;
  if (P > 65535) return -2;                  // grid.y
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, P);
  min_dist_sq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gt), static_cast<const float*>(est), static_cast<float*>(out),
      N, M);
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
