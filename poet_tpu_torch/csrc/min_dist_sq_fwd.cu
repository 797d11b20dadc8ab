// Min squared distance (the ADD-S nearest-neighbour search) — CUDA for
// Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/nn_pallas.py:_kernel (reached from
// min_dist_sq_pallas), the nearest-neighbour search of the ADD-S metric:
//
//   gt   (P, N, 3)  f32, P poses of one model cloud under the gt transforms
//   est  (P, M, 3)  f32, the same cloud under the predicted transforms
//   out  (P, N)     f32, out[p, n] = min_m |gt[p, n] - est[p, m]|^2
//
// The (P, N, M) distance matrix is never formed. The TPU kernel's layout
// (gt points in 512 lanes, est chunks of 1024 in sublanes, est padded with
// a far point, |e|^2 + |g|^2 - 2 g.e on the matrix unit) exists for the
// TPU's vector lanes and MXU; none of it is carried over. There is no
// padding: the tails are bounds-checked.
//
// The distance is the direct difference form (gx-ex)^2 + (gy-ey)^2 +
// (gz-ez)^2: it cannot go negative (so the contract's max(0, .) is the
// identity here), it is exactly 0 for a duplicated point, and it has no
// cancellation. nvcc contracts it into one multiply and two FMAs, so it
// agrees with the plain version to rounding, not bit for bit.
//
// The minimum is PTX's min.NaN.f32: a NaN distance (a NaN coordinate on
// either side, e.g. a diverged model's pose) makes the result NaN, as
// jnp.minimum and torch.amin do. fminf would drop it and report a finite
// error for a pose that has none.
//
// What bounds it: operations. In this form every (gt, est) pair costs 3
// subtractions, 1 multiply, 2 FMAs and 1 min; at the BOP shape (P=64,
// N=M=15000) that is 1.44e10 pairs, 8 f32 operations each counting an FMA
// as 2: 1.72 ms at 67 TFLOP/s, against 5.8 MB of input and output (~2 us at
// 3.35 TB/s). The function itself needs less: the TPU kernel's form,
// |g|^2 + |e|^2 - 2 g.e, leaves one FMA and one add per pair on the f32
// pipes (0.65 ms) and puts the cross term on the tensor cores (3xTF32 for
// f32 accuracy, 0.52 ms, overlapped), so that form bounds it at 0.65 ms.
// What the design does about it:
//   * grid (ceil(N / 1024), P); each thread keeps 4 gt points and their 4
//     running minima in registers, so every est point read from shared
//     memory serves 4 pairs;
//   * the block stages est in tiles of 1024 points as float4 in shared
//     memory (16 KB); all threads read the same point at once, a broadcast
//     without bank conflicts;
//   * the inner loop is 7 instructions per pair and nothing else.
// Moving the cross term onto the tensor cores (|g|^2 + |e|^2 - 2 g.e as a
// product of depth 3, padded) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPtsPerThread = 4;
constexpr int kPtsPerBlock = kThreads * kPtsPerThread;
constexpr int kTile = 1024;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__global__ void __launch_bounds__(kThreads)
min_dist_sq_kernel(const float* __restrict__ gt, const float* __restrict__ est,
                   float* __restrict__ out, int N, int M) {
  __shared__ float4 tile[kTile];
  const int p = blockIdx.y;
  const float* g = gt + (size_t)p * N * 3;
  const float* e = est + (size_t)p * M * 3;
  const int first = blockIdx.x * kPtsPerBlock + threadIdx.x;

  float gx[kPtsPerThread], gy[kPtsPerThread], gz[kPtsPerThread], best[kPtsPerThread];
#pragma unroll
  for (int k = 0; k < kPtsPerThread; ++k) {
    const int n = first + k * kThreads;
    // a point past N computes on zeros and is never stored
    gx[k] = n < N ? g[(size_t)n * 3] : 0.f;
    gy[k] = n < N ? g[(size_t)n * 3 + 1] : 0.f;
    gz[k] = n < N ? g[(size_t)n * 3 + 2] : 0.f;
    best[k] = INFINITY;
  }

  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int count = min(kTile, M - t0);
    __syncthreads();                       // the previous tile is consumed
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const float* q = e + (size_t)(t0 + i) * 3;
      tile[i] = make_float4(q[0], q[1], q[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const float4 q = tile[j];
#pragma unroll
      for (int k = 0; k < kPtsPerThread; ++k) {
        const float dx = gx[k] - q.x, dy = gy[k] - q.y, dz = gz[k] - q.z;
        best[k] = min_nan(best[k], dx * dx + dy * dy + dz * dz);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPtsPerThread; ++k) {
    const int n = first + k * kThreads;
    if (n < N) out[(size_t)p * N + n] = best[k];
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
  const dim3 grid((N + kPtsPerBlock - 1) / kPtsPerBlock, P);
  min_dist_sq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gt), static_cast<const float*>(est), static_cast<float*>(out),
      N, M);
  return (int)cudaGetLastError();
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
