// Probe: a dynamic gather along rows, out[r, c] = table[idx[r, c], c] —
// CUDA for Hopper (sm_90a).
//
// Replaces the TPU probe scripts/test_dyn_gather.py:kernel, which asked
// whether jnp.take_along_axis(table, idx, axis=0) lowers inside a Pallas
// kernel (Mosaic's dynamic_gather): same-shape f32, an index with fewer
// rows than the table, bf16, and a 4800-row table. On Hopper a gather is a
// load with a computed address, so the question becomes what it costs.
//
//   table (T, C) f32 or bf16, idx (R, C) int32 in [0, T) (the wrapper
//   checks the range on the device before the launch), out (R, C) in the
//   table's dtype.
//
// One thread per output element, neighbouring threads on neighbouring
// columns: the idx reads and out writes are coalesced, each table read is a
// 4- or 2-byte load from the row its index names. What bounds it: bytes
// (idx, out, and the table elements the indices name, read once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// I: the index type of the element loop (32-bit below 2^31 elements: a
// 64-bit modulo is a long software sequence)
template <typename E, typename I>
__global__ void __launch_bounds__(256)
take_along_axis_kernel(const E* __restrict__ table, const int* __restrict__ idx,
                       E* __restrict__ out, int C, I n) {
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (I)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    out[i] = table[(int64_t)__ldg(idx + i) * C + c];
  }
}

template <typename E>
int launch(const void* table, const void* idx, void* out, int R, int C, cudaStream_t stream) {
  const int64_t n = (int64_t)R * C;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  const E* t = static_cast<const E*>(table);
  const int* x = static_cast<const int*>(idx);
  E* o = static_cast<E*>(out);
  if (n + (int64_t)blocks * threads < ((int64_t)1 << 31)) {
    take_along_axis_kernel<E, int><<<(unsigned)blocks, threads, 0, stream>>>(t, x, o, C, (int)n);
  } else {
    take_along_axis_kernel<E, int64_t><<<(unsigned)blocks, threads, 0, stream>>>(t, x, o, C, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch otherwise. dtype: 0 = float32,
// 1 = bfloat16.
int poet_take_along_axis(const void* table, const void* idx, void* out, int dtype, int T, int R,
                         int C, void* stream) {
  if (T < 1 || R < 0 || C < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, idx, out, R, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(table, idx, out, R, C, s);
  return -2;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
