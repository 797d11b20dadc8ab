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
// Each thread takes one 16-byte slice of a row's columns, VEC = 4 f32 or 8
// bf16 columns: the slice's indices arrive in 16-byte loads (one for f32,
// two for bf16), each of its VEC table elements is a load from the row its
// index names, and the slice leaves in one 16-byte store. Where C or a
// pointer does not allow 16 bytes the wrapper asks for VEC = 1 (scalar
// columns). The grid is sized to the card (8 blocks of 256 threads on
// every SM, the SM's 2048 threads) and walks the rest: a thread steps its
// (row, slice) by the grid's stride, itself split into rows and slices
// once, so no division runs in the loop.
//
// What bounds it: bytes (idx, out, and the table elements the indices name,
// read once): 6.5 MB at the 4800-row case, about 2 us at 3.35 TB/s, the
// order of one launch. Called from the host it is bound by its launch: the
// wrapper keeps its per-call host work to the checks, one allocation and
// the ctypes call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kMaxDevices = 64;

template <typename E, int VEC>
struct Slice;

template <typename E>
struct Slice<E, 1> {
  static __device__ __forceinline__ void take(const E* __restrict__ table,
                                              const int* __restrict__ idx, E* __restrict__ out,
                                              int64_t o, int col, int C) {
    out[o] = __ldg(table + (int64_t)__ldg(idx + o) * C + col);
  }
};

template <>
struct Slice<float, 4> {
  static __device__ __forceinline__ void take(const float* __restrict__ table,
                                              const int* __restrict__ idx,
                                              float* __restrict__ out, int64_t o, int col,
                                              int C) {
    const int4 i = __ldg(reinterpret_cast<const int4*>(idx + o));
    float4 v;
    v.x = __ldg(table + (int64_t)i.x * C + col);
    v.y = __ldg(table + (int64_t)i.y * C + col + 1);
    v.z = __ldg(table + (int64_t)i.z * C + col + 2);
    v.w = __ldg(table + (int64_t)i.w * C + col + 3);
    *reinterpret_cast<float4*>(out + o) = v;
  }
};

template <>
struct Slice<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void take(const __nv_bfloat16* __restrict__ table,
                                              const int* __restrict__ idx,
                                              __nv_bfloat16* __restrict__ out, int64_t o,
                                              int col, int C) {
    const int4 i[2] = {__ldg(reinterpret_cast<const int4*>(idx + o)),
                       __ldg(reinterpret_cast<const int4*>(idx + o) + 1)};
    const unsigned short* t = reinterpret_cast<const unsigned short*>(table);
    uint4 v;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const unsigned a = __ldg(t + (int64_t)i[j].x * C + col + 4 * j);
      const unsigned b = __ldg(t + (int64_t)i[j].y * C + col + 4 * j + 1);
      const unsigned c = __ldg(t + (int64_t)i[j].z * C + col + 4 * j + 2);
      const unsigned d = __ldg(t + (int64_t)i[j].w * C + col + 4 * j + 3);
      w[2 * j] = a | (b << 16);
      w[2 * j + 1] = c | (d << 16);
    }
    *reinterpret_cast<uint4*>(out + o) = v;
  }
};

template <typename E, int VEC>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const E* __restrict__ table, const int* __restrict__ idx,
                       E* __restrict__ out, int R, int C) {
  const int slices = C / VEC;  // per row
  const int start = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  int r = start / slices;
  int s = start - r * slices;
  const int dr = stride / slices;
  const int ds = stride - dr * slices;
  while (r < R) {
    const int col = s * VEC;
    Slice<E, VEC>::take(table, idx, out, (int64_t)r * C + col, col, C);
    r += dr;
    s += ds;
    if (s >= slices) {
      s -= slices;
      ++r;
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices];
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices) return 0;
  if (cached[device] == 0) {
    cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount, device);
  }
  return cached[device];
}

template <typename E, int VEC>
int launch(const void* table, const void* idx, void* out, int R, int C, cudaStream_t stream) {
  const int64_t items = (int64_t)R * (C / VEC);
  if (items == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return -5;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  take_along_axis_kernel<E, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const E*>(table), static_cast<const int*>(idx), static_cast<E*>(out), R, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch otherwise. dtype: 0 = float32,
// 1 = bfloat16; vec: columns per thread, 1 or the 16-byte width (4 f32,
// 8 bf16), which needs C a multiple of it and the three pointers aligned to
// 16 bytes.
int poet_take_along_axis(const void* table, const void* idx, void* out, int dtype, int T, int R,
                         int C, int vec, void* stream) {
  if (T < 1 || R < 0 || C < 1) return -1;
  const int wide = dtype == 0 ? 4 : 8;
  if (vec != 1 && (vec != wide || C % vec != 0)) return -3;
  if (vec != 1 && (((uintptr_t)table | (uintptr_t)idx | (uintptr_t)out) & 15) != 0) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 1 ? launch<float, 1>(table, idx, out, R, C, s)
                    : launch<float, 4>(table, idx, out, R, C, s);
  }
  if (dtype == 1) {
    return vec == 1 ? launch<__nv_bfloat16, 1>(table, idx, out, R, C, s)
                    : launch<__nv_bfloat16, 8>(table, idx, out, R, C, s);
  }
  return -2;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
