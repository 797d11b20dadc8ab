// Tensor Memory Accelerator (TMA) and mbarrier helpers (sm_90a): inline PTX
// for shared-memory addresses, the transaction-counting mbarrier, tiled
// tensor loads of 2 and 4 dimensions, the proxy fence, and libcuda's
// tensor-map encoder reached at run time. A header: ms_deform_attn_v2.cu (the
// v2 forward's staged slab), ms_deform_attn_fwd_variants.cu (the forward's
// ablations on a staged slab) and probe_kpad.cu (b resident in shared memory)
// include it, and ops/cuda_build.py keys each library by it too.
//
// A load: one thread calls mbar_expect_tx(bar, bytes) for everything a phase
// of the barrier brings, then issues the boxes (tma_load_2d / _4d), each
// naming the barrier; every thread that reads the data waits with
// mbar_wait(bar, parity). A box's shared destination must be 128-byte
// aligned (1024-byte aligned under the 128-byte swizzle, whose XOR pattern
// follows address bits 7-9); the box's bytes count in full, out-of-bounds
// elements included (filled with zeros under CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE).
// The tensor map is a `const __grid_constant__ CUtensorMap` kernel parameter:
// its address is a generic address in the parameter space.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is reached at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma_sm90 {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// after mbar_init, before a barrier that hands the mbarrier to other threads
// (or to the TMA unit)
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// the box at (c0, c1) of a 2-dimensional map into shared memory at dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the box at (c0, c1, c2, c3) of a 4-dimensional map into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory writes of this thread (the generic proxy) made visible to
// the asynchronous proxy: wgmma's operand reads and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- host: libcuda's cuTensorMapEncodeTiled, without linking libcuda ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoder, looked up once through the runtime; nullptr where the driver
// has none.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

}  // namespace tma_sm90
