// Tensor-core and copy helpers shared by the stem conv and the min-distance
// kernels (sm_90a): inline PTX for mma.sync, ldmatrix, cp.async and the TF32
// split. A header: csrc/*.cu include it with #include "mma_sm90.cuh", and
// ops/cuda_build.py keys each library by its source and the headers it
// includes, so a change here rebuilds both.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4; C/D (16x8, f32) for every shape:
//   c0, c1 = C[g][2t, 2t+1],  c2, c3 = C[g+8][2t, 2t+1]
// m16n8k16 bf16: A reg0 = A[g][2t, 2t+1], reg1 = A[g+8][2t, 2t+1],
//                  reg2 = A[g][2t+8, 2t+9], reg3 = A[g+8][2t+8, 2t+9]
//                B reg0 = B[2t, 2t+1][g], reg1 = B[2t+8, 2t+9][g]
//                (the lower index in the low 16 bits)
// m16n8k8 tf32:  A a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//                B b0 = B[t][g], b1 = B[t+4][g]
// m16n8k4 tf32:  A a0 = A[g][t], a1 = A[g+8][t];  B b0 = B[t][g]
// ldmatrix .x4 gives lane l the b16 pair (row l/4, pair l%4) of each of the
// four 8x8 matrices whose row addresses lanes 8i..8i+7 supply; for 16 rows
// of 16 bytes addressed by lanes 0-15 (first half) and 16-31 (second half)
// that is exactly the m16n8k16 bf16 A fragment, and, reading a 16-byte row
// as 4 f32, the m16n8k8 tf32 A fragment.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros (no read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a @ b, bf16 operands, f32 accumulator (m16n8k16)
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a @ b, tf32 operands, f32 accumulator (m16n8k8)
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a, uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a @ b + c, tf32 operands, f32 accumulator (m16n8k4)
__device__ __forceinline__ void mma_tf32_1684(float* d, const uint32_t* a, uint32_t b,
                                              const float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// TF32 rounding of an f32 value: round to nearest, ties away from zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

}  // namespace mma_sm90
