// The activations the hand-written convolution epilogues apply, in f32:
// conv_stem_fwd.cu (the stem's implicit GEMM) and darknet_epilogue.cu (the
// darknet body's FrozenBN + activation pass). Each follows the plain
// PyTorch version operation by operation (ops/conv_stem_cuda.py:ACTIVATIONS,
// ops/darknet_epilogue_cuda.py:activate), each step rounded on its own, so
// an f32 result is the plain version's up to expf's last bits.
#pragma once

#include <cuda_runtime.h>

namespace poet_act {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_MISH = 2, ACT_LEAKY = 3 };

__device__ __forceinline__ float activate(int act, float v) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v > 0.f ? v : __fmul_rn(0.1f, v);
  if (act == ACT_MISH) {
    // x * tanh(softplus(x)) as 1 - 2 / ((1 + e^x)^2 + 1), x clamped at 25,
    // each operation rounded on its own as in the plain version
    const float e = expf(fminf(v, 25.f));
    const float p = __fadd_rn(1.f, e);
    // 2 / d as 2 * rcp_rn(d): scaling by 2 is exact, so this is the IEEE
    // quotient, without the division's slow-path check
    const float t = __fsub_rn(1.f, 2.f * __frcp_rn(__fadd_rn(__fmul_rn(p, p), 1.f)));
    return v > 25.f ? v : __fmul_rn(v, t);
  }
  return v;
}

}  // namespace poet_act
