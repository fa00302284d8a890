// The int8 kernels' epilogue arithmetic, one copy for all of them: Q1 and
// Q2 (conv_wgmma.cuh's DequantActEpilogue) and Q3 (quant.cu).
//
// y = fma(float(acc), deq, bias) with deq = x_scale * w_scale[c] rounded
// once to f32: one rounding, what XLA's CPU fusion of y * s + b computes
// and what ops/quant.py's plain versions emulate in f64; then the
// activation (ELU as jax.nn.elu, expm1; ReLU; sigmoid).
#pragma once

#include "common.cuh"

namespace gr {

__device__ __forceinline__ float dequant_act(int acc, float deq, float bias,
                                             int act) {
  const float y = __fmaf_rn(__int2float_rn(acc), deq, bias);
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_ELU:  // jax.nn.elu: where(y > 0, y, expm1(y))
      return y > 0.0f ? y : expm1f(y);
    case ACT_SIGMOID:
      return 1.0f / (1.0f + expf(-y));
    default:
      return y;
  }
}

}  // namespace gr
