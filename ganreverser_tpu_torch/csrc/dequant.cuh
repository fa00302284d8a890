// The int8 kernels' epilogue arithmetic, one copy for all of them: Q1 and
// Q2 (conv_wgmma.cuh's DequantActEpilogue) and Q3 (quant.cu).
//
// y = fma(float(acc), deq, bias) with deq = x_scale * w_scale[c] rounded
// once to f32: one rounding, what XLA's CPU fusion of y * s + b computes
// and what ops/quant.py's plain versions emulate in f64; then the
// activation (ELU as jax.nn.elu, expm1; ReLU; sigmoid).
//
// The producers' max for Q4: a producer whose output the next layer
// quantises per tensor also raises a device word to max |y| of what it
// stored, so Q4 after it reads y once (quant.cu's quant_apply_max_kernel).
// The word holds the bits of a non-negative f32, which order as unsigned
// integers do, so one atomicMax per block is exact in any order of the
// blocks; the C entry point zeroes the word on the launch's stream first
// (a memset node under CUDA graph capture). A workspace of one partial per
// block would need no zeroing, but Q1 and Q2 run up to 8,192 blocks a
// launch at batch 256, and every block of the quantiser would read them
// all again; the word is also the 0-d output the custom op returns
// (ops/library.py: an output, not a mutated argument). |y| is folded with
// fmaxf from 0, so a NaN is dropped from the max, as Q4's own max drops it.
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

// max over the warp's 32 lanes, in every lane
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// *amax = max(*amax, m) on the bits of non-negative floats; the read first
// skips the atomic where another block already raised the word past m (a
// stale read is only ever lower, so the result is the same)
__device__ __forceinline__ void raise_amax(unsigned int* amax, float m) {
  const unsigned int bits = __float_as_uint(m);
  if (bits > *reinterpret_cast<volatile unsigned int*>(amax))
    atomicMax(amax, bits);
}

}  // namespace gr
