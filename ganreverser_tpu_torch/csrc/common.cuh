// Shared helpers of the hand-written Hopper kernels: f32 <-> storage-type
// conversion, the activation epilogue and the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gr {

// dtype codes passed from Python (ops/cuda_lib.py::DTYPE_CODES)
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// activation codes (ops/cuda_lib.py::ACT_CODES)
enum Act {
  ACT_NONE = 0,
  ACT_RELU = 1,
  ACT_ELU = 2,
  ACT_SIGMOID = 3,
  ACT_PRELU = 4,
  ACT_TANH = 5
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ``alpha`` is the PReLU slope, read only for ACT_PRELU
__device__ __forceinline__ float apply_act(float y, int act,
                                           float alpha = 0.0f) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_ELU:
      // the TPU kernel's form, exp of the clamped negative side minus one
      return y > 0.0f ? y : expf(fminf(y, 0.0f)) - 1.0f;
    case ACT_SIGMOID:
      return 1.0f / (1.0f + expf(-y));
    case ACT_PRELU:
      // nn.PReLU's one shared slope, the TPU kernel's where(y >= 0, y, a y)
      return y >= 0.0f ? y : alpha * y;
    default:
      return y;
  }
}

// The dense layers' activation as PyTorch computes it (ops/dense_kernel.py's
// plain version): ReLU, F.elu's expm1 form, tanh; none for any other code
__device__ __forceinline__ float torch_act(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_ELU:
      return y > 0.0f ? y : expm1f(y);
    case ACT_TANH:
      return tanhf(y);
    default:
      return y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace gr
