// Kernel U: nearest 2x upsample + 3x3 SAME conv + folded eval-BatchNorm
// scale/shift + activation, computed as four output phases of a 2x2 conv
// with phase-aggregated weights at the input resolution.
//
// Replaces ganreverser_tpu/ops/upsample_conv_kernel.py::
// upsample2_conv3x3_bn_act (_kernel, with phase_kernels on the host). A 3x3
// window over a nearest-upsampled image sees only 2x2 distinct input pixels,
// so phase (a, b) of output pixel (2i + a, 2j + b) is
//
//   sum_{ta, tb} xpad[i + a + ta, j + b + tb] . K[a, ta, b, tb]
//
// with K aggregated on the host (16 MACs per output pixel and channel pair
// instead of 36). blockIdx.z is the phase; each phase writes its strided
// quarter of the output directly, so the upsampled input never exists and
// the interleave costs no extra pass.
//
// What bounds it: FMA issue, as kernel B (conv_block.cu): stage 1's
// aggregated weights are 16x512x256 (4 MB in bf16), streamed BK input
// channels at a time through shared memory, with f32 CUDA-core FMAs in this
// first version. The fused final conv head of the TPU kernel is not part of
// this kernel (the generator's head stays a plain convolution).
#include "conv_tile.cuh"

namespace gr {

struct PhaseTaps {
  int a, b;
  __device__ __forceinline__ void operator()(int t, int& dy, int& dx,
                                             int& widx) const {
    const int ta = t >> 1;
    const int tb = t & 1;
    dy = a + ta - 1;  // padded row i + a + ta is input row i + a + ta - 1
    dx = b + tb - 1;
    widx = ((a * 2 + ta) * 2 + b) * 2 + tb;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) upsample2_conv3x3_bn_act_kernel(
    const T* __restrict__ x, const T* __restrict__ k16,
    const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ out, int N, int H, int W, int Ci, int Co, int act) {
  const int a = blockIdx.z >> 1;
  const int b = blockIdx.z & 1;
  const long long rows = static_cast<long long>(N) * H * W;
  const long long per = static_cast<long long>(H) * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int co0 = blockIdx.y * kBN;

  RowCoord rc;
  {
    long long m = m0 + (threadIdx.x >> 2);
    rc.valid = m < rows;
    if (!rc.valid) m = 0;
    rc.n = static_cast<int>(m / per);
    const int r = static_cast<int>(m % per);
    rc.i = r / W;
    rc.j = r % W;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;

  conv_tile_mainloop<T, 4>(x, k16, H, W, Ci, Co, rc, co0, PhaseTaps{a, b},
                           acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int H2 = 2 * H, W2 = 2 * W;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const long long m = m0 + ty * kTM + r;
    if (m >= rows) break;
    const int n = static_cast<int>(m / per);
    const int rem = static_cast<int>(m % per);
    const int oi = 2 * (rem / W) + a;
    const int oj = 2 * (rem % W) + b;
    T* orow = out + ((static_cast<long long>(n) * H2 + oi) * W2 + oj) * Co;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int co = co0 + tx * kTN + c;
      if (co < Co)
        orow[co] = from_f32<T>(
            apply_act(fmaf(acc[r][c], scale[co], shift[co]), act));
    }
  }
}

template <typename T>
static void launch(const void* x, const void* k16, const void* scale,
                   const void* shift, void* out, int n, int h, int w, int ci,
                   int co, int act, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 4);
  upsample2_conv3x3_bn_act_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k16),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), n, h, w, ci, co, act);
}

}  // namespace gr

// x (N,H,W,Ci) and k16 (16,Ci,Co, flattened [a,ta,b,tb]) in the storage
// type, scale/shift (Co,) f32, out (N,2H,2W,Co) in the storage type.
extern "C" int gr_upsample2_conv3x3_bn_act(int dtype, const void* x,
                                           const void* k16, const void* scale,
                                           const void* shift, void* out, int n,
                                           int h, int w, int ci, int co,
                                           int act, void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(x, k16, scale, shift, out, n, h, w, ci, co, act, s);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(x, k16, scale, shift, out, n, h, w, ci, co, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
