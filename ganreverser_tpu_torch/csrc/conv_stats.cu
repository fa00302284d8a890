// Kernel B7: one 3x3 SAME conv whose f32 output is written once, with the
// per-channel sum and sum of squares over N*H*W (a training BatchNorm's
// statistics) taken in the same pass.
//
// Replaces benchmarks/convbn_probe.py::conv_stats_kernel, which carries
// (1, Co) sum/sumsq accumulators across its sequential grid. Blocks on this
// card run in parallel and in no order, so there are two launches and no
// float atomics, as kernel K (kmeans.cu):
//
//  1. conv_stats_kernel: kernel B's implicit-GEMM tile (conv_tile.cuh, 9
//     taps, 64 pixels x 64 channels per block). The epilogue writes y in
//     f32 and sums each channel over the block's 64 rows in a fixed order
//     (each thread its 4 rows, then the 16 row groups in shared memory),
//     writing one partial sum and sumsq per (channel, block) to a
//     workspace laid out [channel][block].
//  2. conv_stats_finish_kernel: one block per channel sums that channel's
//     partials, each thread a fixed stride of blocks in order, then a fixed
//     tree in shared memory. Two runs give bitwise-equal sums.
//
// What bounds it: FMA issue, as kernel B: (256,64,64,256) -> 128 is 618
// GFLOP on 0.27 GB of bf16 input and 0.54 GB of f32 output, far above the
// card's ridge point. The statistics add one f32 read of nothing: they are
// taken from the accumulators before y is written.
#include "conv_tile.cuh"

namespace gr {

constexpr int kFinishThreads = 256;

struct StatsConvTaps {
  __device__ __forceinline__ void operator()(int t, int& dy, int& dx,
                                             int& widx) const {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
    widx = t;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w9,
                      float* __restrict__ y, float* __restrict__ part_sum,
                      float* __restrict__ part_sq, int N, int H, int W, int Ci,
                      int Co) {
  __shared__ float red_s[kBM / kTM][kBN];
  __shared__ float red_q[kBM / kTM][kBN];
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

  conv_tile_mainloop<T, 9>(x, w9, H, W, Ci, Co, rc, co0, StatsConvTaps{}, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[kTN], q[kTN];
#pragma unroll
  for (int c = 0; c < kTN; ++c) s[c] = q[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const long long m = m0 + ty * kTM + r;
    if (m >= rows) break;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int co = co0 + tx * kTN + c;
      if (co < Co) {
        const float v = acc[r][c];
        y[m * Co + co] = v;
        s[c] += v;
        q[c] = fmaf(v, v, q[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    red_s[ty][tx * kTN + c] = s[c];
    red_q[ty][tx * kTN + c] = q[c];
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int co = co0 + threadIdx.x;
    float ts = 0.0f, tq = 0.0f;
    for (int g = 0; g < kBM / kTM; ++g) {
      ts += red_s[g][threadIdx.x];
      tq += red_q[g][threadIdx.x];
    }
    if (co < Co) {
      const long long at = static_cast<long long>(co) * gridDim.x + blockIdx.x;
      part_sum[at] = ts;
      part_sq[at] = tq;
    }
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    conv_stats_finish_kernel(const float* __restrict__ part_sum,
                             const float* __restrict__ part_sq,
                             float* __restrict__ sum, float* __restrict__ sumsq,
                             int nblocks) {
  __shared__ float red_s[kFinishThreads];
  __shared__ float red_q[kFinishThreads];
  const int co = blockIdx.x;
  const float* ps = part_sum + static_cast<long long>(co) * nblocks;
  const float* pq = part_sq + static_cast<long long>(co) * nblocks;
  float s = 0.0f, q = 0.0f;
  for (int b = threadIdx.x; b < nblocks; b += kFinishThreads) {
    s += ps[b];
    q += pq[b];
  }
  red_s[threadIdx.x] = s;
  red_q[threadIdx.x] = q;
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red_s[threadIdx.x] += red_s[threadIdx.x + half];
      red_q[threadIdx.x] += red_q[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sum[co] = red_s[0];
    sumsq[co] = red_q[0];
  }
}

template <typename T>
static int launch(const void* x, const void* w9, void* y, void* ws, void* sum,
                  void* sumsq, int n, int h, int w, int ci, int co,
                  cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const int nblocks = static_cast<int>((rows + kBM - 1) / kBM);
  float* part_sum = static_cast<float*>(ws);
  float* part_sq = part_sum + static_cast<long long>(co) * nblocks;
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 1);
  conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9),
      static_cast<float*>(y), part_sum, part_sq, n, h, w, ci, co);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  conv_stats_finish_kernel<<<co, kFinishThreads, 0, stream>>>(
      part_sum, part_sq, static_cast<float*>(sum),
      static_cast<float*>(sumsq), nblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gr

// x (N,H,W,Ci) and w9 (9,Ci,Co) in the storage type; y (N,H,W,Co) f32; ws a
// workspace of 2 * Co * ceil(N*H*W / 64) f32; sum and sumsq (Co,) f32.
extern "C" int gr_conv_stats(int dtype, const void* x, const void* w9, void* y,
                             void* ws, void* sum, void* sumsq, int n, int h,
                             int w, int ci, int co, void* stream) {
  using namespace gr;
  if (n < 1 || h < 1 || w < 1 || ci < 1 || co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(x, w9, y, ws, sum, sumsq, n, h, w, ci, co, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w9, y, ws, sum, sumsq, n, h, w, ci, co, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
