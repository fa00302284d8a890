// Kernel B8: kernel U (nearest 2x upsample + 3x3 conv + scale/shift + ReLU)
// with each phase's four taps stacked on the reduction axis: one K loop of
// 4*Ci per phase over weights (4, 4*Ci, Co), instead of four loops of Ci.
//
// Replaces benchmarks/tpu_upsample_v2.py::upsample_v2 (_kernel_v2), whose
// one deeper dot per phase concatenated the four shifted patches on the
// channel axis (Mosaic refused the concatenation, so it never ran on the
// TPU). Here no patch is concatenated: element k of the reduction is tap
// k / Ci, channel k % Ci, so the A loader computes each element's tap and a
// BK chunk may straddle two taps when Ci is not a multiple of BK. The tile
// is kernel B's (64 pixels x 64 channels, f32 CUDA-core FMAs; conv_tile.cuh
// holds the constants), blockIdx.z the phase, output written strided per
// phase as kernel U writes it.
//
// What bounds it: FMA issue, as U; the A/B against U measures one K loop of
// 4*Ci against four of Ci, the question a tensor-core redesign of U has to
// answer.
#include "conv_tile.cuh"

namespace gr {

template <typename T>
__global__ void __launch_bounds__(kThreads) upsample_v2_kernel(
    const T* __restrict__ x, const T* __restrict__ k4,
    const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ out, int N, int H, int W, int Ci, int Co) {
  __shared__ __align__(16) float As[kBK][kBM + kApad];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int a = blockIdx.z >> 1;
  const int b = blockIdx.z & 1;
  const long long rows = static_cast<long long>(N) * H * W;
  const long long per = static_cast<long long>(H) * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int co0 = blockIdx.y * kBN;
  const int K = 4 * Ci;
  const T* wp = k4 + static_cast<long long>(blockIdx.z) * K * Co;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int am = tid >> 2;
  const int ak0 = (tid & 3) * 4;
  const int bk = tid >> 4;
  const int bc0 = (tid & 15) * 4;

  int an = 0, ai = 0, aj = 0;
  bool avalid;
  {
    long long m = m0 + am;
    avalid = m < rows;
    if (!avalid) m = 0;
    an = static_cast<int>(m / per);
    const int r = static_cast<int>(m % per);
    ai = r / W;
    aj = r % W;
  }
  const T* ximg = x + static_cast<long long>(an) * H * W * Ci;

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + ak0 + u;
      float v = 0.0f;
      if (avalid && k < K) {
        const int t = k / Ci;  // tap (ta, tb) = (t / 2, t % 2)
        const int ci = k - t * Ci;
        const int yy = ai + a + (t >> 1) - 1;
        const int xx = aj + b + (t & 1) - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = to_f32(ximg[(static_cast<long long>(yy) * W + xx) * Ci + ci]);
      }
      As[ak0 + u][am] = v;
    }
    {
      const int k = k0 + bk;
      const T* wrow = wp + static_cast<long long>(k) * Co;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int co = co0 + bc0 + u;
        Bs[bk][bc0 + u] = (k < K && co < Co) ? to_f32(wrow[co]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float ar[kTM] = {av.x, av.y, av.z, av.w};
      const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    __syncthreads();
  }

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
            apply_act(fmaf(acc[r][c], scale[co], shift[co]), ACT_RELU));
    }
  }
}

template <typename T>
static void launch(const void* x, const void* k4, const void* scale,
                   const void* shift, void* out, int n, int h, int w, int ci,
                   int co, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 4);
  upsample_v2_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k4),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), n, h, w, ci, co);
}

}  // namespace gr

// x (N,H,W,Ci) and k4 (4, 4*Ci, Co; phase a*2+b, rows tap-major) in the
// storage type, scale/shift (Co,) f32, out (N,2H,2W,Co) in the storage type.
extern "C" int gr_upsample_v2(int dtype, const void* x, const void* k4,
                              const void* scale, const void* shift, void* out,
                              int n, int h, int w, int ci, int co,
                              void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(x, k4, scale, shift, out, n, h, w, ci, co, s);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(x, k4, scale, shift, out, n, h, w, ci, co, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
