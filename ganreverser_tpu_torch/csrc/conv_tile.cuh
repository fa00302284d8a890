// The implicit-GEMM main loop shared by conv_block.cu and upsample_conv.cu.
//
// Both kernels compute, for a tile of BM output rows (pixels) by BN output
// channels,
//
//   acc[m][co] = sum_tap sum_ci x[n(m), i(m) + dy(tap), j(m) + dx(tap), ci]
//                               * w[widx(tap)][ci][co]
//
// over an NHWC input whose pixels outside the image read as zero: every
// launch re-applies SAME zero padding at the border, so a chain of layers
// keeps the composition's boundary semantics (no conv-of-zeros leaks into
// the next layer's padding ring). The tile streams BK input channels of one
// tap at a time through shared memory, so neither whole images nor whole
// weight tensors have to fit on chip. Accumulation is f32 in registers,
// TM x TN outputs per thread, whatever the storage type T.
#pragma once

#include "common.cuh"

namespace gr {

constexpr int kBM = 64;        // output rows (pixels) per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 16;        // input channels per shared-memory stage
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // channels per thread
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)
constexpr int kApad = 4;       // keeps float4 alignment, halves bank conflicts

// Position of the A row (input pixel before the tap shift) one thread loads.
struct RowCoord {
  int n, i, j;
  bool valid;
};

// TapFn: void operator()(int tap, int& dy, int& dx, int& widx) const
template <typename T, int kTaps, typename TapFn>
__device__ __forceinline__ void conv_tile_mainloop(
    const T* __restrict__ x, const T* __restrict__ w, int H, int W, int Ci,
    int Co, RowCoord a, int co0, TapFn tap, float (&acc)[kTM][kTN]) {
  __shared__ __align__(16) float As[kBK][kBM + kApad];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channel group of the compute micro-tile
  const int ty = tid >> 4;  // row group of the compute micro-tile
  // A loader: row am, input channels ak0 .. ak0 + 3
  const int am = tid >> 2;
  const int ak0 = (tid & 3) * 4;
  // B loader: input-channel row bk, output channels bc0 .. bc0 + 3
  const int bk = tid >> 4;
  const int bc0 = (tid & 15) * 4;

  for (int t = 0; t < kTaps; ++t) {
    int dy, dx, widx;
    tap(t, dy, dx, widx);
    const int yy = a.i + dy;
    const int xx = a.j + dx;
    const bool inside = a.valid && yy >= 0 && yy < H && xx >= 0 && xx < W;
    const T* xrow =
        inside ? x + ((static_cast<long long>(a.n) * H + yy) * W + xx) * Ci
               : nullptr;
    const T* wtap = w + static_cast<long long>(widx) * Ci * Co;

    for (int c0 = 0; c0 < Ci; c0 += kBK) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ci = c0 + ak0 + u;
        As[ak0 + u][am] = (inside && ci < Ci) ? to_f32(xrow[ci]) : 0.0f;
      }
      {
        const int ci = c0 + bk;
        const T* wrow = wtap + static_cast<long long>(ci) * Co;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int co = co0 + bc0 + u;
          Bs[bk][bc0 + u] = (ci < Ci && co < Co) ? to_f32(wrow[co]) : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
        const float ar[kTM] = {av.x, av.y, av.z, av.w};
        const float br[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
      }
      __syncthreads();
    }
  }
}

}  // namespace gr
