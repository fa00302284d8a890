// Kernel B8: kernel U (nearest 2x upsample + 3x3 conv + scale/shift + ReLU)
// with each phase's four taps stacked on the reduction axis: one K loop of
// 4*Ci per phase over weights (4, 4*Ci, Co), instead of four loops of Ci.
//
// Replaces benchmarks/tpu_upsample_v2.py::upsample_v2 (_kernel_v2), whose
// one deeper dot per phase concatenated the four shifted patches on the
// channel axis (Mosaic refused the concatenation, so it never ran on the
// TPU). Here no patch is concatenated; blockIdx.z is the phase, the output
// written strided per phase as kernel U writes it.
//
// bf16 runs upsample_v2_wgmma_kernel: conv_wgmma.cuh's tensor-core tile
// with StackedPhaseTaps over the weights (4 phases, Co, 4*Kp)
// (ops/conv_operands.py::stacked_kmajor): tap block t at [t*Kp, t*Kp + Ci),
// Kp = Ci rounded up to BK, so no weight box crosses from one tap into the
// next and stage it of a phase reads K offset it * BK of one contiguous
// weight row; the A box of stage it is tap it / kchunks's shifted patch, as
// in U. The epilogue is U's (scale/shift/ReLU, one rounding, the
// phase-strided store). f32 runs upsample_v2_kernel on the CUDA cores (64
// pixels x 64 channels, conv_tile.cuh's constants): element k of the
// reduction is tap k / Ci, channel k % Ci, so its A loader computes each
// element's tap and a BK chunk may straddle two taps.
//
// What bounds it: the tensor cores in bf16 (f32 FMA issue on the CUDA
// cores), as U; held against U at G3's two stages it answers, on this card,
// whether one K loop of 4*Ci beats four of Ci.
#include "conv_tile.cuh"
#include "conv_wgmma.cuh"

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

static int launch_f32(const void* x, const void* k4, const void* scale,
                      const void* shift, void* out, int n, int h, int w,
                      int ci, int co, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 4);
  upsample_v2_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k4),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), n, h, w, ci, co);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel: conv_wgmma.cuh's tile, one stacked K loop per phase
// blockIdx.z, U's epilogue with ReLU.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    upsample_v2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::StackedPhaseTaps, wg::BnActEpilogue<true>>(
      xmap, wmap, args);
}

static int launch_bf16(const void* x, const void* k4, const void* scale,
                       const void* shift, void* out, int n, int h, int w,
                       int ci, int co, const wg::Plan& pl,
                       cudaStream_t stream) {
  const int kchunks = (ci + pl.bk - 1) / pl.bk;
  CUtensorMap xmap, wmap;
  if (!wg::plan_ok(pl, false) ||
      !wg::encode_maps(&xmap, &wmap, x, k4, n, h, w, ci, co,
                       4 * kchunks * pl.bk, 4, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::ConvArgs args{static_cast<const float*>(scale),
                          static_cast<const float*>(shift),
                          nullptr,
                          static_cast<__nv_bfloat16*>(out),
                          h, w, co, ACT_RELU, 0, pl.bh, pl.bw, pl.bk,
                          pl.stages, kchunks};
  const dim3 grid = wg::plan_grid(pl, n, h, w, co, 4);
  return static_cast<int>(wg::by_width(pl.bn, [&](auto bn) {
    return wg::launch(upsample_v2_wgmma_kernel<decltype(bn)::value>, grid,
                      pl.smem, stream, xmap, wmap, args);
  }));
}

}  // namespace gr

// f32: x (N,H,W,Ci) and k4 (4, 4*Ci, Co; phase a*2+b, rows tap-major), the
// plan ignored. bf16: x (N,H,W,Ci) with Ci % 8 == 0 and k4 (4, Co, 4*Kp),
// Kp = ceil(Ci / bk) * bk (ops/conv_operands.py::stacked_kmajor), on the
// plan bh, bw, bn, bk, stages, smem (ops/conv_operands.py::tile_plan).
// scale/shift (Co,) f32, out (N,2H,2W,Co) in the storage type.
extern "C" int gr_upsample_v2(int dtype, const void* x, const void* k4,
                              const void* scale, const void* shift, void* out,
                              int n, int h, int w, int ci, int co, int bh,
                              int bw, int bn, int bk, int stages, int smem,
                              void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_f32(x, k4, scale, shift, out, n, h, w, ci, co, s);
  if (dtype == DT_BF16)
    return launch_bf16(x, k4, scale, shift, out, n, h, w, ci, co,
                       wg::Plan{bh, bw, bn, bk, stages, smem}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
