// Kernels B and B6: one 3x3 SAME conv with a per-channel f32 scale/shift and
// an activation in the epilogue, optionally followed by a 2x2 maxpool fused
// into the same epilogue.
//
// B replaces ganreverser_tpu/ops/conv_block_kernel.py::conv_block
// (_make_kernel), which keeps whole images of a three-layer chain in VMEM.
// On this card a 64x64x64 f32 accumulator alone (1 MB) and stage 2's
// 9x128x128 weights (295 KB in bf16) exceed the 227 KB of shared memory a
// block may use, so the chain is one launch per layer (ops/
// conv_block_kernel.py::conv_block launches them in order) and each launch
// tiles space and streams weight slices over Ci (conv_wgmma.cuh in bf16,
// conv_tile.cuh in f32).
//
// B6 replaces ganreverser_tpu/ops/conv_kernel.py::conv3x3_bn_act, the
// single-layer kernel with the PReLU epilogue (D2's conv + PReLU + pool
// block): the same launch with act = ACT_PRELU, whose one shared slope is
// read from device memory (a pointer to one f32), so a learned slope never
// waits for the host (ops/conv_kernel.py::conv3x3_bn_act).
//
// What bounds both: the tensor cores. Per output pixel a layer does
// 9*Ci*Co MACs on Ci + Co values of traffic, far above the card's ridge
// point. bf16 runs on conv_wgmma.cuh: wgmma on 128-pixel x BN-channel tiles
// fed by a TMA ring, whose 3x3 taps are nine boxes of the same input (the
// Co = 64 layers re-read each box from L2 for only 64 output channels, so L2
// may hold them below the tensor-core rate). f32 keeps conv_tile.cuh's IEEE
// f32 loop on the CUDA cores (64 x 64 tiles, 4 x 4 outputs per thread): the
// f32 parity tests hold the fast paths to 1e-4, which TF32 would break. The
// intermediates between B's layers round-trip device memory in the storage
// type (rounded as the TPU kernel rounds them); the pool in the epilogue
// writes a quarter of the pixels.
#include "conv_tile.cuh"
#include "conv_wgmma.cuh"

namespace gr {

struct Conv3x3Taps {
  __device__ __forceinline__ void operator()(int t, int& dy, int& dx,
                                             int& widx) const {
    dy = t / 3 - 1;
    dx = t % 3 - 1;
    widx = t;
  }
};

// Row m of the implicit GEMM. Without the pool, rows are pixels in (n, i, j)
// order. With it, rows are (pooled pixel, window slot) so that the kTM = 4
// rows of one thread are exactly one 2x2 window.
template <bool kPool>
__device__ __forceinline__ RowCoord conv_row(long long m, long long rows, int H,
                                             int W) {
  RowCoord c;
  c.valid = m < rows;
  if (!c.valid) m = 0;
  if (kPool) {
    const int oh = H / 2, ow = W / 2;
    const long long q = m >> 2;
    const int s = static_cast<int>(m & 3);
    const long long per = static_cast<long long>(oh) * ow;
    c.n = static_cast<int>(q / per);
    const int r = static_cast<int>(q % per);
    c.i = 2 * (r / ow) + (s >> 1);
    c.j = 2 * (r % ow) + (s & 1);
  } else {
    const long long per = static_cast<long long>(H) * W;
    c.n = static_cast<int>(m / per);
    const int r = static_cast<int>(m % per);
    c.i = r / W;
    c.j = r % W;
  }
  return c;
}

template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads)
    conv3x3_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w9,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const float* __restrict__ alpha, T* __restrict__ out,
                          int N, int H, int W, int Ci, int Co, int act) {
  const float slope = act == ACT_PRELU ? *alpha : 0.0f;
  const long long rows = static_cast<long long>(N) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int co0 = blockIdx.y * kBN;
  const RowCoord a = conv_row<kPool>(m0 + (threadIdx.x >> 2), rows, H, W);

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;

  conv_tile_mainloop<T, 9>(x, w9, H, W, Ci, Co, a, co0, Conv3x3Taps{}, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long mr = m0 + ty * kTM;  // first row of this thread
  if (mr >= rows) return;
#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    const int co = co0 + tx * kTN + c;
    if (co >= Co) continue;
    const float sc = scale[co];
    const float sh = shift[co];
    if (kPool) {
      // rows % 4 == 0, so the whole window is valid with its first row;
      // rounding is monotone, so max-then-round == round-then-max
      float y = apply_act(fmaf(acc[0][c], sc, sh), act, slope);
#pragma unroll
      for (int r = 1; r < kTM; ++r)
        y = fmaxf(y, apply_act(fmaf(acc[r][c], sc, sh), act, slope));
      out[(mr >> 2) * Co + co] = from_f32<T>(y);
    } else {
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        if (mr + r < rows)
          out[(mr + r) * Co + co] =
              from_f32<T>(apply_act(fmaf(acc[r][c], sc, sh), act, slope));
      }
    }
  }
}

template <typename T, bool kPool>
static void launch(const void* x, const void* w9, const void* scale,
                   const void* shift, const void* alpha, void* out, int n,
                   int h, int w, int ci, int co, int act,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 1);
  conv3x3_bn_act_kernel<T, kPool><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(alpha), static_cast<T*>(out), n, h, w, ci, co,
      act);
}

// The bf16 kernel: conv_wgmma.cuh's tile, 9 taps, the scale/shift/act
// epilogue.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::Conv3x3Taps, wg::BnActEpilogue<false>>(
      xmap, wmap, args);
}

static int launch_bf16(const void* x, const void* w9, const void* scale,
                       const void* shift, const void* alpha, void* out, int n,
                       int h, int w, int ci, int co, int act, int pool,
                       const wg::Plan& pl, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!wg::plan_ok(pl, pool) ||
      !wg::encode_maps(&xmap, &wmap, x, w9, n, h, w, ci, co, ci, 9, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::ConvArgs args{static_cast<const float*>(scale),
                          static_cast<const float*>(shift),
                          static_cast<const float*>(alpha),
                          static_cast<__nv_bfloat16*>(out),
                          h, w, co, act, pool, pl.bh, pl.bw, pl.bk, pl.stages,
                          (ci + pl.bk - 1) / pl.bk};
  const dim3 grid = wg::plan_grid(pl, n, h, w, co, 1);
  return static_cast<int>(wg::by_width(pl.bn, [&](auto bn) {
    return wg::launch(conv3x3_wgmma_kernel<decltype(bn)::value>, grid,
                      pl.smem, stream, xmap, wmap, args);
  }));
}

}  // namespace gr

// f32: x (N,H,W,Ci) and w9 (9,Ci,Co), the plan ignored. bf16: x (N,H,W,Ci)
// with Ci % 8 == 0 and w9 (9,Co,Ci) K-major (ops/conv_operands.py), on the
// plan bh, bw, bn, bk, stages, smem (ops/conv_operands.py::tile_plan).
// scale/shift (Co,) f32, alpha one f32 (read with act = ACT_PRELU only; may
// be null otherwise), out (N,H,W,Co) or, with pool, (N,H/2,W/2,Co) in the
// storage type.
extern "C" int gr_conv3x3_bn_act(int dtype, const void* x, const void* w9,
                                 const void* scale, const void* shift,
                                 const void* alpha, void* out, int n, int h,
                                 int w, int ci, int co, int act, int pool,
                                 int bh, int bw, int bn, int bk, int stages,
                                 int smem, void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool && (h % 2 || w % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (act == ACT_PRELU && alpha == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_BF16)
    return launch_bf16(x, w9, scale, shift, alpha, out, n, h, w, ci, co, act,
                       pool, wg::Plan{bh, bw, bn, bk, stages, smem}, s);
  if (dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (pool)
    launch<float, true>(x, w9, scale, shift, alpha, out, n, h, w, ci, co, act,
                        s);
  else
    launch<float, false>(x, w9, scale, shift, alpha, out, n, h, w, ci, co,
                         act, s);
  return static_cast<int>(cudaGetLastError());
}
