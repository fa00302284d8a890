// Kernel D: the fast forwards' dense layers in bf16 (ops/dense_kernel.py),
//
//   out[n][m] = act(sum_k x[n][k] * w[k][m] + shift[m]), rounded once to bf16,
//
// x and w bf16, the sums f32, shift f32 (a folded BatchNorm's or a bias),
// act none, ReLU, ELU or tanh as PyTorch computes them (common.cuh's
// torch_act): the rounding points of the plain f32 product of bf16-rounded
// operands, the shift, the activation and one .to(bfloat16).
//
// Replaces no TPU kernel: the JAX package leaves its dense layers to XLA
// (ganreverser_tpu/models/fastpath.py), and the port ran them as f32
// torch.matmul on the CUDA cores (cuBLAS's f32 GEMMs: the operands are
// bf16-rounded, but the product ran in IEEE f32), followed by three f32
// passes for the shift, the activation and the rounding. The products of
// bf16 values are exact in f32, so the tensor cores compute the same
// products; only the order of the f32 sums differs.
//
// What bounds it on an H100: bytes. G's first layer at 128x128 streams a
// 268 MB weight and writes a 134 MB output a batch of 128 (0.12 ms at 3.35
// TB/s; its 34 GFLOP take 0.035 ms on the tensor cores); R's l27 reads a
// 134 MB weight and 34 MB of x. The design keeps the weight stream at the
// memory rate: conv_wgmma.cuh's TMA ring with DenseTaps (the layer as a
// one-tap 1x1 convolution of one 1 x N image, as Q3 runs it) and
// Bf16Operands, each block streaming its BN columns' (M, K') K-major
// weights once through several stages while x's 128-row tile comes from
// L2; the epilogue is BnActEpilogue<false, true> (scale 1, + shift, the
// activation, one rounding), staged on the freed ring and stored 16 bytes
// a thread. Where the (rows, columns) tiles leave SMs idle and K is long
// (R's l27: 8 tiles of 64 columns, K = 131,072), K is split over blockIdx.z
// (ops/quant.py::dense_plan, Q3's, under ops/dense_kernel.py's
// DENSE_POLICY): each split stores its f32 sums (conv_wgmma.cuh's
// SplitSumsEpilogue, which stores Q3's s32 sums too) and
// dense_bf16_sum_kernel adds them in split order, then the shift, the
// activation and the one rounding.
#include <cstdint>

#include "common.cuh"
#include "conv_wgmma.cuh"

namespace gr {

constexpr int kSumThreads = 256;

// D: 128 rows of x by BN columns, all of K, the shift / activation /
// rounding epilogue.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 128 ? 2 : 1)
    dense_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::DenseTaps, wg::BnActEpilogue<false, true>>(
      xmap, wmap, args);
}

// D under a K split: the same tile on split blockIdx.z's K range, its f32
// sums stored for dense_bf16_sum_kernel.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 128 ? 2 : 1)
    dense_bf16_split_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const __grid_constant__ CUtensorMap wmap,
                                  const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::DenseTaps, wg::SplitSumsEpilogue>(xmap, wmap,
                                                               args);
}

// out = bf16(act(sum over the splits of part, in split order, + shift)),
// part (splits, N, M) f32 as dense_bf16_split_wgmma_kernel stored it.
__global__ void __launch_bounds__(kSumThreads)
    dense_bf16_sum_kernel(const float* __restrict__ part, int splits,
                          long long total, int M,
                          const float* __restrict__ shift,
                          __nv_bfloat16* __restrict__ out, int act) {
  for (long long i = static_cast<long long>(blockIdx.x) * kSumThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kSumThreads) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[z * total + i];
    out[i] = __float2bfloat16(torch_act(acc + shift[i % M], act));
  }
}

}  // namespace gr

extern "C" {

// x (N, K') bf16 and w (M, K') bf16, K-major, K' = padded_channels(K)
// (ops/dense_kernel.py::dense_operand); shift (M,) f32; act none, relu, elu
// or tanh (ops/cuda_lib.py::ACT_CODES); on the plan bh = 1, bw = 128, bn,
// bk, stages, smem with ``splits`` K splits, a divisor of ceil(K' / bk)
// (ops/dense_kernel.py::dense_plan); out (N, M) bf16; part (splits, N, M)
// f32 where splits > 1, else unused.
int gr_dense_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                  const float* shift, __nv_bfloat16* out, float* part, int N,
                  int K, int M, int act, int splits, int bh, int bw, int bn,
                  int bk, int stages, int smem, cudaStream_t stream) {
  using namespace gr;
  const wg::Plan pl{bh, bw, bn, bk, stages, smem};
  const int chunks = bk > 0 ? (K + bk - 1) / bk : 0;
  const long long col_tiles = bn > 0 ? (static_cast<long long>(M) + bn - 1) / bn
                                     : 0;
  const bool act_ok =
      act == ACT_NONE || act == ACT_RELU || act == ACT_ELU || act == ACT_TANH;
  CUtensorMap xmap, wmap;
  if (N < 1 || M < 1 || splits < 1 || chunks < splits || chunks % splits ||
      bh != 1 || col_tiles > 65535 || splits > 65535 || !act_ok ||
      (splits > 1 && part == nullptr) ||
      !wg::plan_ok(pl, false, splits > 1 ? 4 : 2) ||
      !wg::encode_maps(&xmap, &wmap, x, w, 1, 1, N, K, M, K, 1, pl))
    return cudaErrorInvalidValue;
  wg::ConvArgs args{};
  args.shift = shift;
  args.out = out;
  args.y32 = part;
  args.H = 1;
  args.W = N;
  args.Co = M;
  args.act = act;
  args.pool = 0;
  args.bh = 1;
  args.bw = bw;
  args.bk = bk;
  args.stages = stages;
  args.kchunks = chunks / splits;
  const dim3 grid = wg::plan_grid(pl, 1, 1, N, M, splits);
  cudaError_t rc = wg::by_width(pl.bn, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return splits > 1
               ? wg::launch(dense_bf16_split_wgmma_kernel<BN>, grid, pl.smem,
                            stream, xmap, wmap, args)
               : wg::launch(dense_bf16_wgmma_kernel<BN>, grid, pl.smem, stream,
                            xmap, wmap, args);
  });
  if (rc != cudaSuccess || splits == 1) return rc;
  const long long total = static_cast<long long>(N) * M;
  const long long want = (total + kSumThreads - 1) / kSumThreads;
  dense_bf16_sum_kernel<<<static_cast<int>(want < 4096 ? want : 4096),
                          kSumThreads, 0, stream>>>(part, splits, total, M,
                                                    shift, out, act);
  return cudaGetLastError();
}

}  // extern "C"
