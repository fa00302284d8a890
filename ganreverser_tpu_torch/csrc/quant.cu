// Kernels Q1-Q4: symmetric int8 with exact int32 sums, the int8 legs of G
// and R (ops/quant.py).
//
// Replace XLA ops of ganreverser_tpu/ops/quant.py and
// ganreverser_tpu/models/fastpath.py (the JAX package computes them with
// lax.conv_general_dilated / dot_general at preferred_element_type=int32,
// not with Pallas):
//
//  * Q4 quantize_symmetric(x, axis=None): scale = max(m, 1e-12) / 127 with
//    m = max |x| over the tensor, q = clip(rint(x / scale), -127, 127)
//    (IEEE division, round half to even, as jnp.round and torch.round).
//    Where x comes from Q1, Q2 or Q3, that producer took m in its epilogue
//    (dequant.cuh's raise_amax) and gr_quantize_act_max is one launch: one
//    read of x, one write of q. The layers' first inputs (G's z, R's
//    images) have no int8 producer: gr_quantize_act takes each block's
//    max |x| into a workspace, then every block of a second launch reduces
//    the workspace (max is exact, so any order gives the same scale) and
//    quantises its range.
//  * Q1 gr_quant_conv3x3: int8 x int8 -> int32 SAME 3x3 conv,
//    quant_conv3x3_same;
//  * Q2 gr_quant_upsample2_conv3x3: the four 2x2 phase convs of
//    kernel U on int8 operands (make_fast_generator_xla_int8's lhs-dilated
//    conv: output phase (a, b) at low-resolution pixel (i, j) reads input
//    (i + a + ta - 1, j + b + tb - 1) with the phase tap [a, ta, b, tb]);
//  * Q3 gr_quant_dense: (N, K) x (K, M) int8 -> int32, quant_dense.
//
// Q1-Q3 share the epilogue, dequant.cuh's dequant_act: y = fma(float(acc),
// x_scale * w_scale[c], bias[c]) -- one rounding, what XLA's CPU fusion of
// y * s + b computes and what the plain versions emulate in f64 -- then the
// activation (ELU as jax.nn.elu, expm1; ReLU; sigmoid) and, for Q1, an
// optional 2x2 max pool (the pool of an f32 tile is exact, so fusing it
// changes nothing), and optionally the max of |y| for the next Q4. The
// activation scale is a device scalar (Q4's output): no host sync.
//
// What bounds them on an H100: Q1 and Q2 operations (R's layers and G's
// stages do 2.4e10-2.8e11 int8 operations on 1-34 MB a call), Q3 and Q4
// bytes. Q1-Q3 run on the int8 tensor cores: conv_wgmma.cuh's mainloop
// with S8Operands (wgmma m64nNk32.s32.s8.s8 on the TMA ring, exact s32
// sums), Q1 with Conv3x3Taps over (9, Co, Ci') K-major int8 weights, Q2
// with U's PhaseTaps over (16, Co, Ci'), Q3 with DenseTaps over (1, M, K')
// (the dense layer as a one-tap 1x1 conv of one 1 x N image), and
// DequantActEpilogue: the epilogue above on the s32 registers, the f32 tile
// staged on the freed ring, R's pool from it, U's phase interleave in the
// store. The int8 channels are padded to rows of 32, 64 or a multiple of
// 16 bytes (ops/quant.py: R's 3-channel stem to 32, G's noise 100 to 112).
// Q1's and Q2's plan is ops/conv_operands.py::tile_plan's with elem_bytes
// = 1 and out_bytes = 4, Q3's ops/quant.py::dense_plan's: 1 x 128 rows of
// x, BN up to 128 columns, and where the (N, M) tiles alone leave the card
// idle (R l27: 8 tiles, K' = 32,768) K split over blockIdx.z; each split
// stores its s32 tile (SplitSumsEpilogue, kernel D's split store too), and
// quant_dense_sum_kernel adds the splits in order (integer sums: exact),
// dequantises and takes the max.
#include <cstdint>

#include "common.cuh"
#include "conv_wgmma.cuh"
#include "dequant.cuh"

namespace gr {

constexpr int kQThreads = 256;
constexpr int kQMaxParts = 1024;  // Q4's partial maxima (blocks of launch 1)
constexpr float kQMax = 127.0f;
constexpr float kQEps = 1e-12f;

// ---------------------------------------------------------------- Q4

// max over the block's threads, in every thread (red: one float a warp)
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < (kQThreads >> 5) ? red[lane] : 0.0f);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// max |x| over block b's grid-stride share of x, into parts[b]; x is read
// as float4 where n % 4 == 0 (the wrapper's tensors are 16-byte aligned)
__global__ void __launch_bounds__(kQThreads)
    quant_absmax_kernel(const float* __restrict__ x, long long n,
                        float* __restrict__ parts) {
  __shared__ float red[kQThreads / 32];
  float m = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * kQThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kQThreads +
                       threadIdx.x;
  if (n % 4 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = t0; i < n / 4; i += stride) {
      const float4 v = x4[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (long long i = t0; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = m;
}

__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(fminf(fmaxf(r, -kQMax), kQMax));
}

__device__ __forceinline__ char4 quantize4(float4 v, float s) {
  return make_char4(quantize_one(v.x, s), quantize_one(v.y, s),
                    quantize_one(v.z, s), quantize_one(v.w, s));
}

// q = quantize_one(x, s) over block b's grid-stride share of x, as float4
// and char4 where n % 4 == 0: four loads a thread issued before the first
// is used, since one at a time leaves the pass waiting on memory latency
__device__ __forceinline__ void quantize_range(const float* __restrict__ x,
                                               long long n, float s,
                                               int8_t* __restrict__ q) {
  const long long stride = static_cast<long long>(gridDim.x) * kQThreads;
  long long i = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x;
  if (n % 4 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    const long long n4 = n / 4;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = x4[i + u * stride];
#pragma unroll
      for (int u = 0; u < 4; ++u) q4[i + u * stride] = quantize4(v[u], s);
    }
    for (; i < n4; i += stride) q4[i] = quantize4(x4[i], s);
  } else {
    for (; i < n; i += stride) q[i] = quantize_one(x[i], s);
  }
}

__global__ void __launch_bounds__(kQThreads)
    quant_apply_kernel(const float* __restrict__ x, long long n,
                       const float* __restrict__ parts, int nparts,
                       int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[kQThreads / 32];
  float m = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += kQThreads) m = fmaxf(m, parts[i]);
  m = block_max(m, red);
  const float s = __fdiv_rn(fmaxf(m, kQEps), kQMax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  quantize_range(x, n, s, q);
}

// Q4 after an int8 producer: *amax is max |x| (the bits of a non-negative
// f32, dequant.cuh's raise_amax), so one pass quantises.
__global__ void __launch_bounds__(kQThreads)
    quant_apply_max_kernel(const float* __restrict__ x, long long n,
                           const unsigned int* __restrict__ amax,
                           int8_t* __restrict__ q, float* __restrict__ scale) {
  const float s = __fdiv_rn(fmaxf(__uint_as_float(*amax), kQEps), kQMax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  quantize_range(x, n, s, q);
}

// Q4's grid: a block per 4,096 elements (four float4 a thread), at most
// kQMaxParts
inline int quant_blocks(long long n) {
  const long long want = (n + 4LL * kQThreads * 4 - 1) / (4LL * kQThreads * 4);
  return static_cast<int>(want < kQMaxParts ? want : kQMaxParts);
}

// ---------------------------------------------------------------- Q3

// Q3 under a K split: out = dequant_act(sum over the splits of part, in
// split order), |out|'s max raising *amax where it is given. part is
// (splits, N, M) s32, as quant_dense_split_s8_kernel's blocks stored it.
__global__ void __launch_bounds__(kQThreads)
    quant_dense_sum_kernel(const int* __restrict__ part, int splits,
                           long long total, int M,
                           const float* __restrict__ x_scale,
                           const float* __restrict__ w_scale,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int act,
                           unsigned int* __restrict__ amax) {
  __shared__ float red[kQThreads / 32];
  const float xsc = *x_scale;
  float m = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * kQThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kQThreads) {
    int acc = 0;
    for (int z = 0; z < splits; ++z) acc += part[z * total + i];
    const int c = static_cast<int>(i % M);
    const float y = dequant_act(acc, __fmul_rn(xsc, w_scale[c]), bias[c], act);
    out[i] = y;
    m = fmaxf(m, fabsf(y));
  }
  if (amax != nullptr) {  // the same in every thread
    m = block_max(m, red);
    if (threadIdx.x == 0) raise_amax(amax, m);
  }
}

// Q3: conv_wgmma.cuh's tile on int8 operands, one tap over 128 rows of x.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    quant_dense_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::DenseTaps, wg::DequantActEpilogue<false>,
                      wg::S8Operands>(xmap, wmap, args);
}

// Q3 under a K split: the same tile on split blockIdx.z's K range, its s32
// sums stored for quant_dense_sum_kernel.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    quant_dense_split_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __grid_constant__ CUtensorMap wmap,
                                const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::DenseTaps, wg::SplitSumsEpilogue,
                      wg::S8Operands>(xmap, wmap, args);
}

// Zero the producer's max word on the launch's stream (null: none asked).
inline cudaError_t zero_amax(float* amax, cudaStream_t stream) {
  return amax == nullptr
             ? cudaSuccess
             : cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
}

// ------------------------------------------------------------ Q1, Q2

// Q1: conv_wgmma.cuh's tile on int8 operands, the 9 taps of a 3x3 conv.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    quant_conv3x3_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::Conv3x3Taps, wg::DequantActEpilogue<false>,
                      wg::S8Operands>(xmap, wmap, args);
}

// Q2: the same on U's four phase taps, blockIdx.z the output phase.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    quant_upsample2_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::PhaseTaps, wg::DequantActEpilogue<true>,
                      wg::S8Operands>(xmap, wmap, args);
}

// One launch of Q1 (kPhase false: 9 weight slices, one phase) or Q2 (16
// slices, four phases) on the plan, which must fit the int8 layout; with
// ``amax``, zeroed first, the max |y| of the output.
template <bool kPhase>
int launch_s8(const void* x, const void* w, const float* x_scale,
              const float* w_scale, const float* bias, float* out,
              float* amax, int n, int h, int wd, int ci, int co, int act,
              int pool, const wg::Plan& pl, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!wg::plan_ok(pl, pool, 4, 1) ||
      !wg::encode_maps(&xmap, &wmap, x, w, n, h, wd, ci, co, ci,
                       kPhase ? 16 : 9, pl, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = zero_amax(amax, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  wg::ConvArgs args{};
  args.scale = w_scale;
  args.shift = bias;
  args.x_scale = x_scale;
  args.y32 = out;
  args.amax = reinterpret_cast<unsigned int*>(amax);
  args.H = h;
  args.W = wd;
  args.Co = co;
  args.act = act;
  args.pool = pool;
  args.bh = pl.bh;
  args.bw = pl.bw;
  args.bk = pl.bk;
  args.stages = pl.stages;
  args.kchunks = (ci + pl.bk - 1) / pl.bk;
  const dim3 grid = wg::plan_grid(pl, n, h, wd, co, kPhase ? 4 : 1);
  return static_cast<int>(wg::by_width(pl.bn, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    if constexpr (kPhase)
      return wg::launch(quant_upsample2_s8_kernel<BN>, grid, pl.smem, stream,
                        xmap, wmap, args);
    else
      return wg::launch(quant_conv3x3_s8_kernel<BN>, grid, pl.smem, stream,
                        xmap, wmap, args);
  }));
}

}  // namespace gr

extern "C" {

// x (n,) f32 -> q (n,) int8 and scale () f32; parts: kQMaxParts floats
int gr_quantize_act(const float* x, int8_t* q, float* scale, float* parts,
                    long long n, cudaStream_t stream) {
  using namespace gr;
  if (n <= 0) return cudaErrorInvalidValue;
  const int blocks = quant_blocks(n);
  quant_absmax_kernel<<<blocks, kQThreads, 0, stream>>>(x, n, parts);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  quant_apply_kernel<<<blocks, kQThreads, 0, stream>>>(x, n, parts, blocks, q,
                                                       scale);
  return cudaGetLastError();
}

// x (n,) f32 and amax () f32, max |x| as an int8 producer returned it ->
// q (n,) int8 and scale () f32, in one launch
int gr_quantize_act_max(const float* x, const float* amax, int8_t* q,
                        float* scale, long long n, cudaStream_t stream) {
  using namespace gr;
  if (n <= 0) return cudaErrorInvalidValue;
  quant_apply_max_kernel<<<quant_blocks(n), kQThreads, 0, stream>>>(
      x, n, reinterpret_cast<const unsigned int*>(amax), q, scale);
  return cudaGetLastError();
}

// x (N,H,W,Ci') int8, Ci' padded (ops/quant.py::pad_int8); w (9, Co, Ci')
// int8, K-major; on the plan bh, bw, bn, bk, stages, smem
// (ops/conv_operands.py::tile_plan with elem_bytes 1, out_bytes 4); out
// (N,H,W,Co) f32 or (N,H/2,W/2,Co) with pool; amax () f32, max |out|
// (zeroed here), or null
int gr_quant_conv3x3(const int8_t* x, const int8_t* w, const float* x_scale,
                     const float* w_scale, const float* bias, float* out,
                     float* amax, int N, int H, int W, int Ci, int Co,
                     int act, int pool, int bh, int bw, int bn, int bk,
                     int stages, int smem, cudaStream_t stream) {
  if (pool && (H % 2 || W % 2)) return cudaErrorInvalidValue;
  return gr::launch_s8<false>(x, w, x_scale, w_scale, bias, out, amax, N, H,
                              W, Ci, Co, act, pool,
                              gr::wg::Plan{bh, bw, bn, bk, stages, smem},
                              stream);
}

// x (N,H,W,Ci') int8 as gr_quant_conv3x3's; w (16, Co, Ci') int8, K-major,
// the phase taps [a, ta, b, tb]; the plan as there; out (N,2H,2W,Co) f32;
// amax as there
int gr_quant_upsample2_conv3x3(const int8_t* x, const int8_t* w,
                               const float* x_scale, const float* w_scale,
                               const float* shift, float* out, float* amax,
                               int N, int H, int W, int Ci, int Co, int act,
                               int bh, int bw, int bn, int bk, int stages,
                               int smem, cudaStream_t stream) {
  return gr::launch_s8<true>(x, w, x_scale, w_scale, shift, out, amax, N, H,
                             W, Ci, Co, act, 0,
                             gr::wg::Plan{bh, bw, bn, bk, stages, smem},
                             stream);
}

// x (N, K') int8 and w (M, K') int8, K-major, K' = padded_channels(K, 1)
// (ops/quant.py::dense_operand); on the plan bh = 1, bw = 128, bn, bk,
// stages, smem with ``splits`` K splits, a divisor of ceil(K' / bk)
// (ops/quant.py::dense_plan); out (N, M) f32; part (splits, N, M) int32
// where splits > 1, else unused; amax () f32, max |out| (zeroed here), or
// null
int gr_quant_dense(const int8_t* x, const int8_t* w, const float* x_scale,
                   const float* w_scale, const float* bias, float* out,
                   int* part, float* amax, int N, int K, int M, int act,
                   int splits, int bh, int bw, int bn, int bk, int stages,
                   int smem, cudaStream_t stream) {
  using namespace gr;
  const wg::Plan pl{bh, bw, bn, bk, stages, smem};
  const int chunks = bk > 0 ? (K + bk - 1) / bk : 0;
  CUtensorMap xmap, wmap;
  if (N < 1 || M < 1 || splits < 1 || chunks < splits || chunks % splits ||
      bh != 1 || (splits > 1 && part == nullptr) ||
      !wg::plan_ok(pl, false, 4, 1) ||
      !wg::encode_maps(&xmap, &wmap, x, w, 1, 1, N, K, M, K, 1, pl, 1))
    return cudaErrorInvalidValue;
  cudaError_t rc = zero_amax(amax, stream);
  if (rc != cudaSuccess) return rc;
  unsigned int* slot = reinterpret_cast<unsigned int*>(amax);
  wg::ConvArgs args{};
  args.scale = w_scale;
  args.shift = bias;
  args.x_scale = x_scale;
  args.y32 = splits > 1 ? reinterpret_cast<float*>(part) : out;
  args.amax = splits > 1 ? nullptr : slot;
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
  rc = wg::by_width(pl.bn, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return splits > 1
               ? wg::launch(quant_dense_split_s8_kernel<BN>, grid, pl.smem,
                            stream, xmap, wmap, args)
               : wg::launch(quant_dense_s8_kernel<BN>, grid, pl.smem, stream,
                            xmap, wmap, args);
  });
  if (rc != cudaSuccess || splits == 1) return rc;
  const long long total = static_cast<long long>(N) * M;
  const long long want = (total + kQThreads - 1) / kQThreads;
  quant_dense_sum_kernel<<<static_cast<int>(want < 4096 ? want : 4096),
                           kQThreads, 0, stream>>>(
      part, splits, total, M, x_scale, w_scale, bias, out, act, slot);
  return cudaGetLastError();
}

}  // extern "C"
