// Kernels Q1-Q4: symmetric int8 with exact int32 sums, the int8 legs of G
// and R (ops/quant.py).
//
// Replace XLA ops of ganreverser_tpu/ops/quant.py and
// ganreverser_tpu/models/fastpath.py (the JAX package computes them with
// lax.conv_general_dilated / dot_general at preferred_element_type=int32,
// not with Pallas):
//
//  * Q4 gr_quantize_act: quantize_symmetric(x, axis=None). Launch 1: each
//    block's max |x| into a workspace; launch 2: every block reduces the
//    workspace (max is exact, so any order gives the same scale), block 0
//    writes scale = max(m, 1e-12) / 127, and each block writes
//    q = clip(rint(x / scale), -127, 127) for its range (IEEE division,
//    round half to even, as jnp.round and torch.round).
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
// changes nothing). The activation scale is a device scalar (Q4's output):
// no host sync.
//
// What bounds them on an H100: Q1 and Q2 operations (R's layers and G's
// stages do 2.4e10-2.8e11 int8 operations on 1-34 MB a call), Q3 and Q4
// bytes. Q1 and Q2 run on the int8 tensor cores: conv_wgmma.cuh's mainloop
// with S8Operands (wgmma m64nNk32.s32.s8.s8 on the TMA ring, exact s32
// sums), Q1 with Conv3x3Taps over (9, Co, Ci') K-major int8 weights, Q2
// with U's PhaseTaps over (16, Co, Ci'), and DequantActEpilogue: the
// epilogue above on the s32 registers, the f32 tile staged on the freed
// ring, R's pool from it, U's phase interleave in the store. The int8
// channels are padded to rows of 32, 64 or a multiple of 16 bytes
// (ops/quant.py: R's 3-channel stem to 32). The plan is
// ops/conv_operands.py::tile_plan's with elem_bytes = 1 and out_bytes = 4.
// Q3 (__dp4a on the CUDA cores, four int8 products a word) splits K over
// blocks when its tiles alone do not fill the card, adding int32 partials
// with atomics (integer sums: exact in any order) and finishing in a
// second launch.
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

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kQThreads >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
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
  const long long stride = static_cast<long long>(gridDim.x) * kQThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kQThreads +
                       threadIdx.x;
  if (n % 4 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    for (long long i = t0; i < n / 4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(quantize_one(v.x, s), quantize_one(v.y, s),
                         quantize_one(v.z, s), quantize_one(v.w, s));
    }
  } else {
    for (long long i = t0; i < n; i += stride) q[i] = quantize_one(x[i], s);
  }
}

// ---------------------------------------------------------------- Q3

constexpr int kDBM = 64, kDBN = 64, kDKW = 16;  // rows, columns, K words

// Block (column tile, row tile, K split): thread (tx, ty) holds rows
// ty + 16 i and columns tx + 16 j (i, j < 4). With splits > 1 the int32
// sums go to ws by atomicAdd and gr_quant_dense's second launch finishes.
__global__ void __launch_bounds__(kQThreads)
    quant_dense_kernel(const int8_t* __restrict__ x,
                       const int32_t* __restrict__ w,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int* __restrict__ ws, int N, int K, int M, int act,
                       int words_per_split) {
  __shared__ int32_t xs_[kDBM * (kDKW + 1)];
  __shared__ int32_t ws_[kDKW * kDBN];
  const int kw_all = K / 4;
  const int m0 = blockIdx.x * kDBN, n0 = blockIdx.y * kDBM;
  const int kb = blockIdx.z * words_per_split;
  const int ke = min(kw_all, kb + words_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int32_t* xw = reinterpret_cast<const int32_t*>(x);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = kb; k0 < ke; k0 += kDKW) {
    const int kw = min(kDKW, ke - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kDBM * kDKW; i += kQThreads) {
      const int r = i / kDKW, k = i % kDKW;
      xs_[r * (kDKW + 1) + k] =
          (k < kw && n0 + r < N)
              ? xw[static_cast<long long>(n0 + r) * kw_all + k0 + k] : 0;
    }
    for (int i = threadIdx.x; i < kDKW * kDBN; i += kQThreads) {
      const int k = i / kDBN, c = i % kDBN;
      ws_[i] = (k < kw && m0 + c < M)
                   ? w[static_cast<long long>(k0 + k) * M + m0 + c] : 0;
    }
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
      int xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs_[(ty + 16 * i) * (kDKW + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws_[k * kDBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
    }
  }
  const float xsc = *x_scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + ty + 16 * i;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = m0 + tx + 16 * j;
      if (c >= M) continue;
      const long long o = static_cast<long long>(r) * M + c;
      if (gridDim.z > 1)
        atomicAdd(ws + o, acc[i][j]);
      else
        out[o] = dequant_act(acc[i][j], __fmul_rn(xsc, w_scale[c]), bias[c],
                             act);
    }
  }
}

__global__ void __launch_bounds__(kQThreads)
    quant_dense_finish_kernel(const int* __restrict__ ws,
                              const float* __restrict__ x_scale,
                              const float* __restrict__ w_scale,
                              const float* __restrict__ bias,
                              float* __restrict__ out, long long total, int M,
                              int act) {
  const float xsc = *x_scale;
  for (long long i = static_cast<long long>(blockIdx.x) * kQThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kQThreads) {
    const int c = static_cast<int>(i % M);
    out[i] = dequant_act(ws[i], __fmul_rn(xsc, w_scale[c]), bias[c], act);
  }
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
// slices, four phases) on the plan, which must fit the int8 layout.
template <bool kPhase>
int launch_s8(const void* x, const void* w, const float* x_scale,
              const float* w_scale, const float* bias, float* out, int n,
              int h, int wd, int ci, int co, int act, int pool,
              const wg::Plan& pl, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!wg::plan_ok(pl, pool, 4, 1) ||
      !wg::encode_maps(&xmap, &wmap, x, w, n, h, wd, ci, co, ci,
                       kPhase ? 16 : 9, pl, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::ConvArgs args{};
  args.scale = w_scale;
  args.shift = bias;
  args.x_scale = x_scale;
  args.y32 = out;
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
  const long long want = (n + 4LL * kQThreads * 4 - 1) / (4LL * kQThreads * 4);
  const int blocks = static_cast<int>(want < kQMaxParts ? want : kQMaxParts);
  quant_absmax_kernel<<<blocks, kQThreads, 0, stream>>>(x, n, parts);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  quant_apply_kernel<<<blocks, kQThreads, 0, stream>>>(x, n, parts, blocks, q,
                                                       scale);
  return cudaGetLastError();
}

// x (N,H,W,Ci') int8, Ci' padded (ops/quant.py::padded_int8_channels); w
// (9, Co, Ci') int8, K-major; on the plan bh, bw, bn, bk, stages, smem
// (ops/conv_operands.py::tile_plan with elem_bytes 1, out_bytes 4); out
// (N,H,W,Co) f32 or (N,H/2,W/2,Co) with pool
int gr_quant_conv3x3(const int8_t* x, const int8_t* w, const float* x_scale,
                     const float* w_scale, const float* bias, float* out,
                     int N, int H, int W, int Ci, int Co, int act, int pool,
                     int bh, int bw, int bn, int bk, int stages, int smem,
                     cudaStream_t stream) {
  if (pool && (H % 2 || W % 2)) return cudaErrorInvalidValue;
  return gr::launch_s8<false>(x, w, x_scale, w_scale, bias, out, N, H, W, Ci,
                              Co, act, pool,
                              gr::wg::Plan{bh, bw, bn, bk, stages, smem},
                              stream);
}

// x (N,H,W,Ci') int8 as gr_quant_conv3x3's; w (16, Co, Ci') int8, K-major,
// the phase taps [a, ta, b, tb]; the plan as there; out (N,2H,2W,Co) f32
int gr_quant_upsample2_conv3x3(const int8_t* x, const int8_t* w,
                               const float* x_scale, const float* w_scale,
                               const float* shift, float* out, int N, int H,
                               int W, int Ci, int Co, int act, int bh, int bw,
                               int bn, int bk, int stages, int smem,
                               cudaStream_t stream) {
  return gr::launch_s8<true>(x, w, x_scale, w_scale, shift, out, N, H, W, Ci,
                             Co, act, 0,
                             gr::wg::Plan{bh, bw, bn, bk, stages, smem},
                             stream);
}

// x (N,K) int8, K % 4 == 0; w (K/4, M) words; out (N,M) f32; ws: N*M int32
// where splits > 1 (zeroed here), else unused
int gr_quant_dense(const int8_t* x, const int32_t* w, const float* x_scale,
                   const float* w_scale, const float* bias, float* out,
                   int* ws, int N, int K, int M, int act, int splits,
                   cudaStream_t stream) {
  using namespace gr;
  if (K % 4 || splits < 1 || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int kw = K / 4;
  const int per = ((kw + splits - 1) / splits + kDKW - 1) / kDKW * kDKW;
  const int used = (kw + per - 1) / per;
  if (used > 1) {
    cudaError_t rc = cudaMemsetAsync(
        ws, 0, sizeof(int) * static_cast<size_t>(N) * M, stream);
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid((M + kDBN - 1) / kDBN, (N + kDBM - 1) / kDBM, used);
  quant_dense_kernel<<<grid, kQThreads, 0, stream>>>(
      x, w, x_scale, w_scale, bias, out, ws, N, K, M, act, per);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || used == 1) return rc;
  const long long total = static_cast<long long>(N) * M;
  const long long want = (total + kQThreads - 1) / kQThreads;
  quant_dense_finish_kernel<<<static_cast<int>(want < 4096 ? want : 4096),
                              kQThreads, 0, stream>>>(
      ws, x_scale, w_scale, bias, out, total, M, act);
  return cudaGetLastError();
}

}  // extern "C"
