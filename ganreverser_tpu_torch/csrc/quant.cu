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
//  * Q1 gr_quant_conv3x3 (mode 0): int8 x int8 -> int32 SAME 3x3 conv,
//    quant_conv3x3_same;
//  * Q2 gr_quant_upsample2_conv3x3 (mode 1): the four 2x2 phase convs of
//    kernel U on int8 operands (make_fast_generator_xla_int8's lhs-dilated
//    conv: output phase (a, b) at low-resolution pixel (i, j) reads input
//    (i + a + ta - 1, j + b + tb - 1) with the phase tap [a, ta, b, tb]);
//  * Q3 gr_quant_dense: (N, K) x (K, M) int8 -> int32, quant_dense.
//
// Q1-Q3 share the epilogue: y = fma(float(acc), x_scale * w_scale[c],
// bias[c]) -- one rounding, what XLA's CPU fusion of y * s + b computes and
// what the plain versions emulate in f64 -- then the activation (ELU as
// jax.nn.elu, expm1; ReLU; sigmoid) and, for Q1, an optional 2x2 max pool
// (the pool of an f32 tile is exact, so fusing it changes nothing). The
// activation scale is a device scalar (Q4's output): no host sync.
//
// What bounds them on an H100: operations. The sums run on the CUDA cores
// with __dp4a (four int8 products a word), not on the int8 tensor cores:
// a simple kernel first. A Q1/Q2 block computes 128 output pixels (an 8 x
// 16 patch) x 64 output channels, each thread 8 pixels x 4 channels,
// staging the (BH + 2) x (BW + 2) input patch and the taps' weights for 32
// input channels at a time in shared memory (G's Co = 3 output conv takes
// a 16 x 32 patch x 4 channels instead); each pixel's words in the patch
// are padded by one so that the pixels of a warp fall in distinct banks.
// Q3 splits K
// over blocks when its tiles alone do not fill the card, adding int32
// partials with atomics (integer sums: exact in any order) and finishing
// in a second launch.
#include <cstdint>

#include "common.cuh"

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

// ------------------------------------------------------- the epilogue

__device__ __forceinline__ float dequant_act(int acc, float deq, float bias,
                                             int act) {
  const float y = __fmaf_rn(__int2float_rn(acc), deq, bias);
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_ELU:  // jax.nn.elu: where(y > 0, y, expm1(y))
      return y > 0.0f ? y : expm1f(y);
    case ACT_SIGMOID:
      return 1.0f / (1.0f + expf(-y));
    default:
      return y;
  }
}

// ------------------------------------------------------------ Q1, Q2

constexpr int kQKW = 8;  // 4-byte words of input channels a stage (32 ci)

// Block tile: kBH x kBW output pixels (low-resolution pixels of one phase
// in mode 1) x kTX * kCoT output channels; thread (tx, ty) holds a 2 x 4
// sub-tile of pixels and channels tx + kTX * j. kMode 0: 9 taps, 1: the
// four taps of phase blockIdx.z % 4.
template <int kMode, int kTX, int kCoT, int kBH, int kBW>
__global__ void __launch_bounds__(kQThreads)
    quant_tapconv_kernel(const int8_t* __restrict__ x,
                         const int32_t* __restrict__ w,
                         const float* __restrict__ x_scale,
                         const float* __restrict__ w_scale,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int H, int W, int Ci,
                         int Co, int act, int pool) {
  constexpr int kTY = kQThreads / kTX;
  static_assert((kBH / 2) * (kBW / 4) == kTY, "2 x 4 pixels a thread");
  constexpr int kBCo = kTX * kCoT;
  constexpr int kPH = kBH + 2, kPW = kBW + 2;
  constexpr int kPS = kQKW + 1;  // patch words a pixel, padded
  constexpr int kTaps = kMode == 0 ? 9 : 4;
  __shared__ int32_t patch[kPH * kPW * kPS];
  __shared__ int32_t wsm[kTaps * kQKW * kBCo];

  const int tiles_w = (W + kBW - 1) / kBW;
  const int oy0 = (blockIdx.x / tiles_w) * kBH;
  const int ox0 = (blockIdx.x % tiles_w) * kBW;
  const int co0 = blockIdx.y * kBCo;
  const int phase = kMode == 0 ? 0 : blockIdx.z % 4;
  const int n = kMode == 0 ? blockIdx.z : blockIdx.z / 4;
  const int pa = phase >> 1, pb = phase & 1;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int r0 = (ty / (kBW / 4)) * 2, c0 = (ty % (kBW / 4)) * 4;
  const int ciw = Ci / 4;
  const int32_t* xw = reinterpret_cast<const int32_t*>(x);

  int acc[8][kCoT];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[p][j] = 0;

  for (int k0 = 0; k0 < ciw; k0 += kQKW) {
    const int kw = min(kQKW, ciw - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kPH * kPW * kQKW; i += kQThreads) {
      const int pix = i / kQKW, k = i % kQKW;
      const int gy = oy0 - 1 + pix / kPW, gx = ox0 - 1 + pix % kPW;
      int32_t v = 0;
      if (k < kw && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = xw[((static_cast<long long>(n) * H + gy) * W + gx) * ciw + k0 + k];
      patch[pix * kPS + k] = v;
    }
    for (int i = threadIdx.x; i < kTaps * kQKW * kBCo; i += kQThreads) {
      const int t = i / (kQKW * kBCo), k = (i / kBCo) % kQKW, c = i % kBCo;
      // mode 1: tap t = (ta, tb) of this phase, [a, ta, b, tb] of the 16
      const int g = kMode == 0 ? t : ((pa * 2 + (t >> 1)) * 2 + pb) * 2 + (t & 1);
      int32_t v = 0;
      if (k < kw && co0 + c < Co)
        v = w[(static_cast<long long>(g) * ciw + k0 + k) * Co + co0 + c];
      wsm[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int dy = kMode == 0 ? t / 3 : pa + (t >> 1);
      const int dx = kMode == 0 ? t % 3 : pb + (t & 1);
      for (int k = 0; k < kw; ++k) {
        int xv[8], wv[kCoT];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          xv[p] = patch[((r0 + (p >> 2) + dy) * kPW + c0 + (p & 3) + dx) * kPS +
                        k];
#pragma unroll
        for (int j = 0; j < kCoT; ++j)
          wv[j] = wsm[(t * kQKW + k) * kBCo + tx + kTX * j];
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int j = 0; j < kCoT; ++j)
            acc[p][j] = __dp4a(xv[p], wv[j], acc[p][j]);
      }
    }
  }

  const float xs = *x_scale;
#pragma unroll
  for (int j = 0; j < kCoT; ++j) {
    const int co = co0 + tx + kTX * j;
    if (co >= Co) continue;
    const float deq = __fmul_rn(xs, w_scale[co]);
    const float b = bias[co];
    float v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) v[p] = dequant_act(acc[p][j], deq, b, act);
    if (kMode == 0 && pool) {
      // the 2 x 4 sub-tile pools to 1 x 2 (H, W and the tile are even)
      const int oy = oy0 + r0, ox = ox0 + c0;
      if (oy >= H) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (ox + 2 * q >= W) continue;
        const float m = fmaxf(fmaxf(v[2 * q], v[2 * q + 1]),
                              fmaxf(v[4 + 2 * q], v[5 + 2 * q]));
        out[((static_cast<long long>(n) * (H / 2) + oy / 2) * (W / 2) +
             ox / 2 + q) * Co + co] = m;
      }
      continue;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int oy = oy0 + r0 + (p >> 2), ox = ox0 + c0 + (p & 3);
      if (oy >= H || ox >= W) continue;
      long long o;
      if (kMode == 0)
        o = ((static_cast<long long>(n) * H + oy) * W + ox) * Co + co;
      else
        o = ((static_cast<long long>(n) * 2 * H + 2 * oy + pa) * 2 * W +
             2 * ox + pb) * Co + co;
      out[o] = v[p];
    }
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

template <int kMode, int kTX, int kCoT, int kBH, int kBW>
cudaError_t launch_tapconv(const int8_t* x, const int32_t* w,
                           const float* x_scale, const float* w_scale,
                           const float* bias, float* out, int N, int H, int W,
                           int Ci, int Co, int act, int pool,
                           cudaStream_t stream) {
  const dim3 grid(((H + kBH - 1) / kBH) * ((W + kBW - 1) / kBW),
                  (Co + kTX * kCoT - 1) / (kTX * kCoT),
                  kMode == 0 ? N : 4 * N);
  quant_tapconv_kernel<kMode, kTX, kCoT, kBH, kBW>
      <<<grid, kQThreads, 0, stream>>>(x, w, x_scale, w_scale, bias, out, H,
                                       W, Ci, Co, act, pool);
  return cudaGetLastError();
}

// 64 channels a block where Co > 4; a block of 4 channels and 512 pixels
// for G's Co = 3 output conv
template <int kMode>
cudaError_t tapconv(const int8_t* x, const int32_t* w, const float* x_scale,
                    const float* w_scale, const float* bias, float* out, int N,
                    int H, int W, int Ci, int Co, int act, int pool,
                    cudaStream_t stream) {
  if (Co <= 4)
    return launch_tapconv<kMode, 4, 1, 16, 32>(x, w, x_scale, w_scale, bias,
                                               out, N, H, W, Ci, Co, act, pool,
                                               stream);
  return launch_tapconv<kMode, 16, 4, 8, 16>(x, w, x_scale, w_scale, bias,
                                             out, N, H, W, Ci, Co, act, pool,
                                             stream);
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

// x (N,H,W,Ci) int8, Ci % 4 == 0; w (9, Ci/4, Co) words; out (N,H,W,Co) f32
// or (N,H/2,W/2,Co) with pool
int gr_quant_conv3x3(const int8_t* x, const int32_t* w, const float* x_scale,
                     const float* w_scale, const float* bias, float* out,
                     int N, int H, int W, int Ci, int Co, int act, int pool,
                     cudaStream_t stream) {
  if (Ci % 4 || (pool && (H % 2 || W % 2))) return cudaErrorInvalidValue;
  return gr::tapconv<0>(x, w, x_scale, w_scale, bias, out, N, H, W, Ci, Co,
                        act, pool, stream);
}

// x (N,H,W,Ci) int8, Ci % 4 == 0; w (16, Ci/4, Co) words, the phase taps
// [a, ta, b, tb]; out (N,2H,2W,Co) f32
int gr_quant_upsample2_conv3x3(const int8_t* x, const int32_t* w,
                               const float* x_scale, const float* w_scale,
                               const float* shift, float* out, int N, int H,
                               int W, int Ci, int Co, int act,
                               cudaStream_t stream) {
  if (Ci % 4) return cudaErrorInvalidValue;
  return gr::tapconv<1>(x, w, x_scale, w_scale, shift, out, N, H, W, Ci, Co,
                        act, 0, stream);
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
