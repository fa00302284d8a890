// StyleGAN2's FIR filter f (x) f, f = [1, 3, 3, 1] / 4 on each axis (the
// 2-D filter normalised to sum 1 and scaled by 4, upfirdn_2d's
// _setup_kernel with gain 4), of each channel of an NHWC tensor, in the
// four forms that models/modules.py::FIRFilter and its gradient use:
//
//   form (up, down, pad0)   rows in -> out   used as
//   (1, 1, 1)               2r + 1 -> 2r     the blur after an up-sampling
//                                            modulated conv, pad (1, 1)
//   (1, 1, 2)               2r -> 2r + 1     its gradient, pad (2, 2)
//   (2, 1, 2)               r -> 2r          the skip's up-sampling: a zero
//                                            after each pixel, pad (2, 1)
//   (1, 2, 1)               2r -> r          its gradient: pad (1, 1), the
//                                            filter, every second pixel
//
// out[o] = sum_k f[k] U[o * down - pad0 + k] along each axis, U the input
// with up - 1 zeros after each pixel, anything outside the input zero.
//
// It replaces no TPU kernel: StyleGAN2 exists only in the port, and the
// JAX package has no counterpart. It replaces the depthwise cuDNN
// convolutions (groups = C, f32 operands) that ran the filter before, and
// their dgrad.
//
// Numbers: each loaded element is rounded to bf16 where round_in is set
// (the forward's operands, as the module path's x.to(dtype) rounds them);
// taps, products and sums are f32 (the taps 1/16, 3/16, 9/16 of the 2-D
// filter are exact); the f32 sum is rounded to bf16 where round_out is set
// (the gradient, as autograd rounds it through that cast) and stored in
// the output's dtype. Only the order of the f32 sums differs from the
// convolution's.
//
// What bounds it: 16 multiply-adds an output against 8 bytes moved (one
// f32 read, one f32 write), about 4 operations a byte, far below the
// card's 295: device-memory bandwidth alone. At StyleGAN2's 1024 x 1024 x
// 32 blur, batch 8, a launch moves 2.15 GB, 0.64 ms at 3.35 TB/s. Design:
//  - one thread owns V channels of one output column and a tile of TH
//    output rows; it walks down the input rows that tile needs, filters
//    each row horizontally (4 taps, f32) and adds each filtered row into
//    the (at most 4) output rows whose vertical taps read it, storing an
//    output row as soon as its last tap is in: the separable form, 8
//    multiply-adds an output, with the whole loop unrolled at compile time
//    (TH, up, down and pad0 are template arguments), so each output row's
//    sum lives in registers for 4 input rows only;
//  - V channels a thread in one 16-byte load (4 f32 or 8 bf16) where C is
//    a multiple of V and both tensors are 16-byte aligned: a warp reads
//    512 contiguous bytes a tap, along the channel axis (C is 32-512 for
//    every blur); the 3-channel skip (C not a multiple of V) takes the
//    scalar path, V = 1, chosen from C by the wrapper's plan;
//  - the horizontal taps of neighbouring columns reread a pixel its
//    neighbours loaded (L1), and a tile's halo rows are the next tile's
//    (L2, the tiles of a row being co-resident): device memory sees each
//    input byte about once, each output byte written once;
//  - the padding and the up-sampling's zeros are never stored: a tap
//    outside the input or between up-sampled pixels loads a nearby valid
//    address and selects zero, with no branch, so the loads of several
//    rows are in flight together;
//  - TH is 8, or 2 where 8 leaves fewer than 4 blocks an SM (the 8 x 8 x
//    512 blur at batch 8 then launches 256 blocks of 128 threads): the
//    wrapper's plan (ops/fir_kernel.py::fir_plan).
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace gr {

constexpr int kFirThreads = 128;

__host__ __device__ constexpr float fir_tap(int k) {
  return (k == 0 || k == 3) ? 0.25f : 0.75f;
}

// the vertical structure of a form, for a tile whose first output row o0
// is a multiple of TH (even where UP is 2, and pad0 even there), input rows
// counted from the tile's first, fir_first_row(o0): does output row t's
// tap k meet an input row (and not an inserted zero)?
template <int UP>
__host__ __device__ constexpr bool fir_vtap(int t, int k) {
  return UP == 1 || (t + k) % 2 == 0;
}

// the input row of output row t's tap k
template <int UP, int DOWN>
__host__ __device__ constexpr int fir_vrow(int t, int k) {
  return UP == 1 ? t * DOWN + k : (t + k) / 2;
}

// the last input row that output row t reads
template <int UP, int DOWN>
__host__ __device__ constexpr int fir_vlast(int t) {
  return fir_vtap<UP>(t, 3) ? fir_vrow<UP, DOWN>(t, 3) : fir_vrow<UP, DOWN>(t, 2);
}

template <int UP, int DOWN, int P>
__device__ __forceinline__ int fir_first_row(int o0) {
  return UP == 1 ? o0 * DOWN - P : (o0 - P) / 2;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// V consecutive elements, loaded as 16-byte packs (V > 1) or one element
template <typename T, int V>
__device__ __forceinline__ void fir_load(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    static_assert(V % kPer == 0, "whole 16-byte packs");
#pragma unroll
    for (int q = 0; q < V / kPer; ++q) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[q * kPer + j] = to_f32(e[j]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void fir_store(T* __restrict__ p, const float (&v)[V]) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) e[j] = from_f32<T>(v[q * kPer + j]);
      reinterpret_cast<uint4*>(p)[q] = u;
    }
  } else {
    static_assert(kBytes == 8, "4 bf16");
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// grid (ceil(wo * c / V / kFirThreads), ceil(ho / TH), n): thread i of a
// row's blocks owns output elements [i V, i V + V) of the flattened (wo, c)
// row, i.e. V channels of one column, rows [o0, o0 + TH) of image z
template <typename TI, typename TO, int V, int UP, int DOWN, int P, int TH>
__global__ void __launch_bounds__(kFirThreads)
    fir_filter_kernel(const TI* __restrict__ x, TO* __restrict__ y, int hi,
                      int wi, int ho, int wo, int c, int round_in,
                      int round_out) {
  static_assert(UP == 1 || (P % 2 == 0 && TH % 2 == 0), "up 2: even pad0 and TH");
  constexpr int kRows = fir_vlast<UP, DOWN>(TH - 1) + 1;
  const long long e =
      (static_cast<long long>(blockIdx.x) * kFirThreads + threadIdx.x) * V;
  const long long out_row = static_cast<long long>(wo) * c;
  if (e >= out_row) return;
  const int col = static_cast<int>(e / c);
  const int ch = static_cast<int>(e - static_cast<long long>(col) * c);
  const int o0 = blockIdx.y * TH;
  const long long in_row = static_cast<long long>(wi) * c;
  const TI* xn = x + static_cast<long long>(blockIdx.z) * hi * in_row + ch;
  TO* yp = y + (static_cast<long long>(blockIdx.z) * ho + o0) * out_row + e;

  // the horizontal taps of this column: the input column each reads (a
  // nearby valid one where the tap meets padding or an inserted zero,
  // whose value is then not used) and whether it meets an input pixel
  int hcol[4];
  bool hok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int u = col * DOWN - P + k;
    hok[k] = u >= 0 && u < wi * UP && u % UP == 0;
    hcol[k] = min(max(u, 0), wi * UP - 1) / UP;
  }

  float acc[TH][V];
#pragma unroll
  for (int t = 0; t < TH; ++t)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[t][j] = 0.0f;

  const int rb = fir_first_row<UP, DOWN, P>(o0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ir = rb + r;
    const bool rok = ir >= 0 && ir < hi;
    const TI* xr = xn + static_cast<long long>(min(max(ir, 0), hi - 1)) * in_row;
    float h[V];
#pragma unroll
    for (int j = 0; j < V; ++j) h[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[V];
      fir_load<TI, V>(xr + static_cast<long long>(hcol[k]) * c, v);
      const bool ok = rok && hok[k];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float a = round_in ? round_bf16(v[j]) : v[j];
        h[j] = ok ? fmaf(fir_tap(k), a, h[j]) : h[j];
      }
    }
#pragma unroll
    for (int t = 0; t < TH; ++t) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (fir_vtap<UP>(t, k) && fir_vrow<UP, DOWN>(t, k) == r) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[t][j] = fmaf(fir_tap(k), h[j], acc[t][j]);
        }
      }
      if (fir_vlast<UP, DOWN>(t) == r && o0 + t < ho) {
        float out[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          out[j] = round_out ? round_bf16(acc[t][j]) : acc[t][j];
        fir_store<TO, V>(yp + static_cast<long long>(t) * out_row, out);
      }
    }
  }
}

template <typename TI, typename TO, int V, int UP, int DOWN, int P>
cudaError_t launch_fir_form(const void* x, void* y, int n, int hi, int wi,
                            int ho, int wo, int c, int round_in,
                            int round_out, int rows, cudaStream_t s) {
  const long long vecs = (static_cast<long long>(wo) * c) / V;
  const long long gx = (vecs + kFirThreads - 1) / kFirThreads;
  const int gy = (ho + rows - 1) / rows;
  if (gx > 0x7fffffffLL || gy > 65535 || n > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned int>(gx), gy, n);
  const TI* xt = static_cast<const TI*>(x);
  TO* yt = static_cast<TO*>(y);
  if (rows == 2)
    fir_filter_kernel<TI, TO, V, UP, DOWN, P, 2><<<grid, kFirThreads, 0, s>>>(
        xt, yt, hi, wi, ho, wo, c, round_in, round_out);
  else
    fir_filter_kernel<TI, TO, V, UP, DOWN, P, 8><<<grid, kFirThreads, 0, s>>>(
        xt, yt, hi, wi, ho, wo, c, round_in, round_out);
  return cudaGetLastError();
}

// the forward forms write f32, the gradient forms read f32 (the f32 output's
// gradient): only those are built
template <typename TI, typename TO, int V>
cudaError_t launch_fir_vec(const void* x, void* y, int n, int hi, int wi,
                           int ho, int wo, int c, int up, int down, int pad0,
                           int round_in, int round_out, int rows,
                           cudaStream_t s) {
  if constexpr (std::is_same_v<TO, float>) {
    if (up == 1 && down == 1 && pad0 == 1)
      return launch_fir_form<TI, TO, V, 1, 1, 1>(x, y, n, hi, wi, ho, wo, c,
                                                 round_in, round_out, rows, s);
    if (up == 2 && down == 1 && pad0 == 2)
      return launch_fir_form<TI, TO, V, 2, 1, 2>(x, y, n, hi, wi, ho, wo, c,
                                                 round_in, round_out, rows, s);
  }
  if constexpr (std::is_same_v<TI, float>) {
    if (up == 1 && down == 1 && pad0 == 2)
      return launch_fir_form<TI, TO, V, 1, 1, 2>(x, y, n, hi, wi, ho, wo, c,
                                                 round_in, round_out, rows, s);
    if (up == 1 && down == 2 && pad0 == 1)
      return launch_fir_form<TI, TO, V, 1, 2, 1>(x, y, n, hi, wi, ho, wo, c,
                                                 round_in, round_out, rows, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TI, typename TO>
cudaError_t launch_fir(const void* x, void* y, int n, int hi, int wi, int ho,
                       int wo, int c, int up, int down, int pad0,
                       int round_in, int round_out, int vec, int rows,
                       cudaStream_t s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TI));
  if (vec == 1)
    return launch_fir_vec<TI, TO, 1>(x, y, n, hi, wi, ho, wo, c, up, down,
                                     pad0, round_in, round_out, rows, s);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x) |
                         reinterpret_cast<std::uintptr_t>(y)) % 16) == 0;
  if (vec != kVec || c % kVec != 0 || !aligned) return cudaErrorInvalidValue;
  return launch_fir_vec<TI, TO, kVec>(x, y, n, hi, wi, ho, wo, c, up, down,
                                      pad0, round_in, round_out, rows, s);
}

}  // namespace gr

// x: (n, hi, wi, c) contiguous of in_dtype; y: (n, ho, wo, c) contiguous of
// out_dtype (DT_F32 or DT_BF16), not aliasing x. (up, down, pad0) one of the
// four forms above, a forward form writing f32, a gradient form reading f32; ho and wo any sizes >= 1 (rows and columns past the
// input's reach read zeros, as a larger pad1 would). round_in / round_out:
// round each loaded element / each f32 sum to bf16. The plan: vec 1 or 16
// bytes of in_dtype (c a multiple of it, both pointers 16-byte aligned),
// rows 2 or 8.
extern "C" int gr_fir_filter(int in_dtype, int out_dtype, const void* x,
                             void* y, int n, int hi, int wi, int ho, int wo,
                             int c, int up, int down, int pad0, int round_in,
                             int round_out, int vec, int rows, void* stream) {
  using namespace gr;
  if (n < 0 || hi < 1 || wi < 1 || ho < 1 || wo < 1 || c < 1 ||
      (rows != 2 && rows != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto ti, auto to) {
    using TI = decltype(ti);
    using TO = decltype(to);
    return static_cast<int>(launch_fir<TI, TO>(x, y, n, hi, wi, ho, wo, c, up,
                                               down, pad0, round_in,
                                               round_out, vec, rows, s));
  };
  if (in_dtype == DT_F32 && out_dtype == DT_F32) return go(float(), float());
  if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    return go(float(), __nv_bfloat16());
  if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    return go(__nv_bfloat16(), float());
  return static_cast<int>(cudaErrorInvalidValue);
}
