// Kernel U: nearest 2x upsample + 3x3 SAME conv + folded eval-BatchNorm
// scale/shift + activation, computed as four output phases of a 2x2 conv
// with phase-aggregated weights at the input resolution.
//
// Replaces ganreverser_tpu/ops/upsample_conv_kernel.py::
// upsample2_conv3x3_bn_act (_kernel, with phase_kernels on the host). A 3x3
// window over a nearest-upsampled image sees only 2x2 distinct input pixels,
// so phase (a, b) of output pixel (2i + a, 2j + b) is
//
//   sum_{ta, tb} xpad[i + a + ta, j + b + tb] . K[a, ta, b, tb]
//
// with K aggregated on the host (16 MACs per output pixel and channel pair
// instead of 36). blockIdx.z is the phase; each phase writes its strided
// quarter of the output directly, so the upsampled input never exists and
// the interleave costs no extra pass.
//
// What bounds it: the tensor cores, as kernel B (conv_block.cu): stage 1's
// aggregated weights are 16x512x256 (4 MB in bf16), streamed BK input
// channels of one tap at a time. In bf16 each phase is conv_wgmma.cuh's tile
// with its four taps, the weights laid out K-major as (16, Co, Ci) by the
// wrapper; in f32 conv_tile.cuh's IEEE f32 loop runs on the CUDA cores.
//
// The second entry point, gr_upsample2_conv3x3_head, is the TPU kernel's
// fused final head (its final_kernel path): U, one rounding to the storage
// type, SAME zero padding, then a 3x3 Co -> Cf conv (Cf 1 to 4) + bias +
// final act. What bounds it is U's tensor-core work (275 GFLOP at G3's
// stage 2, N = 256; the head adds 7.2); a tile of U's output is all a
// block holds, so the head's 3x3 window, which reaches one pixel into the
// neighbouring tiles, cannot be finished inside the block. In bf16 two
// launches do it without recomputing a halo and without writing U's
// output:
//  1. upsample2_head_wgmma_kernel: U's own grid and mainloop (the phase
//     taps, blockIdx.z the phase, the plan of ops/conv_operands.py::
//     head_plan: U's tile with BN at most 128), whose epilogue
//     (conv_wgmma.cuh's HeadTapsEpilogue) rounds the tile to bf16 and
//     multiplies it on the tensor cores by the head's weights, writing each
//     U pixel's nine tap partials v_t(q) = fk[t] . u(q), 9 Cf f32 (108
//     bytes at Cf = 3 against U's 256), per channel block, to a workspace
//     (channel blocks, 4 phases, N, H, W, 9 Cf);
//  2. upsample2_head_finish_kernel: each output pixel p adds v_t(p + t - 1)
//     of its in-image neighbours in tap order, each tap's channel blocks in
//     block order (the SAME padding: a neighbour outside the image adds
//     nothing), then the bias and final act, and rounds once to bf16.
// No float atomics, so two calls are bitwise equal; the rounding points are
// the TPU kernel's, the f32 sums taken in another order. In f32 one launch,
// upsample2_conv3x3_head_kernel, keeps the IEEE f32 CUDA-core design: a
// block computes U over a 16x16 haloed tile of output pixels into shared
// memory (conv_tile.cuh, one 64-row chunk per phase, zero for the halo
// pixels outside the image), then one warp per output pixel runs the 9-tap
// head out of shared memory; the halo recomputes 1.31x of U's work.
#include "conv_tile.cuh"
#include "conv_wgmma.cuh"

namespace gr {

struct PhaseTaps {
  int a, b;
  __device__ __forceinline__ void operator()(int t, int& dy, int& dx,
                                             int& widx) const {
    const int ta = t >> 1;
    const int tb = t & 1;
    dy = a + ta - 1;  // padded row i + a + ta is input row i + a + ta - 1
    dx = b + tb - 1;
    widx = ((a * 2 + ta) * 2 + b) * 2 + tb;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) upsample2_conv3x3_bn_act_kernel(
    const T* __restrict__ x, const T* __restrict__ k16,
    const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ out, int N, int H, int W, int Ci, int Co, int act) {
  const int a = blockIdx.z >> 1;
  const int b = blockIdx.z & 1;
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

  conv_tile_mainloop<T, 4>(x, k16, H, W, Ci, Co, rc, co0, PhaseTaps{a, b},
                           acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
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
            apply_act(fmaf(acc[r][c], scale[co], shift[co]), act));
    }
  }
}

template <typename T>
static void launch(const void* x, const void* k16, const void* scale,
                   const void* shift, void* out, int n, int h, int w, int ci,
                   int co, int act, cudaStream_t stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((co + kBN - 1) / kBN), 4);
  upsample2_conv3x3_bn_act_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k16),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), n, h, w, ci, co, act);
}

// The bf16 kernel: conv_wgmma.cuh's tile, the four taps of phase
// blockIdx.z, the scale/shift/act epilogue with the phase-strided store.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    upsample2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::PhaseTaps, wg::BnActEpilogue<true>>(xmap, wmap,
                                                                 args);
}

static int launch_bf16(const void* x, const void* k16, const void* scale,
                       const void* shift, void* out, int n, int h, int w,
                       int ci, int co, int act, const wg::Plan& pl,
                       cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!wg::plan_ok(pl, false) ||
      !wg::encode_maps(&xmap, &wmap, x, k16, n, h, w, ci, co, ci, 16, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::ConvArgs args{static_cast<const float*>(scale),
                          static_cast<const float*>(shift),
                          nullptr,
                          static_cast<__nv_bfloat16*>(out),
                          h, w, co, act, 0, pl.bh, pl.bw, pl.bk, pl.stages,
                          (ci + pl.bk - 1) / pl.bk};
  const dim3 grid = wg::plan_grid(pl, n, h, w, co, 4);
  return static_cast<int>(wg::by_width(pl.bn, [&](auto bn) {
    return wg::launch(upsample2_wgmma_kernel<decltype(bn)::value>, grid,
                      pl.smem, stream, xmap, wmap, args);
  }));
}

constexpr int kHalo = 16;          // haloed tile side, high-res pixels
constexpr int kOutTile = kHalo - 2;  // output tile side
constexpr int kMaxCf = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads) upsample2_conv3x3_head_kernel(
    const T* __restrict__ x, const T* __restrict__ k16,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const T* __restrict__ fk, const float* __restrict__ fb,
    T* __restrict__ out, int H, int W, int Ci, int Co, int Cf, int act,
    int final_act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [kHalo][kHalo][Co]
  float* fks = reinterpret_cast<float*>(
      smem_raw + static_cast<size_t>(kHalo) * kHalo * Co * sizeof(T));
  const int n = blockIdx.z;
  const int oy0 = blockIdx.y * kOutTile;  // even: the tile side is even
  const int ox0 = blockIdx.x * kOutTile;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tid = threadIdx.x;

  // the head's weights, [tap][f][c] as f32, so lanes read consecutive c
  for (int i = tid; i < 9 * Cf * Co; i += kThreads) {
    const int c = i % Co;
    const int f = (i / Co) % Cf;
    const int t = i / (Co * Cf);
    fks[i] = to_f32(fk[(static_cast<long long>(t) * Co + c) * Cf + f]);
  }

  // U over the haloed region: halo row ly holds output row oy0 - 1 + ly.
  // Row r of phase (a, b)'s chunk is (u, v) = (r / 8, r % 8), at halo
  // (2u + 1 - a, 2v + 1 - b), output (oy0 + 2u - a, ox0 + 2v - b), whose
  // low-resolution pixel is (oy0 / 2 + u - a, ox0 / 2 + v - b).
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int p = 0; p < 4; ++p) {
    const int a = p >> 1;
    const int b = p & 1;
    RowCoord rc;
    {
      const int r = tid >> 2;
      const int u = r >> 3, v = r & 7;
      const int gy = oy0 + 2 * u - a, gx = ox0 + 2 * v - b;
      rc.valid = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
      rc.n = n;
      rc.i = oy0 / 2 + u - a;
      rc.j = ox0 / 2 + v - b;
    }
    for (int co0 = 0; co0 < Co; co0 += kBN) {
      float acc[kTM][kTN];
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = 0.0f;
      conv_tile_mainloop<T, 4>(x, k16, H, W, Ci, Co, rc, co0,
                               PhaseTaps{a, b}, acc);
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const int row = ty * kTM + r;
        const int u = row >> 3, v = row & 7;
        const int gy = oy0 + 2 * u - a, gx = ox0 + 2 * v - b;
        const bool inside = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
        T* dst = tile + ((2 * u + 1 - a) * kHalo + (2 * v + 1 - b)) * Co;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const int co = co0 + tx * kTN + c;
          if (co < Co)
            dst[co] = from_f32<T>(
                inside ? apply_act(fmaf(acc[r][c], scale[co], shift[co]), act)
                       : 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // the head: warp w takes output pixels w, w + 8, ... of the tile
  const int warp = tid >> 5, lane = tid & 31;
  for (int q = warp; q < kOutTile * kOutTile; q += kThreads / 32) {
    const int py = q / kOutTile, px = q % kOutTile;
    const int oy = oy0 + py, ox = ox0 + px;
    if (oy >= H2 || ox >= W2) continue;  // warp-uniform
    float hacc[kMaxCf] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 0; t < 9; ++t) {
      const T* src = tile + ((py + t / 3) * kHalo + (px + t % 3)) * Co;
      const float* wt = fks + t * Cf * Co;
      for (int c = lane; c < Co; c += 32) {
        const float v = to_f32(src[c]);
#pragma unroll
        for (int f = 0; f < kMaxCf; ++f)
          if (f < Cf) hacc[f] = fmaf(v, wt[f * Co + c], hacc[f]);
      }
    }
    T* orow = out + ((static_cast<long long>(n) * H2 + oy) * W2 + ox) * Cf;
#pragma unroll
    for (int f = 0; f < kMaxCf; ++f) {
      if (f < Cf) {
        const float s = warp_sum(hacc[f]);
        if (lane == 0) orow[f] = from_f32<T>(apply_act(s + fb[f], final_act));
      }
    }
  }
}

static int launch_head_f32(const void* x, const void* k16, const void* scale,
                           const void* shift, const void* fk, const void* fb,
                           void* out, int n, int h, int w, int ci, int co,
                           int cf, int act, int final_act,
                           cudaStream_t stream) {
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kHalo) * kHalo * co * sizeof(float) +
                      static_cast<size_t>(9) * cf * co * sizeof(float);
  // the mainloop's static tiles count against the same 48 KB default, so
  // the opt-in is set whatever the dynamic size
  const cudaError_t e = cudaFuncSetAttribute(
      upsample2_conv3x3_head_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((2 * w + kOutTile - 1) / kOutTile),
                  static_cast<unsigned>((2 * h + kOutTile - 1) / kOutTile),
                  static_cast<unsigned>(n));
  upsample2_conv3x3_head_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k16),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(fk), static_cast<const float*>(fb),
      static_cast<float*>(out), h, w, ci, co, cf, act, final_act);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 head, launch 1: U's tile, the four taps of phase blockIdx.z, the
// tap-partials epilogue.
template <int BN>
__global__ void __launch_bounds__(wg::kThreads, BN <= 64 ? 2 : 1)
    upsample2_head_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __grid_constant__ CUtensorMap wmap,
                                const wg::ConvArgs args) {
  wg::conv_wgmma_body<BN, wg::PhaseTaps, wg::HeadTapsEpilogue>(xmap, wmap,
                                                               args);
}

constexpr int kFinishThreads = 256;

// The bf16 head, launch 2: output pixel p of (N, 2H, 2W) adds, for each
// tap t = (dy, dx) in order, v_t of U pixel p + (dy - 1, dx - 1) where that
// pixel lies in the image, over the channel blocks in order; then the bias
// and the final act, rounded once to bf16.
__global__ void __launch_bounds__(kFinishThreads)
    upsample2_head_finish_kernel(const float* __restrict__ taps,
                                 const float* __restrict__ fb,
                                 __nv_bfloat16* __restrict__ out, int N,
                                 int H, int W, int cf, int blocks,
                                 int final_act) {
  const int H2 = 2 * H, W2 = 2 * W;
  const long long p = static_cast<long long>(blockIdx.x) * kFinishThreads +
                      threadIdx.x;
  if (p >= static_cast<long long>(N) * H2 * W2) return;
  const int x = static_cast<int>(p % W2);
  const int y = static_cast<int>((p / W2) % H2);
  const int n = static_cast<int>(p / (static_cast<long long>(W2) * H2));
  const int ld = 9 * cf;
  const long long plane = static_cast<long long>(N) * H * W;  // one phase
  float s[kMaxCf] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < 9; ++t) {
    const int qy = y + t / 3 - 1, qx = x + t % 3 - 1;
    if (qy < 0 || qy >= H2 || qx < 0 || qx >= W2) continue;
    const long long q = ((qy & 1) * 2 + (qx & 1)) * plane +
                        (static_cast<long long>(n) * H + (qy >> 1)) * W +
                        (qx >> 1);
    for (int b = 0; b < blocks; ++b) {
      const float* v = taps + (b * 4 * plane + q) * ld + t * cf;
#pragma unroll
      for (int f = 0; f < kMaxCf; ++f)
        if (f < cf) s[f] += v[f];
    }
  }
#pragma unroll
  for (int f = 0; f < kMaxCf; ++f)
    if (f < cf)
      out[p * cf + f] = __float2bfloat16(apply_act(s[f] + fb[f], final_act));
}

static int launch_head_bf16(const void* x, const void* k16, const void* scale,
                            const void* shift, const void* fk, const void* fb,
                            void* ws, void* out, int n, int h, int w, int ci,
                            int co, int cf, int act, int final_act,
                            const wg::Plan& pl, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!wg::head_plan_ok(pl, cf) ||
      !wg::encode_maps(&xmap, &wmap, x, k16, n, h, w, ci, co, ci, 16, pl))
    return static_cast<int>(cudaErrorInvalidValue);
  wg::ConvArgs args{};
  args.scale = static_cast<const float*>(scale);
  args.shift = static_cast<const float*>(shift);
  args.H = h;
  args.W = w;
  args.Co = co;
  args.act = act;
  args.bh = pl.bh;
  args.bw = pl.bw;
  args.bk = pl.bk;
  args.stages = pl.stages;
  args.kchunks = (ci + pl.bk - 1) / pl.bk;
  args.head_w = static_cast<const __nv_bfloat16*>(fk);
  args.taps = static_cast<float*>(ws);
  args.cf = cf;
  const dim3 grid = wg::plan_grid(pl, n, h, w, co, 4);
  cudaError_t e;
  switch (pl.bn) {  // head_plan_ok: BN is 16, 32, 64 or 128
    case 16:
      e = wg::launch(upsample2_head_wgmma_kernel<16>, grid, pl.smem, stream,
                     xmap, wmap, args);
      break;
    case 32:
      e = wg::launch(upsample2_head_wgmma_kernel<32>, grid, pl.smem, stream,
                     xmap, wmap, args);
      break;
    case 64:
      e = wg::launch(upsample2_head_wgmma_kernel<64>, grid, pl.smem, stream,
                     xmap, wmap, args);
      break;
    default:
      e = wg::launch(upsample2_head_wgmma_kernel<128>, grid, pl.smem, stream,
                     xmap, wmap, args);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pixels = static_cast<long long>(n) * 4 * h * w;
  upsample2_head_finish_kernel<<<static_cast<unsigned>(
                                     (pixels + kFinishThreads - 1) /
                                     kFinishThreads),
                                 kFinishThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(fb),
      static_cast<__nv_bfloat16*>(out), n, h, w, cf,
      static_cast<int>(grid.y), final_act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gr

// f32: x (N,H,W,Ci) and k16 (16,Ci,Co, flattened [a,ta,b,tb]), the plan
// ignored. bf16: x (N,H,W,Ci) with Ci % 8 == 0 and k16 (16,Co,Ci) K-major
// (ops/conv_operands.py), on the plan bh, bw, bn, bk, stages, smem
// (ops/conv_operands.py::tile_plan). scale/shift (Co,) f32, out (N,2H,2W,Co)
// in the storage type.
extern "C" int gr_upsample2_conv3x3_bn_act(int dtype, const void* x,
                                           const void* k16, const void* scale,
                                           const void* shift, void* out, int n,
                                           int h, int w, int ci, int co,
                                           int act, int bh, int bw, int bn,
                                           int bk, int stages, int smem,
                                           void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_bf16(x, k16, scale, shift, out, n, h, w, ci, co, act,
                       wg::Plan{bh, bw, bn, bk, stages, smem}, s);
  if (dtype != DT_F32) return static_cast<int>(cudaErrorInvalidValue);
  launch<float>(x, k16, scale, shift, out, n, h, w, ci, co, act, s);
  return static_cast<int>(cudaGetLastError());
}

// The fused head: x, k16, scale/shift as gr_upsample2_conv3x3_bn_act, fb
// (Cf,) f32, 1 <= Cf <= 4, out (N,2H,2W,Cf) in the storage type. f32: fk
// (3,3,Co,Cf), ws and the plan ignored, N <= 65535. bf16: fk the head's
// weights (head_rows(Cf), Co') K-major (ops/conv_operands.py::
// head_weights), on the plan bh, bw, bn, bk, stages, smem (ops/
// conv_operands.py::head_plan), ws the tap partials, (ceil(Co / bn), 4, N,
// H, W, 9 Cf) f32.
extern "C" int gr_upsample2_conv3x3_head(int dtype, const void* x,
                                         const void* k16, const void* scale,
                                         const void* shift, const void* fk,
                                         const void* fb, void* ws, void* out,
                                         int n, int h, int w, int ci, int co,
                                         int cf, int act, int final_act,
                                         int bh, int bw, int bn, int bk,
                                         int stages, int smem, void* stream) {
  using namespace gr;
  if (cf < 1 || cf > kMaxCf || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_head_f32(x, k16, scale, shift, fk, fb, out, n, h, w, ci, co,
                           cf, act, final_act, s);
  if (dtype == DT_BF16)
    return launch_head_bf16(x, k16, scale, shift, fk, fb, ws, out, n, h, w,
                            ci, co, cf, act, final_act,
                            wg::Plan{bh, bw, bn, bk, stages, smem}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
