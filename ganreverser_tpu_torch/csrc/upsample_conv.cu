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
// What bounds it: FMA issue, as kernel B (conv_block.cu): stage 1's
// aggregated weights are 16x512x256 (4 MB in bf16), streamed BK input
// channels at a time through shared memory, with f32 CUDA-core FMAs in this
// first version.
//
// The second entry point, gr_upsample2_conv3x3_head, is the TPU kernel's
// fused final head (its final_kernel path): U, one rounding to the storage
// type, SAME zero padding, then a 3x3 Co -> Cf conv + bias + final act, in
// one launch whose U output never goes to device memory. A block owns one
// image and a 14x14 tile of high-resolution output pixels. It computes U
// over the 16x16 haloed region into shared memory: the region holds 8x8
// pixels of each phase, so each phase is exactly one 64-row chunk of the
// shared tile (conv_tile.cuh) with that phase's weights, run once per 64
// output channels. The epilogue stores act(scale * acc + shift) rounded to
// the storage type, and zero for the halo pixels outside the image (the
// head's padding ring, applied after the activation and the rounding).
// Then one warp per output pixel runs the 9-tap head out of shared memory,
// lanes striding over Co (conflict-free), a warp sum per output channel.
// At G3's stage 2 (Co = 128) the tile is 64 KB in bf16 and 128 KB in f32,
// above the 48 KB a launch gets without cudaFuncSetAttribute. The halo
// recomputes (16 / 14)^2 = 1.31x of U's work, 1.56x on a 64x64 output where
// the last tile row and column are ragged.
#include "conv_tile.cuh"

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

template <typename T>
static int launch_head(const void* x, const void* k16, const void* scale,
                       const void* shift, const void* fk, const void* fb,
                       void* out, int n, int h, int w, int ci, int co, int cf,
                       int act, int final_act, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kHalo) * kHalo * co * sizeof(T) +
                      static_cast<size_t>(9) * cf * co * sizeof(float);
  // the mainloop's static tiles count against the same 48 KB default, so
  // the opt-in is set whatever the dynamic size
  const cudaError_t e = cudaFuncSetAttribute(
      upsample2_conv3x3_head_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((2 * w + kOutTile - 1) / kOutTile),
                  static_cast<unsigned>((2 * h + kOutTile - 1) / kOutTile),
                  static_cast<unsigned>(n));
  upsample2_conv3x3_head_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k16),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const T*>(fk), static_cast<const float*>(fb),
      static_cast<T*>(out), h, w, ci, co, cf, act, final_act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gr

// x (N,H,W,Ci) and k16 (16,Ci,Co, flattened [a,ta,b,tb]) in the storage
// type, scale/shift (Co,) f32, out (N,2H,2W,Co) in the storage type.
extern "C" int gr_upsample2_conv3x3_bn_act(int dtype, const void* x,
                                           const void* k16, const void* scale,
                                           const void* shift, void* out, int n,
                                           int h, int w, int ci, int co,
                                           int act, void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(x, k16, scale, shift, out, n, h, w, ci, co, act, s);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(x, k16, scale, shift, out, n, h, w, ci, co, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The fused head: x, k16, scale/shift as gr_upsample2_conv3x3_bn_act; fk
// (3,3,Co,Cf) in the storage type, fb (Cf,) f32, 1 <= Cf <= 4; out
// (N,2H,2W,Cf) in the storage type.
extern "C" int gr_upsample2_conv3x3_head(int dtype, const void* x,
                                         const void* k16, const void* scale,
                                         const void* shift, const void* fk,
                                         const void* fb, void* out, int n,
                                         int h, int w, int ci, int co, int cf,
                                         int act, int final_act,
                                         void* stream) {
  using namespace gr;
  if (cf < 1 || cf > kMaxCf || n < 1 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_head<float>(x, k16, scale, shift, fk, fb, out, n, h, w, ci,
                              co, cf, act, final_act, s);
  if (dtype == DT_BF16)
    return launch_head<__nv_bfloat16>(x, k16, scale, shift, fk, fb, out, n, h,
                                      w, ci, co, cf, act, final_act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
