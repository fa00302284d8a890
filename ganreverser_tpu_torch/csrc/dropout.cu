// Kernel B5: dropout whose keep mask is a counter hash of each element's
// flat index and a seed, computed inside the pass, so no mask is stored.
//
// Replaces ganreverser_tpu/ops/dropout_kernel.py::_run (the Pallas body
// _kernel with _hash_bits). Its custom_vjp (_fwd/_bwd) becomes the wrapper's
// torch.autograd.Function (ops/dropout_kernel.py), whose backward launches
// this same kernel on the incoming gradient with the saved seed: identical
// (seed, index) pairs give identical bits, so the forward's mask comes back.
//
// What it computes, to the bit (the TPU kernel's at base 0):
//   idx  = (base + the element's flat index) mod 2^32 (the TPU's
//          (row * 1024 + col) in uint32 over its 1024-column view is the
//          same number at base 0; a rank holding rows [r, r + n) of a batch
//          passes base = r * row elements and gets those rows of the whole
//          batch's mask)
//   h    = fmix32(idx ^ (uint32(seed) * 0x9E3779B9))   (murmur3 finalizer)
//   keep = h < thresh, thresh = min(round(keep_p * 2^32), 2^32 - 1), host
//   y    = keep ? T(float(x) * inv_keep) : 0, inv_keep = f32(1 / keep_p):
//          one f32 multiply, and the bf16 store rounds to nearest even.
//
// What bounds it: one read and one write of x, so device-memory bandwidth
// (R's largest dropout, (256,64,64,64) bf16, is 2 x 134 MB, more than the
// 50 MB L2). But each element also costs about 12-18 integer and float
// instructions (two IMADs in fmix32, the compare, select, multiply and
// rounding), so the memory stream and the issue rate must overlap. Design:
//  - a streaming pass over 16-byte packs (4 f32 or 8 bf16): each thread
//    issues kDropUnroll independent 16-byte loads before it hashes any,
//    with streaming cache hints (ld.global.cs / st.global.cs: every byte is
//    touched once), so several loads per thread are in flight;
//  - 32-bit arithmetic per element: the hash takes the index mod 2^32, so
//    a pack's first index is one 32-bit multiply-add of its pack number and
//    the counter base, and an element's index is that + j;
//  - in bf16, pairs are widened with __bfloat1622float2 and rounded with
//    __floats2bfloat162_rn after the f32 multiply (not __hmul2, which would
//    round the product in bf16 arithmetic: the TPU kernel multiplies in f32
//    and rounds once);
//  - the grid is one resident wave: the occupancy of the kernel times the
//    card's SM count, queried once per device and cached, with a grid-stride
//    loop over the packs;
//  - the seed is an int32 read from device memory (the trainer draws it on
//    the card, so a launch needs no host sync);
//  - both pointers must be 16-byte aligned for the packs; otherwise (a view
//    that starts inside a pack) another kernel takes one element per thread.
//    Any size is taken: block 0 does the ragged tail after the last pack,
//    and the TPU kernel's size % 8192 gate exists only for its (8, 1024)
//    tiling. One launch per call, no shared memory.
#include <cstdint>

#include "common.cuh"

namespace gr {

constexpr int kDropThreads = 256;
constexpr int kDropUnroll = 4;   // 16-byte loads in flight per thread
constexpr int kMaxDevices = 64;  // devices whose resident wave is cached

__device__ __forceinline__ unsigned int fmix32(unsigned int h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float drop_f32(float v, unsigned int idx,
                                          unsigned int seed_mix,
                                          unsigned int thresh, float inv_keep) {
  return fmix32(idx ^ seed_mix) < thresh ? v * inv_keep : 0.0f;
}

// the 16-byte pack: 4 f32 or 8 bf16, element j of the pack at index base + j
__device__ __forceinline__ uint4 drop_pack(uint4 v, float, unsigned int base,
                                           unsigned int seed_mix,
                                           unsigned int thresh, float inv_keep) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = drop_f32(f[j], base + j, seed_mix, thresh, inv_keep);
  return v;
}

__device__ __forceinline__ uint4 drop_pack(uint4 v, __nv_bfloat16,
                                           unsigned int base,
                                           unsigned int seed_mix,
                                           unsigned int thresh, float inv_keep) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    p[j] = __floats2bfloat162_rn(
        drop_f32(f.x, base + 2 * j, seed_mix, thresh, inv_keep),
        drop_f32(f.y, base + 2 * j + 1, seed_mix, thresh, inv_keep));
  }
  return v;
}

// packs p, p + stride, ... of x, kUnroll at a time: the loads of a batch are
// all issued before the first is hashed
template <typename T>
__global__ void __launch_bounds__(kDropThreads)
    fused_dropout_pack_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                              const int* __restrict__ seed, long long npack,
                              long long n, unsigned int base,
                              unsigned int thresh, float inv_keep) {
  constexpr unsigned int kVec = 16 / sizeof(T);
  const unsigned int seed_mix = static_cast<unsigned int>(__ldg(seed)) * 0x9E3779B9u;
  const long long stride = static_cast<long long>(gridDim.x) * kDropThreads;
  long long p = static_cast<long long>(blockIdx.x) * kDropThreads + threadIdx.x;
  for (; p + (kDropUnroll - 1) * stride < npack; p += kDropUnroll * stride) {
    uint4 v[kDropUnroll];
#pragma unroll
    for (int u = 0; u < kDropUnroll; ++u) v[u] = __ldcs(x + p + u * stride);
#pragma unroll
    for (int u = 0; u < kDropUnroll; ++u) {
      // the pack number mod 2^32 times kVec: the index of its first element
      const unsigned int first =
          static_cast<unsigned int>(p + u * stride) * kVec + base;
      __stcs(y + p + u * stride,
             drop_pack(v[u], T(), first, seed_mix, thresh, inv_keep));
    }
  }
  for (; p < npack; p += stride)
    __stcs(y + p, drop_pack(__ldcs(x + p), T(),
                            static_cast<unsigned int>(p) * kVec + base, seed_mix,
                            thresh, inv_keep));
  // the ragged tail, fewer than kVec elements after the last pack
  const long long i = npack * kVec + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const T* xe = reinterpret_cast<const T*>(x);
    T* ye = reinterpret_cast<T*>(y);
    ye[i] = from_f32<T>(drop_f32(to_f32(xe[i]), static_cast<unsigned int>(i) + base,
                                 seed_mix, thresh, inv_keep));
  }
}

// all elements of an unaligned tensor (a view that starts inside a pack),
// one per thread
template <typename T>
__global__ void __launch_bounds__(kDropThreads)
    fused_dropout_elem_kernel(const T* __restrict__ x, T* __restrict__ y,
                              const int* __restrict__ seed, long long n,
                              unsigned int base, unsigned int thresh,
                              float inv_keep) {
  const unsigned int seed_mix = static_cast<unsigned int>(__ldg(seed)) * 0x9E3779B9u;
  const long long stride = static_cast<long long>(gridDim.x) * kDropThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kDropThreads + threadIdx.x;
       i < n; i += stride)
    y[i] = from_f32<T>(drop_f32(to_f32(x[i]), static_cast<unsigned int>(i) + base,
                                seed_mix, thresh, inv_keep));
}

// blocks of `kernel` resident on the current device at once (occupancy x
// SMs), queried on the first launch on each device and cached
template <typename K>
int resident_blocks(K kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDropThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  cache[dev] = per_sm * sms;
  return cache[dev];
}

int wave_grid(long long units, int resident) {
  const long long want = (units + kDropThreads - 1) / kDropThreads;
  return static_cast<int>(want < resident ? want : resident);
}

template <typename T>
cudaError_t launch_dropout(const void* x, void* y, const void* seed,
                           long long n, unsigned int base, unsigned int thresh,
                           float inv_keep, cudaStream_t s) {
  static int pack_wave[kMaxDevices] = {};
  static int elem_wave[kMaxDevices] = {};
  constexpr long long kVec = 16 / static_cast<long long>(sizeof(T));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int* st = static_cast<const int*>(seed);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x) |
                         reinterpret_cast<std::uintptr_t>(y)) % 16) == 0;
  if (aligned && n >= kVec) {
    const int resident = resident_blocks(fused_dropout_pack_kernel<T>, pack_wave);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    const long long npack = n / kVec;
    fused_dropout_pack_kernel<T><<<wave_grid(npack, resident), kDropThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), st, npack, n, base,
        thresh, inv_keep);
  } else {
    const int resident = resident_blocks(fused_dropout_elem_kernel<T>, elem_wave);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    fused_dropout_elem_kernel<T><<<wave_grid(n, resident), kDropThreads, 0, s>>>(
        xt, yt, st, n, base, thresh, inv_keep);
  }
  return cudaGetLastError();
}

}  // namespace gr

// x and y: n contiguous elements of dtype (DT_F32 or DT_BF16); seed: one
// int32 in device memory; base: the counter of x's first element (mod
// 2^32). y may not alias x.
extern "C" int gr_fused_dropout(int dtype, const void* x, void* y,
                                const void* seed, long long n,
                                unsigned int base, unsigned int thresh,
                                float inv_keep, void* stream) {
  using namespace gr;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return static_cast<int>(
          launch_dropout<float>(x, y, seed, n, base, thresh, inv_keep, s));
    case DT_BF16:
      return static_cast<int>(
          launch_dropout<__nv_bfloat16>(x, y, seed, n, base, thresh, inv_keep, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
