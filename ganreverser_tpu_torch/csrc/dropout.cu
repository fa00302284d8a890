// Kernel B5: dropout whose keep mask is a counter hash of each element's
// flat index and a seed, computed inside the pass, so no mask is stored.
//
// Replaces ganreverser_tpu/ops/dropout_kernel.py::_run (the Pallas body
// _kernel with _hash_bits). Its custom_vjp (_fwd/_bwd) becomes the wrapper's
// torch.autograd.Function (ops/dropout_kernel.py), whose backward launches
// this same kernel on the incoming gradient with the saved seed: identical
// (seed, index) pairs give identical bits, so the forward's mask comes back.
//
// What it computes, to the bit (the TPU kernel's):
//   idx  = the element's flat index mod 2^32 (the TPU's (row * 1024 + col)
//          in uint32 over its 1024-column view is the same number)
//   h    = fmix32(idx ^ (uint32(seed) * 0x9E3779B9))   (murmur3 finalizer)
//   keep = h < thresh, thresh = min(round(keep_p * 2^32), 2^32 - 1), host
//   y    = keep ? T(float(x) * inv_keep) : 0, inv_keep = f32(1 / keep_p):
//          one f32 multiply, and the bf16 store rounds to nearest even.
//
// What bounds it: one read and one write of x and about ten integer
// operations per element, so device-memory bandwidth (at R's largest
// dropout, (256,64,64,64) bf16, 2 x 134 MB). Design: the seed is an int32
// read from device memory (the trainer draws it on the card, so a launch
// needs no host sync and can be captured in a graph later); a grid-stride
// loop moves 16 bytes per thread per iteration (4 f32 or 8 bf16) when both
// pointers are 16-byte aligned, one element otherwise, and the ragged tail
// one element at a time. Any size is taken: the TPU kernel's size % 8192
// gate exists only for its (8, 1024) tiling. No shared memory.
#include <cstdint>

#include "common.cuh"

namespace gr {

constexpr int kDropThreads = 256;
constexpr int kDropMaxBlocks = 132 * 8;  // 2,048 threads on each of 132 SMs

__device__ __forceinline__ unsigned int fmix32(unsigned int h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <typename T>
__device__ __forceinline__ T drop_one(T v, long long i, unsigned int seed_mix,
                                      unsigned int thresh, float inv_keep) {
  const unsigned int h = fmix32(static_cast<unsigned int>(i) ^ seed_mix);
  return from_f32<T>(h < thresh ? to_f32(v) * inv_keep : 0.0f);
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kDropThreads)
    fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const int* __restrict__ seed, long long n,
                         unsigned int thresh, float inv_keep) {
  const unsigned int seed_mix = static_cast<unsigned int>(__ldg(seed)) * 0x9E3779B9u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nvec = n / kVec;
  const Pack<T, kVec>* xv = reinterpret_cast<const Pack<T, kVec>*>(x);
  Pack<T, kVec>* yv = reinterpret_cast<Pack<T, kVec>*>(y);
  for (long long p = tid; p < nvec; p += stride) {
    Pack<T, kVec> pack = xv[p];
    const long long base = p * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      pack.v[j] = drop_one(pack.v[j], base + j, seed_mix, thresh, inv_keep);
    yv[p] = pack;
  }
  for (long long i = nvec * kVec + tid; i < n; i += stride)
    y[i] = drop_one(x[i], i, seed_mix, thresh, inv_keep);
}

template <typename T>
cudaError_t launch_dropout(const void* x, void* y, const void* seed,
                           long long n, unsigned int thresh, float inv_keep,
                           cudaStream_t s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(x) |
                         reinterpret_cast<std::uintptr_t>(y)) % 16) == 0;
  const long long units = aligned ? (n + kVec - 1) / kVec : n;
  const long long want = (units + kDropThreads - 1) / kDropThreads;
  const int blocks = static_cast<int>(want < kDropMaxBlocks ? want : kDropMaxBlocks);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int* st = static_cast<const int*>(seed);
  if (aligned)
    fused_dropout_kernel<T, kVec><<<blocks, kDropThreads, 0, s>>>(xt, yt, st, n, thresh,
                                                                 inv_keep);
  else
    fused_dropout_kernel<T, 1><<<blocks, kDropThreads, 0, s>>>(xt, yt, st, n, thresh,
                                                              inv_keep);
  return cudaGetLastError();
}

}  // namespace gr

// x and y: n contiguous elements of dtype (DT_F32 or DT_BF16); seed: one
// int32 in device memory. y may not alias x.
extern "C" int gr_fused_dropout(int dtype, const void* x, void* y,
                                const void* seed, long long n,
                                unsigned int thresh, float inv_keep,
                                void* stream) {
  using namespace gr;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return static_cast<int>(launch_dropout<float>(x, y, seed, n, thresh, inv_keep, s));
    case DT_BF16:
      return static_cast<int>(
          launch_dropout<__nv_bfloat16>(x, y, seed, n, thresh, inv_keep, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
