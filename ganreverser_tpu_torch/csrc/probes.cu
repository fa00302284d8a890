// Kernel B9: three backend probes, the smallest kernels that show the
// build, the launch and the card's matrix units work.
//
// Replaces benchmarks/tpu_pallas_probe.py's trivial (add_kernel), gridded
// (grid_kernel) and with_dot (dot_kernel):
//
//  * gr_probe_add_one: y = x + 1 over a flat f32 array, one block (the TPU
//    probe's single (8, 128) block);
//  * gr_probe_times_two: y = 2 x over (G, L) f32, one block per leading
//    index, as the TPU probe's grid of (1, 256, 128) blocks;
//  * gr_probe_dot_bf16: C = A B with A (M, K) and B (K, N) bf16, C f32,
//    on the tensor cores through wmma (16x16x16 bf16 tiles, f32
//    accumulators), one warp per 16x16 tile of C: the counterpart of the
//    TPU probe's dot on the matrix unit. M, N and K are multiples of 16.
//
// What bounds them: launch latency; they move kilobytes.
#include <mma.h>

#include "common.cuh"

namespace gr {

constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
    probe_add_one_kernel(const float* __restrict__ x, float* __restrict__ y,
                         long long n) {
  for (long long i = threadIdx.x; i < n; i += kProbeThreads) y[i] = x[i] + 1.0f;
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_times_two_kernel(const float* __restrict__ x, float* __restrict__ y,
                           long long per) {
  const long long base = static_cast<long long>(blockIdx.x) * per;
  for (long long i = threadIdx.x; i < per; i += kProbeThreads)
    y[base + i] = x[base + i] * 2.0f;
}

__global__ void probe_dot_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                                      const __nv_bfloat16* __restrict__ b,
                                      float* __restrict__ c, int M, int N,
                                      int K) {
  using namespace nvcuda;
  const int row = blockIdx.y * 16;
  const int col = blockIdx.x * 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
  wmma::fill_fragment(fc, 0.0f);
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fa, a + static_cast<long long>(row) * K + k, K);
    wmma::load_matrix_sync(fb, b + static_cast<long long>(k) * N + col, N);
    wmma::mma_sync(fc, fa, fb, fc);
  }
  wmma::store_matrix_sync(c + static_cast<long long>(row) * N + col, fc, N,
                          wmma::mem_row_major);
}

}  // namespace gr

// x, y: n f32
extern "C" int gr_probe_add_one(const void* x, void* y, long long n,
                                void* stream) {
  using namespace gr;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_add_one_kernel<<<1, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (g, per) f32, one block per row
extern "C" int gr_probe_times_two(const void* x, void* y, int g, long long per,
                                  void* stream) {
  using namespace gr;
  if (g < 1 || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_times_two_kernel<<<g, kProbeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), per);
  return static_cast<int>(cudaGetLastError());
}

// a (m,k), b (k,n) bf16 row-major, c (m,n) f32; m, n, k multiples of 16
extern "C" int gr_probe_dot_bf16(const void* a, const void* b, void* c, int m,
                                 int n, int k, void* stream) {
  using namespace gr;
  if (m < 16 || n < 16 || k < 16 || m % 16 || n % 16 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n / 16), static_cast<unsigned>(m / 16));
  probe_dot_bf16_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
