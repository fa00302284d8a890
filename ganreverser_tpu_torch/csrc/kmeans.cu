// Kernel K: one Lloyd step of kmeans that reads X once, with no float
// atomics, so that two runs give bitwise-equal centroids and counts.
//
// Replaces ganreverser_tpu/ops/kmeans_kernel.py::_kmeans_sums_counts (the
// Pallas body _kernel) and the division of kmeans_step_pallas. The TPU
// kernel carries its (K, D) sums and (K,) counts across a sequential grid;
// blocks on this card run in parallel and in no order, so the step is two
// launches:
//
//  1. kmeans_partial_kernel, a grid over tiles of kRows rows. Each block
//     stages the K centroids, their squared norms, its rows of X, the
//     distances and a (K, D+1) accumulator in shared memory. The distance is
//     the TPU kernel's formula d = |c|^2 - 2 x.c in f32 (|x|^2 is constant
//     per row); the argmin scans k upwards with a strict <, so a tie goes to
//     the first index. One thread per column then walks the block's rows in
//     order, adding x[r][col] (or 1 to the count column D) to the row of its
//     cluster: no two threads touch one address. The block writes its
//     partial (K, D+1) to the workspace; the ragged end of N is masked, so
//     nothing is padded. Optionally each row's assignment is written (int32).
//  2. kmeans_finish_kernel, one block per cluster, sums the partials over
//     blocks in block order, divides by max(count, 1), keeps the old
//     centroid of an empty cluster, and writes the new centroids, the
//     counts and (optionally) the raw sums.
//
// What bounds it: at the main path's shapes (10,000 x 100 f32, K = 20) X is
// 4 MB and the arithmetic 2 N K D = 40 MFLOP, so a step is launch- and
// latency-bound; the design keeps it to two launches that allocate nothing
// and need no host synchronisation, so 15 iterations are 30 launches.
#include "common.cuh"

namespace gr {

constexpr int kRows = 64;          // rows per block of stage 1
constexpr int kThreads = 256;      // threads per block of stage 1
constexpr int kFinishThreads = 128;

// floats of stage 1's dynamic shared memory, the int assignments included
__host__ __device__ inline long long kmeans_smem_floats(int d, int k) {
  return static_cast<long long>(k) * d + k + static_cast<long long>(kRows) * d +
         static_cast<long long>(kRows) * k + static_cast<long long>(k) * (d + 1) +
         kRows;
}

__global__ void __launch_bounds__(kThreads)
    kmeans_partial_kernel(const float* __restrict__ x,
                          const float* __restrict__ c, float* __restrict__ ws,
                          int* __restrict__ assign_out, int N, int D, int K) {
  extern __shared__ float smem[];
  float* cs = smem;                                    // K x D
  float* c2 = cs + static_cast<long long>(K) * D;      // K
  float* xs = c2 + K;                                  // kRows x D
  float* dots = xs + static_cast<long long>(kRows) * D;  // kRows x K
  float* acc = dots + static_cast<long long>(kRows) * K;  // K x (D+1)
  int* as = reinterpret_cast<int*>(acc + static_cast<long long>(K) * (D + 1));

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nrows = static_cast<int>(min(static_cast<long long>(kRows), N - row0));
  const int width = D + 1;

  for (int i = tid; i < K * D; i += kThreads) cs[i] = c[i];
  for (int i = tid; i < nrows * D; i += kThreads) xs[i] = x[row0 * D + i];
  for (int i = tid; i < K * width; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  for (int k = tid; k < K; k += kThreads) {
    const float* ck = cs + k * D;
    float s = 0.0f;
    for (int j = 0; j < D; ++j) s = fmaf(ck[j], ck[j], s);
    c2[k] = s;
  }
  for (int p = tid; p < nrows * K; p += kThreads) {
    const int r = p / K, k = p - r * K;
    const float* xr = xs + r * D;
    const float* ck = cs + k * D;
    float s = 0.0f;
    for (int j = 0; j < D; ++j) s = fmaf(xr[j], ck[j], s);
    dots[p] = s;
  }
  __syncthreads();

  for (int r = tid; r < nrows; r += kThreads) {
    int best = 0;
    float best_d = c2[0] - 2.0f * dots[r * K];
    for (int k = 1; k < K; ++k) {
      const float dk = c2[k] - 2.0f * dots[r * K + k];
      if (dk < best_d) {
        best_d = dk;
        best = k;
      }
    }
    as[r] = best;
    if (assign_out != nullptr) assign_out[row0 + r] = best;
  }
  __syncthreads();

  for (int col = tid; col < width; col += kThreads) {
    for (int r = 0; r < nrows; ++r) {
      const float v = col < D ? xs[r * D + col] : 1.0f;
      acc[as[r] * width + col] += v;
    }
  }
  __syncthreads();

  float* out = ws + static_cast<long long>(blockIdx.x) * K * width;
  for (int i = tid; i < K * width; i += kThreads) out[i] = acc[i];
}

__global__ void __launch_bounds__(kFinishThreads)
    kmeans_finish_kernel(const float* __restrict__ ws,
                         const float* __restrict__ c_old,
                         float* __restrict__ c_new, float* __restrict__ counts,
                         float* __restrict__ sums_out, int nblocks, int D,
                         int K) {
  __shared__ float count;
  const int k = blockIdx.x;
  const long long width = D + 1;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += ws[(static_cast<long long>(b) * K + k) * width + D];
    count = s;
    counts[k] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < D; j += kFinishThreads) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += ws[(static_cast<long long>(b) * K + k) * width + j];
    if (sums_out != nullptr) sums_out[k * D + j] = s;
    c_new[k * D + j] = count > 0.0f ? s / fmaxf(count, 1.0f) : c_old[k * D + j];
  }
}

}  // namespace gr

// x (N,D) f32, c (K,D) f32; workspace of ws_floats >= ceil(N/64) K (D+1)
// floats; c_new (K,D) and counts (K) f32; sums (K,D) f32 and assign (N)
// int32 may be null.
extern "C" int gr_kmeans_step(const void* x, const void* c, void* ws,
                              long long ws_floats, void* c_new, void* counts,
                              void* sums, void* assign, int n, int d, int k,
                              void* stream) {
  using namespace gr;
  if (n <= 0 || d <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nblocks = (n + kRows - 1) / kRows;
  if (ws_floats < static_cast<long long>(nblocks) * k * (d + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = kmeans_smem_floats(d, k) * static_cast<long long>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kmeans_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_partial_kernel<<<nblocks, kThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(ws), static_cast<int*>(assign), n, d, k);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  kmeans_finish_kernel<<<k, kFinishThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(c),
      static_cast<float*>(c_new), static_cast<float*>(counts),
      static_cast<float*>(sums), nblocks, d, k);
  return static_cast<int>(cudaGetLastError());
}
