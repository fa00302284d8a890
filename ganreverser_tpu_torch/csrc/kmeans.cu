// Kernel K: one Lloyd step of kmeans for any K and D, with no float atomics,
// so that two runs give bitwise-equal centroids and counts.
//
// Replaces ganreverser_tpu/ops/kmeans_kernel.py::_kmeans_sums_counts (the
// Pallas body _kernel) and the division of kmeans_step_pallas. The TPU
// kernel carries its (K, D) sums and (K,) counts across a sequential grid;
// blocks on this card run in parallel and in no order, so the step is two
// launches:
//
//  1. kmeans_assign_kernel, a grid over tiles of `rows` rows of X, which a
//     block keeps in shared memory while the centroids stream past in tiles
//     of `kt` clusters (their squared norms beside them). The distance is
//     the TPU kernel's formula d = |c|^2 - 2 x.c in f32 (|x|^2 is constant
//     per row); one thread per row keeps a running argmin over the tiles,
//     scanning k upwards with a strict <, so a tie goes to the first index.
//     The assignment (int32, one per row) goes to device memory; the ragged
//     end of N is masked, so nothing is padded.
//  2. kmeans_update_kernel, one block per (cluster, 128 columns). It walks
//     the assignment in row order, 1,024 rows at a time: ballots compact the
//     rows of its cluster into shared memory, in order. Warp w adds the
//     compacted rows w, w + 8, w + 16, ... to its registers, a lane per
//     column; at the end the eight warps' sums are added in warp order. The
//     order of every sum is thus fixed by N and the assignment alone,
//     whatever the timing; the count is an integer. The block writes
//     sums / max(count, 1), or the old centroid of an empty cluster, the
//     count and (optionally) the raw sums.
//
// The plan (rows, kt and the shared bytes of stage 1) comes from the
// wrapper (ops/kmeans_kernel.py::kmeans_plan), which sizes it to D so that
// one block stays within the 227 KB of shared memory: any K, and D up to
// about 29,000.
//
// What bounds it: at the main path's shapes (10,000 x 100 f32, K = 20) X is
// 4 MB and the arithmetic 2 N K D = 40 MFLOP, so a step is launch- and
// latency-bound; the design keeps it to two launches that allocate nothing
// and need no host synchronisation, so 15 iterations are 30 launches.
#include "common.cuh"

namespace gr {

constexpr int kThreads = 256;        // threads per block of both stages
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;      // columns of stage 2 in registers
constexpr int kColsPerBlock = 32 * kColsPerLane;
constexpr int kSlots = 4;            // assignments a thread reads per chunk
constexpr int kChunk = kThreads * kSlots;  // rows stage 2 compacts at once

__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const float* __restrict__ x,
                         const float* __restrict__ c, int* __restrict__ assign,
                         int N, int D, int K, int rows, int kt) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd row stride: lanes on consecutive k differ in bank
  float* xs = smem;                                      // rows x ld
  float* cs = xs + static_cast<long long>(rows) * ld;    // kt x ld
  float* c2 = cs + static_cast<long long>(kt) * ld;      // kt
  float* dots = c2 + kt;                                 // rows x kt

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(min(static_cast<long long>(rows), N - row0));
  for (int i = tid; i < nrows * D; i += kThreads)
    xs[(i / D) * ld + i % D] = x[row0 * D + i];

  int best = 0;  // thread r < nrows owns row r
  float best_d = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kt) {
    const int nk = min(kt, K - k0);
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < nk * D; i += kThreads)
      cs[(i / D) * ld + i % D] = c[static_cast<long long>(k0) * D + i];
    __syncthreads();
    for (int k = tid; k < nk; k += kThreads) {
      const float* ck = cs + k * ld;
      float s = 0.0f;
      for (int j = 0; j < D; ++j) s = fmaf(ck[j], ck[j], s);
      c2[k] = s;
    }
    for (int p = tid; p < nrows * nk; p += kThreads) {
      const int r = p / nk, k = p - r * nk;
      const float* xr = xs + r * ld;
      const float* ck = cs + k * ld;
      float s = 0.0f;
      for (int j = 0; j < D; ++j) s = fmaf(xr[j], ck[j], s);
      dots[p] = s;
    }
    __syncthreads();
    if (tid < nrows) {
      for (int k = 0; k < nk; ++k) {
        const float dk = c2[k] - 2.0f * dots[tid * nk + k];
        if ((k0 == 0 && k == 0) || dk < best_d) {
          best_d = dk;
          best = k0 + k;
        }
      }
    }
  }
  if (tid < nrows) assign[row0 + tid] = best;
}

__global__ void __launch_bounds__(kThreads)
    kmeans_update_kernel(const float* __restrict__ x,
                         const int* __restrict__ assign,
                         const float* __restrict__ c_old,
                         float* __restrict__ c_new, float* __restrict__ counts,
                         float* __restrict__ sums_out, int N, int D) {
  __shared__ int rows_of_k[kChunk];
  __shared__ int warp_hits[kChunk / 32];
  __shared__ float partial[kWarps][kColsPerBlock];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.y * kColsPerBlock + lane;  // + 32 u
  float acc[kColsPerLane];
#pragma unroll
  for (int u = 0; u < kColsPerLane; ++u) acc[u] = 0.0f;
  long long count = 0;

  for (int r0 = 0; r0 < N; r0 += kChunk) {
    // the chunk's rows of cluster k, compacted in row order: row
    // r0 + s * kThreads + tid is slot s of this thread
    bool hit[kSlots];
    unsigned mask[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = r0 + s * kThreads + tid;
      hit[s] = r < N && assign[r] == k;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mask[s] = __ballot_sync(0xffffffffu, hit[s]);
      if (lane == 0) warp_hits[s * kWarps + warp] = __popc(mask[s]);
    }
    __syncthreads();
    int total = 0, before = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      for (int w = 0; w < kWarps; ++w) {
        const int h = warp_hits[s * kWarps + w];
        before += w < warp ? h : 0;
        total += h;
      }
      if (hit[s])
        rows_of_k[before + __popc(mask[s] & ((1u << lane) - 1u))] =
            r0 + s * kThreads + tid;
      before = total;  // the next slot starts after this one's rows
    }
    __syncthreads();
    // warp w adds compacted rows w, w + 8, ... in order, two rows' loads in
    // flight before their adds
    int i = warp;
    for (; i + kWarps < total; i += 2 * kWarps) {
      const float* xa = x + static_cast<long long>(rows_of_k[i]) * D;
      const float* xb = x + static_cast<long long>(rows_of_k[i + kWarps]) * D;
      float va[kColsPerLane], vb[kColsPerLane];
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) {
        const int col = col0 + 32 * u;
        va[u] = col < D ? xa[col] : 0.0f;
        vb[u] = col < D ? xb[col] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) acc[u] = (acc[u] + va[u]) + vb[u];
    }
    if (i < total) {
      const float* xa = x + static_cast<long long>(rows_of_k[i]) * D;
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) {
        const int col = col0 + 32 * u;
        if (col < D) acc[u] += xa[col];
      }
    }
    count += total;
    __syncthreads();  // rows_of_k and warp_hits are rewritten next
  }

  // the warps' partial sums, added in warp order
#pragma unroll
  for (int u = 0; u < kColsPerLane; ++u) partial[warp][lane + 32 * u] = acc[u];
  __syncthreads();
  const float cnt = static_cast<float>(count);
  if (blockIdx.y == 0 && tid == 0) counts[k] = cnt;
  for (int j = tid; j < kColsPerBlock; j += kThreads) {
    const int col = blockIdx.y * kColsPerBlock + j;
    if (col >= D) continue;
    float sum = partial[0][j];
    for (int w = 1; w < kWarps; ++w) sum += partial[w][j];
    const long long o = static_cast<long long>(k) * D + col;
    if (sums_out != nullptr) sums_out[o] = sum;
    c_new[o] = count > 0 ? sum / fmaxf(cnt, 1.0f) : c_old[o];
  }
}

}  // namespace gr

// x (N,D) f32, c (K,D) f32; c_new (K,D) and counts (K) f32; assign (N)
// int32 (written by stage 1, read by stage 2); sums (K,D) f32 may be null.
// rows, kt and smem_bytes: stage 1's plan (ops/kmeans_kernel.py).
extern "C" int gr_kmeans_step(const void* x, const void* c, void* c_new,
                              void* counts, void* sums, void* assign, int n,
                              int d, int k, int rows, int kt, int smem_bytes,
                              void* stream) {
  using namespace gr;
  if (n <= 0 || d <= 0 || k <= 0 || rows <= 0 || rows > kThreads || kt <= 0 ||
      assign == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need =
      4LL * ((static_cast<long long>(rows) + kt) * (d + 1) + kt +
             static_cast<long long>(rows) * kt);
  if (smem_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e0 = cudaFuncSetAttribute(
      kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kmeans_assign_kernel<<<(n + rows - 1) / rows, kThreads,
                         static_cast<size_t>(smem_bytes), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<int*>(assign), n, d, k, rows, kt);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  const dim3 grid(static_cast<unsigned>(k),
                  static_cast<unsigned>((d + kColsPerBlock - 1) / kColsPerBlock));
  kmeans_update_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(assign),
      static_cast<const float*>(c), static_cast<float*>(c_new),
      static_cast<float*>(counts), static_cast<float*>(sums), n, d);
  return static_cast<int>(cudaGetLastError());
}
