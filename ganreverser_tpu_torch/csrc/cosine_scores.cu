// Kernel C: (Q, N) cosine scores of Q needle rows against N embedding rows,
// both row-normalised inside the kernel, in one pass over D.
//
// Replaces ganreverser_tpu/ops/topk_kernel.py::cosine_scores_pallas
// (_kernel). Each block takes kRowsPerBlock embedding rows and up to kQ
// needles (blockIdx.y walks further groups of needles). It walks D in
// chunks of kChunk: the needle chunk is staged in shared memory, each warp
// streams its rows' chunk once and accumulates, per row, the dot products
// with every needle and the row's sum of squares, while the staging threads
// accumulate the needles' sums of squares. Inputs are read in their storage
// type and cast to f32; the result is
//
//   dot(q, e) / (sqrt(max(|q|^2, 1e-16)) * sqrt(max(|e|^2, 1e-16)))
//
// which is the TPU kernel's clamp on the squared norms. Any D works (the
// chunk loop is masked), and the ragged end of N is masked, so nothing is
// padded.
//
// What bounds it: reading the (N, D) embeddings once from device memory
// (246 MB for the 10,000 x 12,288 bf16 pixel search); the needle chunks come
// from L2 and shared memory, and the arithmetic is 2Q FMAs per element.
#include "common.cuh"

namespace gr {

constexpr int kQ = 16;         // needles per block
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 256;    // == threads per block
constexpr float kEps2 = 1e-16f;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    cosine_scores_kernel(const T* __restrict__ needles,
                         const T* __restrict__ emb, float* __restrict__ out,
                         int Q, int N, int D) {
  __shared__ float qs[kQ][kChunk];
  __shared__ float qsq_part[kWarps][kQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, Q - q0);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp * kRowsPerWarp;

  float dot[kRowsPerWarp][kQ];
  float ee[kRowsPerWarp];
  float qsq[kQ];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    ee[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < kQ; ++q) dot[r][q] = 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) qsq[q] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int d = d0 + tid;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float v = (q < nq && d < D)
                          ? to_f32(needles[static_cast<long long>(q0 + q) * D + d])
                          : 0.0f;
      qs[q][tid] = v;
      qsq[q] = fmaf(v, v, qsq[q]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long row = row0 + r;
      if (row < N) {  // warp-uniform
        const T* er = emb + row * D + d0;
#pragma unroll
        for (int u = 0; u < kChunk / 32; ++u) {
          const int dd = u * 32 + lane;
          const float v = (d0 + dd < D) ? to_f32(er[dd]) : 0.0f;
          ee[r] = fmaf(v, v, ee[r]);
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            dot[r][q] = fmaf(v, qs[q][dd], dot[r][q]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float s = warp_sum(qsq[q]);
    if (lane == 0) qsq_part[warp][q] = s;
  }
  __syncthreads();
  float qinv[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += qsq_part[wi][q];
    qinv[q] = 1.0f / sqrtf(fmaxf(s, kEps2));
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + r;
    const float einv = 1.0f / sqrtf(fmaxf(warp_sum(ee[r]), kEps2));
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float s = warp_sum(dot[r][q]);
      if (lane == 0 && row < N && q < nq)
        out[static_cast<long long>(q0 + q) * N + row] = s * qinv[q] * einv;
    }
  }
}

template <typename T>
static void launch(const void* needles, const void* emb, void* out, int q,
                   int n, int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((q + kQ - 1) / kQ), 1);
  cosine_scores_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(needles), static_cast<const T*>(emb),
      static_cast<float*>(out), q, n, d);
}

}  // namespace gr

// needles (Q,D) and emb (N,D) in the storage type, out (Q,N) f32.
extern "C" int gr_cosine_scores(int dtype, const void* needles,
                                const void* emb, void* out, int q, int n,
                                int d, void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(needles, emb, out, q, n, d, s);
  else if (dtype == DT_BF16)
    launch<__nv_bfloat16>(needles, emb, out, q, n, d, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
