// Kernel S: approximate top-k selection of (Q, N) f32 score rows at a
// recall target, by the rule of ops/approx_topk_kernel.py: element j goes to
// bin j mod L, each bin keeps its largest value (a tie to the lower j), the L
// candidates are ranked by value, descending (a tie to the lower j), and the
// first k are written as values (Q, k) f32 and indices (Q, k) int64.
//
// Replaces jax.lax.approx_max_k as ganreverser_tpu/analysis/similarity.py:
// 34-52 (_select_topk) calls it: an XLA op, not a Pallas kernel, which the
// TPU lowers to the partial reduction of arXiv:2206.14286. Its bins there
// are XLA's own; this kernel's are fixed by the rule, so that it agrees
// bitwise with its plain version (approx_topk_plain).
//
// Every element is one 64-bit key: the value's bits mapped so that a larger
// float is a larger unsigned int (-0.0 as +0.0), above 0xFFFFFFFF - j. The
// keys are distinct and their order is the rule's, so a bin's maximum and
// the ranking are plain unsigned comparisons with no tie left.
//
// Design, one block of kThreads per row (the row loop over grid y covers
// any Q):
//  (a) the bins' maxima: thread t takes bins b = t, t + kThreads, ... and
//      walks j = b, b + L, ...: at each step consecutive threads read
//      consecutive j, so the loads coalesce; the row is read once;
//  (b) the P = next_pow2(L) keys, padded with 0 (below every element's key),
//      are sorted descending by a bitonic network in shared memory, then the
//      first k are written, each value read back from the row at its j.
// P keys take 8 P bytes: L = 1,024 (k = 100 at recall 0.95) 8 KB, L = 8,192
// (recall 0.99) 64 KB, and at most kMaxChunk = 16,384 keys (128 KB, above
// the 48 KB default: the opt-in is set on every launch). A wider P (recall
// 1 at N > 16,384, or a high target with a large k) takes the same network
// over a workspace of Q x P keys in device memory: each block fills and
// sorts a chunk of kMaxChunk keys in shared memory, each stride of the
// network at least a chunk wide is one launch over the workspace, and the
// strides below it run in shared memory again, chunk by chunk; the last
// launch writes the first k.
//
// What bounds it on this card: the bytes. The row is read once (4 N bytes)
// and 12 k bytes are written; the sort touches only shared memory, and its
// log2(P) (log2(P) + 1) / 2 steps of P / 2 compare-exchanges are some
// hundreds of thousands of integer operations a row at P = 1,024, which a
// block's 16 warps take in a few microseconds. Nothing here allocates or
// synchronises with the host, so a CUDA graph captures it.
#include "common.cuh"

namespace gr {
namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 16384;    // keys one block sorts in shared memory
constexpr int kMergeThreads = 256;  // the global strides' launch
constexpr int kMaxGridY = 65535;

using Key = unsigned long long;

__device__ __forceinline__ Key order_key(float v, unsigned j) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;                    // -0.0 ranks as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // a larger float, a larger u
  return (static_cast<Key>(u) << 32) | static_cast<Key>(0xFFFFFFFFu - j);
}

__device__ __forceinline__ unsigned key_index(Key key) {
  return 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
}

// the largest key of bin b: elements b, b + bins, ... of the row (b < bins
// <= n, so the bin holds at least element b)
__device__ __forceinline__ Key bin_max(const float* __restrict__ row, int n,
                                       int bins, int b) {
  Key best = 0;
  for (long long j = b; j < n; j += bins) {
    const Key key = order_key(__ldg(row + j), static_cast<unsigned>(j));
    best = key > best ? key : best;
  }
  return best;
}

// one step of the descending bitonic network on ``count`` keys in shared
// memory whose first key has the global position ``base``: pairs (i, i +
// stride) within runs of 2 stride (a power of two); a run sorts descending
// where the global position's ``size`` bit is 0, ascending where it is 1
__device__ __forceinline__ void bitonic_step(Key* keys, int count, long long base,
                                             long long size, int stride) {
  for (int p = threadIdx.x; p < count / 2; p += blockDim.x) {
    const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
    const Key a = keys[i], b = keys[i + stride];
    const bool descending = ((base + i) & size) == 0;
    if ((a < b) == descending) {
      keys[i] = b;
      keys[i + stride] = a;
    }
  }
  __syncthreads();
}

// the block's chunk of ``chunk`` keys of row ``row``, at global position
// ``base``: with ``fill`` the bins' maxima (key 0 past the L bins), then all
// network sizes up to the chunk; otherwise the chunk read back from ``ws``
// and the strides below the chunk of network size ``size``. With ``out``
// the keys at positions < k are written as values and indices, otherwise the
// chunk goes back to ``ws``.
__global__ void __launch_bounds__(kThreads)
    approx_topk_chunk_kernel(const float* __restrict__ scores, Key* ws,
                             float* __restrict__ out_v, long long* __restrict__ out_i,
                             int q, int n, int k, int bins, long long entries, int chunk,
                             long long size, int fill, int out) {
  extern __shared__ Key keys[];
  const long long base = static_cast<long long>(blockIdx.x) * chunk;
  for (int row = blockIdx.y; row < q; row += gridDim.y) {
    const float* r = scores + static_cast<long long>(row) * n;
    Key* w = ws == nullptr ? nullptr : ws + static_cast<long long>(row) * entries + base;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      if (fill) {
        const long long b = base + i;
        keys[i] = b < bins ? bin_max(r, n, bins, static_cast<int>(b)) : 0;
      } else {
        keys[i] = w[i];
      }
    }
    __syncthreads();
    if (fill) {
      for (int s = 2; s <= chunk; s <<= 1)
        for (int stride = s / 2; stride > 0; stride >>= 1)
          bitonic_step(keys, chunk, base, s, stride);
    } else {
      for (int stride = chunk / 2; stride > 0; stride >>= 1)
        bitonic_step(keys, chunk, base, size, stride);
    }
    if (out) {
      for (int i = threadIdx.x; i < chunk && base + i < k; i += blockDim.x) {
        const unsigned j = key_index(keys[i]);
        const long long o = static_cast<long long>(row) * k + base + i;
        out_v[o] = r[j];
        out_i[o] = static_cast<long long>(j);
      }
    } else {
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) w[i] = keys[i];
    }
    __syncthreads();
  }
}

// one step of the network at a stride of at least a chunk, over the
// workspace's Q x entries keys
__global__ void __launch_bounds__(kMergeThreads)
    approx_topk_merge_kernel(Key* ws, int q, long long entries, long long size,
                             long long stride) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= entries / 2) return;
  const long long i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const bool descending = (i & size) == 0;
  for (int row = blockIdx.y; row < q; row += gridDim.y) {
    Key* w = ws + static_cast<long long>(row) * entries;
    const Key a = w[i], b = w[i + stride];
    if ((a < b) == descending) {
      w[i] = b;
      w[i + stride] = a;
    }
  }
}

}  // namespace
}  // namespace gr

// scores (Q, N) f32; values (Q, k) f32, indices (Q, k) int64; ws: Q x
// entries 8-byte keys, or null where entries == chunk. bins (L), entries
// (next_pow2(L)) and chunk (min(entries, 16,384)): the plan
// (ops/approx_topk_kernel.py::select_plan).
extern "C" int gr_approx_topk(const void* scores, void* values, void* indices, void* ws,
                              int q, int n, int k, int bins, int entries, int chunk,
                              void* stream) {
  using namespace gr;
  const bool pow2 = entries > 0 && (entries & (entries - 1)) == 0 && chunk > 0 &&
                    (chunk & (chunk - 1)) == 0;
  if (q <= 0 || n <= 0 || k <= 0 || k > bins || bins > n || !pow2 || entries < bins ||
      2LL * bins <= entries || chunk > kMaxChunk || chunk > entries ||
      (entries > chunk && (chunk != kMaxChunk || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = chunk * static_cast<int>(sizeof(Key));
  const cudaError_t e = cudaFuncSetAttribute(
      approx_topk_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* sc = static_cast<const float*>(scores);
  auto* w = static_cast<Key*>(ws);
  auto* ov = static_cast<float*>(values);
  auto* oi = static_cast<long long*>(indices);
  const unsigned rows = static_cast<unsigned>(q < kMaxGridY ? q : kMaxGridY);
  const unsigned chunks = static_cast<unsigned>(entries / chunk);
  const bool one = entries == chunk;
  approx_topk_chunk_kernel<<<dim3(chunks, rows), kThreads, smem, s>>>(
      sc, one ? nullptr : w, ov, oi, q, n, k, bins, entries, chunk, 0, 1, one ? 1 : 0);
  for (long long size = 2LL * chunk; !one && size <= entries; size <<= 1) {
    for (long long stride = size / 2; stride >= chunk; stride >>= 1) {
      const unsigned blocks = static_cast<unsigned>((entries / 2 + kMergeThreads - 1) /
                                                    kMergeThreads);
      approx_topk_merge_kernel<<<dim3(blocks, rows), kMergeThreads, 0, s>>>(w, q, entries,
                                                                           size, stride);
    }
    approx_topk_chunk_kernel<<<dim3(chunks, rows), kThreads, smem, s>>>(
        sc, w, ov, oi, q, n, k, bins, entries, chunk, size, 0, size == entries ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}
