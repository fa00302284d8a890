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
// Design: one launch for every L. A row is one thread-block cluster of C
// blocks (C = 1, 2, 4 or 8 from the plan, ops/approx_topk_kernel.py::
// select_plan: more than one where few rows leave SMs idle); block r of the
// cluster owns bins [r per, (r + 1) per), per = ceil(L / C). The row loop
// over grid y covers any Q.
//  (a) the bins' maxima: thread t takes its bins b = lo + t, lo + t +
//      kThreads, ... and walks j = b, b + L, ...: at each step consecutive
//      threads read consecutive j. Where a bin holds several elements and
//      the plan says so ("stage row"), the row is first copied into shared
//      memory by cp.async, all of it in flight at once, and walked there
//      (the written values are read back from it too); otherwise the walk
//      reads the row, a thread's loads going out kBatch at a time
//      (fill_keys). The keys stay in shared memory where the plan says they
//      fit ("keys on chip"); otherwise every pass below walks the row again
//      (from L2: a row is 4 N bytes) instead of keeping them.
//  (b) a radix selection of the k-th largest key, 8 bits a pass from the
//      top: each block counts the digits of its keys still in play (those
//      whose higher digits equal the prefix found so far) in a histogram in
//      shared memory, with warp-aggregated atomics; after a cluster barrier
//      every block sums the C histograms through distributed shared memory
//      (a thread a digit), one warp scans them, and all blocks pick the
//      same digit: the one that holds the k-th key. The walk stops at the first pass whose
//      chosen digit holds exactly the keys still wanted: then the threshold
//      is the prefix with its lower bits zero, and exactly k keys are >= it.
//      The value's 32 bits usually decide; the index half is walked only
//      while keys in play share the threshold's value. Two histograms
//      alternate, so a pass takes one cluster barrier and one block barrier
//      (two in a cluster of several blocks).
//  (c) the k keys >= the threshold are compacted into the cluster's first
//      block: its shared memory where k keys fit, else the row's int64
//      indices output, which holds k keys; then that block sorts them
//      descending, up to kWarpSortKeys in one warp's registers
//      (warp_sort_write), more by a bitonic network in memory over
//      next_pow2(k) positions of which only the first k are stored (every
//      compare-exchange puts the larger key at the lower position, so a
//      pair reaching past k is a no-op), and writes the values, each read
//      back from the row at its j, and the indices. A cluster of one block
//      takes block barriers and its own shared memory throughout.
//
// What bounds it on this card: the bytes. The row is read once where the
// keys stay on chip (4 N bytes) and 12 k bytes are written; the passes and
// the sort touch only shared memory: at L = 16,384 some 0.5 MB a row
// against the 27 MB of a full bitonic sort of the L keys. Nothing here
// allocates or synchronises with the host, so a CUDA graph captures it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace gr {
namespace {

constexpr int kThreads = 512;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPasses = 64 / kRadixBits;
constexpr int kMaxCluster = 8;
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

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
#pragma unroll 4
  for (long long j = b; j < n; j += bins) {
    const Key key = order_key(__ldg(row + j), static_cast<unsigned>(j));
    best = key > best ? key : best;
  }
  return best;
}

// the maxima of the block's ``count`` bins from ``lo`` into ``keys``: thread
// t walks its bins i = t, t + kThreads, ..., each j = lo + i, lo + i + bins,
// ... < n, as one sequence whose loads go out kBatch at a time before any
// is used, whatever the bins a thread owns and the elements a bin holds
// (positions fit 32 bits: n < 2^31, so j + bins < 2^32)
constexpr int kBatch = 8;

__device__ __forceinline__ void fill_keys(Key* keys, const float* __restrict__ row, int n,
                                          int bins, int lo, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) keys[i] = 0;
  int i = threadIdx.x;
  unsigned j = static_cast<unsigned>(lo + i);
  while (i < count) {
    float v[kBatch];
    unsigned at[kBatch];
    int bin[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      bin[u] = i < count ? i : -1;
      at[u] = j;
      if (i < count) {
        v[u] = __ldg(row + j);
        j += static_cast<unsigned>(bins);
        if (j >= static_cast<unsigned>(n)) {
          i += kThreads;
          j = static_cast<unsigned>(lo + i);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (bin[u] >= 0) {
        const Key key = order_key(v[u], at[u]);
        if (key > keys[bin[u]]) keys[bin[u]] = key;
      }
    }
  }
}

// the row's n floats into shared memory with cp.async, every copy in
// flight at once: 16 bytes a copy where the row is 16-byte aligned and n a
// multiple of 4, 4 bytes otherwise; waited for here, seen by the block
// after its next barrier
__device__ __forceinline__ void copy_row(float* srow, const float* __restrict__ row, int n) {
  const bool vec = (reinterpret_cast<unsigned long long>(row) & 15ull) == 0 && (n & 3) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(srow + 4 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(row + 4 * i)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(srow + i));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(row + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// the block's control words: the selection's state
struct Select {
  Key prefix;      // the digits chosen so far, lower bits zero
  Key mask;        // their positions
  unsigned want;   // keys still wanted among those in play
  unsigned done;   // the chosen digit holds exactly ``want`` keys
  unsigned placed; // survivors compacted (read in the cluster's first block)
};

// barrier of the first ``threads`` threads (a multiple of 32), or of the
// block where that is all of it
__device__ __forceinline__ void sort_barrier(int threads) {
  if (threads == kThreads)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// ``count`` keys at ``a`` sorted descending by the first ``threads``
// threads: a bitonic network over P = next_pow2(count) positions, each size
// s a flip step (i against the mirror of i in its run of s) then
// half-cleaners, every compare-exchange putting the larger key at the lower
// position; positions >= count hold no key and act as the smallest, so a
// pair reaching past count never moves.
__device__ __forceinline__ void sort_descending(Key* a, int count, int threads) {
  int pow2 = 1;
  while (pow2 < count) pow2 <<= 1;
  for (int s = 2; s <= pow2; s <<= 1) {
    for (int stride = s / 2; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < pow2 / 2; p += threads) {
        int i, j;
        if (stride == s / 2) {  // flip: the run's mirror
          const int off = p & (stride - 1);
          i = (p - off) * 2 + off;
          j = (p - off) * 2 + s - 1 - off;
        } else {
          i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
          j = i + stride;
        }
        if (j < count) {
          const Key x = a[i], y = a[j];
          if (x < y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      sort_barrier(threads);
    }
  }
}

// at most kWarpSortKeys survivors sort in the registers of one warp: R keys
// a lane (R = 1, 2, 4 or 8), element e = lane R + r, positions k..32 R - 1
// padded with key 0 (below every element's key); a descending bitonic
// network whose strides below R are compare-exchanges within a lane and the
// others shuffles between lanes. Writes the first k as values and indices.
constexpr int kWarpSortKeys = 256;

template <int R>
__device__ __forceinline__ void warp_sort_write(const Key* a, int k, const float* row,
                                                float* __restrict__ out_v,
                                                long long* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  Key v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = lane * R + r < k ? a[lane * R + r] : 0;
  constexpr int kLog = 5 + (R >= 2) + (R >= 4) + (R >= 8);  // log2(32 R)
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int s = 1 << ls, stride = 1 << lt;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = lane * R + r;
        const bool descending = (e & s) == 0;
        if (stride < R) {  // within the lane: r and r + stride
          if ((r & stride) == 0) {
            const Key x = v[r], y = v[r + stride];
            if (descending ? x < y : x > y) {
              v[r] = y;
              v[r + stride] = x;
            }
          }
        } else {  // lane ^ stride / R, the same r
          const Key other = __shfl_xor_sync(kFull, v[r], stride / R);
          const bool larger = ((e & stride) == 0) == descending;
          v[r] = larger == (v[r] > other) ? v[r] : other;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    if (e < k) {
      const unsigned j = key_index(v[r]);
      out_v[e] = row[j];
      out_i[e] = static_cast<long long>(j);
    }
  }
}

// the keys of the block's bins i = threadIdx.x + u kThreads, kUnroll at a
// time: from shared memory, or walked again from the row
constexpr int kUnroll = 4;

template <bool kOnChip>
__device__ __forceinline__ void load_keys(Key (&key)[kUnroll], const Key* keys,
                                          const float* __restrict__ row, int n, int bins,
                                          int lo, int count, int base) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * kThreads + threadIdx.x;
    key[u] = i >= count ? 0 : kOnChip ? keys[i] : bin_max(row, n, bins, lo + i);
  }
}

// per: bins a block owns; sort_on_chip: the survivors go to the first
// block's shared memory (else to the row's indices output); stage: the row
// is copied into shared memory first and the bins walked there. Dynamic
// shared memory: [row: n floats, rounded up to 16 bytes, if stage][keys:
// per if kOnChip][survivors: k if sort_on_chip]. A cluster of one block
// takes block barriers and its own shared memory where a larger one takes
// cluster barriers and distributed shared memory.
template <bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
    approx_topk_select_kernel(const float* __restrict__ scores, float* __restrict__ out_v,
                              long long* __restrict__ out_i, int q, int n, int k, int bins,
                              int per, int sort_on_chip, int stage) {
  extern __shared__ __align__(16) Key smem[];
  __shared__ unsigned hist[2][kRadix];
  __shared__ Select sel;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned blocks = cluster.num_blocks();
  const bool alone = blocks == 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* srow = reinterpret_cast<float*>(smem);
  Key* keys = smem + (stage ? (n + 3) / 4 * 2 : 0);
  Key* survivors = keys + (kOnChip ? per : 0);
  const int lo = static_cast<int>(rank) * per;
  const int count = max(0, min(bins, lo + per) - lo);  // this block's bins
  auto row_barrier = [&]() {
    if (alone)
      __syncthreads();
    else
      cluster.sync();
  };

  for (int row = blockIdx.y; row < q; row += gridDim.y) {
    const float* r = scores + static_cast<long long>(row) * n;
    const float* values = stage ? srow : r;  // where the written values are read
    float* row_v = out_v + static_cast<long long>(row) * k;
    long long* row_i = out_i + static_cast<long long>(row) * k;
    for (int i = threadIdx.x; i < 2 * kRadix; i += kThreads) (&hist[0][0])[i] = 0u;
    if (threadIdx.x == 0) {
      sel.prefix = 0;
      sel.mask = 0;
      sel.want = static_cast<unsigned>(k);
      sel.done = 0u;
      sel.placed = 0u;
    }
    if (kOnChip) {
      if (stage) {
        copy_row(srow, r, n);
        __syncthreads();
        for (int i = threadIdx.x; i < count; i += kThreads) {
          Key best = 0;
#pragma unroll 4
          for (unsigned j = static_cast<unsigned>(lo + i); j < static_cast<unsigned>(n);
               j += static_cast<unsigned>(bins)) {
            const Key key = order_key(srow[j], j);
            best = key > best ? key : best;
          }
          keys[i] = best;
        }
      } else {
        fill_keys(keys, r, n, bins, lo, count);
      }
    }
    __syncthreads();

    // (b) the radix walk (the previous row's reads of this block's memory
    // from the others ended before its compaction's barrier, so the reset
    // above is safe)
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = 64 - kRadixBits * (pass + 1);
      unsigned* h = hist[pass & 1];
      const Key prefix = sel.prefix, mask = sel.mask;
      const unsigned want = sel.want;
      for (int base = 0; base < count; base += kUnroll * kThreads) {
        Key key[kUnroll];
        load_keys<kOnChip>(key, keys, r, n, bins, lo, count, base);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in = key[u] != 0 && (key[u] & mask) == prefix;
          const unsigned active = __ballot_sync(kFull, in);
          if (in) {
            const unsigned digit = static_cast<unsigned>(key[u] >> shift) & (kRadix - 1);
            const unsigned peers = __match_any_sync(active, digit);
            if (lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
          }
        }
      }
      row_barrier();
      // the other histogram is free (its last readers were before the
      // barrier above): in a cluster it takes the sum of the blocks'
      // counts, one digit a thread, read through distributed shared memory
      unsigned* other = hist[(pass + 1) & 1];
      const unsigned* counts = h;
      if (!alone) {
        if (threadIdx.x < kRadix) {
          unsigned v = 0;
#pragma unroll
          for (unsigned b = 0; b < kMaxCluster; ++b)
            if (b < blocks) v += cluster.map_shared_rank(h, b)[threadIdx.x];
          other[threadIdx.x] = v;
        }
        __syncthreads();
        counts = other;
      }
      // warp 0 picks the digit: lane l holds digits kRadix - 1 - (kPer l
      // + m), m < kPer; a scan over the lanes counts the keys above each
      // lane's digits. It leaves the other histogram zeroed.
      if (warp == 0) {
        constexpr int kPer = kRadix / 32;
        unsigned c[kPer], sum = 0;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int d = kRadix - 1 - (kPer * lane + m);
          c[m] = counts[d];
          sum += c[m];
          other[d] = 0u;
        }
        unsigned incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += t;
        }
        unsigned before = incl - sum;
        if (want > before && want <= incl) {  // exactly one lane, one digit
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            if (want > before && want <= before + c[m]) {
              const unsigned d = kRadix - 1 - (kPer * lane + m);
              sel.prefix = prefix | (static_cast<Key>(d) << shift);
              sel.mask = mask | (static_cast<Key>(kRadix - 1) << shift);
              sel.want = want - before;
              sel.done = c[m] == want - before;
            }
            before += c[m];
          }
        }
      }
      __syncthreads();
      if (sel.done) break;
    }
    const Key threshold = sel.prefix;

    // (c) the k keys >= threshold into the first block
    Key* dst = !sort_on_chip ? reinterpret_cast<Key*>(row_i)
               : alone       ? survivors
                             : cluster.map_shared_rank(survivors, 0);
    unsigned* placed = alone ? &sel.placed : cluster.map_shared_rank(&sel.placed, 0);
    for (int base = 0; base < count; base += kUnroll * kThreads) {
      Key key[kUnroll];
      load_keys<kOnChip>(key, keys, r, n, bins, lo, count, base);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool take = key[u] != 0 && key[u] >= threshold;
        const unsigned ballot = __ballot_sync(kFull, take);
        if (ballot) {
          const int leader = __ffs(ballot) - 1;
          unsigned at = 0;
          if (lane == leader) at = atomicAdd(placed, __popc(ballot));
          at = __shfl_sync(kFull, at, leader) + __popc(ballot & ((1u << lane) - 1u));
          if (take && at < static_cast<unsigned>(k)) dst[at] = key[u];
        }
      }
    }
    row_barrier();
    if (rank == 0) {
      Key* a = sort_on_chip ? survivors : reinterpret_cast<Key*>(row_i);
      if (k <= kWarpSortKeys) {
        if (warp == 0) {
          if (k <= 32)
            warp_sort_write<1>(a, k, values, row_v, row_i);
          else if (k <= 64)
            warp_sort_write<2>(a, k, values, row_v, row_i);
          else if (k <= 128)
            warp_sort_write<4>(a, k, values, row_v, row_i);
          else
            warp_sort_write<8>(a, k, values, row_v, row_i);
        }
      } else {
        const int pairs = 1 << (31 - __clz(k - 1));  // next_pow2(k) / 2
        const int threads = min(kThreads, (pairs + 31) / 32 * 32);
        if (static_cast<int>(threadIdx.x) < threads) sort_descending(a, k, threads);
        __syncthreads();
        for (int i = threadIdx.x; i < k; i += kThreads) {
          const unsigned j = key_index(a[i]);
          row_v[i] = values[j];
          row_i[i] = static_cast<long long>(j);
        }
      }
    }
    __syncthreads();
  }
}

// the dynamic shared memory opt-in of a kernel instance, set once per
// process and device to the most a block may take
template <bool kOnChip>
cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int most = 0;
  e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, approx_topk_select_kernel<kOnChip>);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(approx_topk_select_kernel<kOnChip>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <bool kOnChip>
cudaError_t launch(const float* sc, float* ov, long long* oi, int q, int n, int k, int bins,
                   int cluster, int per, int sort_on_chip, int stage, size_t smem,
                   cudaStream_t s) {
  cudaError_t e = opt_in<kOnChip>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster),
                     static_cast<unsigned>(q < kMaxGridY ? q : kMaxGridY));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block a row: the implicit cluster
  return cudaLaunchKernelEx(&cfg, approx_topk_select_kernel<kOnChip>, sc, ov, oi, q, n, k,
                            bins, per, sort_on_chip, stage);
}

}  // namespace
}  // namespace gr

// scores (Q, N) f32; values (Q, k) f32, indices (Q, k) int64. bins (L),
// cluster (C), keys_on_chip, sort_on_chip and stage_row: the plan
// (ops/approx_topk_kernel.py::select_plan). One launch.
extern "C" int gr_approx_topk(const void* scores, void* values, void* indices, int q, int n,
                              int k, int bins, int cluster, int keys_on_chip,
                              int sort_on_chip, int stage_row, void* stream) {
  using namespace gr;
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (q <= 0 || n <= 0 || k <= 0 || k > bins || bins > n || !pow2 ||
      cluster > kMaxCluster || cluster > bins || (stage_row && !keys_on_chip))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (bins + cluster - 1) / cluster;
  const size_t smem = sizeof(float) * (stage_row ? (static_cast<size_t>(n) + 3) / 4 * 4 : 0) +
                      sizeof(Key) * ((keys_on_chip ? static_cast<size_t>(per) : 0) +
                                     (sort_on_chip ? static_cast<size_t>(k) : 0));
  const auto* sc = static_cast<const float*>(scores);
  auto* ov = static_cast<float*>(values);
  auto* oi = static_cast<long long*>(indices);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      keys_on_chip
          ? launch<true>(sc, ov, oi, q, n, k, bins, cluster, per, sort_on_chip, stage_row, smem, s)
          : launch<false>(sc, ov, oi, q, n, k, bins, cluster, per, sort_on_chip, 0, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
