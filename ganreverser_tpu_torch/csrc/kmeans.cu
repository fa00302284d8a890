// Kernel K: Lloyd's iterations of kmeans for any K and D in one persistent
// cooperative launch, with no float atomics, so that two runs give
// bitwise-equal centroids and counts.
//
// Replaces ganreverser_tpu/ops/kmeans_kernel.py::_kmeans_sums_counts (the
// Pallas body _kernel), the division of kmeans_step_pallas and the loop of
// kmeans_pallas. The TPU kernel carries its (K, D) sums and (K,) counts
// across a sequential grid; blocks on this card run in parallel and in no
// order, so one launch of `grid` co-resident blocks (a cooperative launch,
// cooperative_groups::this_grid().sync() between phases) runs every
// iteration. Block b owns a contiguous range of rows, tiles_per_block tiles
// of `rows` rows. Per iteration:
//
//  (a) assignment: the block keeps its tile of rows in shared memory while
//      the centroids stream past in tiles of `kt`, with their squared
//      norms. The distance is the TPU kernel's d = |c|^2 - 2 x.c in IEEE
//      f32 (|x|^2 is constant per row), the products as 4 x 4 register
//      tiles; one thread per row keeps a running argmin, scanning k upwards
//      with a strict <, so a tie goes to the first index. The block also
//      counts its rows per cluster (integer atomics on its own column of a
//      (K, grid) table);
//  (b) one warp per cluster scans its row of the table over the blocks
//      (each (cluster, block) pair's first place within the cluster, and
//      the cluster's count); then block 0 scans the counts over the
//      clusters: each cluster's first place in a cluster-sorted permutation
//      of the rows, and its segments of kSegRows sorted rows;
//  (c) each block places its rows' indices in the permutation, stable in
//      row order (a row's rank among the equal assignments before it in
//      its chunk of 256, plus a running offset per (cluster, block));
//  (d) one warp per (segment, 128 columns), over all SMs, adds a segment's
//      rows in sorted order, eight rows' loads in flight, a lane per column;
//  (e) one warp per cluster adds its segment sums in segment order, writes
//      sums / max(count, 1), or the old centroid of an empty cluster, and
//      the new centroid's squared norm (the first centroids' norms are
//      taken before the first iteration).
//
// The order of every sum is thus fixed by N, the assignment and kSegRows
// alone, whatever the grid or the timing, and a count is an integer. The
// workspace (the permutation, the (K, grid) table, the segments' sums, two
// centroid buffers and their norms) is sized by the wrapper (ops/kmeans_kernel.py::
// lloyd_plan): the segments are at most min(N, ceil(N / 64) + K), so any K
// is taken, and D up to about 29,000 (a row and a centroid in 227 KB).
//
// Why the CUDA cores and not wgmma: the assignment must be the f32 argmin
// the TPU kernel takes, and TF32 or bf16 products flip near-ties; at the
// main path's shapes (10,000 x 100, K = 20) the arithmetic is 40 MFLOP an
// iteration, about 1 us at the f32 rate. What bounds the kernel is latency:
// the grid barriers, the dependent loads of the sums and the launches. The
// design keeps it to one launch for all iterations (apply_r's 15 were 30
// launches) that allocates nothing and needs no host synchronisation.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace gr {

constexpr int kThreads = 256;        // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;      // columns of a segment sum per lane
constexpr int kColsPerWarp = 32 * kColsPerLane;
constexpr int kSegRows = 64;         // sorted rows per segment
constexpr int kInFlight = 8;         // rows of a segment loaded before adding
constexpr int kTileLoads = 8;        // loads a thread has in flight filling a tile
constexpr int kMaxDevices = 64;

struct LloydArgs {
  const float* x;      // (N, D)
  const float* c0;     // (K, D), the initial centroids
  float* c_new;        // (K, D), the last iteration's centroids
  float* counts;       // (K), the last iteration's counts
  float* sums;         // (K, D), the last iteration's sums, or null
  int* assign;         // (N), the last iteration's assignment
  float* cbuf;         // workspace: 2 x (K, D), centroids between iterations
  float* cnorm;        // workspace: (K), the current centroids' squared norms
  float* segsum;       // workspace: (max_segments, D)
  int* perm;           // workspace: (N), the rows sorted by cluster
  int* table;          // workspace: (K, grid) counts, then offsets
  int* ccount;         // workspace: (K) rows per cluster
  int* cstart;         // workspace: (K + 1) first sorted place per cluster
  int* segstart;       // workspace: (K + 1) first segment per cluster
  int* segk;           // workspace: (max_segments) cluster of each segment
  int n, d, k, iters, rows, kt, tiles_per_block;
};

// src[0, count) (rows of D floats) into shared memory at the row stride
// D + 1, each thread's loads in flight before their stores: 16-byte loads
// when D and src allow them, else kTileLoads 4-byte ones
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int count, int D,
                                          float* dst) {
  if (D % 4 == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int count4 = count / 4;
    for (int i0 = threadIdx.x; i0 < count4; i0 += kTileLoads * kThreads) {
      float4 v[kTileLoads];
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < count4) v[u] = src4[i];
      }
#pragma unroll
      for (int u = 0; u < kTileLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i < count4) {  // four columns of one row: D is a multiple of 4
          float* d = dst + (4 * i / D) * (D + 1) + (4 * i) % D;
          d[0] = v[u].x;
          d[1] = v[u].y;
          d[2] = v[u].z;
          d[3] = v[u].w;
        }
      }
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < count; i0 += kTileLoads * kThreads) {
    float v[kTileLoads];
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < count ? src[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const int i = i0 + u * kThreads;
      if (i < count) dst[(i / D) * (D + 1) + i % D] = v[u];
    }
  }
}

// the (nrows x nk) products of the tiles xs and cs into dots (k-major, row
// stride `stride`): a thread holds 4 rows x 4 centroids in registers (a
// warp 8 row groups x 4 centroid groups, so its shared loads are free of
// bank conflicts at the odd stride ld), each sum one fmaf chain over j, as
// the scalar loop would take it; 256 threads cover 64 rows x 64 centroids
__device__ __forceinline__ void tile_dots(const float* xs, const float* cs, float* dots,
                                          int ld, int D, int nrows, int nk, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 4 * ((warp & 1) * 8 + (lane & 7));       // first row
  const int k0l = 4 * ((warp >> 1) * 4 + (lane >> 3));   // first centroid
  if (r0 >= nrows || k0l >= nk) return;
  int xr[4], cr[4];  // shared offsets of the rows and centroids
#pragma unroll
  for (int p = 0; p < 4; ++p) xr[p] = min(r0 + p, nrows - 1) * ld;
#pragma unroll
  for (int q = 0; q < 4; ++q) cr[q] = min(k0l + q, nk - 1) * ld;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < D; ++j) {  // unrolled: the shared loads ahead of the FMAs
    float xv[4], cv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) xv[p] = xs[xr[p] + j];
#pragma unroll
    for (int q = 0; q < 4; ++q) cv[q] = cs[cr[q] + j];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(xv[p], cv[q], acc[p][q]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + p < nrows && k0l + q < nk) dots[(k0l + q) * stride + r0 + p] = acc[p][q];
}

// phase (a) for the tile of rows [row0, row0 + nrows)
__device__ void assign_tile(const LloydArgs& a, const float* __restrict__ c,
                            long long row0, int nrows, int* col,
                            float* smem) {
  const int D = a.d, K = a.k, kt = a.kt;
  const int ld = D + 1;
  float* xs = smem;                                       // rows x ld
  float* cs = xs + static_cast<long long>(a.rows) * ld;   // kt x ld
  float* c2 = cs + static_cast<long long>(kt) * ld;       // kt
  float* dots = c2 + kt;  // kt x rows: a row's thread reads them conflict-free
  const int tid = threadIdx.x;
  load_tile(a.x + row0 * D, nrows * D, D, xs);
  int best = 0;  // thread r < nrows owns row r
  float best_d = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kt) {
    const int nk = min(kt, K - k0);
    __syncthreads();  // the previous tile's reads are done
    load_tile(c + static_cast<long long>(k0) * D, nk * D, D, cs);
    for (int k = tid; k < nk; k += kThreads) c2[k] = a.cnorm[k0 + k];
    __syncthreads();
    tile_dots(xs, cs, dots, ld, D, nrows, nk, a.rows);
    __syncthreads();
    if (tid < nrows) {
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        const float dk = c2[k] - 2.0f * dots[k * a.rows + tid];
        if ((k0 == 0 && k == 0) || dk < best_d) {
          best_d = dk;
          best = k0 + k;
        }
      }
    }
  }
  if (tid < nrows) {
    a.assign[row0 + tid] = best;
    atomicAdd(col + static_cast<long long>(best) * gridDim.x, 1);
  }
}

// exclusive scan of in[0, m) into out[0, m) by one block, 256 elements at
// a time; returns the total. in and out may be the same array. sh: kWarps
// ints of shared memory
__device__ int block_scan(const int* in, int* out, int m, int* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    const int v = i < m ? in[i] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = sh[w];
      before += w < warp ? h : 0;
      total += h;
    }
    if (i < m) out[i] = carry + before + incl - v;
    carry += total;
    __syncthreads();  // sh is rewritten next
  }
  return carry;
}

// phase (b1), all blocks: one warp per cluster (cluster k on block k % grid)
// turns its row of the table (its rows in each block) into offsets within
// the cluster, and counts it
__device__ void cluster_offsets(const LloydArgs& a) {
  constexpr int kChunks = 8;  // 32-block chunks of the row loaded at once
  const int lane = threadIdx.x & 31, G = gridDim.x;
  for (int k = (threadIdx.x >> 5) * G + blockIdx.x; k < a.k; k += G * kWarps) {
    int* row = a.table + static_cast<long long>(k) * G;
    int carry = 0;
    for (int b0 = 0; b0 < G; b0 += 32 * kChunks) {
      int v[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int b = b0 + 32 * q + lane;
        v[q] = b < G ? row[b] : 0;
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int b = b0 + 32 * q + lane;
        int incl = v[q];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += t;
        }
        if (b < G) row[b] = carry + incl - v[q];
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    if (lane == 0) a.ccount[k] = carry;
  }
}

// phase (b2), block 0: each cluster's first sorted place, its count and
// its segments of kSegRows sorted rows
__device__ void plan_segments(const LloydArgs& a, int* sh) {
  const int K = a.k;
  block_scan(a.ccount, a.cstart, K, sh);
  if (threadIdx.x == 0) a.cstart[K] = a.n;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int cnt = a.ccount[k];
    a.counts[k] = static_cast<float>(cnt);
    a.segstart[k] = (cnt + kSegRows - 1) / kSegRows;
  }
  __syncthreads();
  const int total = block_scan(a.segstart, a.segstart, K, sh);
  if (threadIdx.x == 0) a.segstart[K] = total;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads)
    for (int s = a.segstart[k]; s < a.segstart[k + 1]; ++s) a.segk[s] = k;
}

// phase (c): the block's rows [begin, end) into the permutation, stable
__device__ void place_rows(const LloydArgs& a, long long begin, long long end,
                           int* col, int* sa) {
  const int tid = threadIdx.x, G = gridDim.x;
  for (long long r0 = begin; r0 < end; r0 += kThreads) {
    const long long r = r0 + tid;
    const int m = static_cast<int>(min(static_cast<long long>(kThreads), end - r0));
    const int kk = tid < m ? a.assign[r] : -1;
    sa[tid] = kk;
    __syncthreads();
    int rank = 0;
    bool last = true;
    for (int i = 0; i < m; ++i) {
      if (sa[i] == kk) {
        rank += i < tid;
        last = last && i <= tid;
      }
    }
    int base = 0;
    if (kk >= 0) {
      base = col[static_cast<long long>(kk) * G];
      a.perm[a.cstart[kk] + base + rank] = static_cast<int>(r);
    }
    __syncthreads();  // every base is read
    if (kk >= 0 && last) col[static_cast<long long>(kk) * G] = base + rank + 1;
    __syncthreads();  // the offsets are current, sa is free
  }
}

// phase (d): segment sums, one warp per (segment, 128 columns)
__device__ void segment_sums(const LloydArgs& a) {
  const int lane = threadIdx.x & 31, D = a.d;
  const int ncb = (D + kColsPerWarp - 1) / kColsPerWarp;
  const long long items = static_cast<long long>(a.segstart[a.k]) * ncb;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  // item w to warp w / grid of block w % grid: the items spread over the SMs
  for (long long w = static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       w < items; w += warps) {
    const int s = static_cast<int>(w / ncb), cb = static_cast<int>(w % ncb);
    const int kk = a.segk[s];
    const int p0 = a.cstart[kk] + (s - a.segstart[kk]) * kSegRows;
    const int len = min(kSegRows, a.cstart[kk + 1] - p0);
    // the segment's row indices, lane l holding sorted places l and 32 + l
    const int ra = lane < len ? a.perm[p0 + lane] : 0;
    const int rb = 32 + lane < len ? a.perm[p0 + 32 + lane] : 0;
    const int col0 = cb * kColsPerWarp + lane;
    // a lane past D reads column D - 1 and never writes its sum
    int cols[kColsPerLane];
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) cols[u] = min(col0 + 32 * u, D - 1);
    float acc[kColsPerLane];
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) acc[u] = 0.0f;
    int i = 0;
    for (; i + kInFlight <= len; i += kInFlight) {
      float v[kInFlight][kColsPerLane];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int row = __shfl_sync(0xffffffffu, i + q < 32 ? ra : rb, (i + q) & 31);
        const float* xr = a.x + static_cast<long long>(row) * D;
#pragma unroll
        for (int u = 0; u < kColsPerLane; ++u) v[q][u] = xr[cols[u]];
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q)
#pragma unroll
        for (int u = 0; u < kColsPerLane; ++u) acc[u] += v[q][u];
    }
    for (; i < len; ++i) {
      const int row = __shfl_sync(0xffffffffu, i < 32 ? ra : rb, i & 31);
      const float* xr = a.x + static_cast<long long>(row) * D;
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) acc[u] += xr[cols[u]];
    }
    float* out = a.segsum + static_cast<long long>(s) * D;
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) {
      const int c = col0 + 32 * u;
      if (c < D) out[c] = acc[u];
    }
  }
}

// the squared norm of each centroid of c, a warp a centroid (a lane's
// columns in order, then the warp's tree)
__device__ void centroid_norms(const LloydArgs& a, const float* __restrict__ c) {
  const int lane = threadIdx.x & 31;
  for (int k = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; k < a.k;
       k += gridDim.x * kWarps) {
    const float* ck = c + static_cast<long long>(k) * a.d;
    float s = 0.0f;
    for (int j = lane; j < a.d; j += 32) s = fmaf(ck[j], ck[j], s);
    s = warp_sum(s);
    if (lane == 0) a.cnorm[k] = s;
  }
}

// phase (e), a warp a cluster: its sums in segment order, the new centroid
// sums / max(count, 1) (the old one when the cluster is empty) and its
// squared norm for the next assignment
__device__ void finish(const LloydArgs& a, const float* __restrict__ c, float* c_next,
                       bool last) {
  const int lane = threadIdx.x & 31, D = a.d;
  for (int k = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; k < a.k;
       k += gridDim.x * kWarps) {
    const int s0 = a.segstart[k], s1 = a.segstart[k + 1];
    const int cnt = a.cstart[k + 1] - a.cstart[k];
    const long long row = static_cast<long long>(k) * D;
    float norm = 0.0f;
    for (int cb = 0; cb < D; cb += kColsPerWarp) {
      int cols[kColsPerLane];
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) cols[u] = min(cb + lane + 32 * u, D - 1);
      float sum[kColsPerLane];
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) sum[u] = 0.0f;
      int s = s0;
      for (; s + 4 <= s1; s += 4) {  // four segments' loads in flight, added in order
        float v[4][kColsPerLane];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kColsPerLane; ++u)
            v[q][u] = a.segsum[static_cast<long long>(s + q) * D + cols[u]];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kColsPerLane; ++u) sum[u] += v[q][u];
      }
      for (; s < s1; ++s)
#pragma unroll
        for (int u = 0; u < kColsPerLane; ++u)
          sum[u] += a.segsum[static_cast<long long>(s) * D + cols[u]];
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) {
        const int col = cb + lane + 32 * u;
        if (col >= D) continue;
        const float v = cnt > 0 ? sum[u] / fmaxf(static_cast<float>(cnt), 1.0f) : c[row + col];
        c_next[row + col] = v;
        norm = fmaf(v, v, norm);
        if (last && a.sums != nullptr) a.sums[row + col] = sum[u];
      }
    }
    norm = warp_sum(norm);
    if (lane == 0) a.cnorm[k] = norm;
  }
}

// at most 128 registers a thread, so that two blocks share an SM
__global__ void __launch_bounds__(kThreads, 2) kmeans_lloyd_kernel(LloydArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, G = gridDim.x;
  const long long span = static_cast<long long>(a.tiles_per_block) * a.rows;
  const long long begin = min(static_cast<long long>(a.n), b * span);
  const long long end = min(static_cast<long long>(a.n), begin + span);
  int* col = a.table + b;  // this block's column, stride G
  const long long kd = static_cast<long long>(a.k) * a.d;
  centroid_norms(a, a.c0);
  grid.sync();
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const float* c = it == 0 ? a.c0 : a.cbuf + ((it - 1) & 1) * kd;
    float* c_next = last ? a.c_new : a.cbuf + (it & 1) * kd;
    for (int k = threadIdx.x; k < a.k; k += kThreads) col[static_cast<long long>(k) * G] = 0;
    __syncthreads();
    for (long long r0 = begin; r0 < end; r0 += a.rows)
      assign_tile(a, c, r0, static_cast<int>(min(static_cast<long long>(a.rows), end - r0)),
                  col, smem);
    grid.sync();
    cluster_offsets(a);
    grid.sync();
    if (b == 0) plan_segments(a, reinterpret_cast<int*>(smem));
    grid.sync();
    place_rows(a, begin, end, col, reinterpret_cast<int*>(smem));
    grid.sync();
    segment_sums(a);
    grid.sync();
    finish(a, c, c_next, last);
    if (!last) grid.sync();
  }
}

// sets the kernel's dynamic shared-memory opt-in on the current device to
// at least smem_bytes (once per device and size)
cudaError_t opt_in(int smem_bytes) {
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem_bytes <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kmeans_lloyd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e == cudaSuccess) opted[dev] = smem_bytes;
  return e;
}

}  // namespace gr

// Blocks of the Lloyd kernel co-resident on the current device with
// smem_bytes of dynamic shared memory (occupancy x SMs; -1 when a query
// fails).
extern "C" int gr_kmeans_resident(int smem_bytes) {
  using namespace gr;
  int dev = 0, per_sm = 0, sms = 0;
  if (opt_in(smem_bytes) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmeans_lloyd_kernel, kThreads,
                                                    smem_bytes) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return per_sm * sms;
}

// x (N,D) f32, c (K,D) f32; c_new (K,D) and counts (K) f32; sums (K,D) f32
// may be null; assign (N) int32. ws_f: 2KD + K + max_segments D floats; ws_i:
// N + K grid + K + 2 (K + 1) + max_segments ints. rows, kt, smem_bytes, grid,
// tiles_per_block and max_segments: the plan (ops/kmeans_kernel.py::
// lloyd_plan). A grid over the co-resident blocks is refused by the
// cooperative launch (cudaErrorCooperativeLaunchTooLarge).
extern "C" int gr_kmeans_lloyd(const void* x, const void* c, void* c_new,
                               void* counts, void* sums, void* assign,
                               void* ws_f, void* ws_i, int n, int d, int k,
                               int iters, int rows, int kt, int smem_bytes,
                               int grid, int tiles_per_block, int max_segments,
                               void* stream) {
  using namespace gr;
  if (n <= 0 || d <= 0 || k <= 0 || iters <= 0 || rows <= 0 || rows > kThreads ||
      kt <= 0 || rows > 64 || kt > 64 || grid <= 0 || tiles_per_block <= 0 || assign == nullptr ||
      static_cast<long long>(grid) * tiles_per_block * rows < n ||
      max_segments < min(n, (n + kSegRows - 1) / kSegRows + k))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need =
      4LL * ((static_cast<long long>(rows) + kt) * (d + 1) + kt +
             static_cast<long long>(rows) * kt);
  if (smem_bytes < need || smem_bytes < 4 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e0 = opt_in(smem_bytes);
  if (e0 != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e0);
  }
  const long long kd = static_cast<long long>(k) * d;
  LloydArgs a;
  a.x = static_cast<const float*>(x);
  a.c0 = static_cast<const float*>(c);
  a.c_new = static_cast<float*>(c_new);
  a.counts = static_cast<float*>(counts);
  a.sums = static_cast<float*>(sums);
  a.assign = static_cast<int*>(assign);
  a.cbuf = static_cast<float*>(ws_f);
  a.cnorm = a.cbuf + 2 * kd;
  a.segsum = a.cnorm + k;
  a.perm = static_cast<int*>(ws_i);
  a.table = a.perm + n;
  a.ccount = a.table + static_cast<long long>(k) * grid;
  a.cstart = a.ccount + k;
  a.segstart = a.cstart + k + 1;
  a.segk = a.segstart + k + 1;
  a.n = n;
  a.d = d;
  a.k = k;
  a.iters = iters;
  a.rows = rows;
  a.kt = kt;
  a.tiles_per_block = tiles_per_block;
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kmeans_lloyd_kernel), dim3(grid), dim3(kThreads), params,
      static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // a refusal leaves no error behind
  return static_cast<int>(e);
}
