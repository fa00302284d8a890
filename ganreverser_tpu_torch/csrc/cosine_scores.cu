// Kernel C: (Q, N) cosine scores of Q needle rows against N embedding rows,
//
//   dot(q, e) / (sqrt(max(|q|^2, 1e-16)) * sqrt(max(|e|^2, 1e-16))),
//
// the TPU kernel's clamp on the squared norms. Replaces ganreverser_tpu/ops/
// topk_kernel.py::cosine_scores_pallas (_kernel), which normalises both
// operands of each (N tile, D) block in VMEM and takes the product on the
// MXU.
//
// What bounds it: reading the (N, D) embeddings once from device memory,
// 246 MB for apply_r's pixel search (10,000 x 12,288 bf16 at Q = 10), at
// 3.35 TB/s; the products are 2Q operations a byte. So the design streams
// E once, at the card's rate, and computes nothing twice.
//
// bf16, two launches and no float atomics (two calls are bitwise equal):
//  1. cosine_wgmma_kernel: a block takes 128 rows of E (blockIdx.x), up to
//     256 needles (blockIdx.y; BNQ = Q rounded up to a width the kernel is
//     built for) and one slice of D (blockIdx.z): D is split across blocks
//     in whole 64-element chunks, slice z taking chunks [z C / S,
//     (z + 1) C / S), because N = 10,000 gives only 79 row blocks for 132
//     SMs. One producer warp streams the slice through a ring of stages by
//     TMA (conv_wgmma.cuh's helpers: a 2D map over E (D, N) with box
//     (64, 128) and one over the gathered (Q, D) needles with box
//     (64, BNQ), both in the 128-byte swizzle; rows past N and needles past
//     Q read as zero). Two consumer warpgroups take the products on the
//     tensor cores (wgmma m64nBNQk16, A = the E tile, B = the needles; bf16
//     products are exact in f32) and each row's sum of squares from the
//     same shared-memory tile, so E is read once. They write the slice's
//     partial dots (S, Q, N) and partial sums of squares (S, N) to an f32
//     workspace.
//  2. cosine_finish_kernel: adds the slices in slice order and applies the
//     clamp; a needle's squared norm is its own row's.
// TMA needs rows of a multiple of 16 bytes, so the wrapper zero-pads D to a
// multiple of 8 where it is not one (ops/topk_kernel.py::cosine_plan, which
// also picks BNQ, the slices and the ring, and which launch_bf16 checks).
// f32 keeps one IEEE f32 launch on the CUDA cores, cosine_scores_kernel:
// each block takes 32 rows and up to 16 needles, stages 256-element chunks
// of the needles in shared memory, and each warp streams its rows' chunk
// once, accumulating the dots and the rows' and needles' sums of squares.
#include "conv_wgmma.cuh"

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

static int launch_f32(const void* needles, const void* emb, void* out, int q,
                      int n, int d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock),
                  static_cast<unsigned>((q + kQ - 1) / kQ), 1);
  cosine_scores_kernel<float><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(needles), static_cast<const float*>(emb),
      static_cast<float*>(out), q, n, d);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRows = wg::kBM;  // rows of E per block
constexpr int kBK = 64;       // elements of D per stage: 128-byte rows

// Launch 1 (bf16): the partials of slice blockIdx.z for E rows blockIdx.x *
// 128 .. + 128 and needles blockIdx.y * BNQ .. + BNQ.
template <int BNQ>
__global__ void __launch_bounds__(wg::kThreads, BNQ <= 64 ? 3 : 1)
    cosine_wgmma_kernel(const __grid_constant__ CUtensorMap emap,
                        const __grid_constant__ CUtensorMap qmap,
                        float* __restrict__ part_dot,
                        float* __restrict__ part_sq, int Q, int N, int chunks,
                        int stages) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  constexpr int a_bytes = kRows * kBK * 2;
  constexpr int b_bytes = BNQ * kBK * 2;
  constexpr int sbytes = stage_bytes(BNQ, kBK);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + stages * sbytes);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int z = blockIdx.z, slices = gridDim.z;
  const int k0 = static_cast<int>(static_cast<long long>(z) * chunks / slices);
  const int k1 =
      static_cast<int>(static_cast<long long>(z + 1) * chunks / slices);
  const int iters = k1 - k0;
  const int n0 = blockIdx.x * kRows, q0 = blockIdx.y * BNQ;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < iters; ++it) {
        unsigned char* sa = buf + stage * sbytes;
        mbar_wait(&empty[stage], phase ^ 1u);
        mbar_expect_tx(&full[stage], a_bytes + b_bytes);
        tma_load_2d(sa, &emap, &full[stage], (k0 + it) * kBK, n0);
        tma_load_2d(sa + a_bytes, &qmap, &full[stage], (k0 + it) * kBK, q0);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wgi takes rows wgi * 64 .. + 64 of the tile;
  // this thread's accumulator rows are r0 and r0 + 8, and it also takes
  // their sums of squares over 16-byte pieces 2 (l % 4) and 2 (l % 4) + 1
  // of each 128-byte row (the swizzle puts piece c of row r at c ^ (r % 8))
  const int wgi = warp >> 2;
  const int r0 = acc_row(warp, lane);
  float acc[BNQ / 2];
#pragma unroll
  for (int i = 0; i < BNQ / 2; ++i) acc[i] = 0.0f;
  fence_operands(acc);
  float ss[2] = {0.0f, 0.0f};
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(&full[stage], phase);
    const unsigned char* sa = buf + stage * sbytes;
    const uint64_t da = make_desc(sa + wgi * 64 * kBK * 2, 1, 1024);
    const uint64_t db = make_desc(sa + a_bytes, 1, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<BNQ>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * (lane & 3) + e;
        const uint4 v = *reinterpret_cast<const uint4*>(
            sa + row * kBK * 2 + ((c ^ (row & 7)) << 4));
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(v2[i]);
          ss[h] = fmaf(f.x, f.x, ss[h]);
          ss[h] = fmaf(f.y, f.y, ss[h]);
        }
      }
    }
    wgmma_wait<1>();  // the previous stage's products are done
    __syncwarp();     // and every lane's reads of it
    if (it > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // a row's four threads hold two pieces each: add them as a fixed tree
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
  }
  const long long zn = static_cast<long long>(z) * N;
  if (blockIdx.y == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (n0 + r0 + 8 * h < N) part_sq[zn + n0 + r0 + 8 * h] = ss[h];
  }
#pragma unroll
  for (int j = 0; j < BNQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + j * 8 + 2 * (lane & 3) + e;
      if (q >= Q) continue;
      float* dst = part_dot + (static_cast<long long>(z) * Q + q) * N + n0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (n0 + r0 + 8 * h < N) dst[r0 + 8 * h] = acc[j * 4 + 2 * h + e];
    }
}

constexpr int kFinishThreads = 256;

// Launch 2 (bf16): score (q, n) from the slices' partials, in slice order.
__global__ void __launch_bounds__(kFinishThreads)
    cosine_finish_kernel(const float* __restrict__ part_dot,
                         const float* __restrict__ part_sq,
                         const long long* __restrict__ idx,
                         float* __restrict__ out, int Q, int N, int slices) {
  const long long i = static_cast<long long>(blockIdx.x) * kFinishThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(Q) * N) return;
  const int q = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const long long e = idx[q];
  float dot = 0.0f, ee = 0.0f, qq = 0.0f;
  for (int s = 0; s < slices; ++s) {
    dot += part_dot[(static_cast<long long>(s) * Q + q) * N + n];
    ee += part_sq[static_cast<long long>(s) * N + n];
    qq += part_sq[static_cast<long long>(s) * N + e];
  }
  out[i] = dot / (sqrtf(fmaxf(qq, kEps2)) * sqrtf(fmaxf(ee, kEps2)));
}

static int launch_bf16(const void* needles, const void* emb, const void* idx,
                       void* ws, void* out, int q, int n, int d, int bnq,
                       int slices, int stages, int smem, cudaStream_t stream) {
  using namespace wg;
  const int chunks = (d + kBK - 1) / kBK;
  const bool ok = d % 8 == 0 && q >= 1 && n >= 1 &&
                  (bnq == 16 || bnq == 32 || bnq == 64 || bnq == 128 ||
                   bnq == 256) &&
                  slices >= 1 && slices <= chunks && stages >= 2 &&
                  kAlign + stages * (stage_bytes(bnq, kBK) + 16) <= smem &&
                  smem <= kMaxSharedBytes;
  CUtensorMap emap, qmap;
  const long long edims[2] = {d, n}, qdims[2] = {d, q};
  const int ebox[2] = {kBK, kRows}, qbox[2] = {kBK, bnq};
  if (!ok || !encode_map(&emap, emb, 2, edims, ebox, kBK) ||
      !encode_map(&qmap, needles, 2, qdims, qbox, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_dot = static_cast<float*>(ws);
  float* part_sq = part_dot + static_cast<long long>(slices) * q * n;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((q + bnq - 1) / bnq),
                  static_cast<unsigned>(slices));
  const cudaError_t e = by_width(bnq, [&](auto w) {
    constexpr int BNQ = decltype(w)::value;
    const cudaError_t a = cudaFuncSetAttribute(
        cosine_wgmma_kernel<BNQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (a != cudaSuccess) return a;
    cosine_wgmma_kernel<BNQ><<<grid, kThreads, smem, stream>>>(
        emap, qmap, part_dot, part_sq, q, n, chunks, stages);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(q) * n;
  cosine_finish_kernel<<<static_cast<unsigned>((total + kFinishThreads - 1) /
                                               kFinishThreads),
                         kFinishThreads, 0, stream>>>(
      part_dot, part_sq, static_cast<const long long*>(idx),
      static_cast<float*>(out), q, n, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gr

// needles (Q,D) and emb (N,D) in the storage type, out (Q,N) f32. f32: idx,
// ws and the plan ignored. bf16: D % 8 == 0 (the wrapper pads it), idx the
// (Q,) int64 needle rows of emb, ws (S * Q * N + S * N) f32, on the plan
// bnq, slices, stages, smem (ops/topk_kernel.py::cosine_plan).
extern "C" int gr_cosine_scores(int dtype, const void* needles,
                                const void* emb, const void* idx, void* ws,
                                void* out, int q, int n, int d, int bnq,
                                int slices, int stages, int smem,
                                void* stream) {
  using namespace gr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_f32(needles, emb, out, q, n, d, s);
  if (dtype == DT_BF16)
    return launch_bf16(needles, emb, idx, ws, out, q, n, d, bnq, slices,
                       stages, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
