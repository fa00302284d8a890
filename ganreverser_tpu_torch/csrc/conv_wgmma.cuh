// The tensor-core mainloop shared by kernels B (and B6), U (and its fused
// head), B7, B8 and D in bf16 and Q1, Q2 and Q3 in int8, and the helpers
// kernel C's own loop reuses: an implicit GEMM for a 3x3 convolution, one
// output phase of U's 2x2 phase convolution, or a dense layer as a 1x1
// one, over an NHWC input, on Hopper's wgmma fed by TMA.
//
//   acc[m][co] = sum_stage x[n, i(m) + dy(stage), j(m) + dx(stage), c0 + ci]
//                         * w[wz(stage)][co][wk(stage) + ci]
//
// M is a patch of BH x BW = 128 output pixels of one image, N is BN output
// channels (16 to 256), K is streamed BK channels of one tap per pipeline
// stage. Sums are f32 (bf16 operands) or s32 (int8) in registers. Three
// policies are template parameters: the tap policy (Conv3x3Taps, PhaseTaps,
// StackedPhaseTaps, DenseTaps) maps a stage to the two boxes it reads, the
// epilogue (BnActEpilogue, StatsEpilogue, HeadTapsEpilogue,
// DequantActEpilogue, SplitSumsEpilogue) takes the sums from the registers,
// and the operand type (Bf16Operands, the default, or S8Operands) picks the
// instruction; the ring between them is the same for every kernel.
//
// Operands. x is (N, H, W, C) with C % 8 == 0 (the wrapper zero-pads the
// channels, ops/conv_operands.py), read through one 4D tiled tensor map over
// (C, W, H, N) with box (BK, BW, BH, 1): tap (dy, dx) of the tile at
// (n, i0, j0) is the box at (c0, j0 + dx, i0 + dy, n). TMA fills every
// element outside the tensor, negative coordinates included, with zero: that
// is the SAME padding each layer re-applies (conv_tile.cuh), with no padded
// copy and no bounds checks, and it zero-fills the ragged edges (H, W off the
// tile, channels past C) too. The box lands in shared memory as the 128 x BK
// K-major A tile. The weights are (slices, Co, K), K-major, read through a
// 3D map with box (BK, BN, 1); channels past Co read as zero. K is C with
// one slice per tap (B, B6, B7: 9 taps; U: 16 phase taps), or 4 * Kp with
// one slice per phase (B8: the phase's four taps stacked). BK is 64
// (128-byte rows, 128-byte swizzle), or 32 or 16 (64- and 32-byte swizzle)
// where C is that narrow, so a stem of 3 channels computes 16 deep, not 64
// (the wrapper pads such a C to BK: TMA is slow on rows that are half out of
// bounds).
//
// int8 (S8Operands). The same maps over int8 tensors (carried as uint8), BK
// counted in elements: a k step of wgmma m64nNk32.s32.s8.s8 reads the same
// 32 bytes of a row that a bf16 k16 step reads, so BK = 128, 64 or 32 gives
// the 128-, 64- and 32-byte rows, swizzles and descriptor advance of bf16's
// 64, 32 and 16 (ops/quant.py pads int8 channels to 32, 64 or a multiple of
// 16). The s32 sums are exact and take the f32 sums' registers.
//
// Pipeline. One producer warp (one elected lane) issues both loads of a
// stage with cp.async.bulk.tensor on the stage's "full" mbarrier
// (expect_tx); two consumer warpgroups, 64 rows each, wait on it, issue
// wgmma.mma_async (m64nBNk16, bf16 -> f32, both operands from shared memory
// through matrix descriptors, both K-major so neither is transposed), and
// keep one group in flight: a stage is released on its "empty" mbarrier
// (one arrival per consumer warp) when the next stage's products have been
// issued and its own have completed. The ring holds 2 or more stages.
//
// Epilogues, on the freed ring. BnActEpilogue: acc * scale + shift, the
// activation (common.cuh's apply_act, a PReLU slope read from device memory)
// and one rounding to bf16, in f32 as before; the tile is staged and stored
// 16 bytes per thread (scalar where Co % 8 != 0), masking ragged pixels and
// channels. With the pool, the 2x2 max is taken from the staged tile: BH,
// BW and the tile origin are even, so every window lies in one tile, and
// rounding is monotone, so round-then-max equals max-then-round. With a
// phase, phase (a, b) writes pixel (2i + a, 2j + b) of the (N, 2H, 2W, Co)
// output. StatsEpilogue (B7): y in f32 and per-tile channel sums and sums of
// squares, in a fixed order. HeadTapsEpilogue (U's fused head): the head's
// nine tap partials per pixel from a second product on the rounded tile.
// DequantActEpilogue (Q1-Q3): the s32 sums dequantised (dequant.cuh), the
// activation, R's pool or U's phase, stored in f32, with the max |y| of
// what is stored for the next layer's quantiser; or, under Q3's K split,
// the s32 sums stored as they are.
//
// The tile plan (BH, BW, BN, BK, stages, shared bytes) is computed once, by
// ops/conv_operands.py::tile_plan; the host side here only checks it against
// the layout below. The tensor maps are encoded per launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion,
// so the library links no libcuda.
#pragma once

#include <cuda.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "dequant.cuh"

namespace gr {
namespace wg {

constexpr int kBM = 128;                 // output pixels per block
constexpr int kConsumerWarps = 8;        // two warpgroups of 64 rows
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kAlign = 1024;             // the 128-byte swizzle's period
constexpr int kMaxSharedBytes = 232448;

// Everything a launch needs beyond its two tensor maps. The int8
// epilogue's max shares the slot of a field it does not read, so the struct
// keeps the 128 bytes the bf16 kernels were built with (a larger kernel
// parameter changes their code).
struct ConvArgs {
  const float* scale;
  const float* shift;
  const float* alpha;  // the PReLU slope, read with ACT_PRELU only
  __nv_bfloat16* out;  // BnActEpilogue's output
  int H, W, Co, act, pool;
  int bh, bw, bk, stages, kchunks;  // the plan; kchunks = ceil(C / bk)
  float* y32;  // StatsEpilogue's and DequantActEpilogue's output
  union {
    float* part_sum;     // StatsEpilogue's partials, [Co][tiles]
    unsigned int* amax;  // DequantActEpilogue: raised to max |y| stored, or
                         // null (dequant.cuh's raise_amax)
  };
  float* part_sq;
  const __nv_bfloat16* head_w;  // HeadTapsEpilogue's (rows, Co') weights
  float* taps;                  // its tap partials (see HeadTapsEpilogue)
  int cf;                       // the head's output channels
  const float* x_scale;  // DequantActEpilogue's activation scale (one f32)
};

// Bytes of one ring stage: the 128 x BK A tile and the BN x BK weight tile
// of ``eb``-byte elements (2 bf16, 1 int8), on the swizzle's period.
__host__ __device__ constexpr int stage_bytes(int bn, int bk, int eb = 2) {
  return (kBM * bk * eb + bn * bk * eb + kAlign - 1) / kAlign * kAlign;
}

// Shared bytes of a plan's layout: the alignment slack, the ring, its
// full/empty barriers. The epilogue's staged tile reuses the ring.
__host__ __device__ constexpr int smem_need(int bn, int bk, int stages,
                                            int eb = 2) {
  return kAlign + stages * stage_bytes(bn, bk, eb) + 16 * stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed. A wait that
// never ends is a fault of the pipeline: after 2^26 polls (seconds) the
// block traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Matrix descriptor of a K-major tile whose rows are bk * 2 bytes, swizzled
// as the tensor map swizzled it (layout 1, 2, 3: 128-, 64-, 32-byte), the
// 8-row groups ``sbo`` bytes apart; LBO is unused for swizzled K-major tiles.
__device__ __forceinline__ uint64_t make_desc(const void* tile, int layout,
                                              int sbo) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFF) << 32;
  d |= uint64_t(layout) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products' fences.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for A fragments held in registers: the product reads them
// asynchronously, so they must stay live until its wait.
template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The consumer warpgroups' own barrier (the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B from shared memory,
// both K-major; d is this thread's N / 2 accumulators.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// wgmma.mma_async m64nNk32, s32 += s8 x s8, A and B from shared memory,
// both K-major (s8 allows no other layout); d is this thread's N / 2 sums,
// in the same fragment layout as the f32 ones. The sums are exact: without
// .satfinite they wrap, which no int8 convolution here comes near (at most
// 127^2 * 16 * 512 < 2^31 at G's stage 1).
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The mainloop's operand type. A k step reads 32 bytes of every row of
// both tiles in both: kStep bf16 values (f32 sums, m64nNk16) or int8 values
// (s32 sums, m64nNk32), so the ring, the swizzles and the descriptors' K
// advance are the same; BK counts elements, kBytes bytes each.
struct Bf16Operands {
  using Acc = float;
  static constexpr int kStep = 16;
  static constexpr int kBytes = 2;
  template <int BN>
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
    Wgmma<BN>::mma(d, da, db);
  }
};

struct S8Operands {
  using Acc = int;
  static constexpr int kStep = 32;
  static constexpr int kBytes = 1;
  template <int BN>
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
    WgmmaS8<BN>::mma(d, da, db);
  }
};

// wgmma.mma_async m64n16k16, f32 += bf16 x bf16, A from registers (a[0..4),
// the m64k16 fragment: rows l / 4 and l / 4 + 8 of the warp's 16, columns
// 2 * (l % 4) + {0, 1} and those + 8, as mma.sync's A), B from shared memory
// (K-major). The A fragment of a k16 step is the accumulator layout of two
// neighbouring n8 column groups, so a tile's f32 sums become the next
// product's A without going through shared memory.
__device__ __forceinline__ void wgmma_rs16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- what stage ``it`` of a block reads ------------------------------------
//
// A tap policy maps stage ``it`` of the K loop (and the block's output phase,
// blockIdx.z, where there is one) to the A box's channel and pixel offset and
// the weight box's (K, slice) coordinate. The ring, the products and the
// epilogues do not depend on it.
struct StageCoord {
  int c0, dy, dx;  // the A box at (c0, j0 + dx, i0 + dy, n)
  int wk, wz;      // the weight box at (wk, co0, wz)
};

// Kernels B, B6 and B7: tap t = it / kchunks of a 3x3 conv, BK channels of
// it per stage; the weights (9, Co, C).
struct Conv3x3Taps {
  static constexpr int kTaps = 9;
  static __device__ __forceinline__ StageCoord at(int it, int kchunks, int bk,
                                                  int) {
    const int t = it / kchunks;
    const int c0 = (it - t * kchunks) * bk;
    return {c0, t / 3 - 1, t % 3 - 1, c0, t};
  }
};

// Kernel U: tap (ta, tb) of phase (a, b) reads input (a + ta - 1,
// b + tb - 1) with the phase kernel [a, ta, b, tb] of the (16, Co, C)
// weights.
struct PhaseTaps {
  static constexpr int kTaps = 4;
  static __device__ __forceinline__ StageCoord at(int it, int kchunks, int bk,
                                                  int phase) {
    const int t = it / kchunks;
    const int c0 = (it - t * kchunks) * bk;
    const int a = phase >> 1, b = phase & 1, ta = t >> 1, tb = t & 1;
    return {c0, a + ta - 1, b + tb - 1, c0, ((a * 2 + ta) * 2 + b) * 2 + tb};
  }
};

// Kernel B8: U's taps with each phase's four weight blocks stacked on K,
// (4 phases, Co, 4 * Kp) with tap t at [t * Kp, t * Kp + C) and Kp =
// kchunks * bk, so stage it reads K offset t * Kp + c0 = it * bk: one K loop
// of 4 * Kp over one contiguous weight row per output channel.
struct StackedPhaseTaps {
  static constexpr int kTaps = 4;
  static __device__ __forceinline__ StageCoord at(int it, int kchunks, int bk,
                                                  int phase) {
    const int t = it / kchunks;
    const int c0 = (it - t * kchunks) * bk;
    return {c0, (phase >> 1) + (t >> 1) - 1, (phase & 1) + (t & 1) - 1,
            it * bk, phase};
  }
};

// Kernels Q3 (quant.cu) and D (dense.cu): a dense layer (N, K') x (K', M)
// as a one-tap 1x1 convolution over one image of 1 x N pixels and K'
// channels (the tile is 1 x 128 rows of x); blockIdx.z is the K split,
// whose ``kchunks`` stages start at chunk z * kchunks. The weights are (1,
// M, K').
struct DenseTaps {
  static constexpr int kTaps = 1;
  static __device__ __forceinline__ StageCoord at(int it, int kchunks, int bk,
                                                  int split) {
    const int c0 = (split * kchunks + it) * bk;
    return {c0, 0, 0, c0, 0};
  }
};

// The block's place: the 128-pixel tile blockIdx.x (image-major, then tile
// rows, then tile columns) of image n at (i0, j0), output channels co0 ..
// co0 + BN (blockIdx.y) and the output phase blockIdx.z.
struct Tile {
  int n, i0, j0, co0, phase;
};

__device__ __forceinline__ Tile block_tile(const ConvArgs& p, int bn) {
  const int tiles_w = (p.W + p.bw - 1) / p.bw;
  const int tiles_h = (p.H + p.bh - 1) / p.bh;
  const int tj = blockIdx.x % tiles_w;
  const int ti = (blockIdx.x / tiles_w) % tiles_h;
  return {static_cast<int>(blockIdx.x / tiles_w / tiles_h), ti * p.bh,
          tj * p.bw, static_cast<int>(blockIdx.y) * bn,
          static_cast<int>(blockIdx.z)};
}

// Row ``row`` of this consumer thread's accumulators: wgmma's m64nN layout
// gives lane l of warp w rows (w & 3) * 16 + l / 4 and that + 8 of its
// warpgroup's 64, columns j * 8 + 2 * (l % 4) + {0, 1}, in acc[j * 4 +
// {0, 1}] and acc[j * 4 + {2, 3}].
__device__ __forceinline__ int acc_row(int warp, int lane) {
  return (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
}

// Eight staged bf16 values to out[0..min(8, left)), 16 bytes at once when
// Co % 8 == 0 keeps the destination aligned.
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, int left,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < left) dst[e] = src[e];
  }
}

// Four staged f32 values to out[0..min(4, left)), 16 bytes at once when
// Co % 4 == 0.
__device__ __forceinline__ void store4(float* dst, const float* src, int left,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) dst[e] = src[e];
  }
}

// ---- the epilogues ---------------------------------------------------------
//
// Each runs on the 256 consumer threads once both warpgroups are done with
// the ring (``buf``, free to reuse), with this thread's accumulators. Its
// prologue runs on the same threads before the first stage arrives.

// Kernels B, B6, U and B8: acc * scale + shift, the activation, one rounding
// to bf16, staged as [128][BN + 8]; with the pool, the 2x2 max from the
// staged tile; with kPhase, phase (a, b) writes pixel (2i + a, 2j + b) of
// the (N, 2H, 2W, Co) output. With kDense (kernel D, dense.cu): scale 1,
// the BatchNorm folded into the weights, so acc + shift, and the activation
// as PyTorch computes it (common.cuh's torch_act).
template <bool kPhase, bool kDense = false>
struct BnActEpilogue {
  template <int BN>
  static __device__ __forceinline__ void prologue(unsigned char*, const Tile&,
                                                  const ConvArgs&) {}
  template <int BN>
  static __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                             unsigned char* buf, const Tile& t,
                                             const ConvArgs& p) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    constexpr int kLdc = BN + 8;
    __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(buf);
    const float slope = p.act == ACT_PRELU ? *p.alpha : 0.0f;
    const int row_base = acc_row(warp, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const int co = t.co0 + col;
      const float sc0 = !kDense && co < p.Co ? p.scale[co] : 0.0f;
      const float sh0 = co < p.Co ? p.shift[co] : 0.0f;
      const float sc1 = !kDense && co + 1 < p.Co ? p.scale[co + 1] : 0.0f;
      const float sh1 = co + 1 < p.Co ? p.shift[co + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = acc[j * 4 + 2 * h], a1 = acc[j * 4 + 2 * h + 1];
        const float v0 = kDense ? torch_act(a0 + sh0, p.act)
                                : apply_act(fmaf(a0, sc0, sh0), p.act, slope);
        const float v1 = kDense ? torch_act(a1 + sh1, p.act)
                                : apply_act(fmaf(a1, sc1, sh1), p.act, slope);
        *reinterpret_cast<__nv_bfloat162*>(cs + (row_base + 8 * h) * kLdc +
                                           col) = __floats2bfloat162_rn(v0, v1);
      }
    }
    consumer_sync();

    constexpr int kVecs = BN / 8;
    const int H = p.H, W = p.W, Co = p.Co;
    const bool vec = Co % 8 == 0;
    if (!kPhase && p.pool) {
      const int pw = p.bw / 2;
      for (int c = tid; c < (kBM / 4) * kVecs; c += kConsumerThreads) {
        const int pr = c / kVecs, v = c - pr * kVecs;
        const int py = pr / pw, px = pr - py * pw;
        const int P = t.i0 / 2 + py, Q = t.j0 / 2 + px, co = t.co0 + v * 8;
        if (P >= H / 2 || Q >= W / 2 || co >= Co) continue;
        const __nv_bfloat16* s0 =
            cs + ((2 * py) * p.bw + 2 * px) * kLdc + v * 8;
        const __nv_bfloat16* s2 = s0 + p.bw * kLdc;
        __align__(16) __nv_bfloat16 m[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          m[e] = __float2bfloat16(fmaxf(
              fmaxf(__bfloat162float(s0[e]), __bfloat162float(s0[kLdc + e])),
              fmaxf(__bfloat162float(s2[e]), __bfloat162float(s2[kLdc + e]))));
        const long long pix =
            (static_cast<long long>(t.n) * (H / 2) + P) * (W / 2) + Q;
        store8(p.out + pix * Co + co, m, Co - co, vec);
      }
    } else {
      const int pa = t.phase >> 1, pb = t.phase & 1;
      for (int c = tid; c < kBM * kVecs; c += kConsumerThreads) {
        const int row = c / kVecs, v = c - row * kVecs;
        const int pi = t.i0 + row / p.bw, pj = t.j0 + row % p.bw;
        const int co = t.co0 + v * 8;
        if (pi >= H || pj >= W || co >= Co) continue;
        const long long pix =
            kPhase ? ((static_cast<long long>(t.n) * 2 * H + 2 * pi + pa) * 2 *
                          W +
                      2 * pj + pb)
                   : ((static_cast<long long>(t.n) * H + pi) * W + pj);
        store8(p.out + pix * Co + co, cs + row * kLdc + v * 8, Co - co, vec);
      }
    }
  }
};

// Kernel B7: y = acc in f32, and this tile's per-channel sum and sum of
// squares over its pixels inside the image, taken from the accumulators in a
// fixed order (no float atomics, so two runs are bitwise equal):
//  1. each thread adds its two rows of a column (ragged pixels masked to 0:
//     their taps reach back into the image, so their sums are not 0);
//  2. __shfl_xor_sync over lane bits 2, 3 and 4 adds the warp's 8 row pairs
//     as a fixed tree, giving the warp's 16-row column sums;
//  3. one thread per column adds the 8 warps in warp order from [2][8][BN]
//     in the freed ring, and writes partial[co][blockIdx.x] (gridDim.x is
//     the number of tiles), which conv_stats_finish_kernel sums over tiles;
//  4. y is staged as f32 [128][BN + 4] through the ring and stored 16 bytes
//     a thread, ragged pixels and channels masked.
struct StatsEpilogue {
  template <int BN>
  static __device__ __forceinline__ void prologue(unsigned char*, const Tile&,
                                                  const ConvArgs&) {}
  template <int BN>
  static __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                             unsigned char* buf, const Tile& t,
                                             const ConvArgs& p) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = acc_row(warp, lane);
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      in[h] = t.i0 + row / p.bw < p.H && t.j0 + row % p.bw < p.W;
    }
    float* red = reinterpret_cast<float*>(buf);  // sums, then squares
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = in[0] ? acc[j * 4 + e] : 0.0f;
        const float v1 = in[1] ? acc[j * 4 + 2 + e] : 0.0f;
        float s = v0 + v1;
        float q = fmaf(v1, v1, v0 * v0);
#pragma unroll
        for (int m = 4; m <= 16; m <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, m);
          q += __shfl_xor_sync(0xffffffffu, q, m);
        }
        if (lane < 4) {
          const int col = j * 8 + 2 * lane + e;
          red[warp * BN + col] = s;
          red[(kConsumerWarps + warp) * BN + col] = q;
        }
      }
    }
    consumer_sync();
    if (tid < BN && t.co0 + tid < p.Co) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        s += red[w * BN + tid];
        q += red[(kConsumerWarps + w) * BN + tid];
      }
      const long long at =
          static_cast<long long>(t.co0 + tid) * gridDim.x + blockIdx.x;
      p.part_sum[at] = s;
      p.part_sq[at] = q;
    }
    consumer_sync();

    constexpr int kLdc = BN + 4;
    float* cs = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (row0 + 8 * h) * kLdc + col) =
            make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
    }
    consumer_sync();
    constexpr int kVecs = BN / 4;
    const bool vec = p.Co % 4 == 0;
    for (int c = tid; c < kBM * kVecs; c += kConsumerThreads) {
      const int row = c / kVecs, v = c - row * kVecs;
      const int pi = t.i0 + row / p.bw, pj = t.j0 + row % p.bw;
      const int co = t.co0 + v * 4;
      if (pi >= p.H || pj >= p.W || co >= p.Co) continue;
      const long long pix = (static_cast<long long>(t.n) * p.H + pi) * p.W + pj;
      store4(p.y32 + pix * p.Co + co, cs + row * kLdc + v * 4, p.Co - co, vec);
    }
  }
};

// Kernel U's fused head (bf16): in place of U's output, the tap partials
// of the head's 3x3 Co -> Cf conv over this tile's U pixels,
//
//   taps[cb][phase][n][i][j][t * Cf + f] =
//       sum_{c in channel block cb} fk[t / 3][t % 3][c][f] * u[n, 2i + a, 2j + b, c]
//
// with u = act(acc * scale + shift) rounded once to bf16 (the TPU kernel's
// rounding of U's output), cb = blockIdx.y and phase = 2a + b = blockIdx.z.
// The rounded sums go from the accumulators straight into a second product
// as its A fragments (wgmma_rs16), against the head's weights laid out
// K-major as (rows, Co'): row t * Cf + f, rows = 9 Cf rounded up to 16,
// Co' = Co rounded up to BN (ops/conv_operands.py::head_weights). The
// prologue copies the block's BN columns of them into shared memory behind
// the ring and its barriers, in the 128-byte swizzle, 64 channels a chunk.
// The partials (27 f32 a pixel at Cf = 3, against U's 128 bf16 channels) are
// staged as f32 [128][9 Cf] in the freed ring and stored with ragged pixels
// masked; upsample_conv.cu's finish launch adds each output pixel's in-image
// neighbours.
constexpr int kHeadMaxBN = 128;     // the head is built for BN 16 to 128
constexpr int kHeadMaxChunks = 3;   // n16 column groups: 9 * Cf <= 48

__host__ __device__ constexpr int head_rows(int cf) {
  return 16 * ((9 * cf + 15) / 16);
}

// Offset of the head's weight tile from the aligned base: behind the ring
// and its barriers, on the swizzle's period.
__host__ __device__ constexpr int head_w_offset(int bn, int bk, int stages) {
  return (stages * (stage_bytes(bn, bk) + 16) + kAlign - 1) / kAlign * kAlign;
}

__host__ __device__ constexpr int head_w_bytes(int bn, int cf) {
  return (bn + 63) / 64 * head_rows(cf) * 128;
}

struct HeadTapsEpilogue {
  template <int BN>
  static __device__ __forceinline__ void prologue(unsigned char* buf,
                                                  const Tile& t,
                                                  const ConvArgs& p) {
    unsigned char* fw = buf + head_w_offset(BN, p.bk, p.stages);
    const int rows = head_rows(p.cf);
    const long long ld = static_cast<long long>(gridDim.y) * BN;  // Co'
    constexpr int kVecs = BN / 8;  // 16-byte pieces of a row's BN channels
    for (int i = threadIdx.x; i < rows * kVecs; i += kConsumerThreads) {
      const int r = i / kVecs, v = i - r * kVecs;
      const uint4 val = *reinterpret_cast<const uint4*>(p.head_w + r * ld +
                                                        t.co0 + v * 8);
      // chunk v / 8 of 64 channels; piece v % 8 of row r lands at piece
      // (v % 8) ^ (r % 8), as TMA's 128-byte swizzle would put it
      *reinterpret_cast<uint4*>(fw + (v >> 3) * rows * 128 + r * 128 +
                                (((v & 7) ^ (r & 7)) << 4)) = val;
    }
    // written by the generic proxy, read by wgmma (the async proxy) after
    // the consumers' barrier that ends the mainloop
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }

  template <int BN>
  static __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                             unsigned char* buf, const Tile& t,
                                             const ConvArgs& p) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // 1. u in bf16 as the A fragments of BN / 16 k16 steps: step kk takes
    //    the n8 groups 2 kk (registers 0, 1) and 2 kk + 1 (2, 3)
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = t.co0 + j * 8 + 2 * (lane & 3);
      const float sc0 = co < p.Co ? p.scale[co] : 0.0f;
      const float sh0 = co < p.Co ? p.shift[co] : 0.0f;
      const float sc1 = co + 1 < p.Co ? p.scale[co + 1] : 0.0f;
      const float sh1 = co + 1 < p.Co ? p.shift[co + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // channels past Co give act(0), against weight columns of zero
        __nv_bfloat162 u = __floats2bfloat162_rn(
            apply_act(fmaf(acc[j * 4 + 2 * h], sc0, sh0), p.act),
            apply_act(fmaf(acc[j * 4 + 2 * h + 1], sc1, sh1), p.act));
        a[j >> 1][(j & 1) * 2 + h] = *reinterpret_cast<uint32_t*>(&u);
      }
    }

    // 2. the second product, one n16 column group of the taps at a time
    const unsigned char* fw = buf + head_w_offset(BN, p.bk, p.stages);
    const int rows = head_rows(p.cf);
    float d[kHeadMaxChunks][8];
#pragma unroll
    for (int c = 0; c < kHeadMaxChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[c][i] = 0.0f;
      fence_operands(d[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kHeadMaxChunks; ++c) {
      if (c * 16 >= rows) break;  // the same in every thread
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs16(d[c], a[kk],
                   make_desc(fw + (kk >> 2) * rows * 128 + c * 2048, 1, 1024) +
                       2 * (kk & 3));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(a);
#pragma unroll
    for (int c = 0; c < kHeadMaxChunks; ++c) fence_operands(d[c]);

    // 3. staged as f32 [128][9 Cf] in the freed ring, stored a row piece
    //    at a time (a tile row of BW pixels is contiguous in taps)
    const int ld = 9 * p.cf;
    float* cs = reinterpret_cast<float*>(buf);
    const int row0 = acc_row(warp, lane);
#pragma unroll
    for (int c = 0; c < kHeadMaxChunks; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * 16 + j * 8 + 2 * (lane & 3) + e;
            if (col < ld) cs[(row0 + 8 * h) * ld + col] = d[c][j * 4 + 2 * h + e];
          }
    consumer_sync();
    const int tiles = ((p.W + p.bw - 1) / p.bw) * ((p.H + p.bh - 1) / p.bh);
    const long long images = gridDim.x / tiles;
    float* dst = p.taps + ((static_cast<long long>(blockIdx.y) * 4 + t.phase) *
                               images + t.n) * p.H * p.W * ld;
    for (int i = tid; i < kBM * ld; i += kConsumerThreads) {
      const int row = i / ld, col = i - row * ld;
      const int pi = t.i0 + row / p.bw, pj = t.j0 + row % p.bw;
      if (pi < p.H && pj < p.W)
        dst[(static_cast<long long>(pi) * p.W + pj) * ld + col] = cs[i];
    }
  }
};

// Four staged f32 values to out[0..min(4, left)), as store4 does, and
// their max |v| folded into ``m`` from the registers that are stored: a
// read of the staged tile after the store would wait for the store, since
// neither pointer is known to be shared or global.
__device__ __forceinline__ void store4_max(float* dst, const float* src,
                                           int left, bool vec, float& m) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<float4*>(dst) = v;
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w))));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) {
        const float v = src[e];
        dst[e] = v;
        m = fmaxf(m, fabsf(v));
      }
  }
}

// Kernels Q1, Q2 and Q3 (quant.cu): the int8 products' exact s32 sums
// dequantised by dequant.cuh's dequant_act, deq = x_scale * w_scale[c]
// (``scale``) and bias[c] (``shift``), then the activation; staged as f32
// [128][BN + 4] on the freed ring and stored 16 bytes a thread (scalar where
// Co % 4 != 0) into ``y32``, ragged pixels and channels masked. With the
// pool (Q1), the 2x2 max from the staged tile, exact in f32; with kPhase
// (Q2), phase (a, b) writes pixel (2i + a, 2j + b) of the (N, 2H, 2W, Co)
// output. With ``amax``, the max of |y| over the values this block stores
// (after the activation, the pool and the phase interleave; nothing of a
// ragged pixel or channel), reduced over the warp by shuffles and over the
// block through the staged tile's first words, raises *amax once
// (raise_amax): the next layer's activation scale without reading y again.
template <bool kPhase>
struct DequantActEpilogue {
  template <int BN>
  static __device__ __forceinline__ void prologue(unsigned char*, const Tile&,
                                                  const ConvArgs&) {}
  template <int BN>
  static __device__ __forceinline__ void run(int (&acc)[BN / 2],
                                             unsigned char* buf, const Tile& t,
                                             const ConvArgs& p) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    constexpr int kLdc = BN + 4;
    float* cs = reinterpret_cast<float*>(buf);
    const float xs = *p.x_scale;
    const int row0 = acc_row(warp, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const int co = t.co0 + col;
      const float dq0 = co < p.Co ? __fmul_rn(xs, p.scale[co]) : 0.0f;
      const float b0 = co < p.Co ? p.shift[co] : 0.0f;
      const float dq1 = co + 1 < p.Co ? __fmul_rn(xs, p.scale[co + 1]) : 0.0f;
      const float b1 = co + 1 < p.Co ? p.shift[co + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(cs + (row0 + 8 * h) * kLdc + col) =
            make_float2(dequant_act(acc[j * 4 + 2 * h], dq0, b0, p.act),
                        dequant_act(acc[j * 4 + 2 * h + 1], dq1, b1, p.act));
      }
    }
    consumer_sync();

    constexpr int kVecs = BN / 4;
    const int H = p.H, W = p.W, Co = p.Co;
    const bool vec = Co % 4 == 0;
    float* y = p.y32;
    float m = 0.0f;  // max |y| over what this thread stores
    if (!kPhase && p.pool) {
      const int pw = p.bw / 2;
      for (int c = tid; c < (kBM / 4) * kVecs; c += kConsumerThreads) {
        const int pr = c / kVecs, v = c - pr * kVecs;
        const int py = pr / pw, px = pr - py * pw;
        const int P = t.i0 / 2 + py, Q = t.j0 / 2 + px, co = t.co0 + v * 4;
        if (P >= H / 2 || Q >= W / 2 || co >= Co) continue;
        const float* s0 = cs + ((2 * py) * p.bw + 2 * px) * kLdc + v * 4;
        const float* s2 = s0 + p.bw * kLdc;
        __align__(16) float mv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mv[e] = fmaxf(fmaxf(s0[e], s0[kLdc + e]), fmaxf(s2[e], s2[kLdc + e]));
        const long long pix =
            (static_cast<long long>(t.n) * (H / 2) + P) * (W / 2) + Q;
        store4_max(y + pix * Co + co, mv, Co - co, vec, m);
      }
    } else {
      const int pa = t.phase >> 1, pb = t.phase & 1;
      for (int c = tid; c < kBM * kVecs; c += kConsumerThreads) {
        const int row = c / kVecs, v = c - row * kVecs;
        const int pi = t.i0 + row / p.bw, pj = t.j0 + row % p.bw;
        const int co = t.co0 + v * 4;
        if (pi >= H || pj >= W || co >= Co) continue;
        const long long pix =
            kPhase ? ((static_cast<long long>(t.n) * 2 * H + 2 * pi + pa) * 2 *
                          W +
                      2 * pj + pb)
                   : ((static_cast<long long>(t.n) * H + pi) * W + pj);
        store4_max(y + pix * Co + co, cs + row * kLdc + v * 4, Co - co, vec,
                   m);
      }
    }
    if (p.amax != nullptr) {  // the same in every thread
      m = warp_max(m);
      consumer_sync();  // the staged tile is read: its first words are free
      if (lane == 0) cs[warp] = m;
      consumer_sync();
      if (tid == 0) {
#pragma unroll
        for (int w = 1; w < kConsumerWarps; ++w) m = fmaxf(m, cs[w]);
        raise_amax(p.amax, m);
      }
    }
  }
};

// The sums' bits as an f32 word: D's f32 sums as they are, Q3's s32 sums
// bit for bit.
__device__ __forceinline__ float sum_bits(float a) { return a; }
__device__ __forceinline__ float sum_bits(int a) { return __int_as_float(a); }

// Kernels Q3 (quant.cu, s32 sums) and D (dense.cu, f32 sums) under a K
// split: a dense tile's sums as they are, staged as [128][BN + 4] words on
// the freed ring and stored 16 bytes a thread (scalar where Co % 4 != 0) as
// split blockIdx.z's (W, Co) slice of ``y32``, ragged rows and columns
// masked, for the kernel's sum launch to add in split order.
struct SplitSumsEpilogue {
  template <int BN>
  static __device__ __forceinline__ void prologue(unsigned char*, const Tile&,
                                                  const ConvArgs&) {}
  template <int BN, typename Acc>
  static __device__ __forceinline__ void run(Acc (&acc)[BN / 2],
                                             unsigned char* buf, const Tile& t,
                                             const ConvArgs& p) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    constexpr int kLdc = BN + 4;
    float* cs = reinterpret_cast<float*>(buf);
    const int row0 = acc_row(warp, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (row0 + 8 * h) * kLdc + col) =
            make_float2(sum_bits(acc[j * 4 + 2 * h]),
                        sum_bits(acc[j * 4 + 2 * h + 1]));
    }
    consumer_sync();
    constexpr int kVecs = BN / 4;
    const bool vec = p.Co % 4 == 0;
    float* part = p.y32 + static_cast<long long>(t.phase) * p.W * p.Co;
    for (int c = tid; c < kBM * kVecs; c += kConsumerThreads) {
      const int row = c / kVecs, v = c - row * kVecs;
      const int r = t.j0 + row, co = t.co0 + v * 4;
      if (r >= p.W || co >= p.Co) continue;
      store4(part + static_cast<long long>(r) * p.Co + co,
             cs + row * kLdc + v * 4, p.Co - co, vec);
    }
  }
};

// ---- the mainloop ------------------------------------------------------------

// One block: the tile of block_tile, its K loop of Taps::kTaps * kchunks
// stages through the ring, then Epilogue on the sums (f32 for bf16
// operands, s32 for int8: Op).
template <int BN, class Taps, class Epilogue, class Op = Bf16Operands>
__device__ __forceinline__ void conv_wgmma_body(const CUtensorMap& xmap,
                                                const CUtensorMap& wmap,
                                                const ConvArgs& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* buf =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int a_bytes = kBM * p.bk * Op::kBytes;
  const int b_bytes = BN * p.bk * Op::kBytes;
  const int sbytes = stage_bytes(BN, p.bk, Op::kBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + p.stages * sbytes);
  uint64_t* empty = full + p.stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tile t = block_tile(p, BN);
  const int iters = Taps::kTaps * p.kchunks;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
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
        const StageCoord o = Taps::at(it, p.kchunks, p.bk, t.phase);
        unsigned char* sa = buf + stage * sbytes;
        mbar_wait(&empty[stage], phase ^ 1u);
        mbar_expect_tx(&full[stage], a_bytes + b_bytes);
        tma_load_4d(sa, &xmap, &full[stage], o.c0, t.j0 + o.dx, t.i0 + o.dy,
                    t.n);
        tma_load_3d(sa + a_bytes, &wmap, &full[stage], o.wk, t.co0, o.wz);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wgi owns rows wgi * 64 .. + 64 of the tile
  Epilogue::template prologue<BN>(buf, t, p);
  const int wgi = warp >> 2;
  // rows of 128, 64 or 32 bytes: the 128-, 64- or 32-byte swizzle
  const int layout =
      p.bk == 4 * Op::kStep ? 1 : (p.bk == 2 * Op::kStep ? 2 : 3);
  const int sbo = 8 * p.bk * Op::kBytes;
  typename Op::Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_operands(acc);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(&full[stage], phase);
    const unsigned char* sa = buf + stage * sbytes;
    const uint64_t da =
        make_desc(sa + wgi * 64 * p.bk * Op::kBytes, layout, sbo);
    const uint64_t db = make_desc(sa + a_bytes, layout, sbo);
    wgmma_fence();
    // each k step is 32 bytes further along the rows: +2 in 16-byte units
    for (int kk = 0; kk < p.bk / Op::kStep; ++kk)
      Op::template mma<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (it > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  consumer_sync();  // both warpgroups are done reading the ring
  Epilogue::template run<BN>(acc, buf, t, p);
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A plan as the wrapper computed it (ops/conv_operands.py::tile_plan).
struct Plan {
  int bh, bw, bn, bk, stages, smem;
};

// Bytes of the epilogue's staged tile, [128][BN] of out_bytes each (2 for
// bf16, 4 for B7's f32) with 16 bytes of padding per row.
__host__ __device__ constexpr int staged_bytes(int bn, int out_bytes) {
  return kBM * (bn * out_bytes + 16);
}

// Does the plan fit this layout? (the tile, the widths the kernel is built
// for, rows of 32, 64 or 128 bytes of ``elem_bytes``-byte operands, even
// sides with the pool, the staged tile inside the ring, and the shared
// bytes of the layout within what the plan asks for and the card has)
inline bool plan_ok(const Plan& pl, bool pool, int out_bytes = 2,
                    int elem_bytes = 2) {
  const int row = pl.bk * elem_bytes;
  return pl.bh * pl.bw == kBM && pl.bh > 0 &&
         (pl.bn == 16 || pl.bn == 32 || pl.bn == 64 || pl.bn == 128 ||
          pl.bn == 256) &&
         (row == 32 || row == 64 || row == 128) && pl.stages >= 2 &&
         (!pool || (pl.bh % 2 == 0 && pl.bw % 2 == 0)) &&
         staged_bytes(pl.bn, out_bytes) <=
             pl.stages * stage_bytes(pl.bn, pl.bk, elem_bytes) &&
         smem_need(pl.bn, pl.bk, pl.stages, elem_bytes) <= pl.smem &&
         pl.smem <= kMaxSharedBytes;
}

// Does a plan fit HeadTapsEpilogue's layout? (plan_ok, BN at most 128, the
// staged f32 partials inside the ring, the head's weight tile behind the
// ring and its barriers within the plan's bytes)
inline bool head_plan_ok(const Plan& pl, int cf) {
  return plan_ok(pl, false) && pl.bn <= kHeadMaxBN && cf >= 1 &&
         cf <= 4 && kBM * 9 * cf * 4 <= pl.stages * stage_bytes(pl.bn, pl.bk) &&
         kAlign + head_w_offset(pl.bn, pl.bk, pl.stages) +
                 head_w_bytes(pl.bn, cf) <= pl.smem;
}

// Tiled map over a tensor of bf16 (elem_bytes 2) or int8 (1, carried as
// uint8: the bits as they are, the sign the instruction's business) whose
// dims (innermost first) are dims[0..r) and whose innermost dim is
// contiguous; box box[0..r), the innermost bk elements, swizzled by their
// bytes.
inline bool encode_map(CUtensorMap* map, const void* base, int rank,
                       const long long* dims, const int* box, int bk,
                       int elem_bytes = 2) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0)
    return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4], estride[4];
  long long stride = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
    stride *= dims[i];
    if (i + 1 < rank) gstride[i] = static_cast<cuuint64_t>(stride);
  }
  const int row = bk * elem_bytes;
  const CUtensorMapSwizzle sw =
      row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUtensorMapDataType type = elem_bytes == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, static_cast<cuuint32_t>(rank),
            const_cast<void*>(base), gdim, gstride, gbox, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The two maps of a launch: x (N, H, W, C) with box (bk, bw, bh, 1), and the
// K-major weights (slices, Co, K) with box (bk, bn, 1); rows (C and K) a
// multiple of 16 bytes, as TMA's strides must be.
inline bool encode_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x,
                        const void* w, int n, int h, int wd, int c, int co,
                        int k, int slices, const Plan& pl,
                        int elem_bytes = 2) {
  const long long xd[4] = {c, wd, h, n};
  const int xb[4] = {pl.bk, pl.bw, pl.bh, 1};
  const long long wdims[3] = {k, co, slices};
  const int wb[3] = {pl.bk, pl.bn, 1};
  return c * elem_bytes % 16 == 0 && k * elem_bytes % 16 == 0 &&
         encode_map(xmap, x, 4, xd, xb, pl.bk, elem_bytes) &&
         encode_map(wmap, w, 3, wdims, wb, pl.bk, elem_bytes);
}

// The launch grid of a plan: one block per tile and BN channels, ``phases``
// output phases on z.
inline dim3 plan_grid(const Plan& pl, int n, int h, int w, int co,
                      int phases) {
  const long long tiles = static_cast<long long>(n) * ((h + pl.bh - 1) / pl.bh) *
                          ((w + pl.bw - 1) / pl.bw);
  return dim3(static_cast<unsigned>(tiles),
              static_cast<unsigned>((co + pl.bn - 1) / pl.bn),
              static_cast<unsigned>(phases));
}

// One launch of ``kernel`` (a __global__ of (xmap, wmap, args)) with the
// plan's dynamic shared bytes.
template <class Kernel>
inline cudaError_t launch(Kernel kernel, dim3 grid, int smem,
                          cudaStream_t stream, const CUtensorMap& xmap,
                          const CUtensorMap& wmap, const ConvArgs& args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(xmap, wmap, args);
  return cudaGetLastError();
}

// f(std::integral_constant<int, BN>{}) for the plan's BN (plan_ok checked
// that it is one the kernels are built for).
template <class F>
inline cudaError_t by_width(int bn, F f) {
  switch (bn) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

}  // namespace wg
}  // namespace gr
