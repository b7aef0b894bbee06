// The package's tensor-core GEMM, written for Hopper (sm_90a): TMA loads
// into a ring of shared-memory stages, wgmma products on the tensor cores.
// bf16 operands accumulate in fp32; int8 operands (T1) in int32.  It runs
// every bf16 product of the package's kernels:
//
//   G1 qkv[t] = T(y @ Wqkv[t] + bqkv[t])   y [M, D], Wqkv held [K, N], 3 towers
//   G2 out    = T(x + o @ Wout + bout)     Wout held [K, N]
//   G3 do     = T(g @ Wout^T)              Wout held [N, K]
//   G4 dWqkv[t] = y^T d_t                  fp32 partials over fixed row chunks,
//                                          summed in a fixed order; dWout =
//                                          o^T g the same over one tower
//   G5 dY     = sum_t d_t Wqkv[t]^T        fp32, 3 segments
//
// in the attention block's kernels (B1, B3, B2); the MLP block's two
// (mlp_block.cu, B4):
//
//   fc   h_pre = T(y @ W1 + b1)            y [M, D], W1 held [K, N] = [D, Hd]
//   proj out   = T(x + (h @ W2 + b2))      h = T(quick_gelu(h_pre)), W2 held
//                                          [K, N] = [Hd, D]; the bias first
//
// and the probes' (score_depth.cu, probe_gemm.cu):
//
//   T1 c      = a @ b                      bf16: fp32 out, b held [K, N];
//                                          int8: int32 out, b transposed to
//                                          [N, K]
//   T2 o[b]   = q[b] k[b]^T                fp32 [L, L] a tower, both K-major
//   T3 out    = T(x @ w)                   x [B R, D] flat, w held [K, N]
//
// What bounds them on the H100: at the vision shape (M = 256 x 197 rows, D =
// 768) G1 is 178 GFLOP against ~0.3 GB moved, 0.18 ms of tensor-core time and
// 0.09 ms of bytes, so the tensor cores bound the ideal kernel; G2, G3 and G5
// are a third of G1 each, G4 is G1 with the contraction over the rows, B4's
// two products 4/3 of G1 each.  T1's 4-byte output makes its int8 form bound
// by bytes.
//
// The design, the usual shape of a fast Hopper kernel:
//
// * Persistent: one block an SM walks output tiles of 128 x 256 (128 x 128
//   where N is not a multiple of 256, 128 x 64 where N is an odd multiple
//   of 64: a head shard of an odd number of heads) with 12 warps: two consumer
//   warpgroups (64 rows each) and one producer warpgroup, of which one
//   thread walks the contraction one k-tile (128 bytes: 64 bf16 or 128 int8)
//   at a time and issues the TMA copies (cp.async.bulk.tensor, 128-byte
//   swizzle) of each k-tile's A and B into a ring of 3-4 stages, each
//   guarded by an mbarrier pair: `full` completes when the stage's bytes
//   have landed, `empty` when both consumers have finished reading it.  The
//   producer runs on into the next tile while the consumers store the last
//   one.  setmaxnreg moves the producer's registers to the consumers (128
//   accumulators a thread at 256 wide).
// * The consumers run wgmma.mma_async (m64nNk16 bf16 into fp32, m64nNk32 s8
//   into s32: both 32 bytes of the contraction a step) on each stage that
//   has landed, keep one k-tile's products in flight (wgmma.wait_group 1)
//   and then free the stage before.
// * Operands are K-major (the contraction contiguous) or MN-major (rows or
//   columns contiguous, wgmma's transpose, bf16 only: for 8-bit types wgmma
//   takes both operands K-major and has no transpose); both sit in shared
//   memory the way TMA's 128-byte swizzle lays them out, and the wgmma
//   descriptors say so.
// * The epilogue is common.cuh's: the fp32 sum, then each __fadd_rn of the
//   bias / residual in gemm_store's order, then one rounding.  A bf16 output
//   is written into a swizzled shared-memory tile (the residual's tile read
//   into it first by TMA) and stored by TMA, which drains while the block
//   goes on; a 4-byte one (fp32, int32: G4, G5, T1) goes the same way in
//   32-column chunks, except in a launch with ragged columns (T2, below),
//   which stores it from the accumulators.  Rows past M, and a contraction
//   past K, load as zeros (TMA's out-of-bounds fill); rows past M are not
//   stored.
//   Nothing is summed with atomics, so a product repeats bit for bit.
// * N is a multiple of 64 (128 in int8), except in a launch that asks for ragged columns
//   (kRagged, an fp32 output with no bias or residual: T2's N = L = 197 or
//   208; the other products compile without it).  There the last column
//   tile is ragged, B's rows past N load as zeros and columns past N are
//   not stored.  An even N stores pairs from the accumulators; an odd N
//   (rows 4-byte aligned only) stores each value alone, in every tile.  A
//   ragged N up to 256 takes one 256-wide tile, so A's rows are read once.
//
// Clusters with multicast loads and a ping-pong schedule of the two
// consumers (one's epilogue under the other's products) are later work.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is reached through the runtime)

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace flyp {
namespace sm90 {

constexpr int kSwizzleRow = 128, kSwizzleAtom = 8 * kSwizzleRow;
constexpr int kBM = 128;  // output rows of a tile
// The k-tile of an operand type: one swizzle row, 64 bf16 or 128 int8.
template <typename TIn>
constexpr int kTileK = kSwizzleRow / (int)sizeof(TIn);
constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer warpgroup
// Registers a thread after setmaxnreg: the producer gives up what the
// consumers' 128 accumulators need (128 x 40 + 256 x 232 <= 65,536).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kATile = kBM * kSwizzleRow;        // A's k-tile: 16 KB
constexpr int kChunk = kATile / 2;               // 64 rows (K-major) or a 64-wide chunk (MN-major)

// Output tiles 128 x kBN, one block an SM.  A bf16 output is written through
// shared memory by TMA stores (kStaged), which drain while the block goes on
// to its next tile.  A 4-byte one goes the same way, two 32-column chunks
// of a warpgroup's 64 rows at a time (kStaged4), unless its columns are
// ragged (kRagged, T2): a tensor map needs rows of a multiple of 16 bytes,
// which an odd N's are not, so those tiles store from the accumulators.
constexpr int kChunks4 = 2;                        // 4-byte chunks staged at once by a warpgroup
constexpr int kChunk4 = 64 * kSwizzleRow;          // one: [64 rows][32 columns], 8 KB
template <int kBN_, typename TOut, bool kRagged>
struct Tile {
  static constexpr int kBN = kBN_;
  static constexpr bool kStaged = sizeof(TOut) == 2;
  static constexpr bool kStaged4 = sizeof(TOut) == 4 && !kRagged;
  // A 256-wide bf16 tile's 64 KB of output leaves room for 3 stages; a
  // 4-byte one stages 32 KB at a time, which leaves room for 4.
  static constexpr int kStages = kStaged && kBN == 256 ? 3 : 4;
  static constexpr int kStageBytes = kATile + kBN * kSwizzleRow;
  static constexpr int kOutBytes = kStaged ? kBM * kBN * 2                // 128-byte swizzled 64-column chunks
                                   : kStaged4 ? kConsumers * kChunks4 * kChunk4 : 0;
  static constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 1024;  // + alignment to 1024 bytes
};

struct Args {
  int M, N, K, towers, nseg, splits, k_chunk;
  int a_seg, a_tower, b_seg, b_tower;  // the z coordinate of A / B: seg * x_seg + tower * x_tower
  void* C;
  const float* bias;
  const void* resid;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for completion number n of the barrier's phases (parity n & 1).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of shared memory into a 3-d tensor map (rows past its bounds are
// not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The thread's bulk stores have read their shared memory (kRead), or are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// A barrier among the `count` threads of named barrier `id` (0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major: the stride offset steps
// 8 rows of 128 bytes (the leading one is unused).  MN-major: the leading
// offset steps from one 64-wide chunk of M or N to the next, the stride
// offset 8 rows of the contraction.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 16) B (16 x kN); kTA / kTB: A / B held MN-major.
template <int kN>
struct Wgmma;
template <>
struct Wgmma<64> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(kTA), "n"(kTB), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, "
      "%63}, "
      "%64, %65, p, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(kTA), "n"(kTB), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %130, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]),
        "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),
        "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(kTA), "n"(kTB), "r"(1));
  }
};

// d += A (64 x 32) B (32 x kN) in int8, int32 accumulate ("+r": the same
// count of registers as fp32's).  Both operands K-major: for 8-bit types
// wgmma has no transpose and no imm-scale operands, so the bf16 form's
// trailing `1, 1, kTA, kTB` is dropped.
template <int kN>
struct WgmmaS8;
template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]),
        "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]),
        "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
        "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]),
        "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
        "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]),
        "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
  }
};


// C (tower t, split s) = sum over segments and the split's contraction of
// op(A) op(B).  A is held [z][M][K] (K-major) or [z][K][M] (kAMN), B [z][N][K]
// or [z][K][N] (kBMN); z = t * splits + s; C[s][t] is [M, N].  Persistent:
// block b takes output tiles b, b + gridDim.x, ..., numbered with N's tile
// fastest, then M's, then z.  The producer runs on into the next tile's
// k-tiles while the consumers store the last one.  TIn is the operand type:
// bf16 (fp32 accumulators), or int8 (int32 accumulators and output, both
// operands K-major, no epilogue).  A 4-byte output takes no epilogue.
template <int kBN, bool kAMN, bool kBMN, int kOps, typename TOut, bool kRagged, typename TIn>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_r,
                     const Args a) {
  using Cfg = Tile<kBN, TOut, kRagged>;
  constexpr bool kS8 = std::is_same<TIn, int8_t>::value;
  static_assert(!kS8 || (!kAMN && !kBMN && std::is_same<TOut, int>::value && !kRagged),
                "int8: both operands K-major, an int32 output of whole tiles (staged)");
  static_assert(sizeof(TOut) == 2 || kOps == kOpNone, "a 4-byte output takes no epilogue");
  using Acc = typename std::conditional<kS8, int, float>::type;
  constexpr int kStages = Cfg::kStages, kStageBytes = Cfg::kStageBytes, kBKe = kTileK<TIn>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + kConsumers];  // full[s], empty[s], then resid[wg]
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_addr(bars);
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (kStages + s); };
  auto resid_bar = [&](int wg) { return bar0 + 8u * (2 * kStages + wg); };

  const int tid = threadIdx.x, warp = tid / 32;
  const int n_tiles = (a.N + kBN - 1) / kBN, m_tiles = (a.M + kBM - 1) / kBM;
  const int tiles = n_tiles * m_tiles * a.towers * a.splits;
  // The tile's corner, tower, split and contraction range [kbeg, kend).
  struct Work {
    int m0, n0, tower, split, kbeg, kt;
  };
  auto work = [&](int t) {
    Work w;
    w.n0 = (t % n_tiles) * kBN;
    t /= n_tiles;
    w.m0 = (t % m_tiles) * kBM;
    const int z = t / m_tiles;
    w.split = z % a.splits;
    w.tower = z / a.splits;
    w.kbeg = w.split * a.k_chunk;
    const int kend = min(a.K, w.kbeg + a.k_chunk);
    w.kt = kend > w.kbeg ? (kend - w.kbeg + kBKe - 1) / kBKe : 0;
    return w;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(resid_bar(c), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warpgroup: one thread issues every copy
    reg_dealloc<kProducerRegs>();
    if (tid == kConsumers * 128) {
      int g = 0;  // k-tiles loaded by this block so far: stage g % kStages
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Work w = work(t);
        for (int i = 0; i < a.nseg * w.kt; ++i, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty(s), (g / kStages - 1) & 1);
          const int seg = i / w.kt, k = w.kbeg + (i % w.kt) * kBKe;
          const int za = seg * a.a_seg + w.tower * a.a_tower, zb = seg * a.b_seg + w.tower * a.b_tower;
          const uint32_t sa = ring + s * kStageBytes, sb = sa + kATile;
          mbar_expect_tx(full(s), kStageBytes);
          if (kAMN) {
            tma_load(sa, &map_a, full(s), w.m0, k, za);
            tma_load(sa + kChunk, &map_a, full(s), w.m0 + 64, k, za);
          } else {
            tma_load(sa, &map_a, full(s), k, w.m0, za);
          }
          if (kBMN) {
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c) tma_load(sb + c * kChunk, &map_b, full(s), w.n0 + 64 * c, k, zb);
          } else {
            tma_load(sb, &map_b, full(s), k, w.n0, zb);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows m0 + 64 wg of each tile.
  reg_alloc<kConsumerRegs>();
  const int wg = warp / 4, lane = tid % 32;
  (void)map_c;
  (void)map_r;
  int g = 0, e = 0;  // k-tiles consumed and tiles stored by this block so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Work w = work(t);
    const int n_iters = a.nseg * w.kt;
    Acc d[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) d[i] = 0;
    for (int i = 0; i < n_iters; ++i, ++g) {
      const int s = g % kStages;
      mbar_wait(full(s), (g / kStages) & 1);
      const uint32_t sa = ring + s * kStageBytes + wg * kChunk, sb = ring + s * kStageBytes + kATile;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSwizzleRow / 32; ++j) {
        // 32 bytes of the contraction (16 bf16 or 32 int8): 32 bytes along a
        // K-major row, 16 rows of 128 bytes of an MN-major (bf16) chunk.
        const uint64_t da = kAMN ? smem_desc(sa + j * 16 * kSwizzleRow, kChunk, kSwizzleAtom)
                                 : smem_desc(sa + j * 32, 16, kSwizzleAtom);
        const uint64_t db = kBMN ? smem_desc(sb + j * 16 * kSwizzleRow, kChunk, kSwizzleAtom)
                                 : smem_desc(sb + j * 32, 16, kSwizzleAtom);
        if constexpr (kS8) WgmmaS8<kBN>::run(d, da, db);
        else Wgmma<kBN>::template run<kAMN ? 1 : 0, kBMN ? 1 : 0>(d, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the k-tile before this one is done: free its stage
      fence_acc(d);
      if (i > 0 && tid % 128 == 0) mbar_arrive(empty((g - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (n_iters > 0 && tid % 128 == 0) mbar_arrive(empty((g - 1) % kStages));

    // Accumulator 4j + 2h + e of lane l in warp w of the warpgroup: row 16w
    // + l/4 + 8h, column 8j + 2(l%4) + e.
    const float* bias = (kOps & kOpBias) ? a.bias + (size_t)w.tower * a.N : nullptr;
    const int r = (warp % 4) * 16 + lane / 4;
    if constexpr (Cfg::kStaged) {
      // Into the output buffer, 64-column chunks of [128 rows][128 bytes]
      // in TMA's 128-byte swizzle, once the last tile's stores have read it
      // (with kOpResid the residual's tile arrives there first, by TMA, and
      // each thread reads its pairs where it then writes them); then this
      // warpgroup's 64 rows go out by TMA.
      constexpr bool kResid = kOps & kOpResid;
      const uint32_t out = ring + kStages * kStageBytes;
      unsigned char* out_ptr = smem_raw + (out - smem_addr(smem_raw));
      const bool leader = tid % 128 == 0;
      if (leader) {
        bulk_wait<true>();
        if (kResid) {
          mbar_expect_tx(resid_bar(wg), 64 * kBN * 2);
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c) {
            tma_load(out + c * (kBM * kSwizzleRow) + wg * 64 * kSwizzleRow, &map_r, resid_bar(wg), w.n0 + 64 * c,
                     w.m0 + wg * 64, 0);
          }
        }
      }
      if (kResid) mbar_wait(resid_bar(wg), e & 1);
      else named_barrier(1 + wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wg * 64 + r + 8 * h;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          bf162* p = reinterpret_cast<bf162*>(out_ptr + (j / 8) * (kBM * kSwizzleRow) + rr * kSwizzleRow +
                                              (((j % 8) ^ (rr % 8)) * 16) + 4 * (lane % 4));
          const float2 res = kResid ? __bfloat1622float2(*p) : make_float2(0.f, 0.f);
          const float2 v = epilogue_pair<kOps>(res, bias, w.n0 + 8 * j + 2 * (lane % 4), d[4 * j + 2 * h],
                                               d[4 * j + 2 * h + 1]);
          *p = __floats2bfloat162_rn(v.x, v.y);
        }
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (leader) {
        const int z = w.split * a.towers + w.tower;
#pragma unroll
        for (int c = 0; c < kBN / 64; ++c) {
          tma_store(&map_c, out + c * (kBM * kSwizzleRow) + wg * 64 * kSwizzleRow, w.n0 + 64 * c, w.m0 + wg * 64,
                    z);
        }
        bulk_commit();
      }
      ++e;
    } else if constexpr (Cfg::kStaged4) {
      // A 4-byte output (fp32 or int32, stored as it is): per warpgroup,
      // groups of kChunks4 32-column chunks of [64 rows][128 bytes] in TMA's
      // 128-byte swizzle (a warp's pairs land two wavefronts, conflict
      // free), each group once the group before has been read, then out by
      // TMA.  8-byte pair e of lane l's 8-column block j sits at byte 32 (j %
      // 4) + 8 (l % 4) of its row in chunk j / 4.
      const uint32_t out = ring + kStages * kStageBytes + wg * (kChunks4 * kChunk4);
      unsigned char* out_ptr = smem_raw + (out - smem_addr(smem_raw));
      const bool leader = tid % 128 == 0;
      const int z = w.split * a.towers + w.tower;
#pragma unroll
      for (int q = 0; q < kBN / (32 * kChunks4); ++q) {
        if (leader) bulk_wait<true>();
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
#pragma unroll
          for (int jj = 0; jj < 4 * kChunks4; ++jj) {
            const int j = q * 4 * kChunks4 + jj, u = 2 * (jj % 4) + (lane % 4) / 2;
            unsigned char* p = out_ptr + (jj / 4) * kChunk4 + rr * kSwizzleRow + ((u ^ (rr % 8)) * 16) + 8 * (lane % 2);
            if constexpr (kS8) *reinterpret_cast<int2*>(p) = make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
            else *reinterpret_cast<float2*>(p) = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (leader) {
#pragma unroll
          for (int c = 0; c < kChunks4; ++c) {
            tma_store(&map_c, out + c * kChunk4, w.n0 + 32 * (q * kChunks4 + c), w.m0 + wg * 64, z);
          }
          bulk_commit();
        }
      }
    } else {
      // Ragged columns (kRagged: fp32, no epilogue), from the accumulators:
      // columns past N are not stored, and an odd N's rows are only 4-byte
      // aligned, so it stores each value alone rather than in pairs.
      TOut* C = static_cast<TOut*>(a.C) + ((size_t)w.split * a.towers + w.tower) * (size_t)a.M * a.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = w.m0 + wg * 64 + r + 8 * h;
        if (m >= a.M) continue;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int n = w.n0 + 8 * j + 2 * (lane % 4);
          TOut* dst = C + (size_t)m * a.N + n;
          if (a.N % 2 == 0) {
            if (n < a.N) store_pair<TOut>(dst, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
          } else {
            if (n < a.N) dst[0] = d[4 * j + 2 * h];
            if (n + 1 < a.N) dst[1] = d[4 * j + 2 * h + 1];
          }
        }
      }
    }
  }
  if ((Cfg::kStaged || Cfg::kStaged4) && tid % 128 == 0) bulk_wait<false>();
}

// ---------------------------------------------------------------------------
// Host side.

// cuTensorMapEncodeTiled, reached through the runtime (the build links no
// -lcuda), looked up once.
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                          const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = []() -> TensorMapEncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<TensorMapEncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// The tensor-map type of an element.  TMA has no signed 8-bit type; it
// moves bytes, so int8 travels as UINT8.
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, bf16>::value    ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, int>::value   ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// A tensor [z][rows][inner] of T (bf16, int8, or a staged fp32 / int32
// output; inner contiguous) cut in boxes of box_rows x one 128-byte swizzle
// row, zeros out of bounds.
template <typename T>
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t rows, uint64_t z,
                              uint32_t box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {inner, rows, z};
  const cuuint64_t strides[2] = {inner * sizeof(T), inner * rows * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)kTileK<T>, box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One product: C = sum over segments of op(A) op(B), over `towers` towers
// and `splits` chunks of k_chunk of the contraction (C[s][t], [M, N] each).
struct Product {
  const void* A;
  const void* B;
  void* C;
  int M, N, K;
  int towers, nseg, splits, k_chunk;
  int a_z, b_z;                         // z slices held in A and B
  int a_seg, a_tower, b_seg, b_tower;   // 0 or 1: what picks A's and B's z slice
  const float* bias;                    // [towers, N], kOpBias
  const void* resid;                    // [M, N], kOpResid
};

inline Product product(const void* A, const void* B, void* C, int M, int N, int K) {
  Product p{};
  p.A = A; p.B = B; p.C = C;
  p.M = M; p.N = N; p.K = K;
  p.towers = p.nseg = p.splits = 1;
  p.k_chunk = K;
  p.a_z = p.b_z = 1;
  return p;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the kernel tiles the product: N a multiple of 64, and of 128 in
// int8 (any N >= 1 with kRagged), every contiguous extent 16-byte rows for
// TMA (a multiple of 8 bf16 or 16 int8), the chunks of a split contraction
// multiples of the k-tile, the tile count within an int.
template <bool kAMN, bool kBMN, int kOps, typename TOut, bool kRagged, typename TIn>
bool tiles(const Product& p) {
  constexpr int kRow = 16 / (int)sizeof(TIn);
  constexpr int kMinN = std::is_same<TIn, int8_t>::value ? 128 : 64;
  return p.M >= 1 && p.K >= 1 && p.N >= 1 && (p.N % kMinN == 0 || kRagged) && (kAMN ? p.M : p.K) % kRow == 0 &&
         (kBMN ? p.N : p.K) % kRow == 0 && p.k_chunk >= 1 && (p.splits == 1 || p.k_chunk % kTileK<TIn> == 0) &&
         (long long)((p.N + 63) / 64) * ((p.M + kBM - 1) / kBM) * p.towers * p.splits < (1LL << 31) &&
         aligned16(p.A) && aligned16(p.B) && (!Tile<128, TOut, kRagged>::kStaged4 || aligned16(p.C));
}

template <int kBN, bool kAMN, bool kBMN, int kOps, typename TOut, bool kRagged, typename TIn>
cudaError_t launch_tile(const Product& p, cudaStream_t st) {
  using Cfg = Tile<kBN, TOut, kRagged>;
  constexpr int kBKe = kTileK<TIn>;
  CUtensorMap map_a, map_b, map_c{}, map_r{};
  cudaError_t err = kAMN ? tensor_map<TIn>(&map_a, p.A, p.M, p.K, p.a_z, kBKe)
                         : tensor_map<TIn>(&map_a, p.A, p.K, p.M, p.a_z, kBM);
  if (err != cudaSuccess) return err;
  err = kBMN ? tensor_map<TIn>(&map_b, p.B, p.N, p.K, p.b_z, kBKe) : tensor_map<TIn>(&map_b, p.B, p.K, p.N, p.b_z, kBN);
  if (err != cudaSuccess) return err;
  if (Cfg::kStaged) {  // C [towers * splits][M][N], stored in 64 x 64 boxes
    err = tensor_map<bf16>(&map_c, p.C, p.N, p.M, (uint64_t)p.towers * p.splits, 64);
    if (err != cudaSuccess) return err;
    if (kOps & kOpResid) {  // the residual [M][N], read in the same boxes
      err = tensor_map<bf16>(&map_r, p.resid, p.N, p.M, 1, 64);
      if (err != cudaSuccess) return err;
    }
  }
  if (Cfg::kStaged4) {  // C [towers * splits][M][N], stored in 64-row x 32-column boxes
    err = tensor_map<TOut>(&map_c, p.C, p.N, p.M, (uint64_t)p.towers * p.splits, 64);
    if (err != cudaSuccess) return err;
  }
  const Args a{p.M, p.N, p.K, p.towers, p.nseg, p.splits, p.k_chunk, p.a_seg, p.a_tower, p.b_seg, p.b_tower,
               p.C, p.bias, p.resid};
  auto kernel = gemm_sm90_kernel<kBN, kAMN, kBMN, kOps, TOut, kRagged, TIn>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((p.N + kBN - 1) / kBN) * ((p.M + kBM - 1) / kBM) * p.towers * p.splits;
  const int blocks = (int)std::min<long long>(tiles, sms);
  kernel<<<blocks, kThreads, Cfg::kSmemBytes, st>>>(map_a, map_b, map_c, map_r, a);
  return cudaGetLastError();
}

// The tile width: 256 where N allows it (half the shared-memory reads of A
// per product and 128 accumulators a thread), else 128; 64 where N is an odd
// multiple of 64 (a head shard of an odd number of heads, Dv = 192 or 320:
// every tile of the launch 64 wide, 32 accumulators a thread).  A ragged N
// (kRagged) between 129 and 256 takes one 256-wide tile, so each of A's row
// tiles is read once.
inline int tile_n(int N, bool ragged = false) {
  if (N % 128 != 0) {
    if (!ragged && N % 64 == 0) return 64;
    return N > 128 && N <= 256 ? 256 : 128;
  }
  return N % 256 == 0 ? 256 : 128;
}

template <bool kAMN, bool kBMN, int kOps, typename TOut, bool kRagged = false, typename TIn = bf16>
cudaError_t launch(const Product& p, cudaStream_t st) {
  static_assert(!kRagged || (sizeof(TOut) == 4 && kOps == kOpNone), "a ragged N takes an fp32 output alone");
  if (!tiles<kAMN, kBMN, kOps, TOut, kRagged, TIn>(p)) return cudaErrorInvalidValue;
  const int bn = tile_n(p.N, kRagged);
  if constexpr (!std::is_same<TIn, int8_t>::value && !kRagged) {
    if (bn == 64) return launch_tile<64, kAMN, kBMN, kOps, TOut, kRagged, TIn>(p, st);
  }
  return bn == 256 ? launch_tile<256, kAMN, kBMN, kOps, TOut, kRagged, TIn>(p, st)
                   : launch_tile<128, kAMN, kBMN, kOps, TOut, kRagged, TIn>(p, st);
}

// Each product of the attention block takes a head shard's width Dv (the
// heads of one rank under tensor parallelism: Wqkv [3, D, Dv], Wout [Dv,
// D]); the overloads without Dv are the whole block's, Dv = D.

// G1: qkv[t] = T(y @ Wqkv[t] + bqkv[t]); y [M, D], Wqkv [3, D, Dv] held
// [K, N], qkv [3, M, Dv].
inline cudaError_t qkv(const bf16* y, const bf16* wqkv, const float* bqkv, bf16* out, int M, int D, int Dv,
                       cudaStream_t st) {
  Product p = product(y, wqkv, out, M, Dv, D);
  p.towers = 3; p.b_z = 3; p.b_tower = 1;
  p.bias = bqkv;
  return launch<false, true, kOpBias, bf16>(p, st);
}
inline cudaError_t qkv(const bf16* y, const bf16* wqkv, const float* bqkv, bf16* out, int M, int D,
                       cudaStream_t st) {
  return qkv(y, wqkv, bqkv, out, M, D, D, st);
}

// G2: out = T(x + o @ Wout + bout); o [M, Dv], Wout [Dv, D] held [K, N].
inline cudaError_t out_proj(const bf16* o, const bf16* wout, const float* bout, const bf16* x, bf16* out, int M,
                            int D, int Dv, cudaStream_t st) {
  Product p = product(o, wout, out, M, D, Dv);
  p.bias = bout;
  p.resid = x;
  return launch<false, true, kOpBias | kOpResid, bf16>(p, st);
}
inline cudaError_t out_proj(const bf16* o, const bf16* wout, const float* bout, const bf16* x, bf16* out, int M,
                            int D, cudaStream_t st) {
  return out_proj(o, wout, bout, x, out, M, D, D, st);
}

// G2 of a head shard (partial): out = o @ Wout in fp32, no bias, no
// residual; the shards' sum gets them once.
inline cudaError_t out_proj_partial(const bf16* o, const bf16* wout, float* out, int M, int D, int Dv,
                                    cudaStream_t st) {
  return launch<false, true, kOpNone, float>(product(o, wout, out, M, D, Dv), st);
}

// G3: do = T(g @ Wout^T); g [M, D], Wout [Dv, D] held [N, K], do [M, Dv].
inline cudaError_t grad_out(const bf16* g, const bf16* wout, bf16* out, int M, int D, int Dv, cudaStream_t st) {
  return launch<false, false, kOpNone, bf16>(product(g, wout, out, M, Dv, D), st);
}
inline cudaError_t grad_out(const bf16* g, const bf16* wout, bf16* out, int M, int D, cudaStream_t st) {
  return grad_out(g, wout, out, M, D, D, st);
}

// G4's row chunks: a fixed function of the shape, never of the card or the
// run, so the partials and their fixed-order sum repeat bit for bit.  The
// split count s <= 16 least in ceil(t s / 132) / s, the waves of t s tiles
// over one block on each of 132 SMs per unit of work (t = towers x ceil(Na /
// 128) x (Nb / tile width) output tiles of an [Na, Nb] product); chunks of
// ceil(M / s) rows rounded up to the k-tile, at least 256.
inline int weight_grad_chunk(int M, int Na, int Nb, int towers) {
  const int tiles = towers * ((Na + kBM - 1) / kBM) * (Nb / tile_n(Nb));
  const int resident = 132;
  int best = 1;
  double best_cost = 1e9;
  for (int s = 1; s <= 16; ++s) {
    const double cost = (double)((tiles * s + resident - 1) / resident) / s;
    if (cost < best_cost - 1e-9) {
      best = s;
      best_cost = cost;
    }
  }
  const int chunk = (M + best - 1) / best;
  constexpr int kBK = kTileK<bf16>;
  return std::max(256, (chunk + kBK - 1) / kBK * kBK);
}
inline int weight_grad_splits(int M, int Na, int Nb, int towers) {
  const int chunk = weight_grad_chunk(M, Na, Nb, towers);
  return (M + chunk - 1) / chunk;
}

// G4: dw[t] = a^T b_t (fp32 [towers, Na, Nb]); a [M, Na] and b [towers, M,
// Nb] held with the contraction (rows) outermost, so both operands are
// MN-major.  The partials [splits, towers, Na, Nb] are summed in order into
// dw.  The attention block's backward runs it over three towers (dWqkv[t] =
// y^T d_t: Na = D, Nb = Dv) and over one (dWout = o^T g: Na = Dv, Nb = D).
inline cudaError_t weight_grad(const bf16* a, const bf16* b, float* partial, float* dw, int M, int Na, int Nb,
                               int towers, cudaStream_t st) {
  Product p = product(a, b, partial, Na, Nb, M);
  p.towers = towers; p.b_z = towers; p.b_tower = 1;
  p.k_chunk = weight_grad_chunk(M, Na, Nb, towers);
  p.splits = (M + p.k_chunk - 1) / p.k_chunk;
  const cudaError_t err = launch<true, true, kOpNone, float>(p, st);
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, p.splits, (long long)towers * Na * Nb, dw, st);
}

// G5: dY = sum_t d_t Wqkv[t]^T (fp32 [M, D]); d [3, M, Dv] and Wqkv[t]
// [D, Dv] held [N, K] are three segments of one contraction over Dv.
inline cudaError_t input_grad(const bf16* d, const bf16* wqkv, float* dY, int M, int D, int Dv, cudaStream_t st) {
  Product p = product(d, wqkv, dY, M, D, Dv);
  p.nseg = 3; p.a_z = 3; p.a_seg = 1; p.b_z = 3; p.b_seg = 1;
  return launch<false, false, kOpNone, float>(p, st);
}
inline cudaError_t input_grad(const bf16* d, const bf16* wqkv, float* dY, int M, int D, cudaStream_t st) {
  return input_grad(d, wqkv, dY, M, D, D, st);
}

// B4's fc: h_pre = T(y @ W1 + b1); y [M, D], W1 [D, Hd] held [K, N].  G1's
// instantiation over one tower.
inline cudaError_t mlp_fc(const bf16* y, const bf16* w1, const float* b1, bf16* h_pre, int M, int D, int Hd,
                          cudaStream_t st) {
  Product p = product(y, w1, h_pre, M, Hd, D);
  p.bias = b1;
  return launch<false, true, kOpBias, bf16>(p, st);
}

// B4's proj: out = T(x + (h @ W2 + b2)); h [M, Hd], W2 [Hd, D] held [K, N].
// The bias first, then the residual (kOpResidLast): the MLP's order, not
// G2's (x + acc) + b.
inline cudaError_t mlp_proj(const bf16* h, const bf16* w2, const float* b2, const bf16* x, bf16* out, int M, int D,
                            int Hd, cudaStream_t st) {
  Product p = product(h, w2, out, M, D, Hd);
  p.bias = b2;
  p.resid = x;
  return launch<false, true, kOpBias | kOpResid | kOpResidLast, bf16>(p, st);
}

}  // namespace sm90
}  // namespace flyp
