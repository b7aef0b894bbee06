// The measurement tools' GEMMs, for Hopper (sm_90a): T1 and T3, both on
// gemm_sm90.cuh (TMA + wgmma, persistent).
//
// T1 replaces tools/int8_matmul_probe.py::_pallas_mm (pl.pallas_call :100):
// C[M, N] = A[M, K] @ B[K, N] over the full depth, bf16 operands into fp32
// output, or int8 operands into int32 output (exact).  The probe asks whether
// the int8 tensor-core path delivers its 2x over bf16 when we emit the
// product ourselves, so both types run one design:
//
// * bf16: launch<false, true, kOpNone, float>: a K-major, b held [K, N]
//   (MN-major, wgmma's transpose), m64n256k16 into fp32.
// * int8: wgmma m64nNk32 .s32.s8.s8 into int32.  For 8-bit types wgmma
//   takes both operands K-major only, so b [K, N] is first transposed into
//   the caller's bt [N, K] by transpose_s8_kernel (K N bytes read and
//   written, ~1% of the product's time at the qkv shape), then
//   launch<false, false, kOpNone, int, false, int8_t>.  A k-tile of 128
//   int8 is one 128-byte swizzle row, as 64 bf16 are, and a k32 step
//   advances 32 bytes, as bf16's k16 does, so the tiles, stages and
//   descriptors are bf16's.  The int32 sum is exact while 127^2 K < 2^31.
//
// Both stage their 4-byte output in shared memory and store it by TMA, as
// every 4-byte output of whole tiles is: at K = 768 the epilogue is a large
// share of a tile, and stores straight from the accumulators (8 rows a warp
// instruction) took 0.384 / 0.285 ms at the qkv shape against 0.333 /
// 0.226 staged (NVIDIA H100 80GB HBM3, 700 W).
//
// What bounds it on the H100: at the serving shapes the fp32 / int32 output
// (4 bytes an element) is most of the bytes; bf16 is bound by operations
// at qkv and big, by bytes at out; int8 by bytes except at big (PERF.md's
// table).
//
// Shapes: any M >= 1 (rows past M load as zeros and are not stored), N a
// multiple of 128, K a multiple of 8 (bf16) or 16 (int8), TMA's 16-byte
// rows.  The wrapper (flyp_tpu_torch/tools/int8_matmul_probe.py::probe_mm)
// keeps the TPU probe's contract and refuses more: K a multiple of 32
// (bf16) or 64 (int8), M up to 65535 x 128, each refusal a ValueError
// naming the dimension.  Every output element of an accepted shape is
// written.
//
// T3 replaces tools/mfu_levers.py::row_quant's kernel (pl.pallas_call :173):
// out[b] = T(x[b] @ w) for x [B, R, D], w [D, N] bf16, fp32 accumulate,
// rounded to bf16.  The items' rows lie one after another, so this is one
// flat product of gemm_sm90.cuh (TMA + wgmma, persistent): x as [B R, D]
// K-major, w held [K, N] (MN-major, as G1's Wqkv), the bf16 output staged in
// shared memory and stored by TMA; G1's instantiation without the bias and
// with one tower.  Row tiles cross item boundaries, so B R rows cost B R
// rows (50,432 at R = 197, none of them padding), and time follows B R.
// The TPU probe asked whether the hardware pads each item's rows to its
// tile; on this card the answer is "not when the rows are laid out flat".
// Bound by operations at every R.

#include "gemm_sm90.cuh"

namespace {

using namespace flyp;

// bt [N, K] = b^T for int8 b [K, N], 64 x 64-byte tiles through shared
// memory, 16 bytes a thread each way.  K and N multiples of 16.
constexpr int kT = 64, kTRow = kT + 16;  // a tile row padded to keep 16-byte stores aligned
__global__ void __launch_bounds__(256) transpose_s8_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt,
                                                           int K, int N) {
  __shared__ __align__(16) int8_t tile[kT * kTRow];  // [k][n]
  const int k0 = blockIdx.y * kT, n0 = blockIdx.x * kT, r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
  if (k0 + r < K && n0 + c < N) {
    *reinterpret_cast<uint4*>(&tile[r * kTRow + c]) =
        __ldg(reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * N + n0 + c));
  }
  __syncthreads();
  if (n0 + r < N && k0 + c < K) {  // row n0 + r of bt, columns k0 + c ..
    alignas(16) int8_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = tile[(c + i) * kTRow + r];
    *reinterpret_cast<uint4*>(bt + (size_t)(n0 + r) * K + k0 + c) = *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

extern "C" {

// T1, bf16: a [M, K], b [K, N] bf16 row major, c [M, N] fp32, 16-byte
// aligned.  N % 128 == 0, K % 8 == 0.  Returns a cudaError_t.
int flyp_probe_mm_bf16(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  return (int)sm90::launch<false, true, kOpNone, float>(sm90::product(a, b, c, M, N, K),
                                                        static_cast<cudaStream_t>(stream));
}

// T1, int8: a [M, K], b [K, N] int8 row major, c [M, N] int32; bt [N, K]
// int8 scratch (b transposed into it first).  16-byte aligned, N % 128 ==
// 0, K % 16 == 0.  Returns a cudaError_t.
int flyp_probe_mm_int8(const void* a, const void* b, void* bt, void* c, int M, int N, int K, void* stream) {
  if (M < 1 || N < 128 || N % 128 != 0 || K < 16 || K % 16 != 0 || (long long)((K + kT - 1) / kT) > 65535 ||
      !sm90::aligned16(b) || !sm90::aligned16(bt)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  transpose_s8_kernel<<<dim3((N + kT - 1) / kT, (K + kT - 1) / kT), 256, 0, st>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), K, N);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sm90::launch<false, false, kOpNone, int, false, int8_t>(sm90::product(a, bt, c, M, N, K), st);
}

// T3: x [B, R, D], w [D, N], out [B, R, N], all bf16, contiguous and
// 16-byte aligned.  N % 128 == 0, D % 8 == 0 (TMA's 16-byte rows),
// B R < 2^31.  Returns a cudaError_t.
int flyp_row_gemm(const void* x, const void* w, void* out, int B, int R, int D, int N, void* stream) {
  if (B < 1 || R < 1 || (long long)B * R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)sm90::launch<false, true, kOpNone, bf16>(sm90::product(x, w, out, B * R, N, D),
                                                       static_cast<cudaStream_t>(stream));
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
