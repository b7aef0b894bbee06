// The measurement tools' GEMMs, for Hopper (sm_90a): T1 and T3.
//
// T1 replaces tools/int8_matmul_probe.py::_pallas_mm (pl.pallas_call :100):
// C[M, N] = A[M, K] @ B[K, N] over the full depth, bf16 operands into fp32
// output, or int8 operands into int32 output (exact).  The probe asks whether
// the int8 tensor-core path delivers its 2x over bf16 when we emit the
// product ourselves, so both types run one design: the package's tiled GEMM
// (common.cuh: 128 x 128 output tiles, 8 warps of 64 x 32, 64 bytes of
// depth a k-tile, the next k-tile read into registers while the tensor
// cores work on the current one), launch_gemm<bf16, ..., float> on mma.sync
// m16n8k16 and launch_gemm<int8_t, ..., int> on m16n8k32 .s8 with int32
// accumulate (B staged transposed, since ldmatrix .trans moves 16-bit
// elements only).  What bounds it on the H100: at the serving shapes the
// fp32 / int32 output (4 bytes an element) is most of the bytes; bf16 is
// bound by operations at qkv and big, by bytes at out; int8 by bytes except
// at big (PERF.md's table).
//
// Shapes: any M >= 1 (rows past M read as zeros and are not stored), N a
// multiple of 128, K a multiple of 32 (bf16) or 64 (int8); the wrapper
// (flyp_tpu_torch/tools/int8_matmul_probe.py::probe_mm) refuses any other
// shape with a ValueError naming the dimension, as the TPU probe refuses a
// block that does not tile.  Every output element of an accepted shape is
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

bool rows_ok(int M) { return M >= 1 && (M + kBM - 1) / kBM <= 65535; }

}  // namespace

extern "C" {

// T1, bf16: a [M, K], b [K, N] bf16 row major, c [M, N] fp32.  N % 128 == 0,
// K % 32 == 0.  Returns a cudaError_t.
int flyp_probe_mm_bf16(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  if (!rows_ok(M) || N < kBN || N % kBN != 0 || K < kMmaBK || K % kMmaBK != 0) return (int)cudaErrorInvalidValue;
  const GemmArgs g = gemm_args(a, b, c, M, N, K, K, N);
  return (int)launch_gemm<bf16, false, false, kOpNone, float>(g, 1, static_cast<cudaStream_t>(stream));
}

// T1, int8: a [M, K], b [K, N] int8 row major, c [M, N] int32.  N % 128 == 0,
// K % 64 == 0.  Returns a cudaError_t.
int flyp_probe_mm_int8(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  constexpr int kBK = MmaOperand<int8_t>::kBK;
  if (!rows_ok(M) || N < kBN || N % kBN != 0 || K < kBK || K % kBK != 0) return (int)cudaErrorInvalidValue;
  const GemmArgs g = gemm_args(a, b, c, M, N, K, K, N);
  return (int)launch_gemm<int8_t, false, false, kOpNone, int>(g, 1, static_cast<cudaStream_t>(stream));
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
