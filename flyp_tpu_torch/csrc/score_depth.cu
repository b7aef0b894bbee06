// The per-head score-sum probe, for Hopper (sm_90a): T2.
//
// Replaces tools/mfu_levers.py::pallas_score_depth's kernel (pl.pallas_call
// :127).  For q, k [B, L, D] bf16 it computes, per item b,
//
//   o[b] = sum over heads h of q[b, :, h] k[b, :, h]^T        fp32 [L, L]
//
// with the heads taken hd features at a time (hd = 64, the attention
// kernels' head width; 128 and 256, heads merged).  The probe asks whether
// the depth of each contraction step changes the time when the output
// traffic is the same, so hd is a template argument and is the depth of one
// staged step: a block stages hd features of 64 query rows and 64 key rows
// into shared memory, runs hd / 16 mma.sync m16n8k16 steps into one fp32
// accumulator tile held in registers across all heads (the TPU kernel's
// single [Lp, Lp] accumulator), and writes its 64 x 64 piece of o once.
// launch_gemm does not fit: N = L = 208 is not a multiple of 128.  q and k
// are both held [L, D], so k's fragment is the plain ldmatrix of a [n][k]
// tile.  Rows past L read as zeros and are not stored (L = 208 runs 4 x 4
// tiles of 64).
//
// What bounds it on the H100: bytes (q and k read once, o written once in
// fp32: 0.0621 ms at B=256, L=208, D=768) over operations (0.0172 ms).

#include "common.cuh"

namespace {

using namespace flyp;

constexpr int kRows = 64;      // query rows and key rows of a block's tile
constexpr int kThreads = 128;  // 4 warps, 16 query rows each

// A staged tile row: hd features + 8 (16-byte rows, conflict-free ldmatrix).
template <int kHd>
struct Stage {
  static constexpr int kStride = kHd + 8;
  static constexpr int kBytes = 2 * kRows * kStride * (int)sizeof(bf16);  // q and k tiles
};

template <int kHd>
__global__ void __launch_bounds__(kThreads)
    score_depth_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ o, int L, int D) {
  constexpr int S = Stage<kHd>::kStride;
  constexpr int kPieces = kHd / 8;  // 16-byte pieces of a row's hd features
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [64][S]
  bf16* Ks = Qs + kRows * S;                 // [64][S]
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kRows;
  const bf16* qb = q + (size_t)blockIdx.z * L * D;
  const bf16* kb = k + (size_t)blockIdx.z * L * D;
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int h0 = 0; h0 < D; h0 += kHd) {
#pragma unroll
    for (int i = 0; i < kRows * kPieces / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kPieces, c = (e % kPieces) * 8;
      *reinterpret_cast<uint4*>(&Qs[r * S + c]) = m0 + r < L ? load16(qb + (size_t)(m0 + r) * D + h0 + c) : zero;
      *reinterpret_cast<uint4*>(&Ks[r * S + c]) = n0 + r < L ? load16(kb + (size_t)(n0 + r) * D + h0 + c) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kHd / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, &Qs[(wr + ldm_row(lane, false)) * S + ks * 16 + ldm_col(lane, false)]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &Ks[(np * 16 + ldm_row(lane, true)) * S + ks * 16 + ldm_col(lane, true)]);
        mma_bf16(acc[2 * np], af, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  float* ob = o + (size_t)blockIdx.z * L * L;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wr + lane / 4 + half * 8;
      const int n = n0 + nt * 8 + (lane % 4) * 2;
      if (m >= L || n >= L) continue;
      float* dst = ob + (size_t)m * L + n;
      if (n + 1 < L && (L % 2) == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      } else {
        dst[0] = acc[nt][2 * half];
        if (n + 1 < L) dst[1] = acc[nt][2 * half + 1];
      }
    }
}

template <int kHd>
cudaError_t launch(const bf16* q, const bf16* k, float* o, int B, int L, int D, cudaStream_t st) {
  constexpr int smem = Stage<kHd>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(score_depth_kernel<kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (L + kRows - 1) / kRows;
  score_depth_kernel<kHd><<<dim3(tiles, tiles, B), kThreads, smem, st>>>(q, k, o, L, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k [B, L, D] bf16, o [B, L, L] fp32; hd in {64, 128, 256}, D % hd == 0,
// 1 <= B <= 65535.  Returns a cudaError_t.
int flyp_score_depth(const void* q, const void* k, void* o, int B, int L, int D, int hd, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < hd || hd < 1 || D % hd != 0) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  float* op = static_cast<float*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch<64>(qp, kp, op, B, L, D, st);
    case 128: return (int)launch<128>(qp, kp, op, B, L, D, st);
    case 256: return (int)launch<256>(qp, kp, op, B, L, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
