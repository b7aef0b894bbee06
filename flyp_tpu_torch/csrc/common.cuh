// Device helpers, the tiled GEMM and the 64-wide attention tiles shared by the
// package's kernels (attention block forward and backward, MLP block,
// attention).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace flyp {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kHeadDim = 64;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// (x - mean) * rstd * scale + bias, each step rounded as the plain version
// rounds it (no contraction into an FMA).
__device__ __forceinline__ float ln_apply(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// x * sigmoid(1.702 x) in fp32 (CLIP's QuickGELU), sigmoid as 1 / (1 + e^-z).
__device__ __forceinline__ float quick_gelu(float x) {
  return __fmul_rn(x, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, x)))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a / b rounded to nearest, as __fdiv_rn gives it, from rb = __frcp_rn(b)
// (one reciprocal for many quotients by the same b): q = a rb is within an
// ulp, and one correction with the exact residual a - q b (an FMA) rounds
// it correctly (Markstein), for finite a, b whose quotient is normal or 0.
// A softmax's p = e / l, with 0 <= e <= 1 <= l, is such a quotient (e near
// fp32's underflow rounds to within an ulp of its subnormal quotient).
__device__ __forceinline__ float div_rn_by(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// Two fp32 as the bf16 pair of one mma fragment register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cp.async: 16 bytes from device memory into shared memory, bypassing L1;
// zeros when !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n (0-8) of the calling thread's committed cp.async
// groups are pending; the copies of the others are then visible to it (to
// the block after a __syncthreads).  n is a constant once loops unroll.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 4) asm volatile("cp.async.wait_group 4;\n" ::: "memory");
  else if (n == 5) asm volatile("cp.async.wait_group 5;\n" ::: "memory");
  else if (n == 6) asm volatile("cp.async.wait_group 6;\n" ::: "memory");
  else if (n == 7) asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 8;\n" ::: "memory");
}

// Fragment lanes: accumulator element e of lane l sits at row l/4 (+8 for
// e >= 2) and column 2*(l%4) (+1 for odd e) of the 16 x 8 tile.
//
// ldmatrix addressing, relative to a fragment's corner in shared memory.  A
// 16 x 16 A fragment (rows m, depth k) held [m][k], or the 16 x 16 B pair
// (depth k, two 8-column tiles) held [k][n]: row lane%16, column
// (lane/16)*8 -- plain ldmatrix for A, .trans for B.  The same operands held
// the other way round ([k][m] for A, [n][k] for B): row (lane&7) +
// (lane>>4)*8, column ((lane>>3)&1)*8 -- .trans for A, plain for B.  For B,
// registers {0,1} feed the first 8 columns and {2,3} the next 8.
__device__ __forceinline__ int ldm_row(int lane, bool swapped) {
  return swapped ? (lane & 7) + ((lane >> 4) << 3) : lane % 16;
}
__device__ __forceinline__ int ldm_col(int lane, bool swapped) {
  return swapped ? ((lane >> 3) & 1) * 8 : (lane / 16) * 8;
}

// Two-pass fp32 mean and 1/sqrt(var + eps) of one row, by one warp, in
// 16-byte pieces (the row 16-byte aligned, K a multiple of 16 / sizeof(T)).
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ row, int K, float& mean, float& rstd) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int k = lane * kVec; k < K; k += 32 * kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + k);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += to_f(v[j]);
  }
  mean = warp_sum(s) / (float)K;
  float ss = 0.f;
  for (int k = lane * kVec; k < K; k += 32 * kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + k);
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = to_f(v[j]) - mean;
      ss = fmaf(d, d, ss);
    }
  }
  rstd = rsqrtf(warp_sum(ss) / (float)K + kEps);
}

// ---------------------------------------------------------------------------
// Row passes shared by the attention block's forward and backward.

constexpr int kRowThreads = 256;

// y = T(LN(x)) for x [M, D], one warp per row: row_stats and ln_apply, the
// rounding of the GEMM's LN prologue, so the attention block's forward and
// backward compute the same y.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_forward_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
                  T* __restrict__ y, int M, int D) {
  const int m = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;
  const T* row = x + (size_t)m * D;
  float mean, rstd;
  row_stats(row, D, mean, rstd);
  for (int k = lane; k < D; k += 32) y[(size_t)m * D + k] = from_f<T>(ln_apply(to_f(row[k]), mean, rstd, g[k], b[k]));
}

template <typename T>
cudaError_t ln_forward(const T* x, const float* g, const float* b, T* y, int M, int D, cudaStream_t st) {
  constexpr int kRows = kRowThreads / 32;
  ln_forward_kernel<T><<<(M + kRows - 1) / kRows, kRowThreads, 0, st>>>(x, g, b, y, M, D);
  return cudaGetLastError();
}

// out[x] = sum over p of partial[p][x], in order of p.
__global__ void __launch_bounds__(kRowThreads)
reduce_partials_kernel(const float* __restrict__ partial, int parts, long long X, float* __restrict__ out) {
  for (long long x = (long long)blockIdx.x * kRowThreads + threadIdx.x; x < X;
       x += (long long)gridDim.x * kRowThreads) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partial[p * X + x];
    out[x] = s;
  }
}

inline cudaError_t reduce_partials(const float* partial, int parts, long long X, float* out, cudaStream_t st) {
  const long long blocks = (X + kRowThreads - 1) / kRowThreads;
  reduce_partials_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kRowThreads, 0, st>>>(partial, parts, X, out);
  return cudaGetLastError();
}

template <typename TOut>
__device__ __forceinline__ void store_pair(TOut* p, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float v0, float v1) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Loads of data no kernel writes while it runs, through the read-only path.
__device__ __forceinline__ float2 load_pair(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const bf162*>(p)));
}
__device__ __forceinline__ uint4 load16(const bf16* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }

// ---------------------------------------------------------------------------
// Tiled GEMM: C[z] = sum over segments of op(A) op(B) (+ resid) (+ bias),
// where A is held [M, K] (or [K, M] with kAT) and B [K, N] (or [N, K] with
// kBT), row major with leading dimensions lda/ldb.  blockIdx.z = zt * splits
// + s: zt picks a tower (A += zt*a_z, B += zt*b_z, bias += zt*N) and s a
// chunk of the contraction, whose partial goes to C[s][zt] ([M, N] each).
// Rows past M and the contraction past K read as zeros; N % 128 == 0.
//
// kOps says what else it does, at compile time.  Operand prologues (A held
// [M, K]), each rounded to the operand type as the tile is stored: kOpLN (one
// segment, one split): A' = LN(A) over A's K columns with ln_scale/ln_bias;
// kOpGelu: A' = quick_gelu(A) in fp32.  The epilogue, in fp32 with each step
// rounded: kOpResid adds resid (an [M, N] tensor of the output type), then
// kOpBias adds bias (with kOpResidLast the bias first, then resid: resid +
// (acc + bias)); then C rounds to its type.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulate), and
// int8 on the same tiles (m16n8k32, int32 accumulate and output, A [M, K]
// and B [K, N] only, no prologue or epilogue); fp32 runs FMA tiles on the
// CUDA cores, since the tensor cores would round fp32 operands to TF32.

// Blocks of 256 threads, launch-bounded to two per SM (at most 128 registers
// a thread).
constexpr int kGemmThreads = 256;
constexpr int kBM = 128, kBN = 128;
enum : int { kOpNone = 0, kOpLN = 1, kOpBias = 2, kOpResid = 4, kOpGelu = 8, kOpResidLast = 16 };

struct GemmArgs {
  const void* A;
  const void* B;
  void* C;
  int M, N, K, lda, ldb;
  int nseg;
  long long a_seg, b_seg;  // segment strides (elements)
  long long a_z, b_z;      // tower strides (elements)
  int splits, k_chunk;     // contraction chunks: [s * k_chunk, (s + 1) * k_chunk)
  const float* bias;       // [towers, N], kOpBias
  const void* resid;       // [M, N], kOpResid
  const float* ln_scale;   // [K], kOpLN
  const float* ln_bias;
};

// One segment, one split, no epilogue: C = op(A) op(B).
inline GemmArgs gemm_args(const void* A, const void* B, void* C, int M, int N, int K, int lda, int ldb) {
  GemmArgs g{};
  g.A = A; g.B = B; g.C = C;
  g.M = M; g.N = N; g.K = K; g.lda = lda; g.ldb = ldb;
  g.nseg = 1; g.splits = 1; g.k_chunk = K;
  return g;
}

struct GemmBlock {
  int zt, kbeg, kend;
  size_t c_off;
};

__device__ __forceinline__ GemmBlock gemm_block(const GemmArgs& a) {
  GemmBlock g;
  const int s = blockIdx.z % a.splits;
  g.zt = blockIdx.z / a.splits;
  g.kbeg = s * a.k_chunk;
  g.kend = min(a.K, g.kbeg + a.k_chunk);
  g.c_off = ((size_t)s * (gridDim.z / a.splits) + g.zt) * (size_t)a.M * a.N;
  return g;
}

// Row statistics of the block's rows m0.. of A [M, K] (row stride lda; one
// warp per row; zeros past M).
template <typename T>
__device__ void gemm_ln_stats(const T* A, int M, int K, int lda, int m0, float* row_mean, float* row_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kGemmThreads / 32) {
    float mean = 0.f, rstd = 0.f;
    if (m0 + r < M) row_stats(A + (size_t)(m0 + r) * lda, K, mean, rstd);
    if (lane == 0) {
      row_mean[r] = mean;
      row_rstd[r] = rstd;
    }
  }
}

// The epilogue on two adjacent outputs (n, n + 1) of a row whose residual
// pair is r (read only with kOpResid), in fp32 with each step rounded, before
// C's rounding.
template <int kOps>
__device__ __forceinline__ float2 epilogue_pair(float2 r, const float* bias, int n, float v0, float v1) {
  constexpr bool kBiasFirst = (kOps & kOpBias) && (kOps & kOpResidLast);
  if (kBiasFirst) {
    v0 = __fadd_rn(v0, __ldg(bias + n));
    v1 = __fadd_rn(v1, __ldg(bias + n + 1));
  }
  if (kOps & kOpResid) {
    v0 = __fadd_rn(r.x, v0);
    v1 = __fadd_rn(r.y, v1);
  }
  if ((kOps & kOpBias) && !kBiasFirst) {
    v0 = __fadd_rn(v0, __ldg(bias + n));
    v1 = __fadd_rn(v1, __ldg(bias + n + 1));
  }
  return make_float2(v0, v1);
}

// The epilogue on two adjacent outputs (m, n), (m, n + 1) of C [M, N].
template <int kOps, typename TOut>
__device__ __forceinline__ float2 gemm_epilogue(const TOut* resid, const float* bias, int N, int m, int n, float v0,
                                                float v1) {
  const float2 r = (kOps & kOpResid) ? load_pair(resid + (size_t)m * N + n) : make_float2(0.f, 0.f);
  return epilogue_pair<kOps>(r, bias, n, v0, v1);
}

template <int kOps, typename TOut>
__device__ __forceinline__ void gemm_store(TOut* C, const TOut* resid, const float* bias, int N, int m, int n,
                                           float v0, float v1) {
  const float2 v = gemm_epilogue<kOps, TOut>(resid, bias, N, m, n, v0, v1);
  store_pair<TOut>(C + (size_t)m * N + n, v.x, v.y);
}

// fp32: 128 x 128 tiles, each of the 256 threads owning an 8 x 8 piece
// (rows ty + 16i, column pairs 2tx + 32j).
constexpr int kFmaBK = 16;
constexpr int kFmaPad = 4;  // spreads the transposed stores over banks

template <bool kAT, bool kBT, int kOps>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_fma_kernel(const GemmArgs a) {
  constexpr bool kLN = kOps & kOpLN;
  constexpr bool kGelu = kOps & kOpGelu;
  static_assert(!((kLN || kGelu) && kAT), "the operand prologues read A held [M, K]");
  __shared__ float As[kFmaBK][kBM + kFmaPad];  // [k][m]
  __shared__ float Bs[kFmaBK][kBN + kFmaPad];  // [k][n]
  __shared__ float row_mean[kLN ? kBM : 1];
  __shared__ float row_rstd[kLN ? kBM : 1];
  const GemmBlock gb = gemm_block(a);
  const float* A = static_cast<const float*>(a.A) + gb.zt * a.a_z;
  const float* B = static_cast<const float*>(a.B) + gb.zt * a.b_z;
  float* C = static_cast<float*>(a.C) + gb.c_off;
  const float* bias = (kOps & kOpBias) ? a.bias + (size_t)gb.zt * a.N : nullptr;
  const float* resid = static_cast<const float*>(a.resid);
  const int M = a.M, N = a.N, lda = a.lda, ldb = a.ldb;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (kLN) {
    gemm_ln_stats(A, M, a.K, lda, m0, row_mean, row_rstd);
    __syncthreads();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int seg = 0; seg < a.nseg; ++seg) {
    const float* As_g = A + seg * a.a_seg;
    const float* Bs_g = B + seg * a.b_seg;
    for (int k0 = gb.kbeg; k0 < gb.kend; k0 += kFmaBK) {
#pragma unroll
      for (int i = 0; i < (kBM * kFmaBK) / kGemmThreads; ++i) {
        const int e = tid + i * kGemmThreads;
        if (kAT) {  // [k][m]: consecutive threads walk m
          const int r = e / kBM, c = e % kBM;
          const int k = k0 + r, m = m0 + c;
          As[r][c] = k < gb.kend && m < M ? As_g[(size_t)k * lda + m] : 0.f;
        } else {  // [m][k]: consecutive threads walk k
          const int r = e / kFmaBK, c = e % kFmaBK;
          const int m = m0 + r, k = k0 + c;
          float v = 0.f;
          if (k < gb.kend && m < M) {
            v = As_g[(size_t)m * lda + k];
            if (kLN) v = ln_apply(v, row_mean[r], row_rstd[r], a.ln_scale[k], a.ln_bias[k]);
            if (kGelu) v = quick_gelu(v);
          }
          As[c][r] = v;
        }
        if (kBT) {  // [n][k]
          const int r = e / kFmaBK, c = e % kFmaBK;
          const int k = k0 + c;
          Bs[c][r] = k < gb.kend ? Bs_g[(size_t)(n0 + r) * ldb + k] : 0.f;
        } else {  // [k][n]
          const int r = e / kBN, c = e % kBN;
          const int k = k0 + r;
          Bs[r][c] = k < gb.kend ? Bs_g[(size_t)k * ldb + n0 + c] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFmaBK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[2 * j] = Bs[kk][2 * tx + 32 * j];
          bv[2 * j + 1] = Bs[kk][2 * tx + 32 * j + 1];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gemm_store<kOps, float>(C, resid, bias, N, m, n0 + 2 * tx + 32 * j, acc[i][2 * j], acc[i][2 * j + 1]);
    }
  }
}

// The tensor-core operand types.  A k-tile is 64 bytes of depth in both, so
// the shared-memory tiles, their padding and the ldmatrix addressing (in
// bytes) are one design: an int8 fragment of m16n8k32 holds 4 consecutive
// bytes of a row where a bf16 one of m16n8k16 holds 2 bf16.
template <typename T>
struct MmaOperand;
template <>
struct MmaOperand<bf16> {
  using Acc = float;
  static constexpr int kBK = 32;    // depth of a k-tile
  static constexpr int kStep = 16;  // depth of one mma
  static constexpr int kRow = 40;   // elements per row of a [128][kBK] tile: 80 B, conflict-free ldmatrix
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};
template <>
struct MmaOperand<int8_t> {
  using Acc = int;
  static constexpr int kBK = 64;
  static constexpr int kStep = 32;
  static constexpr int kRow = 80;
  // d += a (16x32, row) * b (32x8, col), int32 accumulate.
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint4 load16(const int8_t* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// int8 B, held [K, N], staged [n][k]: ldmatrix .trans moves 16-bit elements
// only.  Lane = 4 ng + kg holds the 4 x 4 byte block at k rows 4 kg.., n
// columns 4 ng.. (one row a word of w); a quad's lanes cover 16 k.  The block
// is transposed with byte permutes, and the quad swaps words so that lane
// 4 ng + kg returns the 16 k of column 4 ng + kg.
__device__ __forceinline__ uint4 s8_transpose_quad(uint4 w4, int lane) {
  const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
  const int kg = lane % 4;
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  // t[j]: the 4 k of column 4 ng + j.
  const uint32_t t[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                         __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
  // Lane kg of the quad gathers column kg: from quad lane s its k group s.
  // got[d] comes from lane (kg + d) & 3.
  uint32_t got[4];
  got[0] = pick4(t, kg);
#pragma unroll
  for (int d = 1; d < 4; ++d) got[d] = __shfl_sync(0xffffffffu, pick4(t, (kg - d) & 3), (lane & ~3) | ((kg + d) & 3));
  return make_uint4(pick4(got, (0 - kg) & 3), pick4(got, (1 - kg) & 3), pick4(got, (2 - kg) & 3),
                    pick4(got, (3 - kg) & 3));
}

// Tensor cores: 128 x 128 tiles, 8 warps in a 2 x 4 grid of 64 x 32 pieces;
// the next k-tile is read into registers while the tensor cores work on the
// current one.  Each bf16 operand tile sits in shared memory the way it is
// held in device memory, and ldmatrix (plain or .trans) turns it into
// fragments.  With kAT (A and B held [K, ...]) the contraction is masked by
// rows, so any K and split; otherwise K % kBK == 0 and the tile loop carries
// no contraction masks (launch_gemm checks).  T = int8_t (A [M, K], B [K, N],
// no prologue or epilogue, int32 out) stages B as [n][k] through
// s8_transpose_quad, so its fragments come from plain ldmatrix, as bf16's do
// from a B held [N, K].
constexpr int kMmaBK = MmaOperand<bf16>::kBK;
constexpr int kNarrow = MmaOperand<bf16>::kRow;
constexpr int kWide = kBM + 8;  // bf16 per row of a [32][128] tile: 272 B

template <bool kAT, bool kBT, int kOps, typename TOut, typename T = bf16>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_mma_kernel(const GemmArgs a) {
  using Op = MmaOperand<T>;
  constexpr bool kS8 = sizeof(T) == 1;
  constexpr int kBK = Op::kBK, kRow = Op::kRow;
  constexpr int kVec = 16 / (int)sizeof(T);       // elements in 16 bytes
  constexpr int kColScale = 2 / (int)sizeof(T);   // ldmatrix columns are bf16-wide
  constexpr bool kLN = kOps & kOpLN;
  constexpr bool kGelu = kOps & kOpGelu;
  static_assert(!((kLN || kGelu) && kAT), "the operand prologues read A held [M, K]");
  static_assert(!(kLN && kGelu), "one operand prologue");
  static_assert(!(kAT && kBT), "a masked contraction reads rows of A and B");
  static_assert(!kS8 || (!kAT && !kBT && kOps == kOpNone && sizeof(TOut) == 4),
                "the int8 GEMM: A [M, K], B [K, N], int32 out, no prologue or epilogue");
  __shared__ __align__(16) T As[kBM * kRow];  // [128][kRow], or [32][kWide] with kAT
  __shared__ __align__(16) T Bs[kBN * kRow];  // [32][kWide], or [128][kRow] with kBT or int8
  __shared__ float row_mean[kLN ? kBM : 1];
  __shared__ float row_rstd[kLN ? kBM : 1];
  const GemmBlock gb = gemm_block(a);
  const T* A = static_cast<const T*>(a.A) + gb.zt * a.a_z;
  const T* B = static_cast<const T*>(a.B) + gb.zt * a.b_z;
  TOut* C = static_cast<TOut*>(a.C) + gb.c_off;
  const float* bias = (kOps & kOpBias) ? a.bias + (size_t)gb.zt * a.N : nullptr;
  const TOut* resid = static_cast<const TOut*>(a.resid);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  // The loops read the arguments from registers.
  const int M = a.M, N = a.N, lda = a.lda, ldb = a.ldb, kbeg = gb.kbeg, kend = gb.kend;
  const long long a_seg = a.a_seg, b_seg = a.b_seg;
  const float* ln_scale = a.ln_scale;
  const float* ln_bias = a.ln_bias;
  const int per_seg = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  const int n_tiles = a.nseg * per_seg;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kLN) {
    gemm_ln_stats(A, M, a.K, lda, m0, row_mean, row_rstd);
    __syncthreads();
  }

  // Each thread moves two 16-byte pieces of each operand per k-tile (int8
  // B: two 4 x 4 byte blocks, one row a word).  The next tile to read starts
  // at column ld_k of the segment at Ag/Bg.
  uint4 a_reg[2], b_reg[2];
  const T* Ag = A;
  const T* Bg = B;
  int ld_k = kbeg;
  auto load_tiles = [&]() {
    const int k0 = ld_k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kGemmThreads;
      if (kAT) {  // 32 k-rows x 128 m
        const int r = e / 16, c = (e % 16) * 8;
        a_reg[i] = k0 + r < kend && m0 + c < M
                       ? load16(Ag + (size_t)(k0 + r) * lda + m0 + c) : zero;
      } else {  // 128 m-rows x kBK k
        const int r = e / 4, c = (e % 4) * kVec;
        a_reg[i] = m0 + r < M ? load16(Ag + (size_t)(m0 + r) * lda + k0 + c) : zero;
      }
      if constexpr (kS8) {  // 16 pieces of 16 k x 32 n, two a warp
        const int piece = warp + 8 * i, kb = piece / 4, nb = piece % 4;
        const T* src = Bg + (size_t)(k0 + kb * 16 + (lane % 4) * 4) * ldb + n0 + nb * 32 + (lane / 4) * 4;
        uint32_t w[4];
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) w[r4] = __ldg(reinterpret_cast<const uint32_t*>(src + (size_t)r4 * ldb));
        b_reg[i] = make_uint4(w[0], w[1], w[2], w[3]);
      } else if (kBT) {  // 128 n-rows x 32 k
        const int r = e / 4, c = (e % 4) * 8;
        b_reg[i] = load16(Bg + (size_t)(n0 + r) * ldb + k0 + c);
      } else {  // 32 k-rows x 128 n
        const int r = e / 16, c = (e % 16) * 8;
        b_reg[i] = !kAT || k0 + r < kend ? load16(Bg + (size_t)(k0 + r) * ldb + n0 + c) : zero;
      }
    }
    ld_k += kBK;
    if (ld_k >= kend) {
      ld_k = kbeg;
      Ag += a_seg;
      Bg += b_seg;
    }
  };
  // k0: the tile's first column (the LN prologue has one segment).
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kGemmThreads;
      if (kAT) {
        *reinterpret_cast<uint4*>(&As[(e / 16) * kWide + (e % 16) * 8]) = a_reg[i];
      } else {
        const int r = e / 4, c = (e % 4) * kVec;
        uint4 v = a_reg[i];
        if (kLN && m0 + r < M) {
          // 8 scales and biases in 16-byte pieces (fp32 vectors are 16-byte aligned).
          float g[8], b[8];
          *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(ln_scale + k0 + c);
          *reinterpret_cast<float4*>(g + 4) = *reinterpret_cast<const float4*>(ln_scale + k0 + c + 4);
          *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(ln_bias + k0 + c);
          *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(ln_bias + k0 + c + 4);
          bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            h[j] = __float2bfloat16_rn(ln_apply(__bfloat162float(h[j]), row_mean[r], row_rstd[r], g[j], b[j]));
          }
        }
        if (kGelu && m0 + r < M) {
          bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(quick_gelu(__bfloat162float(h[j])));
        }
        *reinterpret_cast<uint4*>(&As[r * kRow + c]) = v;
      }
      if constexpr (kS8) {
        const int piece = warp + 8 * i, kb = piece / 4, nb = piece % 4;
        *reinterpret_cast<uint4*>(&Bs[(nb * 32 + lane) * kRow + kb * 16]) = s8_transpose_quad(b_reg[i], lane);
      } else if (kBT) {
        *reinterpret_cast<uint4*>(&Bs[(e / 4) * kNarrow + (e % 4) * 8]) = b_reg[i];
      } else {
        *reinterpret_cast<uint4*>(&Bs[(e / 16) * kWide + (e % 16) * 8]) = b_reg[i];
      }
    }
  };

  typename Op::Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (n_tiles > 0) load_tiles();
  for (int t = 0; t < n_tiles; ++t) {
    store_tiles(kbeg + t * kBK);
    __syncthreads();
    if (t + 1 < n_tiles) load_tiles();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += Op::kStep) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mr = wm + mt * 16;
        if (kAT) {
          ldmatrix_x4_trans(af[mt], &As[(kk + ldm_row(lane, true)) * kWide + mr + ldm_col(lane, true)]);
        } else {
          ldmatrix_x4(af[mt], &As[(mr + ldm_row(lane, false)) * kRow + kk + kColScale * ldm_col(lane, false)]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nc = wn + np * 16;
        uint32_t r[4];
        if (kBT || kS8) {
          ldmatrix_x4(r, &Bs[(nc + ldm_row(lane, true)) * kRow + kk + kColScale * ldm_col(lane, true)]);
        } else {
          ldmatrix_x4_trans(r, &Bs[(kk + ldm_row(lane, false)) * kWide + nc + ldm_col(lane, false)]);
        }
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Op::mma(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + lane / 4 + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + (lane % 4) * 2;
        if constexpr (kS8) {  // int32 stored as it is
          *reinterpret_cast<int2*>(C + (size_t)m * N + n) = make_int2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        } else {
          gemm_store<kOps, TOut>(C, resid, bias, N, m, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

// Launch the GEMM over `towers` towers on the caller's stream.  T is the
// operand type; an fp32 GEMM writes fp32, an int8 one int32.
template <typename T, bool kAT, bool kBT, int kOps, typename TOut>
cudaError_t launch_gemm(const GemmArgs& g, int towers, cudaStream_t st) {
  const dim3 grid(g.N / kBN, (g.M + kBM - 1) / kBM, towers * g.splits);
  if constexpr (sizeof(T) == 4) {
    static_assert(sizeof(TOut) == 4, "an fp32 GEMM writes fp32");
    gemm_fma_kernel<kAT, kBT, kOps><<<grid, kGemmThreads, 0, st>>>(g);
  } else {
    constexpr int kBK = MmaOperand<T>::kBK;
    if (!kAT && (g.K % kBK != 0 || g.k_chunk % kBK != 0)) return cudaErrorInvalidValue;
    gemm_mma_kernel<kAT, kBT, kOps, TOut, T><<<grid, kGemmThreads, 0, st>>>(g);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention tiles: 64 rows (keys, or a query tile of kRows rows) x 64 head
// features in shared memory, and the product of two such tiles.  Used by the
// attention-block backward (attention_block_bwd.cu) and the attention kernels
// (attention.cu).

constexpr int kTile = 64;

template <typename T>
struct TileLayout {
  static constexpr int kStride = sizeof(T) == 4 ? kTile + 1 : kTile + 8;  // fp32: conflict-free column walks;
                                                                          // bf16: 144 B rows for ldmatrix
  static constexpr int kElems = kTile * kStride;
};
constexpr int kAccStride = kTile + 4;  // fp32 result tiles

// C[kRows][64] (=, or += with acc) sum over k < 64 of opA[m][k] * opB[k][n]:
// opA is A[m][k] (A held [k][m] with kAT), opB is B[k][n] (B held [n][k]
// with kBT).  Call from all 2 * kRows threads of the block; each warp (bf16:
// 16 rows) or thread (fp32: 8 rows x 4 columns) writes only its own outputs,
// so the caller syncs before reading C.
template <bool kAT, bool kBT, int kRows = kTile>
__device__ __forceinline__ void tile_product(float* C, int ldc, const float* A, int lda, const float* B, int ldb,
                                             bool acc) {
  constexpr int kStep = kRows / 8;  // rows between a thread's rows
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // rows ty + kStep i, cols tx + 16j
  float r[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float av[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = kAT ? A[k * lda + ty + kStep * i] : A[(ty + kStep * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = kBT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = fmaf(av[i], bv[j], r[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& c = C[(ty + kStep * i) * ldc + tx + 16 * j];
      c = acc ? c + r[i][j] : r[i][j];
    }
}

template <bool kAT, bool kBT, int kRows = kTile>
__device__ __forceinline__ void tile_product(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb,
                                             bool acc) {
  static_assert(kRows % 16 == 0, "one warp per 16 rows");
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) * 16;  // this warp's 16 rows
  float r[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    uint32_t af[4];
    if (kAT) {
      ldmatrix_x4_trans(af, &A[(ks * 16 + ldm_row(lane, true)) * lda + wr + ldm_col(lane, true)]);
    } else {
      ldmatrix_x4(af, &A[(wr + ldm_row(lane, false)) * lda + ks * 16 + ldm_col(lane, false)]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      if (kBT) {
        ldmatrix_x4(b, &B[(np * 16 + ldm_row(lane, true)) * ldb + ks * 16 + ldm_col(lane, true)]);
      } else {
        ldmatrix_x4_trans(b, &B[(ks * 16 + ldm_row(lane, false)) * ldb + np * 16 + ldm_col(lane, false)]);
      }
      mma_bf16(r[2 * np], af, b[0], b[1]);
      mma_bf16(r[2 * np + 1], af, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* c = &C[(wr + lane / 4 + half * 8) * ldc + nt * 8 + (lane % 4) * 2];
      c[0] = acc ? c[0] + r[nt][2 * half] : r[nt][2 * half];
      c[1] = acc ? c[1] + r[nt][2 * half + 1] : r[nt][2 * half + 1];
    }
}

// kRows rows (row0.., zeros past L) x 64 head features of src (row stride ld
// elements; rows 16-byte aligned) into a tile, in 16-byte pieces, by all
// kThreads threads of the block; with scale, T(v * scale).  The block size
// is a constant so the loop unrolls and its loads are all in flight at once.
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long ld, int row0, int L,
                                          float scale = 0.f) {
  constexpr int S = TileLayout<T>::kStride;
  constexpr int kVec = 16 / sizeof(T), kPieces = kHeadDim / kVec;
#pragma unroll
  for (int e = threadIdx.x; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces, c = (e % kPieces) * kVec, j = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (j < L) u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)j * ld + c));
    if constexpr (S * sizeof(T) % 16 == 0) {  // bf16 tile rows: one 16-byte store
      if (scale == 0.f) {
        *reinterpret_cast<uint4*>(&dst[r * S + c]) = u;
        continue;
      }
    }
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float f = to_f(v[i]);
      if (scale != 0.f) f = __fmul_rn(f, scale);
      dst[r * S + c + i] = from_f<T>(f);
    }
  }
}

}  // namespace flyp
