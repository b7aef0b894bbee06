// Device helpers, the fp32 GEMM and the 64-wide attention tiles shared by the
// package's kernels (attention block forward and backward, MLP block,
// attention).  The bf16 and int8 products run on gemm_sm90.cuh.

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

// ---------------------------------------------------------------------------
// The fp32 GEMM: C[z] = sum over segments of op(A) op(B) (+ resid) (+ bias),
// where A is held [M, K] (or [K, M] with kAT) and B [K, N] (or [N, K] with
// kBT), row major with leading dimensions lda/ldb.  blockIdx.z = zt * splits
// + s: zt picks a tower (A += zt*a_z, B += zt*b_z, bias += zt*N) and s a
// chunk of the contraction, whose partial goes to C[s][zt] ([M, N] each).
// Rows past M, columns past N and the contraction past K read as zeros;
// columns past N are not stored (N even: a head shard's 64 H).  It
// runs FMA tiles on the CUDA cores, since the tensor cores would round fp32
// operands to TF32.
//
// kOps says what else it does, at compile time.  Operand prologues (A held
// [M, K]): kOpLN (one segment, one split): A' = LN(A) over A's K columns
// with ln_scale/ln_bias; kOpGelu: A' = quick_gelu(A).  The epilogue, in fp32
// with each step rounded (shared with gemm_sm90.cuh): kOpResid adds resid
// (an [M, N] tensor of the output type), then kOpBias adds bias (with
// kOpResidLast the bias first, then resid: resid + (acc + bias)); then C
// rounds to its type.

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
          Bs[c][r] = k < gb.kend && n0 + r < N ? Bs_g[(size_t)(n0 + r) * ldb + k] : 0.f;
        } else {  // [k][n]
          const int r = e / kBN, c = e % kBN;
          const int k = k0 + r;
          Bs[r][c] = k < gb.kend && n0 + c < N ? Bs_g[(size_t)k * ldb + n0 + c] : 0.f;
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
      const int n = n0 + 2 * tx + 32 * j;
      if (n < N) gemm_store<kOps, float>(C, resid, bias, N, m, n, acc[i][2 * j], acc[i][2 * j + 1]);
    }
  }
}

// Launch the fp32 GEMM over `towers` towers on the caller's stream.
template <bool kAT, bool kBT, int kOps>
cudaError_t launch_gemm(const GemmArgs& g, int towers, cudaStream_t st) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, towers * g.splits);
  gemm_fma_kernel<kAT, kBT, kOps><<<grid, kGemmThreads, 0, st>>>(g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention tiles: 64 rows (keys, or a query tile of kRows rows) x 64 head
// features in shared memory (bf16 rows for the mma.sync routes of
// attention.cuh), and the fp32 product of two such tiles (its fp32 route).

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
// with kBT), in fp32 on the CUDA cores.  Call from all 2 * kRows threads of
// the block; each thread (8 rows x 4 columns) writes only its own outputs,
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

// kRows rows (row0.., zeros past L) x 64 fp32 head features of src (row
// stride ld elements; rows 16-byte aligned) into a tile, in 16-byte pieces,
// by all kThreads threads of the block; with scale, v * scale.  The block
// size is a constant so the loop unrolls and its loads are all in flight at
// once.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long long ld, int row0, int L,
                                          float scale = 0.f) {
  constexpr int S = TileLayout<float>::kStride;
  constexpr int kVec = 4, kPieces = kHeadDim / kVec;
#pragma unroll
  for (int e = threadIdx.x; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces, c = (e % kPieces) * kVec, j = row0 + r;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < L) u = __ldg(reinterpret_cast<const float4*>(src + (size_t)j * ld + c));
    const float v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * S + c + i] = scale != 0.f ? __fmul_rn(v[i], scale) : v[i];
  }
}

}  // namespace flyp
