// Fused pre-LN attention sub-block, inference forward, for Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/attention_block.py::_fwd_infer_kernel (launched by
// _fwd_infer_call through pl.pallas_call).  For x [B, L, D] in the compute
// type T (float or bfloat16) it computes
//
//   y   = T(LN(x) in fp32)
//   q,k,v = T(y @ Wqkv[t] + bqkv[t])            fp32 accumulate, fp32 bias
//   q   = T(q * head_dim^-0.5)
//   o_h = T(T(softmax(q_h k_h^T + mask)) @ v_h)   fp32 scores, fp32 softmax
//   out = T(x + o @ Wout + bout)                  fp32 accumulate
//
// with the rounding points of the TPU kernel, so the plain PyTorch version
// (flyp_tpu_torch/ops/attention_block.py) agrees with it tightly in bf16.
//
// What bounds it on the H100: at ViT-B/16 widths (D=768, L=197) the two
// projections are 8 B L D^2 FLOPs against 4 B L^2 D for attention, and the
// whole block does ~1500 FLOPs per byte it must move, so the ideal kernel is
// bound by the tensor cores (68 us per B=64 launch at 989 TFLOP/s).  The
// TPU kernel held the whole [3, D, D] weight (3.4 MB bf16) in VMEM; the
// H100 gives a block 227 KB of shared memory, so the fusion is split into
// three kernels launched back to back on the caller's stream:
//
//   1. LN fused into the A-tile load of a tiled QKV GEMM (fp32 row stats
//      computed per block), bias epilogue, q/k/v written to scratch;
//   2. attention, one block per (query tile, head, batch item): scores for
//      the tile's full key range kept in shared memory so the softmax is
//      normalised before p is cast (the TPU kernel's rounding point); the
//      causal mask comes from indices and key tiles past the diagonal are
//      skipped; rows and keys past L are masked, never read as garbage;
//   3. the out-projection GEMM with a +x +bout epilogue.
//
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, fp32
// accumulate); fp32 tiles FMA on the CUDA cores, since the tensor cores
// would round fp32 operands to TF32.  wgmma/TMA pipelines and keeping
// q/k/v/o on chip are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kHeadDim = 64;
constexpr float kEps = 1e-5f;
constexpr int kThreads = 256;  // GEMM blocks
constexpr int kBM = 128, kBN = 128;

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

// (x - mean) * rstd * scale + bias, each step rounded as the plain version
// rounds it (no contraction into an FMA).
__device__ __forceinline__ float ln_apply(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// Two-pass fp32 mean and 1/sqrt(var + eps) of rows m0.. of A [M, K], one
// warp per row, into row_mean/row_rstd (zeros past M).
template <typename T>
__device__ void ln_row_stats(const T* __restrict__ A, int M, int K, int m0, float* row_mean, float* row_rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {
      const T* row = A + (size_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f(row[k]);
      mean = warp_sum(s) / (float)K;
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = to_f(row[k]) - mean;
        ss = fmaf(d, d, ss);
      }
      rstd = rsqrtf(warp_sum(ss) / (float)K + kEps);
    }
    if (lane == 0) {
      row_mean[r] = mean;
      row_rstd[r] = rstd;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA tiles on the CUDA cores.

constexpr int kFmaBK = 16;
constexpr int kApad = 4;  // As row padding: spreads the transposed stores over banks

// C[z] = A' @ W[z] + bias[z] (+ resid), row-major [M, K] x [K, N]; kLN:
// A' = LN(A).  N % 128 == 0, K % 16 == 0; rows past M are masked.  Each of
// 256 threads owns an 8 x 8 piece of the 128 x 128 output tile.
template <bool kLN>
__global__ void __launch_bounds__(kThreads)
gemm_fma_kernel(const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ bias,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                const float* __restrict__ resid, float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kFmaBK][kBM + kApad];
  __shared__ float Bs[kFmaBK][kBN];
  __shared__ float row_mean[kBM];
  __shared__ float row_rstd[kBM];

  W += (size_t)blockIdx.z * K * N;
  C += (size_t)blockIdx.z * M * N;
  bias += (size_t)blockIdx.z * N;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (kLN) {
    ln_row_stats(A, M, K, m0, row_mean, row_rstd);
    __syncthreads();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kFmaBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kFmaBK, c = e % kFmaBK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M) {
        v = A[(size_t)m * K + k];
        if (kLN) v = ln_apply(v, row_mean[r], row_rstd[r], ln_scale[k], ln_bias[k]);
      }
      As[c][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (kFmaBK * kBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      Bs[r][c] = W[(size_t)(k0 + r) * N + n0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = acc[i][j];
      v = resid != nullptr ? __fadd_rn(__fadd_rn(resid[(size_t)m * N + n], v), bias[n]) : __fadd_rn(v, bias[n]);
      C[(size_t)m * N + n] = v;
    }
  }
}

constexpr int kFmaQT = 32, kFmaKT = 64;
constexpr int kAttnThreads = 128;
constexpr int kRow = kHeadDim + 1;  // padded smem row: conflict-free column walks

// Row softmax over a row's visible keys in fp32; masked keys and rows past
// L get p = 0 (exp of the TPU kernel's -1e30 bias is exactly 0).  The
// caller's warp owns the row.
__device__ __forceinline__ void row_softmax_stats(const float* row, int visible, float& m, float& l) {
  const int lane = threadIdx.x % 32;
  m = -INFINITY;
  for (int j = lane; j < visible; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  l = 0.f;
  for (int j = lane; j < visible; j += 32) l += expf(row[j] - m);
  l = warp_sum(l);
}

// fp32 attention over q/k/v [3, B*L, D] (heads head-major along D).  One
// block per (query tile, head, batch item); the tile's scores over every key
// it may see stay in shared memory ([kFmaQT, s_cols] fp32).
__global__ void __launch_bounds__(kAttnThreads)
attention_fma_kernel(const float* __restrict__ qkv, float* __restrict__ O, int L, int D, float scale, int causal,
                     int s_cols) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kFmaQT][kRow]
  float* KV = Qs + kFmaQT * kRow;   // [kFmaKT][kRow]
  float* S = KV + kFmaKT * kRow;    // [kFmaQT][s_cols]

  const int q0 = blockIdx.x * kFmaQT;
  const size_t MD = (size_t)gridDim.z * L * D;
  const float* Q = qkv;
  const float* Kt = qkv + MD;
  const float* V = qkv + 2 * MD;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * kHeadDim;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 8 threads
  const int q_end = min(q0 + kFmaQT, L);
  const int kv_len = causal ? q_end : L;  // keys any row of this tile may see
  const int n_tiles = (kv_len + kFmaKT - 1) / kFmaKT;

  for (int e = tid; e < kFmaQT * kHeadDim; e += kAttnThreads) {
    const int r = e / kHeadDim, d = e % kHeadDim;
    const int i = q0 + r;
    Qs[r * kRow + d] = i < L ? __fmul_rn(Q[base + (size_t)i * D + d], scale) : 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFmaKT;
    __syncthreads();
    for (int e = tid; e < kFmaKT * kHeadDim; e += kAttnThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      const int j = k0 + r;
      KV[r * kRow + d] = j < L ? Kt[base + (size_t)j * D + d] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 8 * i) * kRow + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KV[(tx + 16 * j) * kRow + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty + 8 * i) * s_cols + k0 + tx + 16 * j] = s[i][j];
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int cols = n_tiles * kFmaKT;
  for (int r = warp; r < kFmaQT; r += kAttnThreads / 32) {
    const int i = q0 + r;
    float* row = S + (size_t)r * s_cols;
    const int visible = i < L ? (causal ? i + 1 : L) : 0;
    float m, l;
    row_softmax_stats(row, visible, m, l);
    for (int j = lane; j < cols; j += 32) row[j] = j < visible ? __fdiv_rn(expf(row[j] - m), l) : 0.f;
  }

  float acc[4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFmaKT;
    __syncthreads();
    for (int e = tid; e < kFmaKT * kHeadDim; e += kAttnThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      const int j = k0 + r;
      KV[r * kRow + d] = j < L ? V[base + (size_t)j * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kFmaKT; ++jj) {
      float p[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 8 * i) * s_cols + k0 + jj];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = KV[jj * kRow + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) O[base + (size_t)row * D + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 on the tensor cores, fp32 accumulate.

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

// Fragment lanes: accumulator element e of lane l sits at row l/4 (+8 for
// e >= 2) and column 2*(l%4) (+1 for odd e) of the 16 x 8 tile.

constexpr int kMmaBK = 32;
constexpr int kAStride = kMmaBK + 8;  // bf16 per As row: 80 B, conflict-free ldmatrix
constexpr int kBStride = kBN + 8;     // bf16 per Bs row: 272 B

// The bf16 counterpart of gemm_fma_kernel: 8 warps in a 2 x 4 grid, each
// owning a 64 x 32 piece of the 128 x 128 tile.  The next k-tile is read
// into registers while the tensor cores work on the current one; the
// LayerNorm is applied (and rounded to bf16) when the tile is stored to
// shared memory.  N % 128 == 0, K % 32 == 0.
template <bool kLN>
__global__ void __launch_bounds__(kThreads)
gemm_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, const float* __restrict__ bias,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                const bf16* __restrict__ resid, bf16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) bf16 As[kBM * kAStride];
  __shared__ __align__(16) bf16 Bs[kMmaBK * kBStride];
  __shared__ float row_mean[kBM];
  __shared__ float row_rstd[kBM];

  W += (size_t)blockIdx.z * K * N;
  C += (size_t)blockIdx.z * M * N;
  bias += (size_t)blockIdx.z * N;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  if (kLN) {
    ln_row_stats(A, M, K, m0, row_mean, row_rstd);
    __syncthreads();
  }

  // Each thread moves two 16-byte pieces of A (128 x 32) and of W (32 x 128).
  uint4 a_reg[2], b_reg[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / 4, c = (e % 4) * 8;
      a_reg[i] = m0 + r < M ? *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c)
                            : make_uint4(0u, 0u, 0u, 0u);
      const int rb = e / 16, cb = (e % 16) * 8;
      b_reg[i] = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + rb) * N + n0 + cb);
    }
  };
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / 4, c = (e % 4) * 8;
      uint4 v = a_reg[i];
      if (kLN && m0 + r < M) {
        bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          h[j] = __float2bfloat16_rn(
              ln_apply(__bfloat162float(h[j]), row_mean[r], row_rstd[r], ln_scale[k0 + c + j], ln_bias[k0 + c + j]));
        }
      }
      *reinterpret_cast<uint4*>(&As[r * kAStride + c]) = v;
      const int rb = e / 16, cb = (e % 16) * 8;
      *reinterpret_cast<uint4*>(&Bs[rb * kBStride + cb]) = b_reg[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    store_tiles(k0);
    __syncthreads();
    if (k0 + kMmaBK < K) load_tiles(k0 + kMmaBK);
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        ldmatrix_x4(a[mt], &As[(wm + mt * 16 + lane % 16) * kAStride + kk + (lane / 16) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[(kk + lane % 16) * kBStride + wn + np * 16 + (lane / 16) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
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
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (resid != nullptr) {
          const bf162 x = *reinterpret_cast<const bf162*>(resid + (size_t)m * N + n);
          v0 = __fadd_rn(__fadd_rn(__low2float(x), v0), bias[n]);
          v1 = __fadd_rn(__fadd_rn(__high2float(x), v1), bias[n + 1]);
        } else {
          v0 = __fadd_rn(v0, bias[n]);
          v1 = __fadd_rn(v1, bias[n + 1]);
        }
        *reinterpret_cast<bf162*>(C + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

constexpr int kMmaQT = 64;               // query rows per block: 4 warps x 16
constexpr int kMmaKT = 64;               // keys per K/V tile
constexpr int kHStride = kHeadDim + 8;   // bf16 per Q/K/V smem row: 144 B

// Copy 64 rows x 64 head features of q, k or v into smem (zeros past L).
__device__ __forceinline__ void load_head_tile(bf16* dst, const bf16* __restrict__ src, size_t base, int row0,
                                               int L, int D) {
  for (int e = threadIdx.x; e < 64 * (kHeadDim / 8); e += kAttnThreads) {
    const int r = e / (kHeadDim / 8), c = (e % (kHeadDim / 8)) * 8;
    const int j = row0 + r;
    *reinterpret_cast<uint4*>(&dst[r * kHStride + c]) =
        j < L ? *reinterpret_cast<const uint4*>(src + base + (size_t)j * D + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// bf16 attention: one block of 4 warps per (64-row query tile, head, batch
// item), each warp owning 16 query rows.  Scores go through the tensor cores
// into fp32 shared memory ([64, s_stride]); the softmax runs in fp32 and
// writes p as bf16 over the front of its own score row; p @ v goes through
// the tensor cores again.
__global__ void __launch_bounds__(kAttnThreads)
attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ O, int L, int D, float scale, int causal,
                     int s_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);            // [64][kHStride]
  bf16* KV = Qs + kMmaQT * kHStride;                       // [64][kHStride]
  float* S = reinterpret_cast<float*>(KV + kMmaKT * kHStride);  // [64][s_stride]

  const int q0 = blockIdx.x * kMmaQT;
  const size_t MD = (size_t)gridDim.z * L * D;
  const bf16* Q = qkv;
  const bf16* Kt = qkv + MD;
  const bf16* V = qkv + 2 * MD;
  const size_t base = (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * kHeadDim;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_end = min(q0 + kMmaQT, L);
  const int kv_len = causal ? q_end : L;  // keys any row of this tile may see
  const int n_tiles = (kv_len + kMmaKT - 1) / kMmaKT;
  const int wr = warp * 16;  // this warp's first row in the tile

  // q is scaled after its cast to bf16, and the product rounds to bf16 again.
  load_head_tile(Qs, Q, base, q0, L, D);
  __syncthreads();
  for (int e = tid; e < kMmaQT * kHeadDim; e += kAttnThreads) {
    bf16& q = Qs[(e / kHeadDim) * kHStride + e % kHeadDim];
    q = __float2bfloat16_rn(__fmul_rn(__bfloat162float(q), scale));
  }
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qa[ks], &Qs[(wr + lane % 16) * kHStride + ks * 16 + (lane / 16) * 8]);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaKT;
    __syncthreads();
    load_head_tile(KV, Kt, base, k0, L, D);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // k rows are the columns of the 16 x 8 B tiles: no transpose.
        uint32_t r[4];
        ldmatrix_x4(r, &KV[(np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kHStride + ks * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * np], qa[ks], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa[ks], r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = k0 + nt * 8 + (lane % 4) * 2;
      const int r = wr + lane / 4;
      *reinterpret_cast<float2*>(&S[r * s_stride + c]) = make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(&S[(r + 8) * s_stride + c]) = make_float2(s[nt][2], s[nt][3]);
    }
  }
  __syncwarp();

  // Softmax of the warp's 16 rows.  p[j] (bf16) overwrites bytes 2j..2j+1
  // of its own fp32 row, which only ever covers scores already read.
  const int cols = n_tiles * kMmaKT;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wr + rr, i = q0 + r;
    float* row = S + (size_t)r * s_stride;
    bf16* prow = reinterpret_cast<bf16*>(row);
    const int visible = i < L ? (causal ? i + 1 : L) : 0;
    float m, l;
    row_softmax_stats(row, visible, m, l);
    for (int j0 = 0; j0 < cols; j0 += 32) {
      const int j = j0 + lane;
      const float v = row[j];
      __syncwarp();
      prow[j] = __float2bfloat16_rn(j < visible ? __fdiv_rn(expf(v - m), l) : 0.f);
      __syncwarp();
    }
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const bf16* P = reinterpret_cast<const bf16*>(S);
  const int p_stride = 2 * s_stride;  // bf16 per row
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaKT;
    __syncthreads();
    load_head_tile(KV, V, base, k0, L, D);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      ldmatrix_x4(pa, &P[(wr + lane % 16) * p_stride + k0 + ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &KV[(ks * 16 + lane % 16) * kHStride + np * 16 + (lane / 16) * 8]);
        mma_bf16(o[2 * np], pa, r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + wr + lane / 4 + half * 8;
    if (i >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + (lane % 4) * 2;
      *reinterpret_cast<bf162*>(O + base + (size_t)i * D + d) =
          __floats2bfloat162_rn(o[nt][2 * half], o[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

cudaError_t launch_fp32(const float* x, const float* g, const float* beta, const float* wqkv, const float* bqkv,
                        const float* wout, const float* bout, float* out, float* qkv, float* o, int B, int L,
                        int D, int H, int causal, cudaStream_t stream) {
  const int M = B * L;
  gemm_fma_kernel<true><<<dim3(D / kBN, (M + kBM - 1) / kBM, 3), kThreads, 0, stream>>>(
      x, wqkv, bqkv, g, beta, nullptr, qkv, M, D, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int s_cols = ((L + kFmaKT - 1) / kFmaKT) * kFmaKT;
  const size_t smem = (size_t)(kFmaQT * kRow + kFmaKT * kRow + kFmaQT * s_cols) * sizeof(float);
  err = cudaFuncSetAttribute(attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_fma_kernel<<<dim3((L + kFmaQT - 1) / kFmaQT, H, B), kAttnThreads, smem, stream>>>(
      qkv, o, L, D, 1.0f / sqrtf((float)kHeadDim), causal, s_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_fma_kernel<false><<<dim3(D / kBN, (M + kBM - 1) / kBM, 1), kThreads, 0, stream>>>(
      o, wout, bout, nullptr, nullptr, x, out, M, D, D);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* x, const float* g, const float* beta, const bf16* wqkv, const float* bqkv,
                        const bf16* wout, const float* bout, bf16* out, bf16* qkv, bf16* o, int B, int L, int D,
                        int H, int causal, cudaStream_t stream) {
  const int M = B * L;
  gemm_mma_kernel<true><<<dim3(D / kBN, (M + kBM - 1) / kBM, 3), kThreads, 0, stream>>>(
      x, wqkv, bqkv, g, beta, nullptr, qkv, M, D, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Score rows padded by 4 floats: 16-byte shifted rows keep ldmatrix on p
  // free of bank conflicts.
  const int s_stride = ((L + kMmaKT - 1) / kMmaKT) * kMmaKT + 4;
  const size_t smem = (size_t)(kMmaQT + kMmaKT) * kHStride * sizeof(bf16) + (size_t)kMmaQT * s_stride * sizeof(float);
  err = cudaFuncSetAttribute(attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<<<dim3((L + kMmaQT - 1) / kMmaQT, H, B), kAttnThreads, smem, stream>>>(
      qkv, o, L, D, 1.0f / sqrtf((float)kHeadDim), causal, s_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_mma_kernel<false><<<dim3(D / kBN, (M + kBM - 1) / kBM, 1), kThreads, 0, stream>>>(
      o, wout, bout, nullptr, nullptr, x, out, M, D, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  qkv_scratch holds 3*B*L*D and
// o_scratch B*L*D elements of the compute type.  Returns a cudaError_t.
int flyp_attention_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                             const void* bqkv, const void* wout, const void* bout, void* out,
                             void* qkv_scratch, void* o_scratch, int B, int L, int D, int H, int causal,
                             int dtype, void* stream) {
  if (D != H * kHeadDim || D % kBN != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  const float* bq = static_cast<const float*>(bqkv);
  const float* bo = static_cast<const float*>(bout);
  if (dtype == 0) {
    return (int)launch_fp32(static_cast<const float*>(x), g, beta, static_cast<const float*>(wqkv), bq,
                            static_cast<const float*>(wout), bo, static_cast<float*>(out),
                            static_cast<float*>(qkv_scratch), static_cast<float*>(o_scratch), B, L, D, H, causal, s);
  }
  if (dtype == 1) {
    return (int)launch_bf16(static_cast<const bf16*>(x), g, beta, static_cast<const bf16*>(wqkv), bq,
                            static_cast<const bf16*>(wout), bo, static_cast<bf16*>(out),
                            static_cast<bf16*>(qkv_scratch), static_cast<bf16*>(o_scratch), B, L, D, H, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
