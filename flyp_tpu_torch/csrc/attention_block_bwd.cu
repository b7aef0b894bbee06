// Fused pre-LN attention sub-block, training backward, for Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/attention_block.py::_bwd_kernel (launched by
// _bwd_call through pl.pallas_call).  From the block's input x [B, L, D],
// the output cotangent g and the forward's saved q, k, v [B, L, D] and
// lse [B, L, H] (compute type T = float or bfloat16; lse fp32) it computes
// dx (T), dWqkv [3, D, D], dbqkv [3, D], dscale [D] and dbias [D] (fp32),
// rounding where the TPU kernel rounds:
//
//   y    = T(LN(x))                       recomputed from x
//   do   = T(g @ Wout^T)
//   p    = exp(T(q*scale) k^T + mask - lse)        fp32
//   dv   = T(T(p)^T do)
//   dp   = do v^T,  delta = rowsum(p * dp)          fp32
//   ds   = T(p * (dp - delta))
//   dq   = T((ds k) * scale),  dk = T(ds^T T(q*scale))
//   dWqkv[t] = y^T d_t,  dbqkv[t] = colsum(d_t)     fp32 over all B*L rows
//   dY   = sum_t d_t Wqkv[t]^T                      fp32
//   dx   = T(rstd (dY*s - mean(dY*s) - xhat mean(dY*s*xhat)) + g)
//   dscale = colsum(dY * xhat),  dbias = colsum(dY)
//
// (dWout and dbout are plain products over the saved o, outside, as in the
// JAX package.)  What bounds it: ~14 B L D^2 FLOPs of projections (do, dW,
// dY) and 10 B L^2 D of attention products against a few [B, L, D] reads
// and writes, so the tensor cores bound the ideal kernel, as in the forward.
//
// The TPU kernel walks the batch in order and carries dWqkv/dbqkv/dscale/
// dbias across its grid in VMEM.  Blocks on the H100 run in no order, so
// every sum over rows is deterministic instead: dWqkv is one GEMM whose
// contraction runs over all B*L rows (split in a fixed number of chunks,
// partials summed in a fixed order), and the column sums are per-block
// partials reduced by one more pass.  No atomics, so a run repeats bit for
// bit.  The launches, in order, on the caller's stream:
//
//   1. y = T(LN(x)) into scratch;
//   2. do = T(g @ Wout^T)                    (GEMM, B held transposed);
//   3. attention pass (a), per (query tile, head, item): p and dp for the
//      tile's full key range in shared memory, delta, ds (to scratch), dq;
//   4. attention pass (b), per (key tile, head, item): p recomputed from lse
//      tile by tile, dv and dk accumulated over the query tiles;
//   5. dbqkv: column partials of d_t, then their sum;
//   6. dWqkv: y^T d_t per tower, split over rows, then the partials' sum;
//   7. dY = sum_t d_t Wqkv[t]^T              (GEMM, 3 D-long segments);
//   8. LN backward per row with dscale/dbias partials per block, then their
//      sum.
//
// The three GEMMs (do, dWqkv, dY) are the forward's tiled GEMM from
// common.cuh with other operand layouts.  bf16 products run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulate); fp32 products are FMA tiles on
// the CUDA cores, since the tensor cores would round fp32 operands to TF32.

#include "common.cuh"

#include <algorithm>

namespace {

using namespace flyp;

constexpr int kThreads = 256;  // LN and reduction blocks
constexpr int kAttnThreads = 128;
constexpr int kTile = 64;  // attention tiles: 64 rows x 64 (keys or head features)
constexpr int kMaxL = 320;  // the attention passes keep full score rows of this many keys in shared memory

// ---------------------------------------------------------------------------
// Row LayerNorm.

// y = T(LN(x)), one warp per row (the row statistics of the forward's QKV
// GEMM, so y is recomputed exactly).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_forward_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
                  T* __restrict__ y, int M, int D) {
  const int m = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;
  const T* row = x + (size_t)m * D;
  float mean, rstd;
  row_stats(row, D, mean, rstd);
  for (int k = lane; k < D; k += 32) y[(size_t)m * D + k] = from_f<T>(ln_apply(to_f(row[k]), mean, rstd, g[k], b[k]));
}

constexpr int kMaxCols = 32;  // columns per lane: D <= 1024

// dx = T(rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) + g) with
// dxhat = dY * scale, for rows [blockIdx.x * rows, +rows); one warp per row.
// The block's column sums of dY * xhat and dY go to partial[blockIdx.x] as
// [2, D] (dscale, dbias), summed over the block's warps in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_backward_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ dY,
                   const float* __restrict__ scale, T* __restrict__ dx, float* __restrict__ partial, int M, int D,
                   int rows) {
  __shared__ float red[2 * 1024];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m_end = min(M, ((int)blockIdx.x + 1) * rows);
  float acc_s[kMaxCols], acc_b[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc_s[c] = acc_b[c] = 0.f;

  for (int m = (int)blockIdx.x * rows + warp; m < m_end; m += kThreads / 32) {
    const T* xr = x + (size_t)m * D;
    const float* dyr = dY + (size_t)m * D;
    // Row statistics with lane l reading elements l, l + 32, ..., as the
    // loops below do (reading the row in row_stats' 16-byte pieces instead
    // makes this kernel 40% slower).
    float mean = 0.f, rstd = 0.f;
    for (int k = lane; k < D; k += 32) mean += to_f(xr[k]);
    mean = warp_sum(mean) / (float)D;
    for (int k = lane; k < D; k += 32) {
      const float d = to_f(xr[k]) - mean;
      rstd = fmaf(d, d, rstd);
    }
    rstd = rsqrtf(warp_sum(rstd) / (float)D + kEps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int k = lane + 32 * c;
      if (k < D) {
        const float xhat = __fmul_rn(__fsub_rn(to_f(xr[k]), mean), rstd);
        const float dy = dyr[k];
        const float dxhat = __fmul_rn(dy, scale[k]);
        s1 += dxhat;
        s2 += __fmul_rn(dxhat, xhat);
        acc_s[c] += __fmul_rn(dy, xhat);
        acc_b[c] += dy;
      }
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int k = lane + 32 * c;
      if (k < D) {
        const float xhat = __fmul_rn(__fsub_rn(to_f(xr[k]), mean), rstd);
        const float dxhat = __fmul_rn(dyr[k], scale[k]);
        const float v = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dxhat, m1), __fmul_rn(xhat, m2)));
        dx[(size_t)m * D + k] = from_f<T>(__fadd_rn(v, to_f(gout[(size_t)m * D + k])));
      }
    }
  }

  for (int w = 0; w < kThreads / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int k = lane + 32 * c;
        if (k < D) {
          red[k] = w == 0 ? acc_s[c] : red[k] + acc_s[c];
          red[D + k] = w == 0 ? acc_b[c] : red[D + k] + acc_b[c];
        }
      }
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < 2 * D; k += kThreads) partial[(size_t)blockIdx.x * 2 * D + k] = red[k];
}

// ---------------------------------------------------------------------------
// Deterministic sums over rows.

// partial[c][z][n] = sum of src[z][m][n] over rows m of chunk c (fp32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
colsum_partial_kernel(const T* __restrict__ src, float* __restrict__ partial, int M, int N, int rows) {
  const int n = blockIdx.x * kThreads + threadIdx.x, c = blockIdx.y, z = blockIdx.z;
  if (n >= N) return;
  const T* p = src + (size_t)z * M * N + n;
  float s = 0.f;
  for (int m = c * rows; m < min(M, (c + 1) * rows); ++m) s += to_f(p[(size_t)m * N]);
  partial[((size_t)c * gridDim.z + z) * N + n] = s;
}

// out[x] = sum over p of partial[p][x], in order of p.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial, int parts, long long X, float* __restrict__ out) {
  for (long long x = (long long)blockIdx.x * kThreads + threadIdx.x; x < X; x += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partial[p * X + x];
    out[x] = s;
  }
}

// ---------------------------------------------------------------------------
// Attention backward.  Both passes work on 64 x 64 tiles in shared memory and
// run every product through tile_product, which writes (or adds) an fp32
// 64 x 64 result into shared memory; the elementwise steps then read fp32.

template <typename T>
struct TileLayout {
  static constexpr int kStride = sizeof(T) == 4 ? kTile + 1 : kTile + 8;  // fp32: conflict-free column walks;
                                                                          // bf16: 144 B rows for ldmatrix
  static constexpr int kElems = kTile * kStride;
};
constexpr int kAccStride = kTile + 4;  // fp32 result tiles

// C[64][64] (=, or += with acc) sum over k < 64 of opA[m][k] * opB[k][n]:
// opA is A[m][k] (A held [k][m] with kAT), opB is B[k][n] (B held [n][k]
// with kBT).  Call from all 128 threads; each warp (bf16) or thread (fp32)
// writes only its own outputs, so the caller syncs before reading C.
template <bool kAT, bool kBT>
__device__ __forceinline__ void tile_product(float* C, int ldc, const float* A, int lda, const float* B, int ldb,
                                             bool acc) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // rows ty + 8i, cols tx + 16j
  float r[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float av[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = kAT ? A[k * lda + ty + 8 * i] : A[(ty + 8 * i) * lda + k];
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
      float& c = C[(ty + 8 * i) * ldc + tx + 16 * j];
      c = acc ? c + r[i][j] : r[i][j];
    }
}

template <bool kAT, bool kBT>
__device__ __forceinline__ void tile_product(float* C, int ldc, const bf16* A, int lda, const bf16* B, int ldb,
                                             bool acc) {
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

// 64 rows (row0.., zeros past L) x 64 head features at src + base (row
// stride D) into a tile; with scale, T(v * scale) as the forward scales q.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, size_t base, int row0, int L, int D,
                                          float scale = 0.f) {
  constexpr int S = TileLayout<T>::kStride;
  for (int e = threadIdx.x; e < kTile * kHeadDim; e += kAttnThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim, j = row0 + r;
    float v = j < L ? to_f(src[base + (size_t)j * D + c]) : 0.f;
    if (scale != 0.f) v = __fmul_rn(v, scale);
    dst[r * S + c] = from_f<T>(v);
  }
}

struct AttnArgs {
  const void *q, *k, *v, *dout;  // [B, L, D] each
  const float* lse;              // [B, L, H]
  void* ds;                      // [B, H, L, L] scratch
  void *dq, *dk, *dv;            // [B, L, D] each
  int L, D, causal;
  float scale;
  int s_stride;                  // fp32 per score row in pass (a)
};

// Pass (a): one block per (64-row query tile, head, batch item).  p and dp
// over the tile's full key range in shared memory, delta = rowsum(p * dp),
// ds = T(p * (dp - delta)) (to scratch, and over the front of the score
// rows), then dq = T((ds k) * scale).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attention_bwd_dq_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);              // T(q * scale), [64][TS]
  T* dOs = Qs + TileLayout<T>::kElems;                 // do
  T* KVs = dOs + TileLayout<T>::kElems;                // k, then v, then k again
  float* S = reinterpret_cast<float*>(KVs + TileLayout<T>::kElems);  // p, then ds; [64][s_stride]
  float* DP = S + kTile * a.s_stride;                  // dp, then the dq sums
  float* lse_s = DP + kTile * a.s_stride;              // [64]

  const int L = a.L, D = a.D, H = gridDim.y, h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kTile;
  const size_t base = (size_t)b * L * D + (size_t)h * kHeadDim;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const int q_end = min(i0 + kTile, L);
  const int kv_len = a.causal ? q_end : L;
  const int n_tiles = (kv_len + kTile - 1) / kTile, cols = n_tiles * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_tile(Qs, Q, base, i0, L, D, a.scale);
  load_tile(dOs, static_cast<const T*>(a.dout), base, i0, L, D);
  for (int r = tid; r < kTile; r += kAttnThreads) {
    lse_s[r] = i0 + r < L ? a.lse[((size_t)b * L + i0 + r) * H + h] : 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(KVs, K, base, k0, L, D);
    __syncthreads();
    tile_product<false, true>(S + k0, a.s_stride, Qs, TS, KVs, TS, false);  // s = qs k^T
    __syncthreads();
    load_tile(KVs, V, base, k0, L, D);
    __syncthreads();
    tile_product<false, true>(DP + k0, a.s_stride, dOs, TS, KVs, TS, false);  // dp = do v^T
  }
  __syncthreads();

  // One warp per row: p, delta, ds.  ds[j] in T overwrites the front of the
  // row (bf16: bytes 2j..2j+1, which only ever cover entries already read).
  T* ds_g = static_cast<T*>(a.ds) + ((size_t)b * H + h) * L * L;
  const int ds_stride = a.s_stride * (int)(sizeof(float) / sizeof(T));
  for (int r = warp; r < kTile; r += kAttnThreads / 32) {
    const int i = i0 + r;
    const int visible = i < L ? (a.causal ? i + 1 : L) : 0;
    float* srow = S + (size_t)r * a.s_stride;
    const float* dprow = DP + (size_t)r * a.s_stride;
    float delta = 0.f;
    for (int j = lane; j < cols; j += 32) {
      const float p = j < visible ? expf(srow[j] - lse_s[r]) : 0.f;
      srow[j] = p;
      delta += p * dprow[j];
    }
    delta = warp_sum(delta);
    T* dsrow = reinterpret_cast<T*>(srow);
    for (int j0 = 0; j0 < cols; j0 += 32) {
      const int j = j0 + lane;
      const T ds = from_f<T>(__fmul_rn(srow[j], __fsub_rn(dprow[j], delta)));
      __syncwarp();
      dsrow[j] = ds;
      if (i < L && j < L) ds_g[(size_t)i * L + j] = ds;
      __syncwarp();
    }
  }

  // dq sums over the key tiles, into the (now free) dp rows.
  const T* dS = reinterpret_cast<const T*>(S);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(KVs, K, base, k0, L, D);
    __syncthreads();
    tile_product<false, false>(DP, a.s_stride, dS + k0, ds_stride, KVs, TS, t > 0);
  }
  __syncthreads();
  T* dQ = static_cast<T*>(a.dq);
  for (int e = tid; e < kTile * kHeadDim; e += kAttnThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    if (i0 + r < L) dQ[base + (size_t)(i0 + r) * D + c] = from_f<T>(__fmul_rn(DP[r * a.s_stride + c], a.scale));
  }
}

// Pass (b): one block per (64-key tile, head, batch item), walking the query
// tiles that can see its keys: p^T recomputed from lse, dv += T(p)^T do and
// dk += ds^T T(q * scale).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads) attention_bwd_dkv_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<T>::kStride, TE = TileLayout<T>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // k rows j0..
  T* Qs = Ks + TE;                         // T(q * scale) rows i0..
  T* dOs = Qs + TE;                        // do rows i0..
  T* dSs = dOs + TE;                       // ds[i][j]
  T* Pt = dSs + TE;                        // T(p)[j][i]
  float* ST = reinterpret_cast<float*>(Pt + TE);  // s^T [64][kAccStride]
  float* DV = ST + kTile * kAccStride;
  float* DK = DV + kTile * kAccStride;
  float* lse_s = DK + kTile * kAccStride;  // [64]

  const int L = a.L, D = a.D, H = gridDim.y, h = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * kTile;
  const size_t base = (size_t)b * L * D + (size_t)h * kHeadDim;
  const T* ds_g = static_cast<const T*>(a.ds) + ((size_t)b * H + h) * L * L;
  const int tid = threadIdx.x;

  load_tile(Ks, static_cast<const T*>(a.k), base, j0, L, D);
  for (int i0 = a.causal ? j0 : 0; i0 < L; i0 += kTile) {
    __syncthreads();
    load_tile(Qs, static_cast<const T*>(a.q), base, i0, L, D, a.scale);
    load_tile(dOs, static_cast<const T*>(a.dout), base, i0, L, D);
    for (int e = tid; e < kTile * kTile; e += kAttnThreads) {
      const int r = e / kTile, c = e % kTile, i = i0 + r, j = j0 + c;
      dSs[r * TS + c] = i < L && j < L ? ds_g[(size_t)i * L + j] : from_f<T>(0.f);
    }
    for (int r = tid; r < kTile; r += kAttnThreads) {
      lse_s[r] = i0 + r < L ? a.lse[((size_t)b * L + i0 + r) * H + h] : 0.f;
    }
    __syncthreads();
    tile_product<false, true>(ST, kAccStride, Ks, TS, Qs, TS, false);  // s^T = k qs^T
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kAttnThreads) {
      const int r = e / kTile, c = e % kTile, j = j0 + r, i = i0 + c;
      const bool keep = j < L && i < L && (!a.causal || j <= i);
      Pt[r * TS + c] = from_f<T>(keep ? expf(ST[r * kAccStride + c] - lse_s[c]) : 0.f);
    }
    __syncthreads();
    const bool acc = i0 != (a.causal ? j0 : 0);
    tile_product<false, false>(DV, kAccStride, Pt, TS, dOs, TS, acc);  // dv += T(p)^T do
    tile_product<true, false>(DK, kAccStride, dSs, TS, Qs, TS, acc);   // dk += ds^T qs
  }
  __syncthreads();
  T* dK = static_cast<T*>(a.dk);
  T* dV = static_cast<T*>(a.dv);
  for (int e = tid; e < kTile * kHeadDim; e += kAttnThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim, j = j0 + r;
    if (j < L) {
      dK[base + (size_t)j * D + c] = from_f<T>(DK[r * kAccStride + c]);
      dV[base + (size_t)j * D + c] = from_f<T>(DV[r * kAccStride + c]);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T>
struct Bwd {
  // Scratch carved from one workspace, each piece 256-byte aligned.
  struct Scratch {
    T *y, *dout, *d, *ds;
    float *dY, *part_w, *part_b, *part_ln;
  };

  static int k_chunk(int M, int D) {
    // Split the dW contraction so the grid covers ~2 waves of 132 SMs, each
    // chunk at least 256 rows and a multiple of the k-tile.
    const int tiles = 3 * (D / kBN) * (D / kBM);
    const int splits = (264 + tiles - 1) / tiles;
    const int chunk = (M + splits - 1) / splits;
    return std::max(256, ((chunk + 31) / 32) * 32);
  }
  static int ln_rows() { return 64; }

  static size_t carve(Scratch* s, char* base, int B, int L, int D, int H) {
    const size_t M = (size_t)B * L;
    const int chunk = k_chunk((int)M, D), splits = (int)((M + chunk - 1) / chunk);
    const int c_rows = 256, c_chunks = (int)((M + c_rows - 1) / c_rows);
    const int ln_blocks = (int)((M + ln_rows() - 1) / ln_rows());
    size_t off = 0;
    auto take = [&](size_t bytes) {
      char* p = base == nullptr ? nullptr : base + off;
      off += (bytes + 255) / 256 * 256;
      return p;
    };
    char* y = take(M * D * sizeof(T));
    char* dout = take(M * D * sizeof(T));
    char* d = take(3 * M * D * sizeof(T));
    char* ds = take((size_t)B * H * L * L * sizeof(T));
    char* dY = take(M * D * sizeof(float));
    char* pw = take((size_t)splits * 3 * D * D * sizeof(float));
    char* pb = take((size_t)c_chunks * 3 * D * sizeof(float));
    char* pln = take((size_t)ln_blocks * 2 * D * sizeof(float));
    if (s != nullptr) {
      s->y = reinterpret_cast<T*>(y);
      s->dout = reinterpret_cast<T*>(dout);
      s->d = reinterpret_cast<T*>(d);
      s->ds = reinterpret_cast<T*>(ds);
      s->dY = reinterpret_cast<float*>(dY);
      s->part_w = reinterpret_cast<float*>(pw);
      s->part_b = reinterpret_cast<float*>(pb);
      s->part_ln = reinterpret_cast<float*>(pln);
    }
    return off;
  }

  static cudaError_t reduce(const float* partial, int parts, long long X, float* out, cudaStream_t st) {
    const int blocks = (int)std::min((X + kThreads - 1) / kThreads, 4096LL);
    reduce_partials_kernel<<<blocks, kThreads, 0, st>>>(partial, parts, X, out);
    return cudaGetLastError();
  }

  static cudaError_t run(const T* x, const T* gout, const T* q, const T* k, const T* v, const float* lse,
                         const float* ln_scale, const float* ln_bias, const T* wqkv, const T* wout, T* dx,
                         float* dwqkv, float* dbqkv, float* dln, void* workspace, int B, int L, int D, int H,
                         int causal, cudaStream_t st) {
    Scratch s;
    carve(&s, static_cast<char*>(workspace), B, L, D, H);
    const int M = B * L;
    cudaError_t err;
#define FLYP_CHECK(expr)          \
  do {                            \
    err = (expr);                 \
    if (err != cudaSuccess) return err; \
  } while (0)

    // 1. y = T(LN(x)).
    ln_forward_kernel<T><<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(x, ln_scale, ln_bias,
                                                                                        s.y, M, D);
    FLYP_CHECK(cudaGetLastError());

    // 2. do = T(g @ Wout^T).
    FLYP_CHECK((launch_gemm<T, false, true, kOpNone, T>(gemm_args(gout, wout, s.dout, M, D, D, D, D), 1, st)));

    // 3, 4. Attention backward, pass (a) then pass (b).
    AttnArgs a{};
    a.q = q; a.k = k; a.v = v; a.dout = s.dout; a.lse = lse; a.ds = s.ds;
    a.dq = s.d; a.dk = s.d + (size_t)M * D; a.dv = s.d + 2 * (size_t)M * D;
    a.L = L; a.D = D; a.causal = causal; a.scale = 1.0f / sqrtf((float)kHeadDim);
    const int n_tiles = (L + kTile - 1) / kTile;
    a.s_stride = n_tiles * kTile + 4;
    const dim3 agrid(n_tiles, H, B);
    const size_t smem_a = 3 * TileLayout<T>::kElems * sizeof(T) + (2 * kTile * (size_t)a.s_stride + kTile) * sizeof(float);
    FLYP_CHECK(cudaFuncSetAttribute(attention_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem_a));
    attention_bwd_dq_kernel<T><<<agrid, kAttnThreads, smem_a, st>>>(a);
    FLYP_CHECK(cudaGetLastError());
    const size_t smem_b = 5 * TileLayout<T>::kElems * sizeof(T) + (3 * kTile * kAccStride + kTile) * sizeof(float);
    FLYP_CHECK(cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem_b));
    attention_bwd_dkv_kernel<T><<<agrid, kAttnThreads, smem_b, st>>>(a);
    FLYP_CHECK(cudaGetLastError());

    // 5. dbqkv[t] = colsum(d_t).
    const int c_rows = 256, c_chunks = (M + c_rows - 1) / c_rows;
    colsum_partial_kernel<T><<<dim3((D + kThreads - 1) / kThreads, c_chunks, 3), kThreads, 0, st>>>(
        s.d, s.part_b, M, D, c_rows);
    FLYP_CHECK(cudaGetLastError());
    FLYP_CHECK(reduce(s.part_b, c_chunks, 3LL * D, dbqkv, st));

    // 6. dWqkv[t] = y^T d_t, split over rows, then the partials' sum.
    GemmArgs g = gemm_args(s.y, s.d, s.part_w, D, D, M, D, D);
    g.b_z = (long long)M * D;
    g.k_chunk = k_chunk(M, D);
    g.splits = (M + g.k_chunk - 1) / g.k_chunk;
    FLYP_CHECK((launch_gemm<T, true, false, kOpNone, float>(g, 3, st)));
    FLYP_CHECK(reduce(s.part_w, g.splits, 3LL * D * D, dwqkv, st));

    // 7. dY = sum_t d_t Wqkv[t]^T.
    g = gemm_args(s.d, wqkv, s.dY, M, D, D, D, D);
    g.nseg = 3; g.a_seg = (long long)M * D; g.b_seg = (long long)D * D;
    FLYP_CHECK((launch_gemm<T, false, true, kOpNone, float>(g, 1, st)));

    // 8. LN backward, then dscale/dbias from the per-block partials.
    const int ln_blocks = (M + ln_rows() - 1) / ln_rows();
    ln_backward_kernel<T><<<ln_blocks, kThreads, 0, st>>>(x, gout, s.dY, ln_scale, dx, s.part_ln, M, D, ln_rows());
    FLYP_CHECK(cudaGetLastError());
    FLYP_CHECK(reduce(s.part_ln, ln_blocks, 2LL * D, dln, st));
#undef FLYP_CHECK
    return cudaSuccess;
  }
};

bool shapes_ok(int L, int D, int H) {
  return D == H * kHeadDim && D % kBN == 0 && D <= 32 * kMaxCols && L >= 1 && L <= kMaxL;
}

}  // namespace

extern "C" {

// Bytes of device workspace flyp_attention_block_bwd needs (dtype: 0 =
// float32, 1 = bfloat16), or -1 for shapes the kernels do not take.
long long flyp_attention_block_bwd_workspace(int B, int L, int D, int H, int dtype) {
  if (!shapes_ok(L, D, H)) return -1;
  if (dtype == 0) return (long long)Bwd<float>::carve(nullptr, nullptr, B, L, D, H);
  if (dtype == 1) return (long long)Bwd<bf16>::carve(nullptr, nullptr, B, L, D, H);
  return -1;
}

// The training backward.  x, gout, q, k, v, dx: [B, L, D] in the compute
// type; lse [B, L, H], ln_scale/ln_bias [D] fp32; wqkv [3, D, D] and wout
// [D, D] in the compute type.  Outputs dwqkv [3, D, D], dbqkv [3, D] and dln
// [2, D] (dscale, dbias) in fp32.  Returns a cudaError_t.
int flyp_attention_block_bwd(const void* x, const void* gout, const void* q, const void* k, const void* v,
                             const void* lse, const void* ln_scale, const void* ln_bias, const void* wqkv,
                             const void* wout, void* dx, void* dwqkv, void* dbqkv, void* dln, void* workspace,
                             int B, int L, int D, int H, int causal, int dtype, void* stream) {
  if (!shapes_ok(L, D, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  float* dw = static_cast<float*>(dwqkv);
  float* db = static_cast<float*>(dbqkv);
  float* dl = static_cast<float*>(dln);
  if (dtype == 0) {
    using T = float;
    return (int)Bwd<T>::run(static_cast<const T*>(x), static_cast<const T*>(gout), static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), lse_f, g, beta,
                            static_cast<const T*>(wqkv), static_cast<const T*>(wout), static_cast<T*>(dx), dw, db,
                            dl, workspace, B, L, D, H, causal, s);
  }
  if (dtype == 1) {
    using T = bf16;
    return (int)Bwd<T>::run(static_cast<const T*>(x), static_cast<const T*>(gout), static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), lse_f, g, beta,
                            static_cast<const T*>(wqkv), static_cast<const T*>(wout), static_cast<T*>(dx), dw, db,
                            dl, workspace, B, L, D, H, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
