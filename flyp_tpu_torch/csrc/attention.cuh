// Whole-row softmax attention over 64-wide heads, forward and backward: the
// one set of templates behind the attention-block kernels (attention_block.cu:
// B3 and B1; attention_block_bwd.cu: B2) and the attention ops (attention.cu:
// B5 and B6).
//
// q, k and v are read through a batch stride and a row stride (head h at
// column h * 64) and dq, dk, dv written the same way, so neither the
// attention block's [3, B*L, D] projection nor the fused [B, L, 3D] one is
// transposed in device memory; o and do are [B, L, H * 64].  Products
// accumulate in fp32.  The compute type T (float or bfloat16) rounds where
// the TPU kernels round, in one of two schemes picked at compile time by
// kScaleQ:
//
//   kScaleQ, the attention block's (B1-B3):
//     s  = T(q * scale) k^T;  the training forward writes lse = m + log(l),
//          and the backward reads it: p = exp(s - lse)
//     ds = T(p (dp - delta));  dq = T((ds k) * scale),  dk = T(ds^T T(q * scale))
//   otherwise, the attention ops' (B5, B6):
//     s  = (q k^T) * scale in fp32; the op keeps no lse, so the backward's
//          query-tile pass computes each row's max m and sum l and hands
//          them to its key-tile pass: p = exp(s - m) / l
//     ds = T(p (dp - delta) * scale);  dq = T(ds k),  dk = T(ds^T q)
//
// and in both dv = T(T(p)^T do), dp = do v^T and delta = rowsum(p dp) in
// fp32.  The forward normalises p in fp32 before its cast, o = T(T(p) v)
// (B3, B5, B6); the training forward (kTrain, B1) casts the unnormalised
// e = exp(s - m) and divides the product, o = T((T(e) v) / l).  Causal
// (masked) keys and rows past L get p = 0, as exp of the TPU kernels' -1e30
// bias is.
//
// Design.  One block per (query tile, head, batch item) keeps the tile's
// scores over its whole key range in fp32 shared memory, so the softmax is
// normalised before p is cast, as on the TPU (an online softmax would cast
// before it normalises).  bf16 runs every product on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate); fp32 tiles FMA on the CUDA cores,
// since the tensor cores would round fp32 operands to TF32.  The forward
// keeps each warp's q fragments in registers over the key tiles; the
// backward runs its products through tile_product (common.cuh).  Query
// tiles: the largest of 64, 32 (bf16 forward) or 64, 32, 16 rows (backward;
// one warp per 16 rows) whose shared memory fits a block's 227 KB, and 32
// rows for the fp32 forward, so every L <= 1024 fits.  The launches, on the
// caller's stream:
//
//   forward:  s tile by tile, the softmax row by row (p written over the
//             front of its own score row), o = sum over key tiles of p v;
//   backward: pass (a), per query tile: s and dp over the full key range, p,
//             delta, ds (to a [B, H, L, L] workspace, and over the front of
//             its row), dq = ds k;
//             pass (b), per 64-key tile, over the query tiles that see its
//             keys: p^T rebuilt from k q^T and the rows' statistics,
//             dv += T(p)^T do, dk += ds^T q.
//
// Each output element is written by one block: no atomics, and a run repeats
// bit for bit.  wgmma/TMA pipelines and keeping products in registers are
// later work.

#pragma once

#include "common.cuh"

namespace flyp {

constexpr size_t kSmemBlock = 232448;  // 227 KB: the most one block may use

struct AttnArgs {
  const void *q, *k, *v;  // row j of head h of item b at + b * in_b + j * in_r + h * 64
  const void* dout;       // [B, L, H * 64]
  void* o;                // [B, L, H * 64]
  void *dq, *dk, *dv;     // row j of head h of item b at + b * out_b + j * out_r + h * 64
  float* stats;           // per (item, row, head), [B, L, H]: lse with kScaleQ (the training forward
                          // writes it, the backward reads it), else (m, l) pairs from backward pass (a)
  void* ds;               // [B, H, L, L] workspace: T(ds), backward pass (a) to pass (b)
  long long in_b, out_b;
  int in_r, out_r;
  int L, causal;
  float scale;
  int s_stride;  // fp32 per score row: the key range in 64s, + 4
};

inline AttnArgs attn_args(const void* q, const void* k, const void* v, long long in_b, int in_r, int L, int causal) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.in_b = in_b; a.in_r = in_r;
  a.L = L; a.causal = causal;
  a.scale = 1.0f / sqrtf((float)kHeadDim);
  a.s_stride = ((L + kTile - 1) / kTile) * kTile + 4;  // 16-byte shifted rows: ldmatrix on p, ds conflict-free
  return a;
}

// The block's (head, batch item) rows of q, k or v.
template <typename T>
__device__ __forceinline__ const T* head_rows(const void* p, long long b_stride) {
  return static_cast<const T*>(p) + (size_t)blockIdx.z * b_stride + (size_t)blockIdx.y * kHeadDim;
}

// Index in stats ([B, L, H]) of row i of the block's (head, batch item).
__device__ __forceinline__ size_t stat_index(int i, int L) {
  return ((size_t)blockIdx.z * L + i) * gridDim.y + blockIdx.y;
}

// Row max m and sum l of exp(s - m) over a row's visible keys, by the
// caller's warp.
__device__ __forceinline__ void row_softmax_stats(const float* row, int visible, float& m, float& l) {
  const int lane = threadIdx.x % 32;
  m = -INFINITY;
  for (int j = lane; j < visible; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  l = 0.f;
  for (int j = lane; j < visible; j += 32) l += expf(row[j] - m);
  l = warp_sum(l);
}

// The same over unscaled scores, by the caller's warp: row[j] = exp(s_j
// scale - m) in place, m set and l returned (0 for a row past L).
__device__ __forceinline__ float row_exp(float* row, int visible, float scale, float& m) {
  const int lane = threadIdx.x % 32;
  m = -INFINITY;
  for (int j = lane; j < visible; j += 32) m = fmaxf(m, __fmul_rn(row[j], scale));
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < visible; j += 32) {
    const float e = expf(__fmul_rn(row[j], scale) - m);
    row[j] = e;
    l += e;
  }
  return warp_sum(l);
}

// ---------------------------------------------------------------------------
// Forward, fp32: FMA tiles on the CUDA cores, one block of 128 threads per
// (32-row query tile, head, item).

constexpr int kFmaQT = 32;
constexpr int kFmaThreads = 128;
constexpr int kRow = kHeadDim + 1;  // padded smem row: conflict-free column walks

template <bool kScaleQ, bool kTrain>
__global__ void __launch_bounds__(kFmaThreads) attention_fma_kernel(const AttnArgs a) {
  extern __shared__ float smem[];
  __shared__ float row_l[kFmaQT];
  float* Qs = smem;               // [kFmaQT][kRow]
  float* KV = Qs + kFmaQT * kRow; // [64][kRow]
  float* S = KV + kTile * kRow;   // [kFmaQT][s_stride]

  const int L = a.L, D = gridDim.y * kHeadDim, q0 = blockIdx.x * kFmaQT, s_stride = a.s_stride;
  const size_t in_r = a.in_r;
  const float scale = a.scale;
  const float* Q = head_rows<float>(a.q, a.in_b);
  const float* K = head_rows<float>(a.k, a.in_b);
  const float* V = head_rows<float>(a.v, a.in_b);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 8 threads
  const int q_end = min(q0 + kFmaQT, L);
  const int kv_len = a.causal ? q_end : L;  // keys any row of this tile may see
  const int n_tiles = (kv_len + kTile - 1) / kTile;

  for (int e = tid; e < kFmaQT * kHeadDim; e += kFmaThreads) {
    const int r = e / kHeadDim, d = e % kHeadDim;
    const int i = q0 + r;
    const float q = i < L ? Q[i * in_r + d] : 0.f;
    Qs[r * kRow + d] = kScaleQ ? __fmul_rn(q, scale) : q;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    for (int e = tid; e < kTile * kHeadDim; e += kFmaThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      const int j = k0 + r;
      KV[r * kRow + d] = j < L ? K[j * in_r + d] : 0.f;
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
      for (int j = 0; j < 4; ++j) {
        S[(ty + 8 * i) * s_stride + k0 + tx + 16 * j] = kScaleQ ? s[i][j] : __fmul_rn(s[i][j], scale);
      }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int cols = n_tiles * kTile;
  for (int r = warp; r < kFmaQT; r += kFmaThreads / 32) {
    const int i = q0 + r;
    float* row = S + (size_t)r * s_stride;
    const int visible = i < L ? (a.causal ? i + 1 : L) : 0;
    float m, l;
    row_softmax_stats(row, visible, m, l);
    if (kTrain) {
      for (int j = lane; j < cols; j += 32) row[j] = j < visible ? expf(row[j] - m) : 0.f;
      if (lane == 0) {
        row_l[r] = l;
        if (i < L) a.stats[stat_index(i, L)] = m + logf(l);
      }
    } else {
      for (int j = lane; j < cols; j += 32) row[j] = j < visible ? __fdiv_rn(expf(row[j] - m), l) : 0.f;
    }
  }

  float acc[4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    for (int e = tid; e < kTile * kHeadDim; e += kFmaThreads) {
      const int r = e / kHeadDim, d = e % kHeadDim;
      const int j = k0 + r;
      KV[r * kRow + d] = j < L ? V[j * in_r + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      float p[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = S[(ty + 8 * i) * s_stride + k0 + jj];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = KV[jj * kRow + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }

  float* O = static_cast<float*>(a.o) + (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * kHeadDim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      O[(size_t)row * D + tx + 16 * j] = kTrain ? __fdiv_rn(acc[i][j], row_l[ty + 8 * i]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16: mma.sync.m16n8k16 on the tensor cores, fp32 accumulate; one
// block of QT / 16 warps per (QT-row query tile, head, item), each warp
// owning 16 query rows.  Scores go through the tensor cores into fp32
// shared memory ([QT, s_stride]); the softmax runs in fp32 and writes p as
// bf16 over the front of its own score row; p @ v goes through the tensor
// cores again.

template <bool kScaleQ, bool kTrain, int QT>
__global__ void __launch_bounds__(2 * QT) attention_mma_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<bf16>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float row_l[QT];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);             // [QT][TS]
  bf16* KV = Qs + QT * TS;                                  // [64][TS]
  float* S = reinterpret_cast<float*>(KV + kTile * TS);     // [QT][s_stride]

  const int L = a.L, D = gridDim.y * kHeadDim, q0 = blockIdx.x * QT, s_stride = a.s_stride;
  const float scale = a.scale;
  const bf16* Q = head_rows<bf16>(a.q, a.in_b);
  const bf16* K = head_rows<bf16>(a.k, a.in_b);
  const bf16* V = head_rows<bf16>(a.v, a.in_b);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_end = min(q0 + QT, L);
  const int kv_len = a.causal ? q_end : L;  // keys any row of this tile may see
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  const int wr = warp * 16;  // this warp's first row in the tile

  // kScaleQ: q is scaled after its cast to bf16, and rounds to bf16 again.
  load_tile<QT, 2 * QT>(Qs, Q, a.in_r, q0, L, kScaleQ ? scale : 0.f);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qa[ks], &Qs[(wr + lane % 16) * TS + ks * 16 + (lane / 16) * 8]);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<kTile, 2 * QT>(KV, K, a.in_r, k0, L);
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
        ldmatrix_x4(r, &KV[(np * 16 + (lane & 7) + ((lane >> 4) << 3)) * TS + ks * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * np], qa[ks], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qa[ks], r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = kScaleQ ? s[nt][e] : __fmul_rn(s[nt][e], scale);
      const int c = k0 + nt * 8 + (lane % 4) * 2;
      const int r = wr + lane / 4;
      *reinterpret_cast<float2*>(&S[r * s_stride + c]) = make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(&S[(r + 8) * s_stride + c]) = make_float2(s[nt][2], s[nt][3]);
    }
  }
  __syncwarp();

  // Softmax of the warp's 16 rows.  p[j] (bf16) overwrites bytes 2j..2j+1
  // of its own fp32 row, which only ever covers scores already read.
  const int cols = n_tiles * kTile;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = wr + rr, i = q0 + r;
    float* row = S + (size_t)r * s_stride;
    bf16* prow = reinterpret_cast<bf16*>(row);
    const int visible = i < L ? (a.causal ? i + 1 : L) : 0;
    float m, l;
    row_softmax_stats(row, visible, m, l);
    if (kTrain && lane == 0) {
      row_l[r] = l;
      if (i < L) a.stats[stat_index(i, L)] = m + logf(l);
    }
    for (int j0 = 0; j0 < cols; j0 += 32) {
      const int j = j0 + lane;
      const float v = row[j];
      __syncwarp();
      const float e = expf(v - m);
      prow[j] = __float2bfloat16_rn(j < visible ? (kTrain ? e : __fdiv_rn(e, l)) : 0.f);
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
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<kTile, 2 * QT>(KV, V, a.in_r, k0, L);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      ldmatrix_x4(pa, &P[(wr + lane % 16) * p_stride + k0 + ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &KV[(ks * 16 + lane % 16) * TS + np * 16 + (lane / 16) * 8]);
        mma_bf16(o[2 * np], pa, r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa, r[2], r[3]);
      }
    }
  }

  bf16* O = static_cast<bf16*>(a.o) + (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * kHeadDim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + wr + lane / 4 + half * 8;
    if (i >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int d = nt * 8 + (lane % 4) * 2;
      float v0 = o[nt][2 * half], v1 = o[nt][2 * half + 1];
      if (kTrain) {
        const float l = row_l[wr + lane / 4 + half * 8];
        v0 = __fdiv_rn(v0, l);
        v1 = __fdiv_rn(v1, l);
      }
      *reinterpret_cast<bf162*>(O + (size_t)i * D + d) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward pass (a): one block of 2 * QT threads per (QT-row query tile,
// head, item).

template <typename T, int QT, bool kScaleQ>
__global__ void __launch_bounds__(2 * QT) attention_bwd_dq_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);                  // [QT][TS]: q, or T(q * scale)
  T* dOs = Qs + QT * TS;                                   // [QT][TS]
  T* KVs = dOs + QT * TS;                                  // [64][TS]: k, then v, then k again
  float* S = reinterpret_cast<float*>(KVs + kTile * TS);   // [QT][s_stride]: s, then p, then ds
  float* DP = S + QT * a.s_stride;                         // [QT][s_stride]: dp, then the dq sums
  __shared__ float row_lse[QT];                            // kScaleQ: the rows' lse

  const int L = a.L, H = gridDim.y, h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * QT;
  const int D = H * kHeadDim;
  const T* Q = head_rows<T>(a.q, a.in_b);
  const T* K = head_rows<T>(a.k, a.in_b);
  const T* V = head_rows<T>(a.v, a.in_b);
  const T* dO = head_rows<T>(a.dout, (long long)L * D);
  const int kv_len = a.causal ? min(i0 + QT, L) : L;
  const int n_tiles = (kv_len + kTile - 1) / kTile, cols = n_tiles * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<QT, 2 * QT>(Qs, Q, a.in_r, i0, L, kScaleQ ? a.scale : 0.f);
  load_tile<QT, 2 * QT>(dOs, dO, D, i0, L);
  if (kScaleQ && threadIdx.x < QT) {
    const int i = i0 + threadIdx.x;
    row_lse[threadIdx.x] = i < L ? a.stats[stat_index(i, L)] : 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<kTile, 2 * QT>(KVs, K, a.in_r, k0, L);
    __syncthreads();
    tile_product<false, true, QT>(S + k0, a.s_stride, Qs, TS, KVs, TS, false);  // s = q k^T
    __syncthreads();
    load_tile<kTile, 2 * QT>(KVs, V, a.in_r, k0, L);
    __syncthreads();
    tile_product<false, true, QT>(DP + k0, a.s_stride, dOs, TS, KVs, TS, false);  // dp = do v^T
  }
  __syncthreads();

  // One warp per row: p, delta, ds, and ds to the workspace.  ds[j] in T
  // overwrites the front of the row (bf16: bytes 2j..2j+1, which only ever
  // cover entries already read).
  T* ds_g = static_cast<T*>(a.ds) + ((size_t)b * H + h) * L * L;
  const int ds_stride = a.s_stride * (int)(sizeof(float) / sizeof(T));
  for (int r = warp; r < QT; r += QT / 16) {
    const int i = i0 + r;
    const int visible = i < L ? (a.causal ? i + 1 : L) : 0;
    float* srow = S + (size_t)r * a.s_stride;
    const float* dprow = DP + (size_t)r * a.s_stride;
    const float lse = kScaleQ ? row_lse[r] : 0.f;
    float l = 0.f;
    if (!kScaleQ) {
      float m;
      l = row_exp(srow, visible, a.scale, m);
      if (lane == 0 && i < L) reinterpret_cast<float2*>(a.stats)[stat_index(i, L)] = make_float2(m, l);
      __syncwarp();
    }
    float delta = 0.f;
    for (int j = lane; j < cols; j += 32) {
      const float p = j < visible ? (kScaleQ ? expf(srow[j] - lse) : __fdiv_rn(srow[j], l)) : 0.f;
      srow[j] = p;
      delta += p * dprow[j];
    }
    delta = warp_sum(delta);
    T* dsrow = reinterpret_cast<T*>(srow);
    for (int j0 = 0; j0 < cols; j0 += 32) {
      const int j = j0 + lane;
      const float pd = __fmul_rn(srow[j], __fsub_rn(dprow[j], delta));
      const T ds = from_f<T>(kScaleQ ? pd : __fmul_rn(pd, a.scale));
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
    load_tile<kTile, 2 * QT>(KVs, K, a.in_r, k0, L);
    __syncthreads();
    tile_product<false, false, QT>(DP, a.s_stride, dS + k0, ds_stride, KVs, TS, t > 0);  // ds k
  }
  __syncthreads();
  T* dQ = static_cast<T*>(a.dq) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  for (int e = threadIdx.x; e < QT * kHeadDim; e += 2 * QT) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float dq = DP[r * a.s_stride + c];
    if (i0 + r < L) dQ[(size_t)(i0 + r) * a.out_r + c] = from_f<T>(kScaleQ ? __fmul_rn(dq, a.scale) : dq);
  }
}

// Backward pass (b): one block of 128 threads per (64-key tile, head, item),
// walking the 64-row query tiles that can see its keys: p^T rebuilt from
// k q^T and the rows' statistics, dv += T(p)^T do and dk += ds^T q.

constexpr int kDkvThreads = 2 * kTile;

template <typename T, bool kScaleQ>
__global__ void __launch_bounds__(kDkvThreads) attention_bwd_dkv_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<T>::kStride, TE = TileLayout<T>::kElems, kThreads = kDkvThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // k rows j0..
  T* Qs = Ks + TE;                         // q (or T(q * scale)) rows i0..
  T* dOs = Qs + TE;                        // do rows i0..
  T* dSs = dOs + TE;                       // ds[i][j]
  T* Pt = dSs + TE;                        // T(p)[j][i]
  float* ST = reinterpret_cast<float*>(Pt + TE);  // s^T [64][kAccStride]
  float* DV = ST + kTile * kAccStride;
  float* DK = DV + kTile * kAccStride;
  float* row_m = DK + kTile * kAccStride;  // per query row i0..: lse (kScaleQ) or m
  float* row_l = row_m + kTile;            // l

  const int L = a.L, H = gridDim.y, h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * kTile;
  const int D = H * kHeadDim;
  const T* Q = head_rows<T>(a.q, a.in_b);
  const T* dO = head_rows<T>(a.dout, (long long)L * D);
  const T* ds_g = static_cast<const T*>(a.ds) + ((size_t)b * H + h) * L * L;
  const int tid = threadIdx.x;

  load_tile<kTile, kThreads>(Ks, head_rows<T>(a.k, a.in_b), a.in_r, j0, L);
  const int first = a.causal ? j0 : 0;
  for (int i0 = first; i0 < L; i0 += kTile) {
    __syncthreads();
    load_tile<kTile, kThreads>(Qs, Q, a.in_r, i0, L, kScaleQ ? a.scale : 0.f);
    load_tile<kTile, kThreads>(dOs, dO, D, i0, L);
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile, i = i0 + r, j = j0 + c;
      dSs[r * TS + c] = i < L && j < L ? ds_g[(size_t)i * L + j] : from_f<T>(0.f);
    }
    for (int r = tid; r < kTile; r += kThreads) {
      const int i = i0 + r;
      if (kScaleQ) {
        row_m[r] = i < L ? a.stats[stat_index(i, L)] : 0.f;
      } else {
        const float2 ml = i < L ? reinterpret_cast<const float2*>(a.stats)[stat_index(i, L)] : make_float2(0.f, 1.f);
        row_m[r] = ml.x;
        row_l[r] = ml.y;
      }
    }
    __syncthreads();
    tile_product<false, true>(ST, kAccStride, Ks, TS, Qs, TS, false);  // s^T = k q^T
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile, j = j0 + r, i = i0 + c;
      const bool keep = j < L && i < L && (!a.causal || j <= i);
      const float s = ST[r * kAccStride + c];
      float p = 0.f;
      if (keep) p = kScaleQ ? expf(s - row_m[c]) : __fdiv_rn(expf(__fmul_rn(s, a.scale) - row_m[c]), row_l[c]);
      Pt[r * TS + c] = from_f<T>(p);
    }
    __syncthreads();
    const bool acc = i0 != first;
    tile_product<false, false>(DV, kAccStride, Pt, TS, dOs, TS, acc);  // dv += T(p)^T do
    tile_product<true, false>(DK, kAccStride, dSs, TS, Qs, TS, acc);   // dk += ds^T q
  }
  __syncthreads();
  T* dK = static_cast<T*>(a.dk) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  T* dV = static_cast<T*>(a.dv) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  for (int e = tid; e < kTile * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim, j = j0 + r;
    if (j < L) {
      dK[(size_t)j * a.out_r + c] = from_f<T>(DK[r * kAccStride + c]);
      dV[(size_t)j * a.out_r + c] = from_f<T>(DV[r * kAccStride + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Whether a kernel with this much dynamic shared memory and qt fp32 of
// static row arrays fits a block.
inline bool fits_block(size_t dynamic, int qt) { return dynamic + qt * sizeof(float) <= kSmemBlock; }

template <typename Kernel>
cudaError_t launch_attention_kernel(Kernel kernel, int rows, int threads, size_t smem, const AttnArgs& a, int B,
                                    int H, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.L + rows - 1) / rows, H, B), threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The forward: a.o, and with kTrain lse into a.stats.
template <typename T, bool kScaleQ, bool kTrain>
cudaError_t attention_forward(const AttnArgs& a, int B, int H, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    const size_t smem = ((size_t)(kFmaQT + kTile) * kRow + (size_t)kFmaQT * a.s_stride) * sizeof(float);
    if (!fits_block(smem, kFmaQT)) return cudaErrorInvalidValue;
    return launch_attention_kernel(attention_fma_kernel<kScaleQ, kTrain>, kFmaQT, kFmaThreads, smem, a, B, H, st);
  } else {
    auto smem = [&](int qt) {
      return (size_t)(qt + kTile) * TileLayout<bf16>::kStride * sizeof(bf16) + (size_t)qt * a.s_stride * sizeof(float);
    };
    if (fits_block(smem(64), 64)) {
      return launch_attention_kernel(attention_mma_kernel<kScaleQ, kTrain, 64>, 64, 128, smem(64), a, B, H, st);
    }
    if (fits_block(smem(32), 32)) {
      return launch_attention_kernel(attention_mma_kernel<kScaleQ, kTrain, 32>, 32, 64, smem(32), a, B, H, st);
    }
    return cudaErrorInvalidValue;
  }
}

// The backward, pass (a) then pass (b): a.dq, a.dk, a.dv.
template <typename T, bool kScaleQ>
cudaError_t attention_backward(const AttnArgs& a, int B, int H, cudaStream_t st) {
  constexpr int TS = TileLayout<T>::kStride;
  auto dq_smem = [&](int qt) {
    return (size_t)(2 * qt + kTile) * TS * sizeof(T) + 2 * (size_t)qt * a.s_stride * sizeof(float);
  };
  // The query tile: the largest of 64, 32, 16 rows whose footprint fits a
  // block (64 at CLIP's lengths; a 32-row pass (a), two blocks to an SM, ran
  // slower on the H100: fewer rows reload each k and v tile more often).
  cudaError_t err;
  if (fits_block(dq_smem(64), 64)) {
    err = launch_attention_kernel(attention_bwd_dq_kernel<T, 64, kScaleQ>, 64, 128, dq_smem(64), a, B, H, st);
  } else if (fits_block(dq_smem(32), 32)) {
    err = launch_attention_kernel(attention_bwd_dq_kernel<T, 32, kScaleQ>, 32, 64, dq_smem(32), a, B, H, st);
  } else if (fits_block(dq_smem(16), 16)) {
    err = launch_attention_kernel(attention_bwd_dq_kernel<T, 16, kScaleQ>, 16, 32, dq_smem(16), a, B, H, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t dkv_smem = 5 * (size_t)TileLayout<T>::kElems * sizeof(T) +
                          (3 * (size_t)kTile * kAccStride + 2 * kTile) * sizeof(float);
  return launch_attention_kernel(attention_bwd_dkv_kernel<T, kScaleQ>, kTile, kDkvThreads, dkv_smem, a, B, H, st);
}

}  // namespace flyp
