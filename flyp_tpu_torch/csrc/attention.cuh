// Whole-row softmax attention over heads 64 wide (80 on the streamed route,
// below), forward and backward: the
// one set of templates behind the attention-block kernels (attention_block.cu:
// B3 and B1; attention_block_bwd.cu: B2) and the attention ops (attention.cu:
// B5 and B6).
//
// q, k and v are read through a batch stride and a row stride (head h at
// column h * hd, hd the head width) and dq, dk, dv written the same way, so
// neither the attention block's [3, B*L, D] projection nor the fused [B, L,
// 3D] one is transposed in device memory; o and do are [B, L, H * hd].  Products
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
// Three routes, picked per call by type and length; each output element is
// written by one block, with no atomics, so a run repeats bit for bit.
//
// The register route (bf16, L <= 256 keys, kRegKeys: ViT-B's 197 and the
// text tower's 77, but not ViT-L/14's 257 or ViT-L/14@336px's 577, which
// take the streamed route).  Blocks of four warps own 64 rows, each warp 16;
// the block's rows and the whole opposite side of its (head, item) (at most
// 256 rows of k and v, or of q and do) land in shared memory by cp.async,
// one group per 64-row tile, and each tile's products start once it has
// landed.  Every product is mma.sync m16n8k16 with fp32 accumulate, and an
// accumulator's fragments, cast to bf16, are the next product's A
// fragments (as in FlashAttention-2), so no score or probability leaves the
// registers.  The key range is a template constant NT (1-4 tiles of 64) so
// a row's NT * 32 scores a thread stay in registers; 16-key chunks past a
// warp's last visible key are skipped, so L = 197 computes 208 keys.
//
//   forward (attention_fwd_kernel), per 64-row query tile: s for the
//     warp's rows over all keys, then the exact max-then-sum softmax over
//     the lane quad (p normalised in fp32, or e for kTrain), p cast straight
//     into the A fragments of o = p v;
//   backward pass (a) (attention_bwd_q_kernel), per 64-row query tile: s,
//     then p in registers (from m and l computed here, or lse); a sweep of
//     the key chunks for delta = sum p dp (dp in registers); a second for
//     ds and dq += T(ds) k; it writes dq, (m, l) unless kScaleQ, and delta;
//   backward pass (b) (attention_bwd_k_kernel), per 64-key tile: each warp
//     keeps its 16 keys' k and v fragments and dk, dv in registers and
//     walks the query rows that see them 16 at a time: s^T = k q^T,
//     dp^T = v do^T, p^T from the rows' statistics, ds^T with their delta,
//     dv += T(p)^T do, dk += T(ds)^T q.
//
// Per 16 x 16 block of scores the backward runs 8 products (s, dp twice,
// dq; s^T, dp^T, dv, dk) where a backward with an atomic dq runs 5; both
// passes recompute p, so nothing of size L^2 reaches device memory.  A
// softmax division by a row's sum l goes through l's reciprocal and one FMA
// correction (div_rn_by, common.cuh), as correctly rounded as __fdiv_rn
// and a fraction of its instructions.  At B=256, L=197, D=768 the bound is
// bytes (0.092 ms forward, 0.162 ms backward at 3.35 TB/s), but the kernels
// are bound by latency: two blocks of four warps an SM (registers) leave
// few warps to cover the loads, barriers and mma chains (times in PERF.md).
// Registers a thread at NT = 4 (ptxas -v, sm_90a, no spills): forward 200
// (B3), 204 (B5/B6), 255 (B1, which keeps l for o); pass (a) 216 (B2), 255
// (B5/B6); pass (b) 161-163.  Blocks of 128 threads, two to an SM.  Shared
// memory a block at NT = 4: forward (64 + 128 NT) x 144 B = 82,944 B, pass
// (a) (128 + 128 NT) x 144 B = 92,160 B, pass (b) that plus 1,024 NT B of
// row statistics = 96,256 B.
//
// The streamed route (bf16 above 256 keys: ViT-L/14's 257, @336px's 577,
// up to the ops' 1024) serves the same TPU kernels at long rows:
// flyp_tpu/ops/attention_block.py::_fwd_infer_kernel :303 (B3), _fwd_kernel
// :118 (B1), _bwd_kernel :185 (B2); fused_qkv_attention.py::_fwd_kernel,
// _bwd_kernel :62, :74 (B5); flash_attention.py::_fwd_kernel, _bwd_kernel
// :36, :53 (B6).  Blocks of four warps own 64 rows as on the register route,
// with their own rows' A fragments in registers, but the opposite side
// streams through a ring of kStreamStages = 2 slots of two 64-row tiles (k
// and v, or q and do), one cp.async group a tile pair, the next in flight
// while a warp works on the last; so a block's shared memory no longer grows
// with L, and no score, probability or row statistic reaches shared memory:
// they stay in mma.sync registers a 64-key tile or a 16-key chunk at a time.
//
//   forward (attention_fwd_stream_kernel), per 64-row query tile: sweep 1
//     streams the k tiles for each row's max m and sum l of exp(s - m) (l
//     rescaled when m moves); sweep 2 streams k and v, recomputes s and adds
//     T(p) v with p = exp(s - m) / l normalised in fp32 before its cast, so
//     the rule above holds (a one-sweep online softmax would cast e under a
//     running max).  kTrain takes only m in sweep 1 and sums l from the e it
//     casts in sweep 2, o = (T(e) v) / l, lse = m + log l;
//   backward pass (a) (attention_bwd_q_stream_kernel), per 64-row query
//     tile: (m, l) from a stats sweep as the forward's sweep 1 (B5/B6, which
//     keep no lse), a sweep for delta = sum p dp, a sweep for ds and
//     dq += T(ds) k, p and dp a 16-key chunk at a time;
//   backward pass (b) (attention_bwd_k_stream_kernel), per 64-key tile: each
//     warp keeps its 16 keys' k, v fragments and dk, dv in registers, the
//     q/do tiles stream through the ring and every row's statistics (lse or
//     (m, l, 1/l), and delta) are read once into shared memory (16 B a row).
//
// Products are mma.sync m16n8k16, not wgmma: the register route's fragment
// helpers carry over unchanged (an accumulator cast to bf16 is the next
// product's A fragment; the k- and q-side transposes of p v, T(p)^T do and
// T(ds)^T q come from ldmatrix.trans), where wgmma wants its B operand in
// shared memory in its own swizzled layout and 64-row warpgroup tiles.  At
// ViT-L/14 (B = 256, L = 257, D = 1024) the bound is bytes: 0.161 ms
// forward, 0.282 ms backward at 3.35 TB/s (q, k, v (and do) read, o (dq,
// dk, dv) written once); the kernels run at several times that (times in
// PERF.md), bound by the mma chains, exp and the softmax arithmetic of their
// warps.  ptxas -v (sm_90a, no spills): forward 127 registers (B3, B5/B6),
// 123 (B1); pass (a) 149 (B5/B6), 127 (B2); pass (b) 168.  Shared memory a
// block: forward 46,080 B, pass (a) 55,296 B, pass (b) 55,296 B + 16 B a
// row of 64 ceil(L / 64) (60,416 B at L = 257, 71,680 B at 1024); so four
// blocks of 128 threads an SM in the forward, three or four in pass (a),
// three in pass (b) (the launch bounds cap registers for that).  Each pass
// recomputes p, so nothing of size L^2 reaches device memory.
//
// Heads of 80 (kWideHeadDim: ViT-H/14's D = 1,280 in 16 heads) run the
// same three kernels at HD = 80, the head width being a template argument
// of them and of what they use: the tile layout (HeadTile: rows of 176 B,
// an odd number of 16-byte pieces as 144 B is, so ldmatrix stays
// conflict-free), the ring slots, the fragment arrays (five k-steps of
// q k^T, ten 8-column tiles of o, dq, dk, dv) and shared memory.  Only the
// attention block's bf16 rows of 257-1,024 keys take them
// (attention_block.cu, attention_block_bwd.cu); every other route stays at
// 64, and the HD = 64 instantiations compile to what they were (registers
// above).  ptxas -v (sm_90a, no spills) at HD = 80: forward 142 registers
// (B3), 139 (B1); pass (a) 147; pass (b) 218.  Pass (b) keeps its 16 keys'
// k and v fragments and dk, dv in registers, 40 and 80 a thread, so its
// launch bounds ask two blocks an SM; the forward's ask three (four at
// HD = 64), pass (a)'s three.  Shared memory a block: forward 56,320 B,
// pass (a) 67,584 B, pass (b) 67,584 B + 16 B a row (72,704 B at L = 257).
// At B = 256, L = 257 the three take 1.23, 1.83 and 1.88 ms against 0.94,
// 1.42 and 1.28 ms at HD = 64 for 1.25 times the work (PERF.md): pass (b)'s
// two blocks an SM cost it most.
//
// The fp32 route (every L).  One block per (query tile, head, batch item)
// keeps the tile's scores over its whole key range in fp32 shared memory,
// so the softmax is normalised before p is used, as on the TPU; products
// run as FMA tiles on the CUDA cores, since the tensor cores would round
// fp32 operands to TF32.  Query tiles: 32 rows in the forward; the largest
// of 64, 32, 16 rows whose shared memory fits a block's 227 KB in pass (a),
// so every L <= 1024 fits.  The launches, on the caller's stream:
//
//   forward:  s tile by tile, the softmax row by row, o = sum over key
//             tiles of p v (attention_fma_kernel);
//   backward: pass (a), per query tile: s and dp over the full key range, p,
//             delta (to a [B, L, H] fp32 buffer), ds (over p), dq = ds k
//             (attention_bwd_dq_kernel);
//             pass (b), per 64-key tile, over the query tiles that see its
//             keys: p^T rebuilt from k q^T and the rows' statistics, dp^T =
//             v do^T, ds^T from the rows' delta, dv += p^T do, dk += ds^T q
//             (attention_bwd_dkv_kernel).

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
  float* delta;           // [B, L, H]: rowsum(p dp), backward pass (a) to pass (b)
  long long in_b, out_b;
  int in_r, out_r;
  int L, causal;
  float scale;
  int s_stride;  // fp32 per score row: the key range in 64s, + 4
};

// hd: the head width, kHeadDim but for the streamed route's kWideHeadDim.
inline AttnArgs attn_args(const void* q, const void* k, const void* v, long long in_b, int in_r, int L, int causal,
                          int hd = kHeadDim) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v;
  a.in_b = in_b; a.in_r = in_r;
  a.L = L; a.causal = causal;
  a.scale = 1.0f / sqrtf((float)hd);
  a.s_stride = ((L + kTile - 1) / kTile) * kTile + 4;  // 16-byte shifted rows: ldmatrix on p, ds conflict-free
  return a;
}

// The block's (head, batch item) rows of q, k or v, heads HD wide.
template <typename T, int HD = kHeadDim>
__device__ __forceinline__ const T* head_rows(const void* p, long long b_stride) {
  return static_cast<const T*>(p) + (size_t)blockIdx.z * b_stride + (size_t)blockIdx.y * HD;
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
      const float rl = __frcp_rn(l);
      for (int j = lane; j < cols; j += 32) row[j] = j < visible ? div_rn_by(expf(row[j] - m), l, rl) : 0.f;
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
// Backward, fp32, pass (a): one block of 2 * QT threads per (QT-row query
// tile, head, item).

template <int QT, bool kScaleQ>
__global__ void __launch_bounds__(2 * QT) attention_bwd_dq_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<float>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [QT][TS]: q, or q * scale
  float* dOs = Qs + QT * TS;                       // [QT][TS]
  float* KVs = dOs + QT * TS;                      // [64][TS]: k, then v, then k again
  float* S = KVs + kTile * TS;                     // [QT][s_stride]: s, then p, then ds
  float* DP = S + QT * a.s_stride;                 // [QT][s_stride]: dp, then the dq sums
  __shared__ float row_lse[QT];                    // kScaleQ: the rows' lse

  const int L = a.L, h = blockIdx.y, b = blockIdx.z, i0 = blockIdx.x * QT;
  const int D = gridDim.y * kHeadDim;
  const float* Q = head_rows<float>(a.q, a.in_b);
  const float* K = head_rows<float>(a.k, a.in_b);
  const float* V = head_rows<float>(a.v, a.in_b);
  const float* dO = head_rows<float>(a.dout, (long long)L * D);
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

  // One warp per row: p, delta (to a.delta for pass (b)), then ds over p.
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
    const float rl = __frcp_rn(l);
    for (int j = lane; j < cols; j += 32) {
      const float p = j < visible ? (kScaleQ ? expf(srow[j] - lse) : div_rn_by(srow[j], l, rl)) : 0.f;
      srow[j] = p;
      delta += p * dprow[j];
    }
    delta = warp_sum(delta);
    if (lane == 0 && i < L) a.delta[stat_index(i, L)] = delta;
    for (int j = lane; j < cols; j += 32) {
      const float pd = __fmul_rn(srow[j], __fsub_rn(dprow[j], delta));
      srow[j] = kScaleQ ? pd : __fmul_rn(pd, a.scale);
    }
  }

  // dq sums over the key tiles, into the (now free) dp rows.
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<kTile, 2 * QT>(KVs, K, a.in_r, k0, L);
    __syncthreads();
    tile_product<false, false, QT>(DP, a.s_stride, S + k0, a.s_stride, KVs, TS, t > 0);  // ds k
  }
  __syncthreads();
  float* dQ = static_cast<float*>(a.dq) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  for (int e = threadIdx.x; e < QT * kHeadDim; e += 2 * QT) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    const float dq = DP[r * a.s_stride + c];
    if (i0 + r < L) dQ[(size_t)(i0 + r) * a.out_r + c] = kScaleQ ? __fmul_rn(dq, a.scale) : dq;
  }
}

// Backward, fp32, pass (b): one block of 128 threads per (64-key tile, head,
// item), walking the 64-row query tiles that can see its keys: p^T rebuilt
// from k q^T and the rows' statistics, dp^T = v do^T, ds^T from p, dp and
// the rows' delta, dv += p^T do and dk += ds^T q.

constexpr int kDkvThreads = 2 * kTile;

template <bool kScaleQ>
__global__ void __launch_bounds__(kDkvThreads) attention_bwd_dkv_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<float>::kStride, TE = TileLayout<float>::kElems, kThreads = kDkvThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // k rows j0..
  float* Vs = Ks + TE;                             // v rows j0..
  float* Qs = Vs + TE;                             // q (or q * scale) rows i0..
  float* dOs = Qs + TE;                            // do rows i0..
  float* dSt = dOs + TE;                           // ds[j][i]
  float* Pt = dSt + TE;                            // p[j][i]
  float* ST = Pt + TE;                             // s^T [64][kAccStride]
  float* DPT = ST + kTile * kAccStride;            // dp^T
  float* DV = DPT + kTile * kAccStride;
  float* DK = DV + kTile * kAccStride;
  float* row_m = DK + kTile * kAccStride;  // per query row i0..: lse (kScaleQ) or m
  float* row_l = row_m + kTile;            // l
  float* row_rl = row_l + kTile;           // 1 / l
  float* row_d = row_rl + kTile;           // delta

  const int L = a.L, D = gridDim.y * kHeadDim, b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kTile;
  const float* Q = head_rows<float>(a.q, a.in_b);
  const float* dO = head_rows<float>(a.dout, (long long)L * D);
  const int tid = threadIdx.x;

  load_tile<kTile, kThreads>(Ks, head_rows<float>(a.k, a.in_b), a.in_r, j0, L);
  load_tile<kTile, kThreads>(Vs, head_rows<float>(a.v, a.in_b), a.in_r, j0, L);
  const int first = a.causal ? j0 : 0;
  for (int i0 = first; i0 < L; i0 += kTile) {
    __syncthreads();
    load_tile<kTile, kThreads>(Qs, Q, a.in_r, i0, L, kScaleQ ? a.scale : 0.f);
    load_tile<kTile, kThreads>(dOs, dO, D, i0, L);
    for (int r = tid; r < kTile; r += kThreads) {
      const int i = i0 + r;
      if (kScaleQ) {
        row_m[r] = i < L ? a.stats[stat_index(i, L)] : 0.f;
      } else {
        const float2 ml = i < L ? reinterpret_cast<const float2*>(a.stats)[stat_index(i, L)] : make_float2(0.f, 1.f);
        row_m[r] = ml.x;
        row_l[r] = ml.y;
        row_rl[r] = __frcp_rn(ml.y);
      }
      row_d[r] = i < L ? a.delta[stat_index(i, L)] : 0.f;
    }
    __syncthreads();
    tile_product<false, true>(ST, kAccStride, Ks, TS, Qs, TS, false);    // s^T = k q^T
    tile_product<false, true>(DPT, kAccStride, Vs, TS, dOs, TS, false);  // dp^T = v do^T
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile, j = j0 + r, i = i0 + c;
      const bool keep = j < L && i < L && (!a.causal || j <= i);
      const float s = ST[r * kAccStride + c];
      float p = 0.f, ds = 0.f;
      if (keep) {
        p = kScaleQ ? expf(s - row_m[c]) : div_rn_by(expf(__fmul_rn(s, a.scale) - row_m[c]), row_l[c], row_rl[c]);
        const float pd = __fmul_rn(p, __fsub_rn(DPT[r * kAccStride + c], row_d[c]));
        ds = kScaleQ ? pd : __fmul_rn(pd, a.scale);
      }
      Pt[r * TS + c] = p;
      dSt[r * TS + c] = ds;
    }
    __syncthreads();
    const bool acc = i0 != first;
    tile_product<false, false>(DV, kAccStride, Pt, TS, dOs, TS, acc);  // dv += p^T do
    tile_product<false, false>(DK, kAccStride, dSt, TS, Qs, TS, acc);  // dk += ds^T q
  }
  __syncthreads();
  float* dK = static_cast<float*>(a.dk) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  float* dV = static_cast<float*>(a.dv) + (size_t)b * a.out_b + (size_t)h * kHeadDim;
  for (int e = tid; e < kTile * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim, c = e % kHeadDim, j = j0 + r;
    if (j < L) {
      dK[(size_t)j * a.out_r + c] = DK[r * kAccStride + c];
      dV[(size_t)j * a.out_r + c] = DV[r * kAccStride + c];
    }
  }
}

// ---------------------------------------------------------------------------
// The register route: bf16, L <= kRegKeys.  Blocks of four warps, each warp
// owning 16 rows (query rows in the forward and pass (a), keys in pass (b));
// a block's 64 rows and the whole key (or query) range of its (head, item)
// sit in shared memory, loaded by cp.async in one group per 64-row tile so
// the products of a tile start as soon as it lands.  Products run on
// mma.sync m16n8k16 with fp32 accumulate; a product's accumulator
// fragments, cast to bf16, are the next product's A fragments, as in
// FlashAttention-2, so no score reaches shared or device memory.  NT, the
// number of 64-key tiles, is a template constant so a row's scores stay in
// registers (NT * 32 fp32 a thread); chunks of 16 keys past a warp's last
// visible key are skipped.

constexpr int kRegKeys = 256;  // the longest key range the register route keeps
constexpr int kRegRows = 64;   // rows a block owns: four warps of 16
constexpr int kRegThreads = 128;

// Row stride, in bf16, of a shared-memory tile of HD-wide head rows: HD +
// 8, so consecutive rows (144 B at HD 64, 176 B at HD 80) start an odd
// number of 16-byte pieces apart and ldmatrix's eight row addresses fall in
// distinct banks.  At HD 64 it is TileLayout<bf16>::kStride.
template <int HD>
struct HeadTile {
  static constexpr int kStride = HD + 8;
};

// kRows rows (row0.., zeros past L) x HD bf16 of src (row stride ld) into a
// [kRows][HeadTile<HD>::kStride] tile by cp.async, 16 bytes a copy, from all
// kRegThreads threads; the caller commits.
template <int kRows, int HD = kHeadDim>
__device__ __forceinline__ void cp_async_rows(bf16* dst, const bf16* __restrict__ src, long long ld, int row0,
                                              int L) {
  constexpr int TS = HeadTile<HD>::kStride, P = HD / 8;  // 16-byte pieces a row
#pragma unroll
  for (int e = threadIdx.x; e < kRows * P; e += kRegThreads) {
    const int r = e / P, c = (e % P) * 8, j = row0 + r;
    cp_async16(&dst[r * TS + c], src + (size_t)(j < L ? j : 0) * ld + c, j < L);
  }
}

// T(v * scale) in place over the pieces this thread copied with
// cp_async_rows (visible to it once their group is waited for).
template <int kRows, int HD = kHeadDim>
__device__ __forceinline__ void scale_rows(bf16* dst, int row0, int L, float scale) {
  constexpr int TS = HeadTile<HD>::kStride, P = HD / 8;
#pragma unroll
  for (int e = threadIdx.x; e < kRows * P; e += kRegThreads) {
    const int r = e / P, c = (e % P) * 8;
    if (row0 + r >= L) continue;
    uint4* piece = reinterpret_cast<uint4*>(&dst[r * TS + c]);
    uint4 u = *piece;
    bf16* v = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(v[i]), scale));
    *piece = u;
  }
}

// acc[2c], acc[2c + 1] (16 x 16 each) = A times the 16 rows n0 + 16 c.. of
// a tile held [n][feature], transposed (a q k^T-type product), for each of
// the four chunks c < 4 with n0 + 16 c < n_end (the others are left as they
// are).  A is a warp's 16 rows x 64 features held [row][feature] at row a0
// of a_tile, its fragments loaded once per k-step; the chunks'
// accumulators are independent, so eight mma chains are in flight.
__device__ __forceinline__ void mma_nt_tile(float (*acc)[4], const bf16* a_tile, int a0, const bf16* tile, int n0,
                                            int n_end) {
  constexpr int TS = TileLayout<bf16>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, &a_tile[(a0 + ldm_row(lane, false)) * TS + ks * 16 + ldm_col(lane, false)]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n0 + 16 * c >= n_end) continue;
      uint32_t r[4];
      ldmatrix_x4(r, &tile[(n0 + 16 * c + ldm_row(lane, true)) * TS + ks * 16 + ldm_col(lane, true)]);
      mma_bf16(acc[2 * c], af, r[0], r[1]);
      mma_bf16(acc[2 * c + 1], af, r[2], r[3]);
    }
  }
}

// acc[0], acc[1] (16 x 16) = A times the 16 rows n0.. of a tile held
// [n][feature], transposed, with A's fragments (a warp's 16 rows x 16 KS
// features, KS k-steps) in registers.
template <int KS>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const uint32_t (&af)[KS][4], const bf16* tile, int n0) {
  constexpr int TS = HeadTile<16 * KS>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t r[4];
    ldmatrix_x4(r, &tile[(n0 + ldm_row(lane, true)) * TS + ks * 16 + ldm_col(lane, true)]);
    mma_bf16(acc[0], af[ks], r[0], r[1]);
    mma_bf16(acc[1], af[ks], r[2], r[3]);
  }
}

// The A fragments of a warp's 16 rows held [row][feature] at row r0, 16 KS
// features.
template <int KS>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[KS][4], const bf16* tile, int r0) {
  constexpr int TS = HeadTile<16 * KS>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldmatrix_x4(af[ks], &tile[(r0 + ldm_row(lane, false)) * TS + ks * 16 + ldm_col(lane, false)]);
  }
}

// acc (16 x 8 NF features) += A (16 rows x the 16 tile rows k0..) times
// those tile rows, held [k][feature]: a p v-type product.
template <int NF>
__device__ __forceinline__ void mma_rows_nn(float (&acc)[NF][4], const uint32_t (&a)[4], const bf16* tile, int k0) {
  constexpr int TS = HeadTile<8 * NF>::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < NF / 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, &tile[(k0 + ldm_row(lane, false)) * TS + np * 16 + ldm_col(lane, false)]);
    mma_bf16(acc[2 * np], a, r[0], r[1]);
    mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
  }
}

// Two 16 x 8 accumulator tiles (16 rows x 16 columns) as the bf16 A
// fragment over those 16 columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4], const float (&c0)[4], const float (&c1)[4]) {
  f[0] = pack_bf16(c0[0], c0[1]);
  f[1] = pack_bf16(c0[2], c0[3]);
  f[2] = pack_bf16(c1[0], c1[1]);
  f[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scores s[n][e] of a warp's 16 query rows (row wr of Qs) over NT key
// tiles, the tiles waited for one by one (groups 1..NT after the rows'
// group 0, the V tiles' NT groups behind them), a tile's four chunks at
// once.  Chunks of 16 keys at or past kv_warp stay 0.
template <int NT>
__device__ __forceinline__ void row_scores(float (&s)[NT * 8][4], const bf16* Qs, int wr, const bf16* Ks,
                                           int kv_warp) {
#pragma unroll
  for (int n = 0; n < NT * 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    cp_async_wait(2 * NT - 1 - t);
    __syncthreads();
    mma_nt_tile(&s[8 * t], Qs, wr, Ks, t * kTile, kv_warp);
  }
}

// The exact softmax statistics of a warp's rows over scores held in
// registers: (scaled in place unless kScaleQ) m over the visible keys, then
// s[n][e] = exp(s - m) and l = the sum of those, over the lane quad.
// vis[h]: keys row lane/4 + 8h sees (0 for a row past L).
template <int NT, bool kScaleQ>
__device__ __forceinline__ void row_exp_regs(float (&s)[NT * 8][4], const int (&vis)[2], float scale, float (&m)[2],
                                             float (&l)[2]) {
  const int lane = threadIdx.x % 32;
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT * 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!kScaleQ) s[n][e] = __fmul_rn(s[n][e], scale);
      if (n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1]) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
    }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int n = 0; n < NT * 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1] ? expf(s[n][e] - m[e >> 1]) : 0.f;
      s[n][e] = x;
      l[e >> 1] += x;
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// Forward: one block per (64-row query tile, head, item).
template <bool kScaleQ, bool kTrain, int NT>
__global__ void __launch_bounds__(kRegThreads, 2) attention_fwd_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<bf16>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]
  bf16* Ks = Qs + kRegRows * TS;                 // [NT * 64][TS]
  bf16* Vs = Ks + NT * kTile * TS;               // [NT * 64][TS]

  const int L = a.L, D = gridDim.y * kHeadDim, q0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* K = head_rows<bf16>(a.k, a.in_b);
  const bf16* V = head_rows<bf16>(a.v, a.in_b);
  const int n_tiles = ((a.causal ? min(q0 + kRegRows, L) : L) + kTile - 1) / kTile;

  cp_async_rows<kRegRows>(Qs, head_rows<bf16>(a.q, a.in_b), a.in_r, q0, L);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < n_tiles) cp_async_rows<kTile>(Ks + t * kTile * TS, K, a.in_r, t * kTile, L);
    cp_async_commit();
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < n_tiles) cp_async_rows<kTile>(Vs + t * kTile * TS, V, a.in_r, t * kTile, L);
    cp_async_commit();
  }
  cp_async_wait(2 * NT);
  if (kScaleQ) scale_rows<kRegRows>(Qs, q0, L, a.scale);  // q rounds to T(q * scale)
  __syncthreads();

  // Rows r (lane/4) and r + 8 of the warp's 16; a warp wholly past L skips
  // every product (kv_warp = 0) but still takes part in the barriers.
  const int r = q0 + wr + lane / 4;
  const int kv_warp = q0 + wr >= L ? 0 : a.causal ? min(q0 + wr + 16, L) : L;
  int vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) vis[h] = r + 8 * h < L ? (a.causal ? r + 8 * h + 1 : L) : 0;

  float s[NT * 8][4];
  row_scores<NT>(s, Qs, wr, Ks, kv_warp);
  float m[2], l[2];
  row_exp_regs<NT, kScaleQ>(s, vis, a.scale, m, l);
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  if (kTrain) {
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < L) a.stats[stat_index(r + 8 * h, L)] = m[h] + logf(l[h]);
    }
  } else {  // p = e / l, normalised in fp32 before its cast
#pragma unroll
    for (int n = 0; n < NT * 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1]) s[n][e] = div_rn_by(s[n][e], l[e >> 1], rl[e >> 1]);
  }

  cp_async_wait(0);
  __syncthreads();
  float o[8][4] = {};
#pragma unroll
  for (int c = 0; c < NT * 4; ++c) {
    if (c * 16 >= kv_warp) continue;
    uint32_t pa[4];
    acc_to_a(pa, s[2 * c], s[2 * c + 1]);
    mma_rows_nn(o, pa, Vs, c * 16);
  }

  bf16* O = static_cast<bf16*>(a.o) + (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * kHeadDim;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float v0 = o[nt][2 * h], v1 = o[nt][2 * h + 1];
      if (kTrain) {
        v0 = div_rn_by(v0, l[h], rl[h]);
        v1 = div_rn_by(v1, l[h], rl[h]);
      }
      *reinterpret_cast<bf162*>(O + (size_t)i * D + nt * 8 + (lane % 4) * 2) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Backward pass (a): one block per (64-row query tile, head, item).  Each
// warp keeps its rows' p in registers (from s, the statistics computed here
// or the forward's lse), sweeps the key chunks for delta = sum p dp with dp
// in registers, then again for ds and dq += T(ds) k.  It writes dq, the
// statistics ((m, l) unless kScaleQ) and delta.
template <int NT, bool kScaleQ>
__global__ void __launch_bounds__(kRegThreads, 2) attention_bwd_q_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<bf16>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]: q, or T(q * scale)
  bf16* dOs = Qs + kRegRows * TS;                // [64][TS]
  bf16* Ks = dOs + kRegRows * TS;                // [NT * 64][TS]
  bf16* Vs = Ks + NT * kTile * TS;               // [NT * 64][TS]

  const int L = a.L, D = gridDim.y * kHeadDim, i0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* K = head_rows<bf16>(a.k, a.in_b);
  const bf16* V = head_rows<bf16>(a.v, a.in_b);
  const int n_tiles = ((a.causal ? min(i0 + kRegRows, L) : L) + kTile - 1) / kTile;

  cp_async_rows<kRegRows>(Qs, head_rows<bf16>(a.q, a.in_b), a.in_r, i0, L);
  cp_async_rows<kRegRows>(dOs, head_rows<bf16>(a.dout, (long long)L * D), D, i0, L);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < n_tiles) cp_async_rows<kTile>(Ks + t * kTile * TS, K, a.in_r, t * kTile, L);
    cp_async_commit();
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < n_tiles) cp_async_rows<kTile>(Vs + t * kTile * TS, V, a.in_r, t * kTile, L);
    cp_async_commit();
  }
  cp_async_wait(2 * NT);
  if (kScaleQ) scale_rows<kRegRows>(Qs, i0, L, a.scale);
  __syncthreads();

  const int r = i0 + wr + lane / 4;
  const int kv_warp = i0 + wr >= L ? 0 : a.causal ? min(i0 + wr + 16, L) : L;
  int vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) vis[h] = r + 8 * h < L ? (a.causal ? r + 8 * h + 1 : L) : 0;

  float p[NT * 8][4];
  row_scores<NT>(p, Qs, wr, Ks, kv_warp);
  if (kScaleQ) {  // p = exp(s - lse)
    float lse[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[h] = r + 8 * h < L ? a.stats[stat_index(r + 8 * h, L)] : 0.f;
#pragma unroll
    for (int n = 0; n < NT * 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1] ? expf(p[n][e] - lse[e >> 1]) : 0.f;
  } else {  // p = exp(s scale - m) / l, the statistics handed to pass (b)
    float m[2], l[2];
    row_exp_regs<NT, false>(p, vis, a.scale, m, l);
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
    for (int n = 0; n < NT * 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1]) p[n][e] = div_rn_by(p[n][e], l[e >> 1], rl[e >> 1]);
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < L) reinterpret_cast<float2*>(a.stats)[stat_index(r + 8 * h, L)] = make_float2(m[h], l[h]);
    }
  }

  cp_async_wait(0);
  __syncthreads();
  // dp = do v^T in registers, one chunk of 16 keys at a time, in both
  // sweeps; do's fragments stay in registers.
  uint32_t da[4][4];
  load_a_frags(da, dOs, wr);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NT * 4; ++c) {
    if (c * 16 >= kv_warp) continue;
    float dp[2][4] = {};
    mma_nt(dp, da, Vs, c * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e >> 1] += p[2 * c + u][e] * dp[u][e];
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < L) a.delta[stat_index(r + 8 * h, L)] = delta[h];
  }

  float dq[8][4] = {};
#pragma unroll
  for (int c = 0; c < NT * 4; ++c) {
    if (c * 16 >= kv_warp) continue;
    float dp[2][4] = {};
    mma_nt(dp, da, Vs, c * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pd = __fmul_rn(p[2 * c + u][e], __fsub_rn(dp[u][e], delta[e >> 1]));
        dp[u][e] = kScaleQ ? pd : __fmul_rn(pd, a.scale);  // ds
      }
    uint32_t dsa[4];
    acc_to_a(dsa, dp[0], dp[1]);
    mma_rows_nn(dq, dsa, Ks, c * 16);  // dq += T(ds) k
  }

  bf16* dQ = static_cast<bf16*>(a.dq) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * kHeadDim;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float v0 = dq[nt][2 * h], v1 = dq[nt][2 * h + 1];
      if (kScaleQ) {
        v0 = __fmul_rn(v0, a.scale);
        v1 = __fmul_rn(v1, a.scale);
      }
      *reinterpret_cast<bf162*>(dQ + (size_t)i * a.out_r + nt * 8 + (lane % 4) * 2) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Backward pass (b): one block per (64-key tile, head, item).  Each warp
// keeps its 16 keys' k and v fragments and dk, dv in registers and sweeps
// the query rows that can see them, 16 at a time: s^T = k q^T and
// dp^T = v do^T in registers, p^T from the rows' statistics, ds^T with
// their delta, dv += T(p)^T do and dk += T(ds)^T q.
template <int NT, bool kScaleQ>
__global__ void __launch_bounds__(kRegThreads, 2) attention_bwd_k_kernel(const AttnArgs a) {
  constexpr int TS = TileLayout<bf16>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]
  bf16* Vs = Ks + kRegRows * TS;                 // [64][TS]
  bf16* Qs = Vs + kRegRows * TS;                 // [NT * 64][TS]: q, or T(q * scale)
  bf16* dOs = Qs + NT * kTile * TS;              // [NT * 64][TS]
  // Per query row: (lse, -, -, delta) with kScaleQ, else (m, l, 1 / l, delta).
  float4* row_st = reinterpret_cast<float4*>(dOs + NT * kTile * TS);

  const int L = a.L, D = gridDim.y * kHeadDim, j0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* Q = head_rows<bf16>(a.q, a.in_b);
  const bf16* dO = head_rows<bf16>(a.dout, (long long)L * D);
  const int first = a.causal ? (int)blockIdx.x : 0;  // the first query tile that sees these keys

  cp_async_rows<kRegRows>(Ks, head_rows<bf16>(a.k, a.in_b), a.in_r, j0, L);
  cp_async_rows<kRegRows>(Vs, head_rows<bf16>(a.v, a.in_b), a.in_r, j0, L);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= first && t * kTile < L) {
      cp_async_rows<kTile>(Qs + t * kTile * TS, Q, a.in_r, t * kTile, L);
      cp_async_rows<kTile>(dOs + t * kTile * TS, dO, D, t * kTile, L);
    }
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < NT * kTile; i += kRegThreads) {
    float m = 0.f, l = 1.f, d = 0.f;
    if (i < L) {
      if (kScaleQ) {
        m = a.stats[stat_index(i, L)];
      } else {
        const float2 ml = reinterpret_cast<const float2*>(a.stats)[stat_index(i, L)];
        m = ml.x;
        l = ml.y;
      }
      d = a.delta[stat_index(i, L)];
    }
    row_st[i] = make_float4(m, l, __frcp_rn(l), d);
  }
  cp_async_wait(NT);
  __syncthreads();

  const int jw = j0 + wr;       // the warp's first key
  const int j = jw + lane / 4;  // keys j (accumulator rows lane/4) and j + 8
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, Ks, wr);
  load_a_frags(va, Vs, wr);
  float dk[8][4] = {}, dv[8][4] = {};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    cp_async_wait(NT - 1 - t);
    if (kScaleQ && t >= first && t * kTile < L) scale_rows<kTile>(Qs + t * kTile * TS, t * kTile, L, a.scale);
    __syncthreads();
    if (t < first || jw >= L) continue;
#pragma unroll
    for (int qc = 0; qc < 4; ++qc) {
      const int ib = t * kTile + qc * 16;  // the chunk's first query row
      if (ib >= L || (a.causal && ib + 15 < jw)) continue;
      float st[2][4] = {}, dpt[2][4] = {};
      mma_nt(st, ka, Qs, ib);    // s^T = k q^T
      mma_nt(dpt, va, dOs, ib);  // dp^T = v do^T
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ib + u * 8 + (lane % 4) * 2 + (e & 1), jj = j + 8 * (e >> 1);
          float pv = 0.f, ds = 0.f;
          if (jj < L && i < L && (!a.causal || jj <= i)) {
            const float4 st_i = row_st[i];
            pv = kScaleQ ? expf(st[u][e] - st_i.x)
                         : div_rn_by(expf(__fmul_rn(st[u][e], a.scale) - st_i.x), st_i.y, st_i.z);
            const float pd = __fmul_rn(pv, __fsub_rn(dpt[u][e], st_i.w));
            ds = kScaleQ ? pd : __fmul_rn(pd, a.scale);
          }
          st[u][e] = pv;
          dpt[u][e] = ds;
        }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[0], st[1]);
      acc_to_a(dsa, dpt[0], dpt[1]);
      mma_rows_nn(dv, pa, dOs, ib);  // dv += T(p)^T do
      mma_rows_nn(dk, dsa, Qs, ib);  // dk += T(ds)^T q
    }
  }

  bf16* dK = static_cast<bf16*>(a.dk) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * kHeadDim;
  bf16* dV = static_cast<bf16*>(a.dv) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * kHeadDim;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = j + 8 * h;
    if (jj >= L) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const size_t off = (size_t)jj * a.out_r + nt * 8 + (lane % 4) * 2;
      *reinterpret_cast<bf162*>(dK + off) = __floats2bfloat162_rn(dk[nt][2 * h], dk[nt][2 * h + 1]);
      *reinterpret_cast<bf162*>(dV + off) = __floats2bfloat162_rn(dv[nt][2 * h], dv[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The streamed route: bf16 above kRegKeys keys (the header's note).  Its
// kernels reuse the register route's fragment helpers and launch over the
// same 64-row blocks of kRegThreads.

constexpr int kStreamStages = 2;  // ring slots: the next load is in flight while a tile is used

// The head widths of the streamed route: kHeadDim, and kWideHeadDim (ViT-H/14's
// 80, 16 heads of 1,280) for the attention block's bf16 rows of more than
// kRegKeys and at most kWideMaxKeys keys; every other route stays at kHeadDim.
constexpr int kWideHeadDim = 80;
constexpr int kWideMaxKeys = 1024;

// Elements of one ring slot: two 64-row tiles of HD-wide rows.
template <int HD>
struct StreamSlot {
  static constexpr int kElems = 2 * kTile * HeadTile<HD>::kStride;
};

template <int HD>
__device__ __forceinline__ bf16* ring_slot(bf16* ring, int u) {
  return ring + (u % kStreamStages) * StreamSlot<HD>::kElems;
}

// The ring runs a kernel's sequence of n loads in order; issue(u) copies
// load u's tiles into ring_slot(u) by cp.async (one group a load, an empty
// one past the end, so the wait count stays constant).  ring_start issues
// the first kStreamStages - 1.
template <typename Issue>
__device__ __forceinline__ void ring_start(const Issue& issue, int n) {
#pragma unroll
  for (int u = 0; u < kStreamStages - 1; ++u) {
    if (u < n) issue(u);
    cp_async_commit();
  }
}

// Makes load u visible to the block, then issues load u + kStreamStages - 1
// into the slot of load u - 1, which every warp has finished with once it
// reaches this barrier.  landed(u) runs between the wait and the barrier,
// when a thread's own copies of load u are visible to it.
template <typename Issue, typename Landed>
__device__ __forceinline__ void ring_next(const Issue& issue, int u, int n, const Landed& landed) {
  cp_async_wait(kStreamStages - 2);
  landed(u);
  __syncthreads();
  if (u + kStreamStages - 1 < n) issue(u + kStreamStages - 1);
  cp_async_commit();
}
template <typename Issue>
__device__ __forceinline__ void ring_next(const Issue& issue, int u, int n) {
  ring_next(issue, u, n, [](int) {});
}

// s (8 x 16 x 8 accumulators: a warp's 16 rows x the 64 keys k0.. of tile
// kt) = A k^T over 16 KS features, scaled unless kScaleQ; 16-key chunks at
// or past kv_warp stay 0.
template <bool kScaleQ, int KS>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&qa)[KS][4], const bf16* kt, int k0,
                                            int kv_warp, float scale) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (k0 + 16 * c < kv_warp) mma_nt(&s[2 * c], qa, kt, 16 * c);
  if (!kScaleQ) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
  }
}

// Folds the scores of the 64 keys k0.. into the rows' running max m and,
// with kSum, sum l of exp(s - m) over the visible keys (vis[h]: keys row
// lane/4 + 8h sees), l rescaled when m moves.  Over the whole key range
// this gives the softmax's exact max and its sum up to fp32 rounding.
template <bool kSum>
__device__ __forceinline__ void fold_stats(const float (&s)[8][4], const int (&vis)[2], int k0, float (&m)[2],
                                           float (&l)[2]) {
  const int lane = threadIdx.x % 32;
  float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1]) tm[e >> 1] = fmaxf(tm[e >> 1], s[n][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(tm[h]));
    if (kSum && mn != m[h]) l[h] *= expf(m[h] - mn);  // from m = -inf, l = 0 stays 0
    m[h] = mn;
  }
  if (kSum) {
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + n * 8 + (lane % 4) * 2 + (e & 1) < vis[e >> 1]) part[e >> 1] += expf(s[n][e] - m[e >> 1]);
    l[0] += quad_sum(part[0]);
    l[1] += quad_sum(part[1]);
  }
}

// Forward: one block per (64-row query tile, head, item).  Sweep 1 streams
// the k tiles for each row's max m (and, unless kTrain, its sum l); sweep 2
// streams k and v, recomputes s, and accumulates o += T(p) v with p = exp(s
// - m) / l normalised in fp32 before its cast (kTrain: e = exp(s - m), its
// sum l taken here, and o = (T(e) v) / l at the end, with lse = m + log l).
template <bool kScaleQ, bool kTrain, int HD>
__global__ void __launch_bounds__(kRegThreads, HD == kHeadDim ? 4 : 3)
    attention_fwd_stream_kernel(const AttnArgs a) {
  constexpr int TS = HeadTile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]
  bf16* ring = Qs + kRegRows * TS;               // slots of [k; v]

  const int L = a.L, D = gridDim.y * HD, q0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* K = head_rows<bf16, HD>(a.k, a.in_b);
  const bf16* V = head_rows<bf16, HD>(a.v, a.in_b);
  const int n = ((a.causal ? min(q0 + kRegRows, L) : L) + kTile - 1) / kTile;  // key tiles
  // Loads 0..n-1: k tile u (sweep 1); n..2n-1: k and v tile u - n (sweep 2).
  auto issue = [&](int u) {
    bf16* slot = ring_slot<HD>(ring, u);
    const int k0 = (u < n ? u : u - n) * kTile;
    cp_async_rows<kTile, HD>(slot, K, a.in_r, k0, L);
    if (u >= n) cp_async_rows<kTile, HD>(slot + kTile * TS, V, a.in_r, k0, L);
  };

  cp_async_rows<kRegRows, HD>(Qs, head_rows<bf16, HD>(a.q, a.in_b), a.in_r, q0, L);
  cp_async_commit();
  ring_start(issue, 2 * n);
  cp_async_wait(kStreamStages - 1);
  if (kScaleQ) scale_rows<kRegRows, HD>(Qs, q0, L, a.scale);  // q rounds to T(q * scale)
  __syncthreads();
  uint32_t qa[HD / 16][4];
  load_a_frags(qa, Qs, wr);

  // Rows r (lane/4) and r + 8 of the warp's 16; a warp wholly past L skips
  // every product (kv_warp = 0) but still takes part in the barriers.
  const int r = q0 + wr + lane / 4;
  const int kv_warp = q0 + wr >= L ? 0 : a.causal ? min(q0 + wr + 16, L) : L;
  int vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) vis[h] = r + 8 * h < L ? (a.causal ? r + 8 * h + 1 : L) : 0;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < n; ++t) {
    ring_next(issue, t, 2 * n);
    float s[8][4];
    tile_scores<kScaleQ>(s, qa, ring_slot<HD>(ring, t), t * kTile, kv_warp, a.scale);
    fold_stats<!kTrain>(s, vis, t * kTile, m, l);
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  float o[HD / 8][4] = {}, le[2] = {0.f, 0.f};
  for (int t = 0; t < n; ++t) {
    ring_next(issue, n + t, 2 * n);
    const bf16* kt = ring_slot<HD>(ring, n + t);
    float s[8][4];
    tile_scores<kScaleQ>(s, qa, kt, t * kTile, kv_warp, a.scale);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (t * kTile + 16 * c >= kv_warp) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = 0.f;
          if (t * kTile + (2 * c + u) * 8 + (lane % 4) * 2 + (e & 1) < vis[h]) {
            x = expf(s[2 * c + u][e] - m[h]);
            if (kTrain) le[h] += x;
            else x = div_rn_by(x, l[h], rl[h]);  // p normalised in fp32 before its cast
          }
          s[2 * c + u][e] = x;
        }
      uint32_t pa[4];
      acc_to_a(pa, s[2 * c], s[2 * c + 1]);
      mma_rows_nn(o, pa, kt + kTile * TS, 16 * c);
    }
  }

  if (kTrain) {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(le[h]);
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < L) a.stats[stat_index(r + 8 * h, L)] = m[h] + logf(l[h]);
    }
  }
  bf16* O = static_cast<bf16*>(a.o) + (size_t)blockIdx.z * L * D + (size_t)blockIdx.y * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= L) continue;
    const float rlh = kTrain ? __frcp_rn(l[h]) : 0.f;  // l summed in sweep 2
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      float v0 = o[nt][2 * h], v1 = o[nt][2 * h + 1];
      if (kTrain) {
        v0 = div_rn_by(v0, l[h], rlh);
        v1 = div_rn_by(v1, l[h], rlh);
      }
      *reinterpret_cast<bf162*>(O + (size_t)i * D + nt * 8 + (lane % 4) * 2) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Backward pass (a): one block per (64-row query tile, head, item), q and
// do fragments in registers.  Unless kScaleQ (B5/B6 keep no lse), a stats
// sweep over the k tiles gives each row's (m, l) as the forward's sweep 1
// does, written for pass (b); a sweep over k and v sums delta = sum p dp
// in fp32, with p and dp a 16-key chunk at a time; a last sweep forms ds
// and dq += T(ds) k.  It writes dq, the statistics and delta.
template <bool kScaleQ, int HD>
__global__ void __launch_bounds__(kRegThreads, 3) attention_bwd_q_stream_kernel(const AttnArgs a) {
  constexpr int TS = HeadTile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]: q, or T(q * scale)
  bf16* dOs = Qs + kRegRows * TS;                // [64][TS]
  bf16* ring = dOs + kRegRows * TS;              // slots of [k; v]

  const int L = a.L, D = gridDim.y * HD, i0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* K = head_rows<bf16, HD>(a.k, a.in_b);
  const bf16* V = head_rows<bf16, HD>(a.v, a.in_b);
  const int n = ((a.causal ? min(i0 + kRegRows, L) : L) + kTile - 1) / kTile;  // key tiles
  const int n_stats = kScaleQ ? 0 : n, n_loads = n_stats + 2 * n;
  // Loads 0..n_stats-1: k tiles (stats sweep); then k and v tiles, twice.
  auto issue = [&](int u) {
    bf16* slot = ring_slot<HD>(ring, u);
    const int k0 = (u < n_stats ? u : (u - n_stats) % n) * kTile;
    cp_async_rows<kTile, HD>(slot, K, a.in_r, k0, L);
    if (u >= n_stats) cp_async_rows<kTile, HD>(slot + kTile * TS, V, a.in_r, k0, L);
  };

  cp_async_rows<kRegRows, HD>(Qs, head_rows<bf16, HD>(a.q, a.in_b), a.in_r, i0, L);
  cp_async_rows<kRegRows, HD>(dOs, head_rows<bf16, HD>(a.dout, (long long)L * D), D, i0, L);
  cp_async_commit();
  ring_start(issue, n_loads);
  cp_async_wait(kStreamStages - 1);
  if (kScaleQ) scale_rows<kRegRows, HD>(Qs, i0, L, a.scale);
  __syncthreads();
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_a_frags(qa, Qs, wr);
  load_a_frags(da, dOs, wr);

  const int r = i0 + wr + lane / 4;
  const int kv_warp = i0 + wr >= L ? 0 : a.causal ? min(i0 + wr + 16, L) : L;
  int vis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) vis[h] = r + 8 * h < L ? (a.causal ? r + 8 * h + 1 : L) : 0;

  // kScaleQ: m holds lse and p = exp(s - lse); else p = exp(s scale - m) / l.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (kScaleQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = r + 8 * h < L ? a.stats[stat_index(r + 8 * h, L)] : 0.f;
  } else {
    for (int t = 0; t < n; ++t) {
      ring_next(issue, t, n_loads);
      float s[8][4];
      tile_scores<false>(s, qa, ring_slot<HD>(ring, t), t * kTile, kv_warp, a.scale);
      fold_stats<true>(s, vis, t * kTile, m, l);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < L) reinterpret_cast<float2*>(a.stats)[stat_index(r + 8 * h, L)] = make_float2(m[h], l[h]);
    }
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // p and dp of the 16 keys key0.. (chunk c of a tile kt, v at kt + 64 rows).
  auto chunk = [&](float (&p)[2][4], float (&dp)[2][4], const bf16* kt, int c, int key0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[u][e] = dp[u][e] = 0.f;
    mma_nt(p, qa, kt, 16 * c);
    mma_nt(dp, da, kt + kTile * TS, 16 * c);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = 0.f;
        if (key0 + u * 8 + (lane % 4) * 2 + (e & 1) < vis[h]) {
          x = kScaleQ ? expf(p[u][e] - m[h]) : div_rn_by(expf(__fmul_rn(p[u][e], a.scale) - m[h]), l[h], rl[h]);
        }
        p[u][e] = x;
      }
  };

  float delta[2] = {0.f, 0.f};
  for (int t = 0; t < n; ++t) {
    const int u = n_stats + t;
    ring_next(issue, u, n_loads);
    const bf16* kt = ring_slot<HD>(ring, u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key0 = t * kTile + 16 * c;
      if (key0 >= kv_warp) continue;
      float p[2][4], dp[2][4];
      chunk(p, dp, kt, c, key0);
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] += p[v][e] * dp[v][e];
    }
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < L) a.delta[stat_index(r + 8 * h, L)] = delta[h];
  }

  float dq[HD / 8][4] = {};
  for (int t = 0; t < n; ++t) {
    const int u = n_stats + n + t;
    ring_next(issue, u, n_loads);
    const bf16* kt = ring_slot<HD>(ring, u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key0 = t * kTile + 16 * c;
      if (key0 >= kv_warp) continue;
      float p[2][4], dp[2][4];
      chunk(p, dp, kt, c, key0);
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pd = __fmul_rn(p[v][e], __fsub_rn(dp[v][e], delta[e >> 1]));
          dp[v][e] = kScaleQ ? pd : __fmul_rn(pd, a.scale);  // ds
        }
      uint32_t dsa[4];
      acc_to_a(dsa, dp[0], dp[1]);
      mma_rows_nn(dq, dsa, kt, 16 * c);  // dq += T(ds) k
    }
  }

  bf16* dQ = static_cast<bf16*>(a.dq) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r + 8 * h;
    if (i >= L) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      float v0 = dq[nt][2 * h], v1 = dq[nt][2 * h + 1];
      if (kScaleQ) {
        v0 = __fmul_rn(v0, a.scale);
        v1 = __fmul_rn(v1, a.scale);
      }
      *reinterpret_cast<bf162*>(dQ + (size_t)i * a.out_r + nt * 8 + (lane % 4) * 2) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Backward pass (b): one block per (64-key tile, head, item).  Each warp
// keeps its 16 keys' k and v fragments and dk, dv in registers; the query
// tiles that see those keys stream through the ring as [q; do] slots, and
// every row's statistics (lse or (m, l, 1/l), and delta) sit in shared
// memory, read once at the start.  Per 16 query rows: s^T = k q^T, dp^T =
// v do^T, p^T, ds^T, dv += T(p)^T do and dk += T(ds)^T q, as on the
// register route.
template <bool kScaleQ, int HD>
__global__ void __launch_bounds__(kRegThreads, HD == kHeadDim ? 3 : 2)
    attention_bwd_k_stream_kernel(const AttnArgs a) {
  constexpr int TS = HeadTile<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][TS]
  bf16* Vs = Ks + kRegRows * TS;                 // [64][TS]
  bf16* ring = Vs + kRegRows * TS;               // slots of [q, or T(q * scale); do]
  // Per query row: (lse, -, -, delta) with kScaleQ, else (m, l, 1 / l, delta).
  float4* row_st = reinterpret_cast<float4*>(ring + kStreamStages * StreamSlot<HD>::kElems);

  const int L = a.L, D = gridDim.y * HD, j0 = blockIdx.x * kRegRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wr = warp * 16;
  const bf16* Q = head_rows<bf16, HD>(a.q, a.in_b);
  const bf16* dO = head_rows<bf16, HD>(a.dout, (long long)L * D);
  const int first = a.causal ? (int)blockIdx.x : 0;  // the first query tile that sees these keys
  const int n = (L + kTile - 1) / kTile - first;     // query tiles
  auto issue = [&](int u) {
    bf16* slot = ring_slot<HD>(ring, u);
    const int i0 = (first + u) * kTile;
    cp_async_rows<kTile, HD>(slot, Q, a.in_r, i0, L);
    cp_async_rows<kTile, HD>(slot + kTile * TS, dO, D, i0, L);
  };

  cp_async_rows<kRegRows, HD>(Ks, head_rows<bf16, HD>(a.k, a.in_b), a.in_r, j0, L);
  cp_async_rows<kRegRows, HD>(Vs, head_rows<bf16, HD>(a.v, a.in_b), a.in_r, j0, L);
  cp_async_commit();
  ring_start(issue, n);
  for (int i = first * kTile + threadIdx.x; i < (first + n) * kTile; i += kRegThreads) {
    float m = 0.f, l = 1.f, d = 0.f;
    if (i < L) {
      if (kScaleQ) {
        m = a.stats[stat_index(i, L)];
      } else {
        const float2 ml = reinterpret_cast<const float2*>(a.stats)[stat_index(i, L)];
        m = ml.x;
        l = ml.y;
      }
      d = a.delta[stat_index(i, L)];
    }
    row_st[i] = make_float4(m, l, __frcp_rn(l), d);
  }
  cp_async_wait(kStreamStages - 1);
  __syncthreads();

  const int jw = j0 + wr;       // the warp's first key
  const int j = jw + lane / 4;  // keys j (accumulator rows lane/4) and j + 8
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a_frags(ka, Ks, wr);
  load_a_frags(va, Vs, wr);
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  for (int u = 0; u < n; ++u) {
    const int t = first + u;
    bf16* qt = ring_slot<HD>(ring, u);
    ring_next(issue, u, n, [&](int) {
      if (kScaleQ) scale_rows<kTile, HD>(qt, t * kTile, L, a.scale);  // the pieces this thread copied
    });
    if (jw >= L) continue;
    const bf16* dot = qt + kTile * TS;
#pragma unroll
    for (int qc = 0; qc < 4; ++qc) {
      const int ib = t * kTile + qc * 16;  // the chunk's first query row
      if (ib >= L || (a.causal && ib + 15 < jw)) continue;
      float st[2][4] = {}, dpt[2][4] = {};
      mma_nt(st, ka, qt, qc * 16);    // s^T = k q^T
      mma_nt(dpt, va, dot, qc * 16);  // dp^T = v do^T
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ib + v * 8 + (lane % 4) * 2 + (e & 1), jj = j + 8 * (e >> 1);
          float pv = 0.f, ds = 0.f;
          if (jj < L && i < L && (!a.causal || jj <= i)) {
            const float4 st_i = row_st[i];
            pv = kScaleQ ? expf(st[v][e] - st_i.x)
                         : div_rn_by(expf(__fmul_rn(st[v][e], a.scale) - st_i.x), st_i.y, st_i.z);
            const float pd = __fmul_rn(pv, __fsub_rn(dpt[v][e], st_i.w));
            ds = kScaleQ ? pd : __fmul_rn(pd, a.scale);
          }
          st[v][e] = pv;
          dpt[v][e] = ds;
        }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, st[0], st[1]);
      acc_to_a(dsa, dpt[0], dpt[1]);
      mma_rows_nn(dv, pa, dot, qc * 16);  // dv += T(p)^T do
      mma_rows_nn(dk, dsa, qt, qc * 16);  // dk += T(ds)^T q
    }
  }

  bf16* dK = static_cast<bf16*>(a.dk) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * HD;
  bf16* dV = static_cast<bf16*>(a.dv) + (size_t)blockIdx.z * a.out_b + (size_t)blockIdx.y * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int jj = j + 8 * h;
    if (jj >= L) continue;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const size_t off = (size_t)jj * a.out_r + nt * 8 + (lane % 4) * 2;
      *reinterpret_cast<bf162*>(dK + off) = __floats2bfloat162_rn(dk[nt][2 * h], dk[nt][2 * h + 1]);
      *reinterpret_cast<bf162*>(dV + off) = __floats2bfloat162_rn(dv[nt][2 * h], dv[nt][2 * h + 1]);
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

// Bytes of the register route's tiles: `rows` own rows and two [nt * 64]
// tiles of the other side.
inline size_t reg_smem(int rows, int nt) {
  return (size_t)(rows + 2 * nt * kTile) * TileLayout<bf16>::kStride * sizeof(bf16);
}

// One of a kernel template's four instantiations, by the number of 64-key
// tiles (1-4), launched over 64-row blocks of kRegThreads.
#define FLYP_REG_LAUNCH(nt, KERNEL, smem)                                                   \
  switch (nt) {                                                                            \
    case 1: return launch_attention_kernel(KERNEL(1), kRegRows, kRegThreads, smem, a, B, H, st); \
    case 2: return launch_attention_kernel(KERNEL(2), kRegRows, kRegThreads, smem, a, B, H, st); \
    case 3: return launch_attention_kernel(KERNEL(3), kRegRows, kRegThreads, smem, a, B, H, st); \
    case 4: return launch_attention_kernel(KERNEL(4), kRegRows, kRegThreads, smem, a, B, H, st); \
    default: return cudaErrorInvalidValue;                                                 \
  }

template <bool kScaleQ, bool kTrain>
cudaError_t attention_forward_regs(const AttnArgs& a, int B, int H, cudaStream_t st) {
  const int nt = (a.L + kTile - 1) / kTile;
#define FLYP_FWD(n) attention_fwd_kernel<kScaleQ, kTrain, n>
  FLYP_REG_LAUNCH(nt, FLYP_FWD, reg_smem(kRegRows, nt))
#undef FLYP_FWD
}

template <bool kScaleQ>
cudaError_t attention_bwd_q_regs(const AttnArgs& a, int B, int H, cudaStream_t st) {
  const int nt = (a.L + kTile - 1) / kTile;
#define FLYP_BWD_Q(n) attention_bwd_q_kernel<n, kScaleQ>
  FLYP_REG_LAUNCH(nt, FLYP_BWD_Q, reg_smem(2 * kRegRows, nt))
#undef FLYP_BWD_Q
}

template <bool kScaleQ>
cudaError_t attention_bwd_k_regs(const AttnArgs& a, int B, int H, cudaStream_t st) {
  const int nt = (a.L + kTile - 1) / kTile;
  const size_t smem = reg_smem(2 * kRegRows, nt) + 4 * (size_t)nt * kTile * sizeof(float);
#define FLYP_BWD_K(n) attention_bwd_k_kernel<n, kScaleQ>
  FLYP_REG_LAUNCH(nt, FLYP_BWD_K, smem)
#undef FLYP_BWD_K
}
#undef FLYP_REG_LAUNCH

// Bytes of the streamed route's shared memory at head width HD: `own`
// 64-row tiles and the ring.
template <int HD>
inline size_t stream_smem(int own) {
  return ((size_t)own * kRegRows * HeadTile<HD>::kStride + (size_t)kStreamStages * StreamSlot<HD>::kElems) *
         sizeof(bf16);
}

// Whether the streamed route takes rows of L keys at head width HD: any row
// past the register route's at kHeadDim, kWideHeadDim's rows up to
// kWideMaxKeys.
template <int HD>
inline bool stream_rows(int L) {
  return L > kRegKeys && (HD == kHeadDim || L <= kWideMaxKeys);
}

// The forward: a.o, and with kTrain lse into a.stats.  HD is kHeadDim on
// every route, or kWideHeadDim in bf16 on the streamed one.
template <typename T, bool kScaleQ, bool kTrain, int HD = kHeadDim>
cudaError_t attention_forward(const AttnArgs& a, int B, int H, cudaStream_t st) {
  static_assert(HD == kHeadDim || (HD == kWideHeadDim && sizeof(T) == 2), "kWideHeadDim runs bf16 rows only");
  if constexpr (sizeof(T) == 4) {
    const size_t smem = ((size_t)(kFmaQT + kTile) * kRow + (size_t)kFmaQT * a.s_stride) * sizeof(float);
    if (!fits_block(smem, kFmaQT)) return cudaErrorInvalidValue;
    return launch_attention_kernel(attention_fma_kernel<kScaleQ, kTrain>, kFmaQT, kFmaThreads, smem, a, B, H, st);
  } else {
    if constexpr (HD == kHeadDim) {
      if (a.L <= kRegKeys) return attention_forward_regs<kScaleQ, kTrain>(a, B, H, st);
    }
    if (!stream_rows<HD>(a.L)) return cudaErrorInvalidValue;
    return launch_attention_kernel(attention_fwd_stream_kernel<kScaleQ, kTrain, HD>, kRegRows, kRegThreads,
                                   stream_smem<HD>(1), a, B, H, st);
  }
}

// The backward, pass (a) then pass (b): a.dq, a.dk, a.dv; pass (a) also
// writes a.delta (and, unless kScaleQ, the (m, l) pairs into a.stats).  HD
// as in attention_forward.
template <typename T, bool kScaleQ, int HD = kHeadDim>
cudaError_t attention_backward(const AttnArgs& a, int B, int H, cudaStream_t st) {
  static_assert(HD == kHeadDim || (HD == kWideHeadDim && sizeof(T) == 2), "kWideHeadDim runs bf16 rows only");
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    if constexpr (HD == kHeadDim) {
      if (a.L <= kRegKeys) {
        err = attention_bwd_q_regs<kScaleQ>(a, B, H, st);
        if (err != cudaSuccess) return err;
        return attention_bwd_k_regs<kScaleQ>(a, B, H, st);
      }
    }
    if (!stream_rows<HD>(a.L)) return cudaErrorInvalidValue;
    err = launch_attention_kernel(attention_bwd_q_stream_kernel<kScaleQ, HD>, kRegRows, kRegThreads,
                                  stream_smem<HD>(2), a, B, H, st);
    if (err != cudaSuccess) return err;
    const size_t rows = (size_t)(a.L + kTile - 1) / kTile * kTile;  // pass (b)'s row statistics
    const size_t smem = stream_smem<HD>(2) + rows * sizeof(float4);
    if (!fits_block(smem, 0)) return cudaErrorInvalidValue;
    return launch_attention_kernel(attention_bwd_k_stream_kernel<kScaleQ, HD>, kRegRows, kRegThreads, smem, a, B,
                                   H, st);
  } else {
    constexpr int TS = TileLayout<float>::kStride;
    auto dq_smem = [&](int qt) {
      return (size_t)(2 * qt + kTile) * TS * sizeof(float) + 2 * (size_t)qt * a.s_stride * sizeof(float);
    };
    // The query tile: the largest of 64, 32, 16 rows whose footprint fits a
    // block.
    if (fits_block(dq_smem(64), 64)) {
      err = launch_attention_kernel(attention_bwd_dq_kernel<64, kScaleQ>, 64, 128, dq_smem(64), a, B, H, st);
    } else if (fits_block(dq_smem(32), 32)) {
      err = launch_attention_kernel(attention_bwd_dq_kernel<32, kScaleQ>, 32, 64, dq_smem(32), a, B, H, st);
    } else if (fits_block(dq_smem(16), 16)) {
      err = launch_attention_kernel(attention_bwd_dq_kernel<16, kScaleQ>, 16, 32, dq_smem(16), a, B, H, st);
    } else {
      return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    const size_t dkv_smem = 6 * (size_t)TileLayout<float>::kElems * sizeof(float) +
                            (4 * (size_t)kTile * kAccStride + 4 * kTile) * sizeof(float);
    return launch_attention_kernel(attention_bwd_dkv_kernel<kScaleQ>, kTile, kDkvThreads, dkv_smem, a, B, H, st);
  }
}

}  // namespace flyp
