// Fused pre-LN attention sub-block, inference and training forward, for
// Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/attention_block.py::_fwd_infer_kernel (launched by
// _fwd_infer_call through pl.pallas_call; entry flyp_attention_block_fwd)
// and _fwd_kernel (launched by _fwd_call; entry
// flyp_attention_block_fwd_train).  For x [B, L, D] in the compute type T
// (float or bfloat16) the inference forward computes
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
//   1. the QKV GEMM (common.cuh, shared with the backward) with LN fused
//      into its A-tile load (fp32 row stats computed per block) and a bias
//      epilogue, q/k/v written to scratch;
//   2. attention, one block per (query tile, head, batch item): scores for
//      the tile's full key range kept in shared memory so the softmax is
//      normalised before p is cast (the TPU kernel's rounding point); the
//      causal mask comes from indices and key tiles past the diagonal are
//      skipped; rows and keys past L are masked, never read as garbage;
//   3. the out-projection GEMM (common.cuh) with a +x +bout epilogue.
//
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, fp32
// accumulate); fp32 tiles FMA on the CUDA cores, since the tensor cores
// would round fp32 operands to TF32.  wgmma/TMA pipelines and keeping
// q/k/v/o on chip are later work.
//
// The training forward (kTrain) runs the same three kernels and keeps what
// the backward needs: q/k/v and o go to caller-owned outputs instead of
// scratch, and the attention kernel writes lse = m + log(l) per (row, head)
// (relative to the scaled scores).  It also moves one rounding point, as
// _fwd_kernel does: the unnormalised e = exp(s - m) is cast for e @ v and
// the fp32 product is divided by l, o_h = T((T(e) @ v_h) / l).

#include "common.cuh"

namespace {

using namespace flyp;

// ---------------------------------------------------------------------------
// fp32 attention: FMA tiles on the CUDA cores.

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

// lse [B, L, H] index of row i of the block's (head, batch item).
__device__ __forceinline__ size_t lse_index(int i, int L) {
  return ((size_t)blockIdx.z * L + i) * gridDim.y + blockIdx.y;
}

// fp32 attention over q/k/v [3, B*L, D] (heads head-major along D).  One
// block per (query tile, head, batch item); the tile's scores over every key
// it may see stay in shared memory ([kFmaQT, s_cols] fp32).  kTrain: the
// training forward's rounding (see the header) and lse written.
template <bool kTrain>
__global__ void __launch_bounds__(kAttnThreads)
attention_fma_kernel(const float* __restrict__ qkv, float* __restrict__ O, float* __restrict__ lse, int L, int D,
                     float scale, int causal, int s_cols) {
  extern __shared__ float smem[];
  __shared__ float row_l[kFmaQT];
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
    if (kTrain) {
      for (int j = lane; j < cols; j += 32) row[j] = j < visible ? expf(row[j] - m) : 0.f;
      if (lane == 0) {
        row_l[r] = l;
        if (i < L) lse[lse_index(i, L)] = m + logf(l);
      }
    } else {
      for (int j = lane; j < cols; j += 32) row[j] = j < visible ? __fdiv_rn(expf(row[j] - m), l) : 0.f;
    }
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
    for (int j = 0; j < 4; ++j) {
      O[base + (size_t)row * D + tx + 16 * j] = kTrain ? __fdiv_rn(acc[i][j], row_l[ty + 8 * i]) : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 attention: mma.sync.m16n8k16 on the tensor cores, fp32 accumulate.

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
// the tensor cores again.  kTrain: e = exp(s - m) is cast unnormalised, o
// divided by l in fp32, and lse written.
template <bool kTrain>
__global__ void __launch_bounds__(kAttnThreads)
attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ O, float* __restrict__ lse, int L, int D,
                     float scale, int causal, int s_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float row_l[kMmaQT];
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
    if (kTrain && lane == 0) {
      row_l[r] = l;
      if (i < L) lse[lse_index(i, L)] = m + logf(l);
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
      float v0 = o[nt][2 * half], v1 = o[nt][2 * half + 1];
      if (kTrain) {
        const float l = row_l[wr + lane / 4 + half * 8];
        v0 = __fdiv_rn(v0, l);
        v1 = __fdiv_rn(v1, l);
      }
      *reinterpret_cast<bf162*>(O + base + (size_t)i * D + d) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------

// q|k|v [3, M, D] = T(LN(x)) @ Wqkv[t] + bqkv[t]: three towers, LN prologue.
GemmArgs qkv_args(const void* x, const float* g, const float* beta, const void* wqkv, const float* bqkv, void* qkv,
                  int M, int D) {
  GemmArgs a = gemm_args(x, wqkv, qkv, M, D, D, D, D);
  a.b_z = (long long)D * D;
  a.bias = bqkv;
  a.ln_scale = g;
  a.ln_bias = beta;
  return a;
}

// out = T(x + o @ Wout + bout).
GemmArgs out_args(const void* o, const void* wout, const float* bout, const void* x, void* out, int M, int D) {
  GemmArgs a = gemm_args(o, wout, out, M, D, D, D, D);
  a.bias = bout;
  a.resid = x;
  return a;
}

// lse == nullptr: the inference forward; otherwise the training forward.
cudaError_t launch_fp32(const float* x, const float* g, const float* beta, const float* wqkv, const float* bqkv,
                        const float* wout, const float* bout, float* out, float* qkv, float* o, float* lse, int B,
                        int L, int D, int H, int causal, cudaStream_t stream) {
  cudaError_t err = launch_gemm<float, false, false, kOpLN | kOpBias, float>(qkv_args(x, g, beta, wqkv, bqkv, qkv, B * L, D), 3,
                                                                   stream);
  if (err != cudaSuccess) return err;
  const int s_cols = ((L + kFmaKT - 1) / kFmaKT) * kFmaKT;
  const size_t smem = (size_t)(kFmaQT * kRow + kFmaKT * kRow + kFmaQT * s_cols) * sizeof(float);
  auto* attn = lse != nullptr ? attention_fma_kernel<true> : attention_fma_kernel<false>;
  err = cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn<<<dim3((L + kFmaQT - 1) / kFmaQT, H, B), kAttnThreads, smem, stream>>>(
      qkv, o, lse, L, D, 1.0f / sqrtf((float)kHeadDim), causal, s_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<float, false, false, kOpBias | kOpResid, float>(out_args(o, wout, bout, x, out, B * L, D), 1, stream);
}

cudaError_t launch_bf16(const bf16* x, const float* g, const float* beta, const bf16* wqkv, const float* bqkv,
                        const bf16* wout, const float* bout, bf16* out, bf16* qkv, bf16* o, float* lse, int B, int L,
                        int D, int H, int causal, cudaStream_t stream) {
  cudaError_t err = launch_gemm<bf16, false, false, kOpLN | kOpBias, bf16>(qkv_args(x, g, beta, wqkv, bqkv, qkv, B * L, D), 3,
                                                                 stream);
  if (err != cudaSuccess) return err;
  // Score rows padded by 4 floats: 16-byte shifted rows keep ldmatrix on p
  // free of bank conflicts.
  const int s_stride = ((L + kMmaKT - 1) / kMmaKT) * kMmaKT + 4;
  const size_t smem = (size_t)(kMmaQT + kMmaKT) * kHStride * sizeof(bf16) + (size_t)kMmaQT * s_stride * sizeof(float);
  auto* attn = lse != nullptr ? attention_mma_kernel<true> : attention_mma_kernel<false>;
  err = cudaFuncSetAttribute(attn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn<<<dim3((L + kMmaQT - 1) / kMmaQT, H, B), kAttnThreads, smem, stream>>>(
      qkv, o, lse, L, D, 1.0f / sqrtf((float)kHeadDim), causal, s_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<bf16, false, false, kOpBias | kOpResid, bf16>(out_args(o, wout, bout, x, out, B * L, D), 1, stream);
}

int launch(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
           const void* wout, const void* bout, void* out, void* qkv, void* o, float* lse, int B, int L, int D, int H,
           int causal, int dtype, void* stream) {
  if (D != H * kHeadDim || D % kBN != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  const float* bq = static_cast<const float*>(bqkv);
  const float* bo = static_cast<const float*>(bout);
  if (dtype == 0) {
    return (int)launch_fp32(static_cast<const float*>(x), g, beta, static_cast<const float*>(wqkv), bq,
                            static_cast<const float*>(wout), bo, static_cast<float*>(out), static_cast<float*>(qkv),
                            static_cast<float*>(o), lse, B, L, D, H, causal, s);
  }
  if (dtype == 1) {
    return (int)launch_bf16(static_cast<const bf16*>(x), g, beta, static_cast<const bf16*>(wqkv), bq,
                            static_cast<const bf16*>(wout), bo, static_cast<bf16*>(out), static_cast<bf16*>(qkv),
                            static_cast<bf16*>(o), lse, B, L, D, H, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  qkv_scratch holds 3*B*L*D and
// o_scratch B*L*D elements of the compute type.  Returns a cudaError_t.
int flyp_attention_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                             const void* bqkv, const void* wout, const void* bout, void* out,
                             void* qkv_scratch, void* o_scratch, int B, int L, int D, int H, int causal,
                             int dtype, void* stream) {
  return launch(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, out, qkv_scratch, o_scratch, nullptr, B, L, D, H,
                causal, dtype, stream);
}

// The training forward: as flyp_attention_block_fwd, and q|k|v ([3, B, L, D]
// in qkv), o ([B, L, D]) and lse ([B, L, H] fp32) are the caller's outputs.
int flyp_attention_block_fwd_train(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                                   const void* bqkv, const void* wout, const void* bout, void* out, void* qkv,
                                   void* o, void* lse, int B, int L, int D, int H, int causal, int dtype,
                                   void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, out, qkv, o, static_cast<float*>(lse), B, L, D, H,
                causal, dtype, stream);
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
