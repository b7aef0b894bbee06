// Fused pre-LN attention sub-block, training backward, for Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/attention_block.py::_bwd_kernel (launched by
// _bwd_call through pl.pallas_call).  From the block's input x [B, L, D],
// the output cotangent g and the forward's saved attention output o, q, k,
// v [B, L, D] and lse [B, L, H] (compute type T = float or bfloat16; lse
// fp32) it computes dx (T), dWqkv [3, D, D], dbqkv [3, D], dscale [D],
// dbias [D], dWout [D, D] and dbout [D] (fp32), rounding where the TPU
// kernel rounds:
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
//   dWout = o^T g,  dbout = colsum(g)               fp32 over all B*L rows
//
// dWout and dbout read o and g as they are (a bf16 product is exact in
// fp32), as the JAX package's fp32 product of the same values.  What bounds
// it: ~16 B L D^2 FLOPs of projections (do, dWqkv, dY, dWout) and 10 B L^2 D
// of attention products against a few [B, L, D] reads and writes, so the
// tensor cores bound the ideal kernel, as in the forward.
//
// The TPU kernel walks the batch in order and carries dWqkv/dbqkv/dscale/
// dbias across its grid in VMEM.  Blocks on the H100 run in no order, so
// every sum over rows is deterministic instead: dWqkv and dWout are GEMMs
// whose contraction runs over all B*L rows (split in a fixed number of
// chunks, partials summed in a fixed order), and the column sums are
// per-block partials reduced by one more pass.  No atomics, so a run
// repeats bit for bit.  The launches, in order, on the caller's stream:
//
//   1. y = T(LN(x)) into scratch (common.cuh's ln_forward_kernel, the
//      forward's);
//   2. do = T(g @ Wout^T)                    (GEMM, B held transposed);
//   3. attention pass (a), per (query tile, head, item): p from lse and dp
//      over the tile's key range, delta = rowsum(p dp) (to a [B, L, H] fp32
//      scratch), ds, dq;
//   4. attention pass (b), per (key tile, head, item): p and dp recomputed
//      tile by tile, ds from the rows' delta, dv and dk accumulated over the
//      query tiles (both passes are the templates of attention.cuh, in the
//      attention block's rounding scheme: bf16 up to 256 keys in registers,
//      fp32 and longer rows in shared memory, up to kMaxL keys);
//   5. dbqkv: column partials of d_t, then their sum;
//   6. dWqkv: y^T d_t per tower, split over fixed row chunks, then the
//      partials' sum;
//   7. dY = sum_t d_t Wqkv[t]^T              (GEMM, 3 D-long segments);
//   8. LN backward per row with dscale/dbias partials per block, then their
//      sum;
//   9. dWout = o^T g: step 6's product over one tower, its own split of the
//      rows, the partials (in step 6's scratch, summed by then) summed in
//      order;
//  10. dbout: column partials of g (in step 5's scratch), then their sum.
//
// bf16 runs the four GEMMs (do, dWqkv, dY, dWout) on gemm_sm90.cuh (G3, G4
// over three towers and over one, and G5 there: TMA into a ring of
// shared-memory stages, wgmma on the tensor cores, fp32 accumulate); fp32
// runs them on common.cuh's FMA tiles on the CUDA cores, since the tensor
// cores would round fp32 operands to TF32.
//
// Head-group tensor parallelism runs the same launches on one shard of the
// heads (entry flyp_attention_block_bwd_shard; the JAX kernel's shard
// semantics): q, k, v are [B, L, Dv], Wqkv [3, D, Dv] and Wout [Dv, D] with
// Dv = 64 H_local, so o and do are [M, Dv], dWqkv [3, D, Dv], dbqkv [3, Dv]
// and dWout [Dv, D], and dY contracts over Dv; dbout, a sum of g alone, is
// whole on every shard.  dY, and so dscale, dbias and dx, are then the
// shard's part, linear in dY: with add_g = 0 the LN backward writes
// T(dx_ln) without + g, for the caller to sum over the shards and add g
// once.  Any whole number of heads runs: an odd one (Dv = 192, 320) ends
// G3's and G4's columns in 64-wide tiles (gemm_sm90.cuh) and dWout's rows in
// a part of a 128-row tile, and the fp32 FMA GEMM masks the columns of its
// last tile.
//
// Heads are 64 wide but for the whole block in bf16 over rows of 257-1,024
// keys, whose heads may be 80 wide (attention.cuh's kWideHeadDim, ViT-H/14:
// D = 1,280 in 16 heads); the GEMMs do not see the head width.  The
// LayerNorm backward holds a row's columns in registers, 32 a lane up to D
// = 1,024 and 40 up to D = 1,280 (kWideCols; rows past 1,024 columns only
// come with heads of 80).

#include "attention.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace flyp;

constexpr int kThreads = kRowThreads;  // LN and reduction blocks
constexpr int kMaxL = 1024;  // the longest rows this backward takes, its attention passes' limit

// Columns a lane of the LN backward holds: 32 up to D = 1,024, 40 up to D =
// 1,280 (ViT-H/14's vision tower).  The count is a template argument, so
// the rows up to 1,024 columns keep their code and their bits.
constexpr int kCols = 32, kWideCols = 40;
constexpr int kMaxD = 32 * kWideCols;  // the widest row the backward takes

// dx = T(rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) + g) with
// dxhat = dY * scale, for rows [blockIdx.x * rows, +rows); one warp per row,
// D <= 32 kMaxCols.
// kAddG = false leaves + g out (a head shard's part); a template argument,
// so the whole block's kernel holds no branch for it.
// The block's column sums of dY * xhat and dY go to partial[blockIdx.x] as
// [2, D] (dscale, dbias), summed over the block's warps in a fixed order.
template <typename T, bool kAddG, int kMaxCols>
__global__ void __launch_bounds__(kThreads)
ln_backward_kernel(const T* __restrict__ x, const T* __restrict__ gout, const float* __restrict__ dY,
                   const float* __restrict__ scale, T* __restrict__ dx, float* __restrict__ partial, int M, int D,
                   int rows) {
  __shared__ float red[2 * 32 * kMaxCols];
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
        dx[(size_t)m * D + k] = from_f<T>(kAddG ? __fadd_rn(v, to_f(gout[(size_t)m * D + k])) : v);
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

// ---------------------------------------------------------------------------

// The GEMMs: fp32 on common.cuh's FMA tiles, bf16 on gemm_sm90.cuh (G3,
// G4, G5).  The weight grads' row chunks are gemm_sm90.cuh's fixed split for
// both types.
// Dv: the head shard's width (Dv = D for the whole block).
cudaError_t grad_out_gemm(const float* g, const float* wout, float* dout, int M, int D, int Dv, cudaStream_t st) {
  return launch_gemm<false, true, kOpNone>(gemm_args(g, wout, dout, M, Dv, D, D, D), 1, st);
}
cudaError_t grad_out_gemm(const bf16* g, const bf16* wout, bf16* dout, int M, int D, int Dv, cudaStream_t st) {
  return sm90::grad_out(g, wout, dout, M, D, Dv, st);
}
// dw[t] = a^T b_t (fp32 [towers, Na, Nb]) over the M rows of a [M, Na] and
// b [towers, M, Nb].
cudaError_t weight_grad_gemm(const float* a, const float* b, float* partial, float* dw, int M, int Na, int Nb,
                             int towers, cudaStream_t st) {
  GemmArgs g = gemm_args(a, b, partial, Na, Nb, M, Na, Nb);
  g.b_z = (long long)M * Nb;
  g.k_chunk = sm90::weight_grad_chunk(M, Na, Nb, towers);
  g.splits = (M + g.k_chunk - 1) / g.k_chunk;
  const cudaError_t err = launch_gemm<true, false, kOpNone>(g, towers, st);
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, g.splits, (long long)towers * Na * Nb, dw, st);
}
cudaError_t weight_grad_gemm(const bf16* a, const bf16* b, float* partial, float* dw, int M, int Na, int Nb,
                             int towers, cudaStream_t st) {
  return sm90::weight_grad(a, b, partial, dw, M, Na, Nb, towers, st);
}
cudaError_t input_grad_gemm(const float* d, const float* wqkv, float* dY, int M, int D, int Dv, cudaStream_t st) {
  GemmArgs g = gemm_args(d, wqkv, dY, M, D, Dv, Dv, Dv);
  g.nseg = 3; g.a_seg = (long long)M * Dv; g.b_seg = (long long)D * Dv;
  return launch_gemm<false, true, kOpNone>(g, 1, st);
}
cudaError_t input_grad_gemm(const bf16* d, const bf16* wqkv, float* dY, int M, int D, int Dv, cudaStream_t st) {
  return sm90::input_grad(d, wqkv, dY, M, D, Dv, st);
}

template <typename T>
struct Bwd {
  // Scratch carved from one workspace, each piece 256-byte aligned.
  struct Scratch {
    T *y, *dout, *d;
    float *delta, *dY, *part_w, *part_b, *part_ln;
  };

  static int ln_rows() { return 64; }

  static size_t carve(Scratch* s, char* base, int B, int L, int D, int Dv, int H) {
    const size_t M = (size_t)B * L;
    // The weight grads' partials share one scratch, as do the column sums'.
    const size_t part_w = std::max((size_t)sm90::weight_grad_splits((int)M, D, Dv, 3) * 3,
                                   (size_t)sm90::weight_grad_splits((int)M, Dv, D, 1)) * D * Dv;
    const int c_rows = 256, c_chunks = (int)((M + c_rows - 1) / c_rows);
    const int ln_blocks = (int)((M + ln_rows() - 1) / ln_rows());
    size_t off = 0;
    auto take = [&](size_t bytes) {
      char* p = base == nullptr ? nullptr : base + off;
      off += (bytes + 255) / 256 * 256;
      return p;
    };
    char* y = take(M * D * sizeof(T));
    char* dout = take(M * Dv * sizeof(T));
    char* d = take(3 * M * Dv * sizeof(T));
    char* delta = take(M * H * sizeof(float));
    char* dY = take(M * D * sizeof(float));
    char* pw = take(part_w * sizeof(float));
    char* pb = take((size_t)c_chunks * std::max(3 * Dv, D) * sizeof(float));
    char* pln = take((size_t)ln_blocks * 2 * D * sizeof(float));
    if (s != nullptr) {
      s->y = reinterpret_cast<T*>(y);
      s->dout = reinterpret_cast<T*>(dout);
      s->d = reinterpret_cast<T*>(d);
      s->delta = reinterpret_cast<float*>(delta);
      s->dY = reinterpret_cast<float*>(dY);
      s->part_w = reinterpret_cast<float*>(pw);
      s->part_b = reinterpret_cast<float*>(pb);
      s->part_ln = reinterpret_cast<float*>(pln);
    }
    return off;
  }

  static cudaError_t run(const T* x, const T* gout, const T* o, const T* q, const T* k, const T* v,
                         const float* lse, const float* ln_scale, const float* ln_bias, const T* wqkv, const T* wout,
                         T* dx, float* dwqkv, float* dbqkv, float* dln, float* dwout, float* dbout, void* workspace,
                         int B, int L, int D, int Dv, int H, int causal, int add_g, cudaStream_t st) {
    Scratch s;
    carve(&s, static_cast<char*>(workspace), B, L, D, Dv, H);
    const int M = B * L;
    cudaError_t err;
#define FLYP_CHECK(expr)          \
  do {                            \
    err = (expr);                 \
    if (err != cudaSuccess) return err; \
  } while (0)

    // 1. y = T(LN(x)).
    FLYP_CHECK(ln_forward(x, ln_scale, ln_bias, s.y, M, D, st));

    // 2. do = T(g @ Wout^T).
    FLYP_CHECK(grad_out_gemm(gout, wout, s.dout, M, D, Dv, st));

    // 3, 4. Attention backward (attention.cuh), pass (a) then pass (b), at
    // the head width Dv / H.
    const int hd = Dv / H;
    AttnArgs a = attn_args(q, k, v, (long long)L * Dv, Dv, L, causal, hd);
    a.dout = s.dout;
    a.stats = const_cast<float*>(lse);  // read only, in the attention block's scheme
    a.delta = s.delta;
    a.dq = s.d; a.dk = s.d + (size_t)M * Dv; a.dv = s.d + 2 * (size_t)M * Dv;
    a.out_b = (long long)L * Dv; a.out_r = Dv;
    if constexpr (sizeof(T) == 2) {
      if (hd == kWideHeadDim) FLYP_CHECK((attention_backward<T, true, kWideHeadDim>(a, B, H, st)));
      else FLYP_CHECK((attention_backward<T, true>(a, B, H, st)));
    } else {
      FLYP_CHECK((attention_backward<T, true>(a, B, H, st)));
    }

    // 5. dbqkv[t] = colsum(d_t).
    const int c_rows = 256, c_chunks = (M + c_rows - 1) / c_rows;
    colsum_partial_kernel<T><<<dim3((Dv + kThreads - 1) / kThreads, c_chunks, 3), kThreads, 0, st>>>(
        s.d, s.part_b, M, Dv, c_rows);
    FLYP_CHECK(cudaGetLastError());
    FLYP_CHECK(reduce_partials(s.part_b, c_chunks, 3LL * Dv, dbqkv, st));

    // 6. dWqkv[t] = y^T d_t, split over rows, then the partials' sum.
    FLYP_CHECK(weight_grad_gemm(s.y, s.d, s.part_w, dwqkv, M, D, Dv, 3, st));

    // 7. dY = sum_t d_t Wqkv[t]^T.
    FLYP_CHECK(input_grad_gemm(s.d, wqkv, s.dY, M, D, Dv, st));

    // 8. LN backward, then dscale/dbias from the per-block partials.
    const int ln_blocks = (M + ln_rows() - 1) / ln_rows();
    if (D > 32 * kCols)  // heads of kWideHeadDim, the whole block: add_g
      ln_backward_kernel<T, true, kWideCols><<<ln_blocks, kThreads, 0, st>>>(x, gout, s.dY, ln_scale, dx, s.part_ln,
                                                                             M, D, ln_rows());
    else if (add_g)
      ln_backward_kernel<T, true, kCols><<<ln_blocks, kThreads, 0, st>>>(x, gout, s.dY, ln_scale, dx, s.part_ln, M,
                                                                         D, ln_rows());
    else
      ln_backward_kernel<T, false, kCols><<<ln_blocks, kThreads, 0, st>>>(x, gout, s.dY, ln_scale, dx, s.part_ln, M,
                                                                          D, ln_rows());
    FLYP_CHECK(cudaGetLastError());
    FLYP_CHECK(reduce_partials(s.part_ln, ln_blocks, 2LL * D, dln, st));

    // 9. dWout = o^T g over the rows, in part_w after dWqkv's sum.
    FLYP_CHECK(weight_grad_gemm(o, gout, s.part_w, dwout, M, Dv, D, 1, st));

    // 10. dbout = colsum(g), in part_b after dbqkv's sum.
    colsum_partial_kernel<T><<<dim3((D + kThreads - 1) / kThreads, c_chunks, 1), kThreads, 0, st>>>(
        gout, s.part_b, M, D, c_rows);
    FLYP_CHECK(cudaGetLastError());
    FLYP_CHECK(reduce_partials(s.part_b, c_chunks, D, dbout, st));
#undef FLYP_CHECK
    return cudaSuccess;
  }
};

// Heads of 64 for any row up to kMaxL keys and D up to 1,024 (a head shard
// too); heads of kWideHeadDim for the whole block in bf16 on the streamed
// route's rows (attention.cuh).  Rows past 1,024 columns only at
// kWideHeadDim, whose one width (ViT-H/14's 1,280) is the reason for them.
bool shapes_ok(int L, int D, int Dv, int H, int dtype) {
  if (H < 1 || D % kBN != 0 || Dv > D || L < 1 || L > kMaxL) return false;
  if (Dv == H * kHeadDim) return D <= 32 * kCols;
  return Dv == H * kWideHeadDim && Dv == D && D <= kMaxD && dtype == 1 && stream_rows<kWideHeadDim>(L);
}

template <typename T>
int run_bwd(const void* x, const void* gout, const void* o, const void* q, const void* k, const void* v,
            const void* lse, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* wout, void* dx,
            void* dwqkv, void* dbqkv, void* dln, void* dwout, void* dbout, void* workspace, int B, int L, int D,
            int Dv, int H, int causal, int add_g, void* stream) {
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto f32 = [](void* p) { return static_cast<float*>(p); };
  return (int)Bwd<T>::run(in(x), in(gout), in(o), in(q), in(k), in(v), static_cast<const float*>(lse),
                          static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), in(wqkv), in(wout),
                          static_cast<T*>(dx), f32(dwqkv), f32(dbqkv), f32(dln), f32(dwout), f32(dbout), workspace,
                          B, L, D, Dv, H, causal, add_g, static_cast<cudaStream_t>(stream));
}

long long workspace_bytes(int B, int L, int D, int Dv, int H, int dtype) {
  if (!shapes_ok(L, D, Dv, H, dtype)) return -1;
  if (dtype == 0) return (long long)Bwd<float>::carve(nullptr, nullptr, B, L, D, Dv, H);
  if (dtype == 1) return (long long)Bwd<bf16>::carve(nullptr, nullptr, B, L, D, Dv, H);
  return -1;
}

int launch_bwd(const void* x, const void* gout, const void* o, const void* q, const void* k, const void* v,
               const void* lse, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* wout,
               void* dx, void* dwqkv, void* dbqkv, void* dln, void* dwout, void* dbout, void* workspace, int B, int L,
               int D, int Dv, int H, int causal, int add_g, int dtype, void* stream) {
  // A head shard's part (add_g = 0) keeps heads of 64.
  if (!shapes_ok(L, D, Dv, H, dtype) || (!add_g && Dv != H * kHeadDim)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run_bwd<float>(x, gout, o, q, k, v, lse, ln_scale, ln_bias, wqkv, wout, dx, dwqkv, dbqkv, dln, dwout,
                          dbout, workspace, B, L, D, Dv, H, causal, add_g, stream);
  if (dtype == 1)
    return run_bwd<bf16>(x, gout, o, q, k, v, lse, ln_scale, ln_bias, wqkv, wout, dx, dwqkv, dbqkv, dln, dwout,
                         dbout, workspace, B, L, D, Dv, H, causal, add_g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of device workspace flyp_attention_block_bwd needs (dtype: 0 =
// float32, 1 = bfloat16), or -1 for shapes the kernels do not take.
long long flyp_attention_block_bwd_workspace(int B, int L, int D, int H, int dtype) {
  return workspace_bytes(B, L, D, D, H, dtype);
}

// The training backward.  x, gout, o, q, k, v, dx: [B, L, D] in the compute
// type; lse [B, L, H], ln_scale/ln_bias [D] fp32; wqkv [3, D, D] and wout
// [D, D] in the compute type.  Outputs dwqkv [3, D, D], dbqkv [3, D], dln
// [2, D] (dscale, dbias), dwout [D, D] and dbout [D] in fp32.  Returns a
// cudaError_t.
int flyp_attention_block_bwd(const void* x, const void* gout, const void* o, const void* q, const void* k,
                             const void* v, const void* lse, const void* ln_scale, const void* ln_bias,
                             const void* wqkv, const void* wout, void* dx, void* dwqkv, void* dbqkv, void* dln,
                             void* dwout, void* dbout, void* workspace, int B, int L, int D, int H, int causal,
                             int dtype, void* stream) {
  return launch_bwd(x, gout, o, q, k, v, lse, ln_scale, ln_bias, wqkv, wout, dx, dwqkv, dbqkv, dln, dwout, dbout,
                    workspace, B, L, D, D, H, causal, 1, dtype, stream);
}

// The workspace of flyp_attention_block_bwd_shard, or -1.
long long flyp_attention_block_bwd_shard_workspace(int B, int L, int D, int Dv, int H, int dtype) {
  return workspace_bytes(B, L, D, Dv, H, dtype);
}

// One head shard of the backward: o, q, k, v [B, L, Dv] with Dv = 64 H,
// wqkv [3, D, Dv], wout [Dv, D]; outputs dwqkv [3, D, Dv], dbqkv [3, Dv],
// dwout [Dv, D], the whole dbout [D] and the shard's part of dln [2, D] and
// of dx [B, L, D], which with add_g = 0 is T(dx_ln) without + gout.
int flyp_attention_block_bwd_shard(const void* x, const void* gout, const void* o, const void* q, const void* k,
                                   const void* v, const void* lse, const void* ln_scale, const void* ln_bias,
                                   const void* wqkv, const void* wout, void* dx, void* dwqkv, void* dbqkv, void* dln,
                                   void* dwout, void* dbout, void* workspace, int B, int L, int D, int Dv, int H,
                                   int causal, int add_g, int dtype, void* stream) {
  return launch_bwd(x, gout, o, q, k, v, lse, ln_scale, ln_bias, wqkv, wout, dx, dwqkv, dbqkv, dln, dwout, dbout,
                    workspace, B, L, D, Dv, H, causal, add_g, dtype, stream);
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
