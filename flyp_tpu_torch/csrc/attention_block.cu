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
// four launches back to back on the caller's stream:
//
//   1. y = T(LN(x)) into scratch, once per row (common.cuh's
//      ln_forward_kernel, shared with the backward);
//   2. the QKV GEMM with a bias epilogue, q/k/v written to scratch;
//   3. attention (attention.cuh, shared with the backward and the attention
//      ops, in the attention block's rounding scheme), one block per (query
//      tile, head, batch item): scores for the tile's full key range kept
//      whole (in registers for bf16 up to 256 keys, else in shared memory)
//      so the softmax is normalised before p is cast (the TPU kernel's
//      rounding point); the causal mask comes from indices and key chunks
//      past the diagonal are skipped; rows and keys past L are masked
//      (zero-filled), never read as garbage;
//   4. the out-projection GEMM with a +x +bout epilogue.
//
// bf16 runs both GEMMs on gemm_sm90.cuh (TMA into a ring of shared-memory
// stages, wgmma on the tensor cores, fp32 accumulate; G1 and G2 there);
// fp32 runs common.cuh's FMA tiles on the CUDA cores, since the tensor cores
// would round fp32 operands to TF32.  Keeping q/k/v/o on chip is later work.
//
// The training forward (kTrain) runs the same four launches and keeps what
// the backward needs: q/k/v and o go to caller-owned outputs instead of
// scratch, and the attention kernel writes lse = m + log(l) per (row, head)
// (relative to the scaled scores).  It also moves one rounding point, as
// _fwd_kernel does: the unnormalised e = exp(s - m) is cast for e @ v and
// the fp32 product is divided by l, o_h = T((T(e) @ v_h) / l).
//
// Head-group tensor parallelism runs the same launches on one shard of the
// heads (entry flyp_attention_block_fwd_shard; the JAX kernels' shard
// semantics, flyp_tpu/ops/attention_block.py::_partitioned): Wqkv is
// [3, D, Dv] and Wout [Dv, D] with Dv = 64 H_local, so the QKV GEMM has
// N = 3 towers of Dv columns, attention runs H_local heads over rows of
// Dv, and the out-projection contracts over K = Dv.  With `partial` the
// out-projection's epilogue drops the bias and the residual and writes the
// fp32 product, which the caller sums over the shards before adding x and
// bout once.  Any whole number of heads runs: an odd one (Dv = 192, 320)
// ends the QKV product's columns in 64-wide tiles (gemm_sm90.cuh), and the
// fp32 FMA GEMM masks the columns of its last tile.  D stays a multiple of
// 128.
//
// The head width is 64 (kHeadDim) but for one case: the whole block (no
// shard) in bf16 with heads of 80 (kWideHeadDim: ViT-H/14's D = 1,280 in 16
// heads) over rows of 257-1,024 keys, which attention.cuh's streamed route
// runs at that width (attention_fwd_stream_kernel<true, kTrain, 80>).  The
// projections do not see the head width.

#include "attention.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace flyp;

// q|k|v [3, M, Dv] = y @ Wqkv[t] + bqkv[t] (fp32): three towers.
GemmArgs qkv_args(const float* y, const float* wqkv, const float* bqkv, float* qkv, int M, int D, int Dv) {
  GemmArgs a = gemm_args(y, wqkv, qkv, M, Dv, D, D, Dv);
  a.b_z = (long long)D * Dv;
  a.bias = bqkv;
  return a;
}

// out = x + o @ Wout + bout (fp32); o [M, Dv], Wout [Dv, D].
GemmArgs out_args(const float* o, const float* wout, const float* bout, const float* x, float* out, int M, int D,
                  int Dv) {
  GemmArgs a = gemm_args(o, wout, out, M, D, Dv, Dv, D);
  a.bias = bout;
  a.resid = x;
  return a;
}

cudaError_t qkv_gemm(const float* y, const float* wqkv, const float* bqkv, float* qkv, int M, int D, int Dv,
                     cudaStream_t st) {
  return launch_gemm<false, false, kOpBias>(qkv_args(y, wqkv, bqkv, qkv, M, D, Dv), 3, st);
}
cudaError_t qkv_gemm(const bf16* y, const bf16* wqkv, const float* bqkv, bf16* qkv, int M, int D, int Dv,
                     cudaStream_t st) {
  return sm90::qkv(y, wqkv, bqkv, qkv, M, D, Dv, st);
}
cudaError_t out_gemm(const float* o, const float* wout, const float* bout, const float* x, float* out, int M, int D,
                     int Dv, cudaStream_t st) {
  return launch_gemm<false, false, kOpBias | kOpResid>(out_args(o, wout, bout, x, out, M, D, Dv), 1, st);
}
cudaError_t out_gemm(const bf16* o, const bf16* wout, const float* bout, const bf16* x, bf16* out, int M, int D,
                     int Dv, cudaStream_t st) {
  return sm90::out_proj(o, wout, bout, x, out, M, D, Dv, st);
}
// The partial out-projection of a head shard: fp32 o @ Wout, no epilogue.
cudaError_t out_gemm_partial(const float* o, const float* wout, float* out, int M, int D, int Dv, cudaStream_t st) {
  return launch_gemm<false, false, kOpNone>(gemm_args(o, wout, out, M, D, Dv, Dv, D), 1, st);
}
cudaError_t out_gemm_partial(const bf16* o, const bf16* wout, float* out, int M, int D, int Dv, cudaStream_t st) {
  return sm90::out_proj_partial(o, wout, out, M, D, Dv, st);
}

// lse == nullptr: the inference forward; otherwise the training forward.
// y: [B, L, D] scratch of the compute type; qkv [3, B, L, Dv], o [B, L, Dv].
// partial: out is fp32 [B, L, D], o @ Wout alone.  HD: the head width,
// Dv / H.
template <typename T, int HD = kHeadDim>
cudaError_t run(const T* x, const float* g, const float* beta, const T* wqkv, const float* bqkv, const T* wout,
                const float* bout, void* out, T* qkv, T* o, T* y, float* lse, int B, int L, int D, int Dv, int H,
                int causal, int partial, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err = ln_forward(x, g, beta, y, M, D, stream);
  if (err != cudaSuccess) return err;
  err = qkv_gemm(y, wqkv, bqkv, qkv, M, D, Dv, stream);
  if (err != cudaSuccess) return err;
  const size_t MDv = (size_t)M * Dv;
  AttnArgs a = attn_args(qkv, qkv + MDv, qkv + 2 * MDv, (long long)L * Dv, Dv, L, causal, HD);
  a.o = o;
  a.stats = lse;
  err = lse != nullptr ? attention_forward<T, true, true, HD>(a, B, H, stream)
                       : attention_forward<T, true, false, HD>(a, B, H, stream);
  if (err != cudaSuccess) return err;
  if (partial) return out_gemm_partial(o, wout, static_cast<float*>(out), M, D, Dv, stream);
  return out_gemm(o, wout, bout, x, static_cast<T*>(out), M, D, Dv, stream);
}

int launch(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv, const void* bqkv,
           const void* wout, const void* bout, void* out, void* qkv, void* o, void* y, float* lse, int B, int L,
           int D, int Dv, int H, int causal, int partial, int dtype, void* stream) {
  if (H < 1 || Dv % H != 0 || D % kBN != 0 || Dv > D) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  const float* bq = static_cast<const float*>(bqkv);
  const float* bo = static_cast<const float*>(bout);
  const int hd = Dv / H;
  if (hd == kWideHeadDim) {  // the whole block (no head shard) in bf16 on the streamed route
    if (dtype != 1 || Dv != D || partial || !stream_rows<kWideHeadDim>(L)) return (int)cudaErrorInvalidValue;
    using T = bf16;
    return (int)run<T, kWideHeadDim>(static_cast<const T*>(x), g, beta, static_cast<const T*>(wqkv), bq,
                                     static_cast<const T*>(wout), bo, out, static_cast<T*>(qkv), static_cast<T*>(o),
                                     static_cast<T*>(y), lse, B, L, D, Dv, H, causal, partial, s);
  }
  if (hd != kHeadDim) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    using T = float;
    return (int)run(static_cast<const T*>(x), g, beta, static_cast<const T*>(wqkv), bq, static_cast<const T*>(wout),
                    bo, out, static_cast<T*>(qkv), static_cast<T*>(o), static_cast<T*>(y), lse, B, L, D, Dv, H,
                    causal, partial, s);
  }
  if (dtype == 1) {
    using T = bf16;
    return (int)run(static_cast<const T*>(x), g, beta, static_cast<const T*>(wqkv), bq, static_cast<const T*>(wout),
                    bo, out, static_cast<T*>(qkv), static_cast<T*>(o), static_cast<T*>(y), lse, B, L, D, Dv, H,
                    causal, partial, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  qkv_scratch holds 3*B*L*D, o_scratch
// and y_scratch B*L*D elements of the compute type.  Returns a cudaError_t.
int flyp_attention_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                             const void* bqkv, const void* wout, const void* bout, void* out,
                             void* qkv_scratch, void* o_scratch, void* y_scratch, int B, int L, int D, int H,
                             int causal, int dtype, void* stream) {
  return launch(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, out, qkv_scratch, o_scratch, y_scratch, nullptr, B, L,
                D, D, H, causal, 0, dtype, stream);
}

// The training forward: as flyp_attention_block_fwd, and q|k|v ([3, B, L, D]
// in qkv), o ([B, L, D]) and lse ([B, L, H] fp32) are the caller's outputs.
int flyp_attention_block_fwd_train(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                                   const void* bqkv, const void* wout, const void* bout, void* out, void* qkv,
                                   void* o, void* y_scratch, void* lse, int B, int L, int D, int H, int causal,
                                   int dtype, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, out, qkv, o, y_scratch, static_cast<float*>(lse), B,
                L, D, D, H, causal, 0, dtype, stream);
}

// One head shard of either forward (lse == null: the inference forward):
// wqkv [3, D, Dv], bqkv [3, Dv], wout [Dv, D] with Dv = 64 H; qkv [3, B, L,
// Dv] and o [B, L, Dv].  partial = 1: out is fp32 [B, L, D], o @ Wout with
// neither bout nor x; else out = T(x + o @ Wout + bout) of the compute type.
int flyp_attention_block_fwd_shard(const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
                                   const void* bqkv, const void* wout, const void* bout, void* out, void* qkv,
                                   void* o, void* y_scratch, void* lse, int B, int L, int D, int Dv, int H,
                                   int causal, int partial, int dtype, void* stream) {
  return launch(x, ln_scale, ln_bias, wqkv, bqkv, wout, bout, out, qkv, o, y_scratch, static_cast<float*>(lse), B,
                L, D, Dv, H, causal, partial, dtype, stream);
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
