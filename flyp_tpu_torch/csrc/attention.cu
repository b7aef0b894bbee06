// Whole-row softmax attention, forward and backward, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same attention over two layouts:
//
//   * flyp_tpu/ops/fused_qkv_attention.py::_fwd_kernel and _bwd_kernel
//     (pl.pallas_call in _fwd_call and _bwd_call; B5): q, k and v sliced
//     from the fused [B, L, 3D] projection, dq|dk|dv written back fused;
//   * flyp_tpu/ops/flash_attention.py::_fwd_kernel and _bwd_kernel
//     (pl.pallas_call in _flat_call; B6): q, k, v [B, L, H, 64].
//
// Both entry points read q, k and v through a batch stride and a row stride
// (3D for B5, D for B6; head h at column h * 64) and write dq, dk, dv the
// same way, so neither layout is transposed in device memory; o and do are
// [B, L, H * 64].  They run the attention templates of attention.cuh (shared
// with the attention block's kernels) in the attention ops' rounding scheme:
//
//   s     = (q k^T) * scale, -1e30 on causal columns           fp32
//   p     = softmax(s) = exp(s - m) / l                         fp32
//   o     = T(T(p) v)
//   dv    = T(T(p)^T do),  dp = do v^T,  delta = rowsum(p dp)  fp32
//   ds    = T(p (dp - delta) * scale)
//   dq    = T(ds k),  dk = T(ds^T q)
//
// The backward recomputes p from q and k (the TPU op keeps only q, k and v):
// its query-tile pass hands each row's m, l and delta (fp32, [B, L, H]) to
// its key-tile pass, which recomputes ds^T; nothing of size L^2 reaches
// device memory.
//
// Which kernels run (attention.cuh): bf16 at L <= 256, the register route
// (attention_fwd_kernel; attention_bwd_q_kernel then attention_bwd_k_kernel:
// scores, probabilities and products in mma.sync registers, k/v or q/do
// tiles by cp.async); bf16 at 257-1024, the streamed route
// (attention_fwd_stream_kernel; attention_bwd_q_stream_kernel then
// attention_bwd_k_stream_kernel: the same registers, the opposite side
// streamed through a two-slot cp.async ring); fp32 at every L, the fp32
// route (attention_fma_kernel; attention_bwd_dq_kernel then
// attention_bwd_dkv_kernel, scores in shared memory).
//
// What bounds it on the H100: per (batch item, head) the forward does 4 L^2
// 64 FLOPs against 4 L 64 elements it must move (~L/2 FLOPs per byte in
// bf16, under the card's ~295 at CLIP's L <= 1024), so an ideal kernel is
// bound by memory: 0.092 ms forward and 0.162 ms backward at B=256, L=197,
// D=768 in bf16 (0.161 ms and 0.282 ms at ViT-L/14's B=256, L=257,
// D=1024).  The register and streamed routes are bound by issue instead
// (mma.sync, exp and the softmax's fragment arithmetic); their registers
// and shared memory per block are in attention.cuh's header, their times
// in PERF.md.

#include "attention.cuh"

namespace {

using namespace flyp;

constexpr int kMaxL = 1024;

bool shapes_ok(int B, int L, int H) { return B >= 1 && H >= 1 && L >= 1 && L <= kMaxL; }

}  // namespace

extern "C" {

// o [B, L, H * 64] = attention(q, k, v); q, k, v row j of head h of item b at
// + b * in_b + j * in_r + h * 64 (elements; rows 16-byte aligned).  dtype: 0
// = float32, 1 = bfloat16.  L <= 1024.  Returns a cudaError_t.
int flyp_attention_fwd(const void* q, const void* k, const void* v, void* o, long long in_b, int in_r, int B, int L,
                       int H, int causal, int dtype, void* stream) {
  if (!shapes_ok(B, L, H)) return (int)cudaErrorInvalidValue;
  AttnArgs a = attn_args(q, k, v, in_b, in_r, L, causal);
  a.o = o;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)attention_forward<float, false, false>(a, B, H, st);
  if (dtype == 1) return (int)attention_forward<bf16, false, false>(a, B, H, st);
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv (row j of head h of item b at + b * out_b + j * out_r + h * 64)
// from q, k, v (as the forward takes them) and do [B, L, H * 64].
// Workspaces, fp32, from the query-tile pass to the key-tile pass: stats
// [B, L, H, 2] (each row's softmax max m and sum l) and delta [B, L, H].
int flyp_attention_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                       void* stats, void* delta, long long in_b, int in_r, long long out_b, int out_r, int B,
                       int L, int H, int causal, int dtype, void* stream) {
  if (!shapes_ok(B, L, H)) return (int)cudaErrorInvalidValue;
  AttnArgs a = attn_args(q, k, v, in_b, in_r, L, causal);
  a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.delta = static_cast<float*>(delta);
  a.out_b = out_b; a.out_r = out_r;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)attention_backward<float, false>(a, B, H, st);
  if (dtype == 1) return (int)attention_backward<bf16, false>(a, B, H, st);
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
