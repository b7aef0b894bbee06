// The five bf16 products of gemm_sm90.cuh (G1-G5), each on its own, for
// Hopper (sm_90a).  The attention block's kernels (attention_block.cu,
// attention_block_bwd.cu) launch the same products inside B1, B3 and B2; these
// entries let flyp_tpu_torch/ops/gemm_sm90.py hold each product against its
// plain version and time it beside torch.mm at the main path's shapes.
//
// Shapes: M >= 1 rows, D a multiple of 128 and Dv (the head shard's width,
// Dv = D for the whole block) a multiple of 64 up to D; bf16 operands,
// 16-byte aligned and contiguous.  Each entry returns a cudaError_t
// (cudaErrorInvalidValue for a shape the kernel cannot tile).

#include "gemm_sm90.cuh"

namespace {

using namespace flyp;

bool shape_ok(int M, int D, int Dv) {
  return M >= 1 && D >= 128 && D % 128 == 0 && Dv >= 64 && Dv % 64 == 0 && Dv <= D;
}

const bf16* in(const void* p) { return static_cast<const bf16*>(p); }

}  // namespace

extern "C" {

// G1: qkv [3, M, Dv] = T(y @ wqkv[t] + bqkv[t]); y [M, D], wqkv [3, D, Dv],
// bqkv [3, Dv] fp32.
int flyp_gemm_qkv(const void* y, const void* wqkv, const void* bqkv, void* qkv, int M, int D, int Dv,
                  void* stream) {
  if (!shape_ok(M, D, Dv)) return (int)cudaErrorInvalidValue;
  return (int)sm90::qkv(in(y), in(wqkv), static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M, D, Dv,
                        static_cast<cudaStream_t>(stream));
}

// G2: out [M, D] = T(x + o @ wout + bout); o [M, Dv], wout [Dv, D], bout [D] fp32.
int flyp_gemm_out(const void* o, const void* wout, const void* bout, const void* x, void* out, int M, int D,
                  int Dv, void* stream) {
  if (!shape_ok(M, D, Dv)) return (int)cudaErrorInvalidValue;
  return (int)sm90::out_proj(in(o), in(wout), static_cast<const float*>(bout), in(x), static_cast<bf16*>(out), M, D,
                             Dv, static_cast<cudaStream_t>(stream));
}

// G3: dout [M, Dv] = T(g @ wout^T); g [M, D], wout [Dv, D].
int flyp_gemm_grad_out(const void* g, const void* wout, void* dout, int M, int D, int Dv, void* stream) {
  if (!shape_ok(M, D, Dv)) return (int)cudaErrorInvalidValue;
  return (int)sm90::grad_out(in(g), in(wout), static_cast<bf16*>(dout), M, D, Dv,
                             static_cast<cudaStream_t>(stream));
}

// Bytes of fp32 partials G4 needs at (M, D, Dv).
long long flyp_gemm_weight_grad_workspace(int M, int D, int Dv) {
  if (!shape_ok(M, D, Dv)) return -1;
  return (long long)sm90::weight_grad_splits(M, D, Dv, 3) * 3 * D * Dv * (long long)sizeof(float);
}

// G4: dw [3, D, Dv] fp32 = y^T d[t]; y [M, D], d [3, M, Dv].
int flyp_gemm_weight_grad(const void* y, const void* d, void* workspace, void* dw, int M, int D, int Dv,
                          void* stream) {
  if (!shape_ok(M, D, Dv)) return (int)cudaErrorInvalidValue;
  return (int)sm90::weight_grad(in(y), in(d), static_cast<float*>(workspace), static_cast<float*>(dw), M, D, Dv,
                                3, static_cast<cudaStream_t>(stream));
}

// G5: dY [M, D] fp32 = sum_t d[t] @ wqkv[t]^T; d [3, M, Dv], wqkv [3, D, Dv].
int flyp_gemm_input_grad(const void* d, const void* wqkv, void* dY, int M, int D, int Dv, void* stream) {
  if (!shape_ok(M, D, Dv)) return (int)cudaErrorInvalidValue;
  return (int)sm90::input_grad(in(d), in(wqkv), static_cast<float*>(dY), M, D, Dv,
                               static_cast<cudaStream_t>(stream));
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
