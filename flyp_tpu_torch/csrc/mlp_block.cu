// Fused pre-LN MLP block forward, for Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/mlp_block.py::_fwd_kernel (launched by _fwd_call
// through pl.pallas_call; B4).  For x [M = B*L, D] in the compute type T
// (float or bfloat16), W1 [D, 4D], W2 [4D, D] in T and fp32 LN parameters and
// biases it computes, rounding where the TPU kernel rounds:
//
//   y     = T(LN(x) in fp32)
//   h_pre = T(y @ W1 + b1)                      fp32 accumulate, fp32 bias
//   h     = T(h_pre * sigmoid(1.702 h_pre))     fp32
//   out   = T(x + (h @ W2 + b2))                fp32 accumulate
//
// and writes out and h_pre (the backward's residual).  What bounds it on the
// H100: 16 M D^2 FLOPs against (6 M D + 8 D^2) elements moved, ~1000 FLOPs
// per byte at ViT-B/16 widths, so the tensor cores bound the ideal kernel
// (0.48 ms at B=256, L=197, D=768 in bf16).  The TPU kernel kept y and the
// 4x hidden activations in VMEM and wrote only out and h_pre; here W1 and
// W2 (4.7 MB in bf16) do not fit in a block's 227 KB, so the block is two
// launches of the one tiled GEMM (common.cuh) on the caller's stream:
//
//   1. h_pre: LN fused into the A-tile load (fp32 row statistics per block),
//      +b1 epilogue;
//   2. out: quick_gelu applied to h_pre in the A-tile load (the GEMM's GELU
//      prologue, so h never reaches device memory), +b2 +x epilogue.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, fp32 accumulate); fp32
// tiles FMA on the CUDA cores, since the tensor cores would round fp32
// operands to TF32.  wgmma/TMA pipelines are later work.

#include "common.cuh"

namespace {

using namespace flyp;

template <typename T>
cudaError_t run(const T* x, const float* ln_scale, const float* ln_bias, const T* w1, const float* b1, const T* w2,
                const float* b2, T* out, T* h_pre, int M, int D, int Hd, cudaStream_t st) {
  GemmArgs fc = gemm_args(x, w1, h_pre, M, Hd, D, D, Hd);
  fc.bias = b1;
  fc.ln_scale = ln_scale;
  fc.ln_bias = ln_bias;
  cudaError_t err = launch_gemm<T, false, false, kOpLN | kOpBias, T>(fc, 1, st);
  if (err != cudaSuccess) return err;
  GemmArgs proj = gemm_args(h_pre, w2, out, M, D, Hd, Hd, D);
  proj.bias = b2;
  proj.resid = x;
  return launch_gemm<T, false, false, kOpGelu | kOpBias | kOpResid | kOpResidLast, T>(proj, 1, st);
}

}  // namespace

extern "C" {

// x, out [M, D] and h_pre [M, Hd] in the compute type (dtype: 0 = float32,
// 1 = bfloat16); w1 [D, Hd] and w2 [Hd, D] in the compute type; ln_scale,
// ln_bias, b2 [D] and b1 [Hd] fp32.  D and Hd multiples of 128.  Returns a
// cudaError_t.
int flyp_mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* h_pre, int M, int D, int Hd, int dtype,
                       void* stream) {
  if (M < 1 || D % kBN != 0 || Hd % kBN != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  const float* bias1 = static_cast<const float*>(b1);
  const float* bias2 = static_cast<const float*>(b2);
  if (dtype == 0) {
    using T = float;
    return (int)run(static_cast<const T*>(x), g, beta, static_cast<const T*>(w1), bias1, static_cast<const T*>(w2),
                    bias2, static_cast<T*>(out), static_cast<T*>(h_pre), M, D, Hd, st);
  }
  if (dtype == 1) {
    using T = bf16;
    return (int)run(static_cast<const T*>(x), g, beta, static_cast<const T*>(w1), bias1, static_cast<const T*>(w2),
                    bias2, static_cast<T*>(out), static_cast<T*>(h_pre), M, D, Hd, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
