// Fused pre-LN MLP block forward, for Hopper (sm_90a).
//
// Replaces flyp_tpu/ops/mlp_block.py::_fwd_kernel (launched by _fwd_call
// through pl.pallas_call; B4).  For x [M = B*L, D] in the compute type T
// (float or bfloat16), W1 [D, 4D], W2 [4D, D] in T and fp32 LN parameters and
// biases it computes, rounding where the TPU kernel rounds:
//
//   y     = T(LN(x) in fp32)
//   h_pre = T(y @ W1 + b1)                      fp32 accumulate, fp32 bias
//   h     = T(h_pre * sigmoid(1.702 h_pre))     fp32, of the rounded h_pre
//   out   = T(x + (h @ W2 + b2))                fp32 accumulate, bias first
//
// and writes out and h_pre (the backward's residual).  What bounds it on the
// H100: 16 M D^2 FLOPs against (6 M D + 8 D^2) elements moved, ~1000 FLOPs
// per byte at ViT-B/16 widths, so the tensor cores bound the ideal kernel
// (0.48 ms at B=256, L=197, D=768 in bf16).  The TPU kernel kept y and the
// 4x hidden activations in VMEM and wrote only out and h_pre; here W1 and
// W2 (4.7 MB in bf16) do not fit in a block's 227 KB, so bf16 runs four
// launches on the caller's stream:
//
//   1. y = T(LN(x)) into scratch, once per row (common.cuh's
//      ln_forward_kernel, the rounding of B1-B3's);
//   2. fc on gemm_sm90.cuh (TMA + wgmma, persistent), +b1: h_pre;
//   3. h = T(quick_gelu(h_pre)) into scratch, from the rounded h_pre, by a
//      pass at full occupancy (gelu_kernel; h is a transient: the backward
//      recomputes it from h_pre, as the JAX package does);
//   4. proj on gemm_sm90.cuh over h, +b2 then +x (the residual's tile read
//      by TMA).
//
// The GELU stands alone because in fc's epilogue its fp32 exp and division
// ran on the two consumer warpgroups alone, latency-bound and under no
// product: fc took 1.10 ms there against 0.37 + 0.22 for fc and the pass at
// the vision shape (NVIDIA H100 80GB HBM3, 700 W).  y, h_pre read back, and
// h (M x (D + 8D) bf16) go through device memory where the TPU kept them on
// chip.  fp32 runs two launches of common.cuh's FMA GEMM on the CUDA cores
// (the tensor cores would round fp32 operands to TF32), with LN and the
// GELU applied in its operand prologues, so it needs no scratch.

#include "gemm_sm90.cuh"

namespace {

using namespace flyp;

// h = T(quick_gelu(h_pre)) over n bf16 (n a multiple of 8), 8 a thread a
// step, 16-byte aligned.
__global__ void __launch_bounds__(kRowThreads) gelu_kernel(const bf16* __restrict__ h_pre, bf16* __restrict__ h,
                                                           long long n8) {
  for (long long i = blockIdx.x * (long long)kRowThreads + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kRowThreads) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(h_pre) + i);
    bf162* v = reinterpret_cast<bf162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(v[k]);
      v[k] = __floats2bfloat162_rn(quick_gelu(f.x), quick_gelu(f.y));
    }
    reinterpret_cast<uint4*>(h)[i] = u;
  }
}

cudaError_t gelu(const bf16* h_pre, bf16* h, long long n, cudaStream_t st) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n8 = n / 8, want = (n8 + kRowThreads - 1) / kRowThreads;
  gelu_kernel<<<(int)(want < 32LL * sms ? want : 32LL * sms), kRowThreads, 0, st>>>(h_pre, h, n8);
  return cudaGetLastError();
}

cudaError_t run(const float* x, const float* ln_scale, const float* ln_bias, const float* w1, const float* b1,
                const float* w2, const float* b2, float* out, float* h_pre, float*, float*, int M, int D, int Hd,
                cudaStream_t st) {
  GemmArgs fc = gemm_args(x, w1, h_pre, M, Hd, D, D, Hd);
  fc.bias = b1;
  fc.ln_scale = ln_scale;
  fc.ln_bias = ln_bias;
  cudaError_t err = launch_gemm<false, false, kOpLN | kOpBias>(fc, 1, st);
  if (err != cudaSuccess) return err;
  GemmArgs proj = gemm_args(h_pre, w2, out, M, D, Hd, Hd, D);
  proj.bias = b2;
  proj.resid = x;
  return launch_gemm<false, false, kOpGelu | kOpBias | kOpResid | kOpResidLast>(proj, 1, st);
}

cudaError_t run(const bf16* x, const float* ln_scale, const float* ln_bias, const bf16* w1, const float* b1,
                const bf16* w2, const float* b2, bf16* out, bf16* h_pre, bf16* y, bf16* h, int M, int D, int Hd,
                cudaStream_t st) {
  if (y == nullptr || h == nullptr || !sm90::aligned16(h_pre) || !sm90::aligned16(h)) return cudaErrorInvalidValue;
  cudaError_t err = ln_forward(x, ln_scale, ln_bias, y, M, D, st);
  if (err != cudaSuccess) return err;
  err = sm90::mlp_fc(y, w1, b1, h_pre, M, D, Hd, st);
  if (err != cudaSuccess) return err;
  err = gelu(h_pre, h, (long long)M * Hd, st);
  if (err != cudaSuccess) return err;
  return sm90::mlp_proj(h, w2, b2, x, out, M, D, Hd, st);
}

template <typename T>
int launch(const void* x, const float* g, const float* beta, const void* w1, const float* b1, const void* w2,
           const float* b2, void* out, void* h_pre, void* y, void* h, int M, int D, int Hd, cudaStream_t st) {
  return (int)run(static_cast<const T*>(x), g, beta, static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
                  static_cast<T*>(out), static_cast<T*>(h_pre), static_cast<T*>(y), static_cast<T*>(h), M, D, Hd,
                  st);
}

}  // namespace

extern "C" {

// x, out [M, D] and h_pre [M, Hd] in the compute type (dtype: 0 = float32,
// 1 = bfloat16); w1 [D, Hd] and w2 [Hd, D] in the compute type; ln_scale,
// ln_bias, b2 [D] and b1 [Hd] fp32.  bf16 also takes scratch y [M, D] and h
// [M, Hd] (h holds T(quick_gelu(h_pre)) after the call); fp32 ignores them.
// D and Hd multiples of 128, bf16 tensors 16-byte aligned.  Returns a
// cudaError_t.
int flyp_mlp_block_fwd(const void* x, const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, void* h_pre, void* y, void* h, int M, int D, int Hd,
                       int dtype, void* stream) {
  if (M < 1 || D % kBN != 0 || Hd % kBN != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_scale);
  const float* beta = static_cast<const float*>(ln_bias);
  const float* bias1 = static_cast<const float*>(b1);
  const float* bias2 = static_cast<const float*>(b2);
  if (dtype == 0) return launch<float>(x, g, beta, w1, bias1, w2, bias2, out, h_pre, y, h, M, D, Hd, st);
  if (dtype == 1) return launch<bf16>(x, g, beta, w1, bias1, w2, bias2, out, h_pre, y, h, M, D, Hd, st);
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
