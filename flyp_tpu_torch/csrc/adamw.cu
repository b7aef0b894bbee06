// The fused AdamW update probe, for Hopper (sm_90a): T4.
//
// Replaces tools/mfu_levers.py::adamw_pallas's kernel (pl.pallas_call :264):
// one AdamW step over n parameters, reading p (fp32), m, v (fp32 or bf16)
// and g (bf16) and writing p, m, v, in place (the TPU probe donated them).
// Every operation is fp32 and rounds where the TPU kernel's body (:247-256)
// rounds, in its order, with no contraction into an FMA:
//
//   m' = m * b1 + (1 - b1) * g
//   v' = v * b2 + ((1 - b2) * g) * g
//   p' = p - lr * ((m' / (1 - b1^count)) / (sqrt(v' / (1 - b2^count)) + eps) + wd * p)
//
// and m', v' round to the moment type (bf16 round-to-nearest-even).  The
// constants arrive as fp32, computed in float64 and rounded once, as JAX
// rounds its weak-typed Python floats.
//
// What bounds it on the H100: bytes, 26 a parameter with fp32 moments and 18
// with bf16 (1.1556 / 0.8000 ms for the probe's 148,897,792 parameters at
// 3.35 TB/s).  One pass, each thread moving 8 parameters at a time in 16-byte
// loads and stores, in a grid-stride loop; the last n % 8 go one at a time.

#include "common.cuh"

namespace {

using namespace flyp;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // parameters a thread moves at a time

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, lr, eps, wd;
};

template <typename TM>
__device__ __forceinline__ void update(float& p, TM& m, TM& v, float g, const Consts& c) {
  const float m32 = __fadd_rn(__fmul_rn(to_f(m), c.b1), __fmul_rn(c.one_minus_b1, g));
  const float v32 = __fadd_rn(__fmul_rn(to_f(v), c.b2), __fmul_rn(__fmul_rn(c.one_minus_b2, g), g));
  const float mhat = __fdiv_rn(m32, c.bc1);
  const float vhat = __fdiv_rn(v32, c.bc2);
  const float step = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), c.eps)), __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(c.lr, step));
  m = from_f<TM>(m32);
  v = from_f<TM>(v32);
}

// kVec elements of T at p (16-byte aligned) to or from registers.
template <typename T>
__device__ __forceinline__ void load_vec(T (&r)[kVec], const T* p) {
#pragma unroll
  for (int i = 0; i < kVec * (int)sizeof(T) / 16; ++i) {
    *reinterpret_cast<uint4*>(&r[i * 16 / sizeof(T)]) = *reinterpret_cast<const uint4*>(p + i * 16 / sizeof(T));
  }
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&r)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec * (int)sizeof(T) / 16; ++i) {
    *reinterpret_cast<uint4*>(p + i * 16 / sizeof(T)) = *reinterpret_cast<const uint4*>(&r[i * 16 / sizeof(T)]);
  }
}

template <typename TM>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(float* __restrict__ p, TM* __restrict__ m, TM* __restrict__ v, const bf16* __restrict__ g,
                 long long n, const Consts c) {
  const long long groups = n / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < groups; i += stride) {
    const long long off = i * kVec;
    __align__(16) float pr[kVec];
    __align__(16) TM mr[kVec];
    __align__(16) TM vr[kVec];
    __align__(16) bf16 gr[kVec];
    load_vec(pr, p + off);
    load_vec(mr, m + off);
    load_vec(vr, v + off);
    load_vec(gr, g + off);
#pragma unroll
    for (int j = 0; j < kVec; ++j) update(pr[j], mr[j], vr[j], __bfloat162float(gr[j]), c);
    store_vec(p + off, pr);
    store_vec(m + off, mr);
    store_vec(v + off, vr);
  }
  if (blockIdx.x == 0) {
    for (long long i = groups * kVec + threadIdx.x; i < n; i += kThreads) {
      update(p[i], m[i], v[i], __bfloat162float(g[i]), c);
    }
  }
}

template <typename TM>
cudaError_t launch(float* p, TM* m, TM* v, const bf16* g, long long n, const Consts& c, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n / kVec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : want < 8LL * sms ? want : 8LL * sms);  // 8 blocks of 256 a SM
  adamw_kernel<TM><<<blocks, kThreads, 0, st>>>(p, m, v, g, n, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// In place over n parameters: p fp32; m, v of the moment type (mdtype: 0 =
// float32, 1 = bfloat16); g bf16; all 16-byte aligned.  The constants are
// fp32: b1, 1 - b1, b2, 1 - b2, 1 - b1^count, 1 - b2^count, lr, eps, wd.
// Returns a cudaError_t.
int flyp_adamw_update(void* p, void* m, void* v, const void* g, long long n, float b1, float one_minus_b1, float b2,
                      float one_minus_b2, float bc1, float bc2, float lr, float eps, float wd, int mdtype,
                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const Consts c{b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, lr, eps, wd};
  float* pp = static_cast<float*>(p);
  const bf16* gp = static_cast<const bf16*>(g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mdtype == 0) return (int)launch(pp, static_cast<float*>(m), static_cast<float*>(v), gp, n, c, st);
  if (mdtype == 1) return (int)launch(pp, static_cast<bf16*>(m), static_cast<bf16*>(v), gp, n, c, st);
  return (int)cudaErrorInvalidValue;
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
