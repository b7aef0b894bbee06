// The per-head score-sum probe, for Hopper (sm_90a): T2.
//
// Replaces tools/mfu_levers.py::pallas_score_depth's kernel (pl.pallas_call
// :127).  For q, k [B, L, D] bf16 it computes, per item b,
//
//   o[b] = sum over heads h of q[b, :, h] k[b, :, h]^T        fp32 [L, L]
//
// with the heads taken hd features at a time (hd = 64, the attention
// kernels' head width; 128 and 256, heads merged).  Summing the heads'
// products into one fp32 accumulator, as the TPU kernel's single [Lp, Lp]
// buffer does, is the full D-deep contraction q[b] k[b]^T, so this is one
// product of gemm_sm90.cuh with a tower an item: A = q and B = k, both
// K-major, each advancing a z slice a tower; M = N = L, K = D; o stored from
// the accumulators in fp32 (the GEMM's kRagged launch), columns past L
// masked (L = 197 or 208 is not a multiple of 128), rows past L not stored,
// and an odd L's values stored one by one (its rows are only 4-byte
// aligned).  L up to 256 takes one
// 256-wide tile, so each q row tile is read once and k twice (the second
// time from L2: an item's two row tiles are neighbouring tiles).
//
// hd is the probe's question (does the depth of a contraction step change
// the time when the output traffic is the same?), and on Hopper it changes
// nothing in the schedule: wgmma steps k16 whatever hd is, the ring stages 64
// features at a time, and one accumulator runs across all heads.  So hd is
// checked (it must be 64, 128 or 256 and divide D) and the three depths run
// the same kernel; their times should agree within the run's noise.
//
// What bounds it on the H100: bytes (q and k read once, o written once in
// fp32: 0.0621 ms at B=256, L=208, D=768) over operations (0.0172 ms).  The
// fp32 output is 44 of the 208 MB moved; it is stored straight from the
// accumulators, each warp writing 32-byte row pieces (an even L).

#include "gemm_sm90.cuh"

extern "C" {

// q, k [B, L, D] bf16, o [B, L, L] fp32, all contiguous and 16-byte aligned;
// hd in {64, 128, 256}, D % hd == 0, B >= 1, L >= 1.  Returns a cudaError_t.
int flyp_score_depth(const void* q, const void* k, void* o, int B, int L, int D, int hd, void* stream) {
  if (B < 1 || L < 1 || (hd != 64 && hd != 128 && hd != 256) || D < hd || D % hd != 0) {
    return (int)cudaErrorInvalidValue;
  }
  flyp::sm90::Product p = flyp::sm90::product(q, k, o, L, L, D);
  p.towers = B;
  p.a_z = p.b_z = B;
  p.a_tower = p.b_tower = 1;
  return (int)flyp::sm90::launch<false, false, flyp::kOpNone, float, true>(p, static_cast<cudaStream_t>(stream));
}

const char* flyp_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
