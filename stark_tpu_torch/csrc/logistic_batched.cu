// B2: chain-batched log-likelihood pass, value and beta gradient in one
// pass over X for all chains, with optional per-chain row offsets; links
// bernoulli_logit and gaussian.
//
// Replaces the TPU kernel stark_tpu/ops/logistic_fused.py:
// _make_batched_kernel (called through _batched_call).  For C chains,
// l = beta_c . x_n (+ offsets[c, n]):
//   bernoulli_logit (link 0)
//     val   (C,)    sum_n  y log s(l) + (1 - y) log s(-l)
//     gbeta (C, D)  sum_n  (y - s(l)) x_n
//     resid (C, N)  y - s(l)
//   gaussian (link 1), scale-free: sigma is applied by the caller
//     val   (C,)    sum_n  (y - l)^2          (the SSR)
//     gbeta (C, D)  sum_n  (y - l) x_n
//     resid (C, N)  y - l
// resid is written only with offsets: the offset path's own output, which
// the model chains through the gather that made the offsets.
//
// Bound on an H100 SXM at the offset-path flagship shape (C=32, D=32,
// N=1M, with offsets): it must read xT (128 MB), y (4 MB) and offsets
// (128 MB) and write resid (128 MB): 388 MB, 116 us at 3.35 TB/s, against
// 2*C*D*N FMAs = 4.1 GFLOP, 61 us at 67 TFLOP/s.  So it is bound by
// memory.  At the LMM offset path (C=16, D=8, N=100k, gaussian) it moves
// 16.4 MB: 4.9 us.  The design (fused_pass.cuh) reads each byte once: X
// staged once per sub-tile for all chains, offsets read and resid written
// in coalesced rows; the reductions are deterministic, without atomics.
#include "fused_pass.cuh"

extern "C" int stark_logistic_batched(
    const float* xT, const float* y, const float* offsets, const float* beta,
    float* val, float* gbeta, float* resid, float* scratch, int C, int D,
    int N, int rows_per_block, int nblk, int link, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.y = y;
  p.beta = beta;
  p.C = C;
  p.D = D;
  p.N = N;
  p.rows_per_block = rows_per_block;
  p.offsets = offsets;
  p.resid = resid;
  stark::carve_scratch(p, scratch, nblk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (link == stark::kGaussian)
    return stark::launch<false, stark::kGaussian, false>(p, nblk, val, gbeta, nullptr, s);
  if (link == stark::kBernoulli)
    return stark::launch<false, stark::kBernoulli, false>(p, nblk, val, gbeta, nullptr, s);
  return (int)cudaErrorInvalidValue;
}
