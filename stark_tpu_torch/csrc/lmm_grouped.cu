// B4: grouped linear mixed model, Gaussian log-likelihood pass over
// group-sorted rows with Q random effects per group, for all chains.
//
// Replaces the TPU kernel stark_tpu/ops/hier_fused.py:
// _make_grouped_lmm_kernel (called through _grouped_lmm_call).  For C
// chains, mu = ic[c] + beta_c . x_n + sum_q z[q, n] u[c, group(n), q] and
// resid = y - mu, it returns the scale-free sums (sigma is applied by the
// caller):
//   ssr    (C,)        sum_n  resid^2
//   sresid (C,)        sum_n  resid            (the intercept gradient)
//   gbeta  (C, D)      sum_n  resid x_n
//   gu     (C, G, Q)   sum_{n in g}  resid z[q, n]
// with group(n) = first_gid[n / lane_tile] + gl[n], the reference's layout
// read as is.
//
// Bound on an H100 SXM at BASELINE config 3 (C=16, D=8, Q=2, N=100k,
// G=10k): it must read xT (3.2 MB), zT (0.8 MB), y and gl (0.4 MB each)
// and u (1.28 MB) and write gu (1.28 MB): 7.4 MB, 2.2 us at 3.35 TB/s;
// and it does about 2*C*N*(D+Q) FMAs = 64 MFLOP, 1 us at 67 TFLOP/s.  So
// it is bound by bytes, and at this size by its two launches.
//
// Design: the gaussian, random-effect variant of fused_pass.cuh (B1's
// pass).  u is gathered per row from (C, G, Q), which lives in L2; the
// per-(group, q) gradients are segment sums of resid * z over the sorted
// rows, written straight out for groups inside a block and through the
// head/tail partials for groups that straddle blocks.  The TPU kernel's
// per-tile u windows laid side by side (u_tiles), its chain padding to a
// sublane multiple of 8 and its VMEM guard (_check_chain_vmem) are
// artifacts of the TPU's VMEM and (8, 128) tiling and have no
// counterpart here.  No (C, N) array is ever written; no float atomics.
#include "fused_pass.cuh"

extern "C" int stark_lmm_grouped(
    const float* xT, const float* zT, const float* y, const int* gl,
    const int* first_gid, const float* beta, const float* u,
    const float* intercept, float* ssr, float* sresid, float* gbeta,
    float* gu, float* scratch, int C, int D, int Q, int N, int G,
    int lane_tile, int rows_per_block, int nblk, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.y = y;
  p.beta = beta;
  p.C = C;
  p.D = D;
  p.N = N;
  p.rows_per_block = rows_per_block;
  p.gl = gl;
  p.first_gid = first_gid;
  p.lane_tile = lane_tile;
  p.alpha = u;
  p.G = G;
  p.Q = Q;
  p.galpha = gu;
  p.zT = zT;
  p.ic = intercept;
  stark::carve_scratch(p, scratch, nblk);
  return stark::launch<true, stark::kGaussian, true>(
      p, nblk, ssr, gbeta, sresid, static_cast<cudaStream_t>(stream));
}
