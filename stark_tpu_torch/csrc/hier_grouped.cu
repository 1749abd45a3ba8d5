// B1: grouped hierarchical Bernoulli-logit log-likelihood, value and
// gradient in one pass over group-sorted rows, for all chains at once.
//
// Replaces the TPU kernel stark_tpu/ops/hier_fused.py:_make_grouped_kernel
// (called through _grouped_call).  For C chains it returns
//   val    (C,)    sum_n  y log s(l) + (1 - y) log s(-l)
//   gbeta  (C, D)  sum_n  (y - s(l)) x_n
//   galpha (C, G)  sum_{n in g} (y - s(l))
// with l = beta_c . x_n + alpha[c, group(n)] and group(n) =
// first_gid[n / lane_tile] + gl[n], the reference's layout read as is.
//
// Bound on an H100 SXM at the flagship shape (C=64, D=32, N=1M, G=1000):
// it must read xT (128 MB), y and gl (4 MB each): 136 MB, 40.6 us at
// 3.35 TB/s; and it must do 2*C*D*N FMAs (logits and gradient) = 8.2
// GFLOP, 122 us at the 67 TFLOP/s of the FP32 CUDA cores.  So it is
// bound by arithmetic, not memory.  The design (fused_pass.cuh) keeps the
// FMAs on the CUDA cores in float32 with shared-memory operands, stages X
// once per sub-tile for every chain, and never materialises a (C, N)
// array.  The TPU kernel's one-hot products (an MXU habit) are replaced
// by a gather of alpha and segment sums over the sorted rows; its
// 123-tile grid by ~256 row blocks; its XLA partial sums by a second
// deterministic pass.  Tensor cores (3xTF32) and async copies are left
// for later.
#include "fused_pass.cuh"

extern "C" int stark_hier_grouped(
    const float* xT, const float* y, const int* gl, const int* first_gid,
    const float* beta, const float* alpha, float* val, float* gbeta,
    float* galpha, float* scratch, int C, int D, int N, int G, int lane_tile,
    int rows_per_block, int nblk, void* stream) {
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
  p.alpha = alpha;
  p.G = G;
  p.galpha = galpha;
  stark::carve_scratch(p, scratch, nblk);
  return stark::launch<true, stark::kBernoulli, false>(
      p, nblk, val, gbeta, nullptr, static_cast<cudaStream_t>(stream));
}
