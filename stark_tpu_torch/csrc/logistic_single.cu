// B3: single-chain log-likelihood pass, value and beta gradient in one
// pass over X, with an optional (N,) row offset; links bernoulli_logit
// and gaussian.
//
// Replaces the TPU kernel stark_tpu/ops/logistic_fused.py:_make_kernel
// (called through _fused_call).  With l = beta . x_n (+ offsets[n]):
//   val   ()     sum_n  link value term   (bernoulli: the log-lik; gaussian: the SSR)
//   gbeta (D,)   sum_n  resid x_n
//   resid (N,)   the per-row residual, only with offsets
// (see fused_pass.cuh for the link terms; the gaussian pass is scale-free).
//
// Bound on an H100 SXM at the flagship's xT (D=32, N=1M, no offsets): it
// must read xT (128 MB) and y (4 MB): 132 MB, 39 us at 3.35 TB/s, against
// 2*D*N FMAs = 64 MFLOP, 1 us at 67 TFLOP/s.  So it is bound by bytes.
//
// Design.  A matrix-vector product has no chain axis to share X across,
// so B2's shared-memory staging buys nothing here.  Each thread owns one
// row of a 256-row sub-tile and reads its x_n straight into registers, 32
// features at a time, coalesced along N; it computes the logit, the link
// terms and resid, and multiplies resid into the same registers.  A
// warp's 32 per-row gradient vectors are summed by a transposing butterfly
// (31 shuffles; lane j ends with feature j), which the lane adds to its
// warp's row in shared memory.  Only that lane ever touches that entry,
// so no atomics are needed.  At the block's end the warps' rows and the
// value are summed in a fixed order into per-block partials, and
// fused_pass.cuh's finish adds those in block order: a second launch is
// bitwise equal.  For D > 32 the gradient re-reads x by chunks of 32
// (from L1/L2, just read for the logit).
#include "fused_pass.cuh"

namespace stark {

constexpr int kSingleThreads = 256;  // one row per thread per sub-tile
constexpr int kDChunk = 32;          // features held in registers at once

__host__ __device__ inline int single_features_padded(int d) {
  return (d + kDChunk - 1) / kDChunk * kDChunk;
}

// Transposing butterfly over a warp: after the width-W step, slot j holds
// feature j + (the lane's bits >= W) summed over the lanes that differ in
// those bits; lane j ends with feature j summed over the warp in v[0].
// W is a template argument so every index is known at compile time and v
// stays in registers.
template <int W>
__device__ __forceinline__ void warp_transpose_sum(float (&v)[kDChunk], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = upper ? v[j] : v[j + W];
    const float keep = upper ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) warp_transpose_sum<W / 2>(v, lane);
}

template <int kLink>
__global__ void __launch_bounds__(kSingleThreads) single_pass(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, N = p.N;
  const int Dp = single_features_padded(D);
  float* bs = smem;               // beta, zero-padded to Dp
  float* gw = smem + Dp;          // per-warp gradient rows [warp][Dp]
  float* red = gw + (kSingleThreads / 32) * Dp;  // per-warp value sums
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int row_begin = b * p.rows_per_block;
  const int row_end = min(N, row_begin + p.rows_per_block);

  for (int d = t; d < Dp; d += kSingleThreads) bs[d] = d < D ? p.beta[d] : 0.f;
  for (int i = t; i < (kSingleThreads / 32) * Dp; i += kSingleThreads) gw[i] = 0.f;
  __syncthreads();

  float vacc = 0.f;
  float xr[kDChunk];
  for (int row0 = row_begin; row0 < row_end; row0 += kSingleThreads) {
    const int n = row0 + t;
    const bool ok = n < row_end;
    float l = 0.f;
    for (int d0 = 0; d0 < Dp; d0 += kDChunk) {
#pragma unroll
      for (int j = 0; j < kDChunk; ++j) {
        const int d = d0 + j;
        xr[j] = (ok && d < D) ? __ldg(p.xT + (size_t)d * N + n) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kDChunk; ++j) l = fmaf(bs[d0 + j], xr[j], l);
    }
    if (p.offsets != nullptr && ok) l += p.offsets[n];
    const float yv = ok ? p.y[n] : 0.f;
    float v, res;
    if (kLink == kGaussian) {
      res = yv - l;
      v = res * res;
    } else {
      v = yv * log_sigmoid(l) + (1.f - yv) * log_sigmoid(-l);
      res = yv - sigmoid(l);
    }
    res = ok ? res : 0.f;
    vacc += ok ? v : 0.f;
    if (p.resid != nullptr && ok) p.resid[n] = res;

    for (int d0 = 0; d0 < Dp; d0 += kDChunk) {
      if (Dp > kDChunk) {  // the logit loop left only the last chunk in registers
#pragma unroll
        for (int j = 0; j < kDChunk; ++j) {
          const int d = d0 + j;
          xr[j] = (ok && d < D) ? __ldg(p.xT + (size_t)d * N + n) : 0.f;
        }
      }
      float v32[kDChunk];
#pragma unroll
      for (int j = 0; j < kDChunk; ++j) v32[j] = res * xr[j];
      warp_transpose_sum<kDChunk / 2>(v32, lane);
      gw[warp * Dp + d0 + lane] += v32[0];
    }
  }

  // value: warp butterfly, then the warps in order
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) vacc += __shfl_xor_sync(0xffffffffu, vacc, w);
  if (lane == 0) red[warp] = vacc;
  __syncthreads();
  for (int d = t; d < D; d += kSingleThreads) {
    float s = 0.f;
    for (int w = 0; w < kSingleThreads / 32; ++w) s += gw[w * Dp + d];
    p.gpart[(size_t)b * D + d] = s;
  }
  if (t == 0) {
    float s = 0.f;
    for (int w = 0; w < kSingleThreads / 32; ++w) s += red[w];
    p.vpart[b] = s;
  }
}

}  // namespace stark

extern "C" int stark_logistic_single(
    const float* xT, const float* y, const float* offsets, const float* beta,
    float* val, float* gbeta, float* resid, float* scratch, int D, int N,
    int rows_per_block, int nblk, int link, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.y = y;
  p.beta = beta;
  p.C = 1;
  p.D = D;
  p.N = N;
  p.rows_per_block = rows_per_block;
  p.offsets = offsets;
  p.resid = resid;
  stark::carve_scratch(p, scratch, nblk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = stark::single_features_padded(D);
  const size_t bytes = sizeof(float) * (dp + (stark::kSingleThreads / 32) * (dp + 1));
  void (*kern)(stark::Params);
  if (link == stark::kGaussian) kern = stark::single_pass<stark::kGaussian>;
  else if (link == stark::kBernoulli) kern = stark::single_pass<stark::kBernoulli>;
  else return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, stark::kSingleThreads, bytes, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (D + 1 + stark::kThreads - 1) / stark::kThreads;
  stark::finish<false><<<blocks, stark::kThreads, 0, s>>>(p, nblk, val, gbeta);
  return (int)cudaGetLastError();
}
