// What the kernels of stark_tpu_torch/csrc share: Params (the arguments
// of B1, B2 and B3), carve_scratch (their per-block partials), group_of
// (the grouped layout), finish (the second kernel that adds the per-block
// partials in block order; B1 and B3), the link codes, the accurate
// bernoulli link (log_sigmoid, sigmoid; B3) and stark_error_string (every
// library).  Each kernel's pass is in its own source: hier_grouped.cu
// (B1), logistic_batched.cu (B2), logistic_single.cu (B3), lmm_grouped.cu
// (B4, which has its own arguments, partials and second kernel).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stark {

constexpr int kThreads = 256;   // threads of a block of finish
constexpr int kBernoulli = 0;   // link codes of the C entry points
constexpr int kGaussian = 1;

struct Params {
  const float* xT;    // (D, N) row-major
  const float* y;     // (N,)
  const float* beta;  // (C, D)
  int C, D, N, rows_per_block;
  // grouped (B1)
  const int* gl;         // (N,) local group id within the reference tile
  const int* first_gid;  // (N / lane_tile,) first group of each tile
  int lane_tile;
  const float* alpha;    // (C, G) group intercepts
  int G;
  float* galpha;         // (C, G) output
  float* head;           // (nblk, C) first-group partial
  float* tail;           // (nblk, C) last-group partial
  int* blo;              // (nblk,) first group of the block
  int* bhi;              // (nblk,) last group of the block
  // offset path (B2, B3)
  const float* offsets;  // (C, N) or null
  float* resid;          // (C, N) output when offsets are given
  // per-block partials
  float* gpart;          // (nblk, C, D)
  float* vpart;          // (nblk, C)
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  const float e = expf(-fabsf(x));
  const float s = 1.f / (1.f + e);
  return x >= 0.f ? s : e * s;
}

__device__ __forceinline__ int group_of(const Params& p, int n) {
  return p.first_gid[n / p.lane_tile] + p.gl[n];
}

// Second pass: add the per-block partials in block order.  One thread per
// beta-gradient entry, per chain value and (grouped) per (chain, group).
template <bool kGrouped>
__global__ void finish(Params p, int nblk, float* val, float* gbeta) {
  const int C = p.C, D = p.D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ncd = (long long)C * D;
  if (i < ncd) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += p.gpart[(size_t)b * ncd + i];
    gbeta[i] = s;
    return;
  }
  long long j = i - ncd;
  if (j < C) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += p.vpart[(size_t)b * C + j];
    val[j] = s;
    return;
  }
  j -= C;
  if (kGrouped && j < (long long)C * p.G) {
    const int c = (int)(j / p.G), g = (int)(j % p.G);
    int lo = 0, hi = nblk;  // first block whose last group is >= g
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (p.bhi[mid] < g) lo = mid + 1; else hi = mid;
    }
    float s = 0.f;
    bool interior = false;
    for (int b = lo; b < nblk && p.blo[b] <= g; ++b) {
      if (p.blo[b] == g) s += p.head[(size_t)b * C + c];
      else if (p.bhi[b] == g) s += p.tail[(size_t)b * C + c];
      else interior = true;  // written by the block that owns it
    }
    if (!interior) p.galpha[(size_t)c * p.G + g] = s;  // zero when empty
  }
}

// Carve the caller's scratch buffer: gpart (nblk*C*D), vpart, head, tail
// (nblk*C each), blo, bhi (nblk ints each);
// stark_tpu_torch/ops/logistic_fused.py:scratch_words sizes it.
inline void carve_scratch(Params& p, float* scratch, int nblk) {
  const size_t nc = (size_t)nblk * p.C;
  p.gpart = scratch;
  p.vpart = p.gpart + nc * p.D;
  p.head = p.vpart + nc;
  p.tail = p.head + nc;
  p.blo = reinterpret_cast<int*>(p.tail + nc);
  p.bhi = p.blo + nblk;
}

}  // namespace stark

extern "C" const char* stark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
