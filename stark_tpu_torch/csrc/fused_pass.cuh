// What the kernels of stark_tpu_torch/csrc share: Params (the arguments
// of B1, B2 and B3), carve_scratch (their per-block partials), group_of
// (the grouped layout), finish (the second kernel that adds the per-block
// partials in block order; B1 and B3), the link codes, the accurate
// bernoulli link (log_sigmoid, sigmoid; B3) and stark_error_string (every
// library).  Each kernel's pass is in its own source: hier_grouped.cu
// (B1), logistic_batched.cu (B2), logistic_single.cu (B3), lmm_grouped.cu
// (B4, which has its own arguments, partials and second kernel).  Also
// the dot precisions (STARK_FUSED_PRECISION) of B1, B2 and B4 and what
// each takes of an operand (below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stark {

constexpr int kThreads = 256;   // threads of a block of finish
constexpr int kBernoulli = 0;   // link codes of the C entry points
constexpr int kGaussian = 1;

// Dot precisions, the codes of the C entry points
// (stark_tpu_torch/ops/precision.py:PRECISIONS).  kHighest: float32
// products.  kDefault: one bf16 pass, both operands rounded to bf16 (to
// nearest even).  kHigh: three bf16 passes, a = a_hi + a_lo with a_hi =
// bf16(a), a_lo = bf16(a - a_hi), a.b taken as a_hi b_hi + a_hi b_lo +
// a_lo b_hi.  A product of two bf16 values is exact in float32, so each
// pass is float32 FMAs on the CUDA cores, summed in float32.
constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An operand as a kernel stages it in shared memory for the dots at
// kPrec: x (highest); bf16(x) (default); for high, a_hi and a_lo packed
// in one 32-bit word, a_hi's 16 bits above a_lo's, so a staged tile
// keeps its size and layout (hi_of and lo_of unpack them).
template <int kPrec>
__device__ __forceinline__ float stage_operand(float x) {
  if (kPrec == kDefault) return bf16_round(x);
  if (kPrec == kHigh) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const __nv_bfloat16 lo = __float2bfloat16_rn(x - __bfloat162float(hi));
    return __uint_as_float((unsigned)__bfloat16_as_ushort(hi) << 16 |
                           (unsigned)__bfloat16_as_ushort(lo));
  }
  return x;
}

__device__ __forceinline__ float hi_of(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xffff0000u);
}

__device__ __forceinline__ float lo_of(float w) {
  return __uint_as_float(__float_as_uint(w) << 16);
}

// a.b of two staged operands at kPrec, added to acc: one FMA, or for
// high the three passes in their order.
template <int kPrec>
__device__ __forceinline__ float fma_staged(float a, float b, float acc) {
  if (kPrec != kHigh) return fmaf(a, b, acc);
  const float ah = hi_of(a), bh = hi_of(b);
  acc = fmaf(ah, bh, acc);
  acc = fmaf(ah, lo_of(b), acc);
  return fmaf(lo_of(a), bh, acc);
}

// What a dot at kPrec takes of x against an exact 0/1 operand (a one-hot
// of group ids, which the kernels take as a gather or a segment sum): x,
// bf16(x), or a_hi + a_lo (one float32 add, as the plain version's).
template <int kPrec>
__device__ __forceinline__ float onehot_operand(float x) {
  if (kPrec == kDefault) return bf16_round(x);
  if (kPrec == kHigh) {
    const float hi = bf16_round(x);
    return hi + bf16_round(x - hi);
  }
  return x;
}

// The four staged operands of v for the dots at kPrec.
template <int kPrec>
__device__ __forceinline__ float4 stage_operand4(float4 v) {
  return make_float4(stage_operand<kPrec>(v.x), stage_operand<kPrec>(v.y),
                     stage_operand<kPrec>(v.z), stage_operand<kPrec>(v.w));
}

// Round for the dots at kPrec, in place, the rows [0, nrows) of a
// sub-tile [row][kRowsT] (stride kLdT) that this thread copied: the
// mapping of the kernels' stage (i -> row i / (kRowsT / 4), 4 columns
// from 4 (i % (kRowsT / 4)), i stepping by kThreadsT), after the
// thread's cp.async wait and before the barrier that shows the sub-tile
// to the block, so it costs no barrier.
template <int kPrec, int kRowsT, int kLdT, int kThreadsT>
__device__ __forceinline__ void stage_rows(float* tile, int nrows) {
  if (kPrec == kHighest) return;
#pragma unroll 1
  for (int i = threadIdx.x; i < nrows * (kRowsT / 4); i += kThreadsT) {
    float4* v = reinterpret_cast<float4*>(tile + (i / (kRowsT / 4)) * kLdT +
                                          (i % (kRowsT / 4)) * 4);
    *v = stage_operand4<kPrec>(*v);
  }
}

// A staged operand's value against a 0/1 operand: a_hi + a_lo of a
// packed word (high), the value itself otherwise.
template <int kPrec>
__device__ __forceinline__ float staged_value(float w) {
  return kPrec == kHigh ? hi_of(w) + lo_of(w) : w;
}

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
