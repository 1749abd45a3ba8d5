// What the kernels of stark_tpu_torch/csrc share: Params (the arguments
// of B1, B2 and B3), carve_scratch (their per-block partials), group_of
// (the grouped layout), finish (the second kernel that adds the per-block
// partials in block order; B1 and B3), the link codes, the accurate
// bernoulli link (log_sigmoid, sigmoid; B3) and stark_error_string (every
// library).  Each kernel's pass is in its own source: hier_grouped.cu
// (B1), logistic_batched.cu (B2), logistic_single.cu (B3), lmm_grouped.cu
// (B4, which has its own arguments, partials and second kernel).  Also
// the dot precisions (STARK_FUSED_PRECISION) of B1, B2 and B4 and what
// each takes of an operand, and the storage types of X
// (STARK_FUSED_X_DTYPE) and how a kernel reads and widens them (below).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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

// Storage types of X (and of B4's z), the codes of the C entry points
// (stark_tpu_torch/ops/precision.py:X_CODES): float32, bf16, int8, fp8
// e4m3 (e4m3fn: no infinity) and fp8 e5m2.  A kernel reads a narrow slab
// from device memory at its storage width (2 bytes, or 1) and widens each
// element to float32 where it stages it (`stage_x4`); the widening is
// exact (every bf16, int8 and fp8 value is a float32), so everything
// after the staging, the dots and every sum, is the float32 kernel's.
// Every such value is also exact in bf16 (int8 and fp8 have at most 8
// significant bits and bf16's exponent range), so at high and default
// the staged rounding of a narrow x is the identity: bf16(x) = x, and x's
// a_hi, a_lo word is x's own bits (a_lo = 0); only beta, alpha, u and
// resid are rounded.  The scales of a packed slab never reach a kernel:
// the models fold them into the parameter operand.
constexpr int kXF32 = 0;
constexpr int kXBf16 = 1;
constexpr int kXInt8 = 2;
constexpr int kXE4M3 = 3;
constexpr int kXE5M2 = 4;

__host__ __device__ inline bool x_code_ok(int xdt) { return xdt >= kXF32 && xdt <= kXE5M2; }

// Bytes of one element stored as xdt.
__host__ __device__ inline int x_size(int xdt) {
  return xdt == kXF32 ? 4 : xdt == kXBf16 ? 2 : 1;
}

// One element's bits (the low 16 or 8 of `bits`) stored as kX, as float32.
template <int kX>
__device__ __forceinline__ float widen(unsigned bits) {
  if (kX == kXBf16) return __uint_as_float(bits << 16);
  if (kX == kXInt8) return (float)(int)(signed char)(unsigned char)bits;
  const __nv_fp8_interpretation_t kind = kX == kXE4M3 ? __NV_E4M3 : __NV_E5M2;
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)bits, kind)));
}

// Element i of a slab stored as kX, widened to float32 (read-only path).
template <int kX>
__device__ __forceinline__ float load_x(const void* base, size_t i) {
  if (kX == kXF32) return __ldg(static_cast<const float*>(base) + i);
  if (kX == kXBf16) return widen<kX>(__ldg(static_cast<const unsigned short*>(base) + i));
  return widen<kX>(__ldg(static_cast<const unsigned char*>(base) + i));
}

// Elements off .. off + 3 of a slab stored as kX, widened, of which the
// first `left` exist (the rest are zeros and are not read): one load of
// all four (16 bytes of float32, 8 of bf16, 4 of int8 or fp8) where they
// lie whole at an address aligned to their size, else one load per
// element, so a read never reaches past the row's last element.
template <int kX>
__device__ __forceinline__ float4 load_x4(const void* base, size_t off, int left) {
  constexpr int kSize = kX == kXF32 ? 4 : kX == kXBf16 ? 2 : 1;
  const unsigned char* p = static_cast<const unsigned char*>(base) + off * kSize;
  float v[4];
  if (left >= 4 && (reinterpret_cast<uintptr_t>(p) & (4 * kSize - 1)) == 0) {
    if (kSize == 4) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else if (kSize == 2) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = widen<kX>(w.x & 0xffffu);
      v[1] = widen<kX>(w.x >> 16);
      v[2] = widen<kX>(w.y & 0xffffu);
      v[3] = widen<kX>(w.y >> 16);
    } else {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = widen<kX>((w >> (8 * e)) & 0xffu);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < left ? load_x<kX>(base, off + e) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Stage elements off .. off + 3 of a slab of storage type xdt into dst
// (16-byte aligned) as float32, with plain loads: the kernels' narrow
// instantiations stage x this way, where the float32 ones copy it with
// cp.async (which has no copy of 1 or 2 bytes).  The type is a uniform
// runtime switch: the staging runs outside the FMA loops, and one narrow
// instantiation serves every type (float32 too: B4's z may be float32
// beside a narrow x).
__device__ __forceinline__ void stage_x4(float* dst, const void* base, int xdt, size_t off,
                                         int left) {
  float4 v;
  switch (xdt) {
    case kXF32: v = load_x4<kXF32>(base, off, left); break;
    case kXBf16: v = load_x4<kXBf16>(base, off, left); break;
    case kXInt8: v = load_x4<kXInt8>(base, off, left); break;
    case kXE4M3: v = load_x4<kXE4M3>(base, off, left); break;
    default: v = load_x4<kXE5M2>(base, off, left); break;
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// A slab's base pointer advanced by n elements stored as xdt.
template <typename T>
__host__ __device__ inline const T* x_advance(const T* base, size_t n, int xdt) {
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(base) + n * x_size(xdt));
}

struct Params {
  const float* xT;    // (D, N) row-major, stored as xdt (a float pointer
                      // to the base of a narrow slab too)
  int xdt;            // storage type of xT (kXF32 ...)
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
