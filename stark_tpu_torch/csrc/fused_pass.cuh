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

// ---- The bf16 tensor-core pieces of B1's hier_mma (csrc/hier_grouped.cu)
// and B2's b2_mma (csrc/logistic_batched.cu) ----

// c += a b on the tensor cores: mma.sync m16n8k16, bf16 operands, float32
// accumulators.  Fragments (PTX ISA, mma.m16n8k16 with .bf16), g = lane /
// 4, t = lane % 4: a[0] (row g, k 2t and 2t+1), a[1] (row g + 8, the
// same k), a[2] (row g, k 2t+8 and 2t+9), a[3] (row g + 8, those k); b0
// (k 2t and 2t+1, column g), b1 (k 2t+8 and 2t+9, column g); c[0], c[1]
// (row g, columns 2t, 2t+1), c[2], c[3] (row g + 8, the same columns).  A
// register's lower k lies in its low 16 bits.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (two) 8 x 8 matrices of 16-bit elements from shared memory, each
// row 16 bytes at the address that lane 8 j + i gives (matrix j, row i;
// lanes 0-15 for two); register j of lane l holds 32-bit word l % 4 of
// row l / 4 of matrix j.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// A bf16 pair of two staged words: their a_hi halves (hi_pair) or their
// a_lo halves (lo_pair), the first word's in the low half (the lower k).
__device__ __forceinline__ unsigned hi_pair(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x7632);
}

__device__ __forceinline__ unsigned lo_pair(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5410);
}

// x's pairs (4 A registers) and b's (2 B registers) from staged words:
// the a_hi plane, and at high the a_lo plane (none for a narrow x, whose
// a_lo is 0).
struct XPairs {
  unsigned hi[4], lo[4];
};

template <int kPrec, bool kNarrow>
__device__ __forceinline__ XPairs x_pairs(unsigned w0, unsigned w1, unsigned w2, unsigned w3,
                                          unsigned w4, unsigned w5, unsigned w6, unsigned w7) {
  XPairs x;
  x.hi[0] = hi_pair(w0, w1);
  x.hi[1] = hi_pair(w2, w3);
  x.hi[2] = hi_pair(w4, w5);
  x.hi[3] = hi_pair(w6, w7);
  if (kPrec == kHigh && !kNarrow) {
    x.lo[0] = lo_pair(w0, w1);
    x.lo[1] = lo_pair(w2, w3);
    x.lo[2] = lo_pair(w4, w5);
    x.lo[3] = lo_pair(w6, w7);
  }
  return x;
}

// c += x . b at kPrec: x_hi b_hi, then at high x_lo b_hi (not for a
// narrow x) and x_hi b_lo: the reference's passes in its order (its a
// the other operand), each product exact, summed in float32.
template <int kPrec, bool kNarrow>
__device__ __forceinline__ void mma_prec(float (&c)[4], const XPairs& x, unsigned bh0,
                                         unsigned bh1, unsigned bl0, unsigned bl1) {
  mma_bf16(c, x.hi, bh0, bh1);
  if (kPrec == kHigh) {
    if (!kNarrow) mma_bf16(c, x.lo, bh0, bh1);
    mma_bf16(c, x.hi, bl0, bl1);
  }
}

// The sub-tile row of the logits' MMA row g + 8 u of m-tile M: bits 0-1
// from g % 4, bit 2 from u, bit 3 from M % 2, bit 4 from g / 4, the rest
// from M / 2.  So a warp's loads of x[d][row] (d = d0 + t, t < 4, g < 8;
// kLd = 4 mod 32) meet 32 banks, and so do its resid stores
// (rs[chain][row], the chains t and t + 4 of an n-tile; B1 and B2 both
// take kLd = 132).
__device__ __forceinline__ int mma_row(int M, int g, int u) {
  return 32 * (M >> 1) + 8 * (M & 1) + 4 * u + (g & 3) + 16 * (g >> 2);
}

// The bf16 pairs of two unrounded float32 words a (the lower k) and b,
// rounded as stage_operand<kPrec> rounds them: bf16(a), bf16(b) in hi
// (one cvt), and at high bf16(a - a_hi), bf16(b - b_hi) in lo: the
// pairs hi_pair and lo_pair take of the two staged words, built in
// registers from the words as computed (B2 rounds resid so, where the
// gradient loads it).
template <int kPrec>
__device__ __forceinline__ void round_pairs(unsigned a, unsigned b, unsigned& hi, unsigned& lo) {
  const float fa = __uint_as_float(a), fb = __uint_as_float(b);
  const __nv_bfloat162 h = __floats2bfloat162_rn(fa, fb);  // .x (low half) from a
  hi = *reinterpret_cast<const unsigned*>(&h);
  if (kPrec == kHigh) {
    const __nv_bfloat162 l = __floats2bfloat162_rn(fa - __uint_as_float(hi << 16),
                                                   fb - __uint_as_float(hi & 0xffff0000u));
    lo = *reinterpret_cast<const unsigned*>(&l);
  }
}

// x's pairs (XPairs) from eight unrounded float32 words, each pair
// (w0, w1), (w2, w3), ... rounded by round_pairs: the pairs x_pairs takes
// of the staged words, without staging them.
template <int kPrec, bool kNarrow>
__device__ __forceinline__ XPairs x_round_pairs(unsigned w0, unsigned w1, unsigned w2, unsigned w3,
                                                unsigned w4, unsigned w5, unsigned w6,
                                                unsigned w7) {
  constexpr int kP = kNarrow ? kDefault : kPrec;  // a narrow x is its own a_hi, a_lo = 0
  XPairs x;
  round_pairs<kP>(w0, w1, x.hi[0], x.lo[0]);
  round_pairs<kP>(w2, w3, x.hi[1], x.lo[1]);
  round_pairs<kP>(w4, w5, x.hi[2], x.lo[2]);
  round_pairs<kP>(w6, w7, x.hi[3], x.lo[3]);
  return x;
}

// Storage types of X (and of B4's z), the codes of the C entry points
// (stark_tpu_torch/ops/precision.py:X_CODES): float32, bf16, int8, fp8
// e4m3 (e4m3fn: no infinity) and fp8 e5m2.  A kernel reads a narrow slab
// from device memory at its storage width (2 bytes, or 1) and widens each
// element to float32 where it stages it (`stage_x4`, or in B1 and B2
// after cp.async of the packed words, `x_window_copy` below); the widening is
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
// (16-byte aligned) as float32, with plain loads: B4's and b2_chunk's
// narrow instantiations stage x this way, as B1's and b2_mma's do where
// they have no packed slot (x_window_copy); the float32 ones copy it
// with cp.async (which has no copy of 1 or 2 bytes).  The type is a uniform
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

// ---- Narrow X copied in flight: cp.async of the packed words, widened
// after the wait (B1's hier_mma; B2's b2_mma, each warp its own rows) ----
//
// cp.async has no copy of 1 or 2 bytes, and a narrow row of a sub-tile
// (elements off .. off + rows - 1 of the slab, 2 or 1 bytes each) starts
// 16-byte aligned only where off * size is a multiple of 16: a row of xT
// starts at element d * N.  So a row is copied as the 16-byte windows,
// aligned to the slab's base, that cover it: window 0 starts at the
// boundary at or before its first element, `head` = off * size mod 16
// bytes before it, and x_window_chunks(rows, size) windows hold the row
// at any head.  x_window_copy starts the copies of the windows that hold
// one of the row's first nvalid elements (no others), lane j of a warp
// window j, j + 32, ...; a window that reaches past the slab's last byte
// copies only the slab's bytes and fills the rest with zeros (cp.async's
// src-size), so no copy reads outside the slab.  After its wait and a
// __syncwarp the same warp widens the row (x_window_load4: lane l the
// elements 4 l .. 4 l + 3, zeros from nvalid on), its own copies only,
// so the widening needs no barrier of the block.  The slab's base must
// be 16-byte aligned; a slab that is not (a view) keeps the plain loads
// of stage_x4.  (Python mirror: stark_tpu_torch/ops/hier_fused.py:
// x_windows.)

// 16-byte windows that hold a row of `rows` elements of `size` bytes at
// any head (0 .. 15): 17 for 128 bf16 elements, 9 for 128 of one byte.
__host__ __device__ constexpr int x_window_chunks(int rows, int size) {
  return (rows * size + 30) / 16;
}

// Start the copy of window j of the row at element `off` (its first
// nvalid elements valid) of a slab of slab_bytes bytes at `base` into
// `dst` (16-byte aligned), if the window holds one of those elements.
__device__ __forceinline__ void x_window_copy1(void* dst, const void* base, int size,
                                               long long slab_bytes, long long off, int nvalid,
                                               int j) {
  const long long b = off * size, w0 = b & ~15LL;
  if (16 * j >= (int)(b - w0) + nvalid * size) return;  // past the row's last valid element
  const long long src = w0 + 16LL * j;
  const long long left = slab_bytes - src;  // > 0: the window holds a valid element
  const int bytes = left < 16 ? (int)left : 16;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(static_cast<const char*>(base) + src), "r"(bytes));
}

// Start the copies of the windows of the row at element `off` (its first
// nvalid elements valid) of a slab of slab_bytes bytes at `base` into
// `slot` (the row's x_window_chunks windows, 16-byte aligned): lane j of
// the calling warp copies windows j, j + 32, ....  (Written out rather
// than on x_window_copy1: B1 on narrow X ran 4 % slower so on an H100,
// PERF.md.)
__device__ __forceinline__ void x_window_copy(void* slot, const void* base, int size,
                                              long long slab_bytes, long long off, int nvalid,
                                              int lane) {
  const long long b = off * size, w0 = b & ~15LL;
  const int end = (int)(b - w0) + nvalid * size;  // bytes from window 0 to the last valid one
  for (int j = lane; 16 * j < end; j += 32) {
    const long long src = w0 + 16LL * j;
    const long long left = slab_bytes - src;  // > 0: the window holds a valid element
    const int bytes = left < 16 ? (int)left : 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(static_cast<char*>(slot) +
                                                                    16 * j))),
                 "l"(static_cast<const char*>(base) + src), "r"(bytes));
  }
}

// Elements r .. r + 3 of a row copied by x_window_copy (window 0 at
// `slot`, the row's first element `head` bytes into it), stored as kX and
// widened to float32; zeros from element nvalid on.  The words are read
// whole and the elements cut out with funnel shifts, so a head off 4-byte
// alignment costs one word more.
template <int kX>
__device__ __forceinline__ float4 x_window_widen4(const void* slot, int head, int r, int nvalid) {
  constexpr int kSize = kX == kXBf16 ? 2 : 1;
  const unsigned* w = static_cast<const unsigned*>(slot);
  const int b = head + r * kSize, q = b >> 2, s = (b & 3) * 8;
  unsigned e[4];
  if (kSize == 2) {
    const unsigned lo = __funnelshift_r(w[q], w[q + 1], s);
    const unsigned hi = __funnelshift_r(w[q + 1], w[q + 2], s);
    e[0] = lo & 0xffffu;
    e[1] = lo >> 16;
    e[2] = hi & 0xffffu;
    e[3] = hi >> 16;
  } else {
    const unsigned v = __funnelshift_r(w[q], w[q + 1], s);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = (v >> (8 * i)) & 0xffu;
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = r + i < nvalid ? widen<kX>(e[i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// x_window_widen4 for a narrow storage type xdt, a uniform runtime switch.
__device__ __forceinline__ float4 x_window_load4(const void* slot, int xdt, int head, int r,
                                                 int nvalid) {
  switch (xdt) {
    case kXBf16: return x_window_widen4<kXBf16>(slot, head, r, nvalid);
    case kXInt8: return x_window_widen4<kXInt8>(slot, head, r, nvalid);
    case kXE4M3: return x_window_widen4<kXE4M3>(slot, head, r, nvalid);
    default: return x_window_widen4<kXE5M2>(slot, head, r, nvalid);
  }
}

// A float32 operand's word split into three bf16 pieces, a = p0 + p1 +
// p2, each the rest so far cut to bf16 toward zero (the high 16 bits of
// its float32 word; the differences are exact in float32): the piece
// words, low halves 0.  A float32 has 24 significant bits and each piece
// takes 8, so the sum is exact for every a that is a multiple of 2^-133,
// bf16's least subnormal (every normal a of magnitude >= 2^-110, and 0);
// of a smaller a the bits below 2^-133 are lost (an error under 2^-133).
// Cut toward zero, no piece overflows, the largest float32 too (to
// nearest, bf16(a) of a >= (2 - 2^-8) 2^127 would be infinite).  B1's
// and B2's tensor-core passes at highest on narrow X take beta and resid
// so: x (exact in bf16) times each piece is exact in float32.
__device__ __forceinline__ void split3(unsigned a, unsigned& p0, unsigned& p1, unsigned& p2) {
  p0 = a & 0xffff0000u;
  const float r1 = __uint_as_float(a) - __uint_as_float(p0);
  p1 = __float_as_uint(r1) & 0xffff0000u;
  p2 = __float_as_uint(r1 - __uint_as_float(p1)) & 0xffff0000u;
}

// The three bf16 pairs (b0 or b1 registers, one per piece of split3) of
// two float32 words a (the lower k) and b.
__device__ __forceinline__ void split3_pairs(unsigned a, unsigned b, unsigned (&pair)[3]) {
  unsigned a0, a1, a2, b0, b1, b2;
  split3(a, a0, a1, a2);
  split3(b, b0, b1, b2);
  pair[0] = hi_pair(a0, b0);
  pair[1] = hi_pair(a1, b1);
  pair[2] = hi_pair(a2, b2);
}

// c += x . b at highest on a narrow x (its own bf16 bits, XPairs.hi):
// x p0, x p1, x p2, each product exact in float32, summed in float32.
// b0[i], b1[i]: the B registers of piece i.
__device__ __forceinline__ void mma_split3(float (&c)[4], const XPairs& x, const unsigned (&b0)[3],
                                           const unsigned (&b1)[3]) {
  mma_bf16(c, x.hi, b0[0], b1[0]);
  mma_bf16(c, x.hi, b0[1], b1[1]);
  mma_bf16(c, x.hi, b0[2], b1[2]);
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

// galpha[j] (j = c G + g) of a grouped pass from its blocks' head and
// tail partials, in block order; left to the block that owns g whole.
__device__ __forceinline__ void finish_group(const Params& p, int nblk, long long j) {
  const int C = p.C;
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
  if (kGrouped && j < (long long)C * p.G) finish_group(p, nblk, j);
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

// (once a library: in part 0 of a source compiled in parts,
// stark_tpu_torch/_build.py:PARTS)
#if !defined(STARK_PART) || STARK_PART == 0
extern "C" const char* stark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
