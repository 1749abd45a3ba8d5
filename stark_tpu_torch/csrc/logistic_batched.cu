// B2: chain-batched log-likelihood pass, value and beta gradient in one
// pass over X for all chains, with optional per-chain row offsets; links
// bernoulli_logit and gaussian; optionally for S independent shards of
// rows at once (consensus Monte Carlo: shard s has its own beta, xT, y,
// offsets and outputs).
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
// Shard axis.  With S shards every array gains a leading S axis (beta
// (S, C, D), xT (S, D, N), y (S, N), offsets and resid (S, C, N), val (S,
// C), gbeta (S, C, D)), and one launch serves them all: the grid is (row
// blocks, S), blockIdx.y picks the shard, and each shard's partials sit in
// a region of the scratch buffer of their own, summed by b2_finish within
// the shard only.  The row split of a shard is b2_blocks' at most kBlocks
// / S blocks, so the launch stays about one wave.  The shard offsets are
// compiled into instantiations of their own (kShards), launched for S >
// 1; S = 1 runs the unsharded pass: the same code, blocks and sums, so
// the same bits and time.
//
// Bound on an H100 SXM at the offset-path flagship shape (C=32, D=32,
// N=1M, with offsets): it must read xT (128 MB), y (4 MB) and offsets
// (128 MB) and write resid (128 MB): 388 MB, 116 us at 3.35 TB/s, against
// 2*C*D*N FMAs = 4.1 GFLOP, 61 us at 67 TFLOP/s.  So with offsets it is
// bound by bytes, and without them (132 MB, 39 us) by the FMAs.  At the
// LMM offset path (C=16, D=8, N=100k, gaussian) it moves 16.4 MB: 4.9 us.
// The design keeps the CUDA cores fed from registers and keeps the next
// sub-tile's bytes in flight while the current one is computed.
//
// Work split.  Block b owns the sub-tiles [b*S/B, (b+1)*S/B) of kRows
// rows (S sub-tiles in all, B = min(kBlocks, S) blocks of 128 threads,
// three resident per SM while a block takes at most 75 KB of shared
// memory and 168 registers a thread, as at C <= 32, D <= 32): one wave,
// and every block within one sub-tile of the others
// (stark_tpu_torch/ops/logistic_fused.py:b2_blocks computes the same
// split; the launcher refuses any other block count).  Sub-tiles of x, y
// and the first chunk's offsets are copied to shared memory with
// cp.async.  While two blocks of two buffers fit on an SM (D <= 32 at
// C <= 32: 73 KB a block) the next sub-tile is copied while the current
// one is computed, one barrier per sub-tile; past that one buffer is
// staged after the sub-tile is done, and past that again the gradient
// sums live in device memory, so widths run as far as one block of the
// rest fits the SM's shared memory (layout below; at C = 32 up to D =
// 327, at C = 64 up to D = 273).  A row of xT or offsets that starts off
// 16-byte alignment (row c starts at c * N) is copied 4 bytes at a time;
// rows past N are staged as zeros.  X is read from device memory once per
// evaluation and serves every chain.
//
// Per sub-tile and chunk of kChains = 32 chains (a chain count past 32
// takes chunks in turn; at C <= 32 no lane computes a chain past 32):
//   offsets  the chunk's (kChains, kRows) offsets land in the resid tile
//            rs [chain][row]: the first chunk's with the sub-tile, a later
//            chunk's when it starts.
//   logits   thread (chain group cg, row group rg) computes a 4 x 8 tile
//            of logits, chains 4 cg + {0..3} and rows 4 rg + {0..3} and
//            64 + 4 rg + {0..3}: per feature one float4 of beta (held
//            transposed in shared memory) and two of x for 32 FMAs.
//   link     row by row (y read once per row), each chain's logit plus its
//            offset from rs; bernoulli: one exp, one log and one division
//            per element, in the hardware's approximate forms (__expf,
//            __logf, __fdividef):
//              e = exp(-|l|), u = 1 + e,
//              val += min(l, 0) + (y - 1) l - log(u),
//              resid = y - (l >= 0 ? 1 : e) / u.
//            Absolute errors per row: __logf errs by up to 2^-21.41
//            (3.6e-7) on [1, 2]; log(u) for log1p(e) loses e below 2^-24
//            (6e-8); __expf is within 2 + 1.17 |l| ulp of e, which moves
//            log1p(e) and resid by at most 2.4e-7 ((2 + 1.17 x) e^-x
//            2^-23 is largest at x = 0); __fdividef adds 2 ulp (1.2e-7)
//            of resid.  So a value term is within 6.6e-7 and resid within
//            3.6e-7 of the accurate forms'.  gaussian: resid = y - l,
//            val += resid^2, exact.  Value sums stay in registers; resid
//            goes to rs once, over the offsets it was computed from.
//   store    with offsets, resid (C, N) from rs: a warp writes one chain's
//            128 rows, 16 bytes a thread (4 bytes where the row is off
//            alignment), streaming past L2.
//   gradient thread (chain group gcg, feature group fg, row slice) owns a
//            4 x 8 tile of gbeta (chains gcg + 8 i, features f0 + fg + 4 j)
//            over a quarter of the rows: per 4 rows four float4 of resid
//            and eight of x for 128 FMAs, accumulated in registers over
//            the block's sub-tiles (added to the block's sums per sub-tile
//            only when C > kChains or D > kFeat).
// The strides put the float4 operands of a warp in distinct banks.
//
// Dot precision (STARK_FUSED_PRECISION; kPrec, csrc/fused_pass.cuh), as
// B1 (csrc/hier_grouped.cu) takes it: the reference passes it to the two
// dots beta x and resid x^T.  x is rounded when its sub-tile has landed
// (each thread its own copies, before the barrier), beta when the block
// stages it, resid when it goes to rs for the gradient: as the link
// stores it, without offsets; with offsets, resid goes to device memory
// whole, so the store rounds what it read and one barrier more lets the
// gradient read it.  At high a staged operand is a_hi and a_lo packed in one
// word (the layout and its widths are highest's) and each product is
// three FMAs.  The offsets and the value sums are not rounded: the
// reference adds the offsets after its dot.
//
// X's storage type (STARK_FUSED_X_DTYPE; p.xdt), as B1 takes it
// (csrc/hier_grouped.cu): a bf16, int8 or fp8 xT is read at its width
// with plain loads (4 elements at once where whole and aligned, else one
// at a time; a shard's rows start at s * D * n elements, so at config 2's
// n = 125,000 every row of a 1-byte slab starts off 4-byte alignment:
// 125,000 = 8 mod 16) and widened to float32 where it is staged; the
// offsets, y and resid stay float32 and cp.async.  Past the staging the
// pass is the float32 pass at every precision, the staged rounding of x
// skipped (the identity on narrow values).
//
// Every sum runs in a fixed order: per thread in row and feature order;
// the row groups of a warp by a fixed shuffle tree; the row slices of the
// gradient and the two warps of a row-group pair one after the other in
// index order; across blocks in b2_finish, a warp per output whose lanes
// take every 32nd block in order and meet in a fixed shuffle tree.  (A
// sequential sum across the blocks, csrc/fused_pass.cuh's finish, put
// gbeta 3-5x further from the float64 sum than the plain float32 version
// at N = 40,003, D = 32, C = 20.)  No float atomics: repeated launches
// are bitwise equal.  Masking is by selects, never by multiplying with a
// mask (0 * NaN = NaN).
#include "fused_pass.cuh"

namespace stark {
namespace b2 {

constexpr int kThreads = 128;     // 4 warps
constexpr int kBlocksPerSm = 3;   // at most 168 registers a thread
constexpr int kBlocks = 132 * kBlocksPerSm;  // H100 SXM: 132 SMs
constexpr int kTwoPerSm = 113 * 1024;  // most shared memory of a block, in
                                       // bytes, with two blocks on an SM
constexpr int kOnePerSm = 227 * 1024;  // most shared memory of one block
constexpr int kRows = 128;        // rows per staged sub-tile
constexpr int kLd = kRows + 4;    // row stride of the shared tiles: 16-byte
                                  // rows, neighbouring rows 4 banks apart
constexpr int kChains = 32;       // chains per chunk
constexpr int kGroupsC = kChains / 4;  // chain groups of 4 (logits, gradient)
constexpr int kRowGroups = 16;    // row groups of 8 rows (logits)
constexpr int kFeat = 32;         // features per gradient chunk
constexpr int kSlices = 4;        // row slices of the gradient product
static_assert(kGroupsC * kRowGroups == kThreads, "logits mapping");
static_assert(kGroupsC * (kFeat / 8) * kSlices == kThreads, "gradient mapping");
static_assert(kRowGroups * 8 == kRows && kSlices * 32 == kRows, "row mapping");
static_assert(kThreads == kRows, "one y per thread");

__host__ __device__ inline int chains_padded(int c) {
  return (c + kChains - 1) / kChains * kChains;
}

// One chunk of chains and features only: the gradient tile stays in
// registers for the whole block.
__host__ __device__ inline bool one_tile(int C, int D) {
  return chains_padded(C) == kChains && D <= kFeat;
}

// Dynamic shared memory, in 4-byte words, every array 16-byte aligned.
struct Layout {
  int nbuf;   // x, y and resid buffers
  int xrows;  // feature rows of one x buffer
  bool gsl_global;  // gradient sums in the block's slice of gpart
  int xs, ys, rs, bsh, vsl, gsl, words;
};

// With two buffers, each x buffer holds D rounded up to whole gradient
// chunks, the rows past D zero.  With one, it holds D rows, and the
// gradient's reads of rows past D (at most kFeat - 1 of them) land in ys
// and rs, which nothing writes during the gradient: their products fall
// in accumulators that are never stored.  Either way the gradient's
// operand offsets are constants.
__host__ __device__ inline Layout layout_with(int C, int D, int nbuf, bool gsl_global) {
  Layout L;
  const int cp = chains_padded(C);
  L.nbuf = nbuf;
  L.gsl_global = gsl_global;
  L.xrows = nbuf == 2 ? (D + kFeat - 1) / kFeat * kFeat : D;
  int o = 0;
  L.xs = o;     o += nbuf * L.xrows * kLd;   // x sub-tiles [buffer][d][r]
  L.ys = o;     o += nbuf * kRows;           // y [buffer][r]
  L.rs = o;     o += nbuf * kChains * kLd;   // offsets, then resid [buffer][chain][r]
  L.bsh = o;    o += D * round4(C) + cp - round4(C);  // beta [d][c], rows
                                             // round4(C) apart; the zeros past
                                             // the last row take the last
                                             // chunk's reads of absent chains
  L.vsl = o;    o += 2 * cp;                 // value partials [c][warp pair]
  if (one_tile(C, D)) {
    L.gsl = L.xs;  // gradient sums [c][d], written after the last
                   // sub-tile, when the x buffers are free
  } else if (gsl_global) {
    L.gsl = -1;
  } else {
    L.gsl = o;  o += round4(C * D);
  }
  L.words = o;
  return L;
}

// Two buffers while two blocks still fit on an SM, else one; the
// gradient sums in device memory (L2) when one block would not fit with
// them in shared memory.
__host__ __device__ inline Layout layout(int C, int D) {
  const Layout two = layout_with(C, D, 2, false);
  if (two.words * (long long)sizeof(float) <= kTwoPerSm) return two;
  const Layout one = layout_with(C, D, 1, false);
  if (one.words * (long long)sizeof(float) <= kOnePerSm) return one;
  return layout_with(C, D, 1, true);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of 4 floats src[off .. off + 3] to dst, of which the
// first `left` exist (the rest are zeros): one 16-byte copy where the
// source is aligned and whole, else four of 4 bytes.
__device__ __forceinline__ void copy4(float* dst, const float* src, size_t off, int left,
                                      bool a16) {
  if (a16 && (off & 3) == 0 && left >= 4) {
    cp_async16(dst, src + off);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + (e < left ? off + e : 0), e < left);
  }
}

// Start the copies of the offsets of chains k .. k + kChains - 1 (those
// below C) for the sub-tile at row0 into rs.
__device__ __forceinline__ void stage_offsets(const Params& p, float* rs, int k, int row0,
                                              int nvalid, bool o16) {
  for (int i = threadIdx.x; i < kChains * (kRows / 4); i += kThreads) {
    const int cl = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    if (k + cl < p.C && r < nvalid)
      copy4(rs + cl * kLd + r, p.offsets, (size_t)(k + cl) * p.N + row0 + r, nvalid - r, o16);
  }
}

// Start the copies of the sub-tile at row0 (nvalid rows) into one buffer:
// x, y and, with offsets, the first chunk's offsets.  kNarrow: a narrow x
// is loaded and widened here instead (stage_x4), done when the thread
// leaves.
template <bool kNarrow>
__device__ __forceinline__ void stage(const Params& p, float* xs, float* ys, float* rs,
                                      int row0, int nvalid, bool x16, bool o16) {
  const int t = threadIdx.x;
  if constexpr (kNarrow) {
#pragma unroll 1
    for (int i = t; i < p.D * (kRows / 4); i += kThreads) {
      const int d = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
      stage_x4(xs + d * kLd + r, p.xT, p.xdt, (size_t)d * p.N + row0 + r, nvalid - r);
    }
  }
  for (int i = t; !kNarrow && i < p.D * (kRows / 4); i += kThreads) {
    const int d = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    copy4(xs + d * kLd + r, p.xT, (size_t)d * p.N + row0 + r, nvalid - r, x16);
  }
  cp_async4(ys + t, p.y + row0 + (t < nvalid ? t : 0), t < nvalid);
  if (p.offsets != nullptr) stage_offsets(p, rs, 0, row0, nvalid, o16);
}

// kOneTile: one_tile(C, D), the flagship's case (two buffers, one chunk,
// the gradient tile in registers throughout), compiled apart so that none
// of the other cases' state takes its registers.
// The arguments of shard s (blockIdx.y): every array advanced to the
// shard's own slice, the partials to the shard's region of the scratch.
__device__ __forceinline__ Params shard_view(Params p, int s, int nblk) {
  const size_t cd = (size_t)p.C * p.D, cn = (size_t)p.C * p.N;
  p.xT = x_advance(p.xT, (size_t)s * p.D * p.N, p.xdt);
  p.y += (size_t)s * p.N;
  p.beta += s * cd;
  if (p.offsets != nullptr) p.offsets += s * cn;
  if (p.resid != nullptr) p.resid += s * cn;
  p.gpart += (size_t)s * nblk * cd;
  p.vpart += (size_t)s * nblk * p.C;
  return p;
}

// kShards: S > 1, blockIdx.y the shard.  kPrec: the dot precision.
// kNarrow: xT stored as bf16, int8 or fp8 (p.xdt), its own instantiations,
// so that the float32 ones keep their code and registers.
template <bool kOneTile, int kLink, bool kShards, int kPrec, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) b2_pass(Params p, int nblk) {
  extern __shared__ __align__(16) float smem[];
  if (kShards) p = shard_view(p, blockIdx.y, nblk);
  const int C = p.C, D = p.D, N = p.N;
  const Layout L = layout(C, D);
  float* xs = smem + L.xs;
  float* ys = smem + L.ys;
  float* rs = smem + L.rs;
  float* bsh = smem + L.bsh;
  float* vsl = smem + L.vsl;
  float* gsl = !kOneTile && L.gsl_global ? p.gpart + (size_t)blockIdx.x * C * D : smem + L.gsl;

  const int cp = kOneTile ? kChains : chains_padded(C);
  const int cb = round4(C);  // row stride of bsh
  const int xbuf = (kOneTile ? kFeat : L.xrows) * kLd;
  const int rbuf = kChains * kLd;
  const bool two = kOneTile || L.nbuf == 2;
  const bool offs = p.offsets != nullptr;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  const bool o16 = offs && (reinterpret_cast<uintptr_t>(p.offsets) & 15) == 0;
  const bool r16 = offs && (reinterpret_cast<uintptr_t>(p.resid) & 15) == 0;

  // first sub-tile in flight while the block sets up
  stage<kNarrow>(p, xs, ys, rs, sub0 * kRows, min(kRows, N - sub0 * kRows), x16, o16);
  cp_async_commit();

  for (int i = t; i < D * cb + cp - cb; i += kThreads) {  // beta [d][c]
    const int d = i / cb, c = i - d * cb;
    bsh[i] = d < D && c < C ? stage_operand<kPrec>(p.beta[(size_t)c * D + d]) : 0.f;
  }
  if (two) {  // padded feature rows of both buffers
    for (int i = t; i < (L.xrows - D) * kLd; i += kThreads) {
      xs[D * kLd + i] = 0.f;
      xs[xbuf + D * kLd + i] = 0.f;
    }
  }
  for (int i = t; i < 2 * cp; i += kThreads) vsl[i] = 0.f;

  // logits mapping: 4 chain groups x 8 row groups per warp, a warp pair
  // per 4 chain groups
  const int cg = (warp >> 1) * 4 + (lane >> 3);
  const int rg = (warp & 1) * 8 + (lane & 7);
  // gradient mapping: 8 chain groups x 4 feature groups per warp, one
  // row slice per warp
  const int sl = warp;
  const int gcg = lane & 7;
  const int fg = lane >> 3;

  float vacc[4] = {0.f, 0.f, 0.f, 0.f};
  float gacc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) gacc[i][j] = 0.f;

  // Value partials of chunk k to vsl: the warp's 8 row groups by a fixed
  // shuffle tree, then one add per (chain, warp of the pair).
  auto fold_values = [&](int k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = vacc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if ((lane & 7) == 0) vsl[(k + 4 * cg + i) * 2 + (warp & 1)] += v;
      vacc[i] = 0.f;
    }
  };
  // The gradient tile (chains k + gcg + 8 i, features f0 + fg + 4 j) to
  // gsl [c][d], one row slice after the other in index order; slice 0
  // starts the sums when `first`.  Every thread reaches the barriers.
  auto fold_gradient = [&](int k, int f0, bool first) {
    for (int q = 0; q < kSlices; ++q) {
      if (sl == q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = k + gcg + kGroupsC * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int f = f0 + fg + 4 * j;
            if (c < C && f < D) {
              float* g = gsl + c * D + f;
              *g = first && q == 0 ? gacc[i][j] : *g + gacc[i][j];
            }
            gacc[i][j] = 0.f;
          }
        }
      }
      __syncthreads();
    }
  };

  for (int sub = sub0; sub < sub1; ++sub) {
    const int buf = two ? (sub - sub0) & 1 : 0;
    const int row0 = sub * kRows;
    const int nvalid = min(kRows, N - row0);
    cp_async_wait_all();
    if (!kNarrow) stage_rows<kPrec, kRows, kLd, kThreads>(xs + buf * xbuf, D);
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) {
      const int nrow0 = row0 + kRows;
      stage<kNarrow>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows, rs + (buf ^ 1) * rbuf, nrow0,
            min(kRows, N - nrow0), x16, o16);
    }
    cp_async_commit();

    const float* xcur = xs + buf * xbuf;
    const float* ycur = ys + buf * kRows;
    float* rcur = rs + buf * rbuf;

    for (int k = 0; k < cp; k += kChains) {
      if (k > 0) {
        __syncthreads();  // the previous chunk is done with rcur
        if (offs) {  // this chunk's offsets (the wait also lands the next sub-tile)
          stage_offsets(p, rcur, k, row0, nvalid, o16);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
      }

      // ---- logits: chains k + 4 cg + i, rows 4 rg + j and 64 + 4 rg + j
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      {
        const float* bp = bsh + k + 4 * cg;
        const float* xp = xcur + 4 * rg;
#pragma unroll 2
        for (int d = 0; d < D; ++d) {
          const float4 bv = *reinterpret_cast<const float4*>(bp + d * cb);
          const float4 x0 = *reinterpret_cast<const float4*>(xp + d * kLd);
          const float4 x1 = *reinterpret_cast<const float4*>(xp + d * kLd + kRows / 2);
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
          const float xx[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fma_staged<kPrec>(bb[i], xx[j], acc[i][j]);
        }
      }

      // ---- link, row by row; resid over the offsets in rcur
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = (j < 4 ? 0 : kRows / 2) + 4 * rg + (j & 3);
        const bool valid = r < nvalid;
        const float yv = ycur[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = valid && k + 4 * cg + i < C;
          const float l = offs ? acc[i][j] + rcur[(4 * cg + i) * kLd + r] : acc[i][j];
          float v, res;
          if (kLink == kGaussian) {
            res = yv - l;
            v = res * res;
          } else {
            const float ex = __expf(-fabsf(l));
            const float u = 1.f + ex;
            // y log s(l) + (1 - y) log s(-l) = min(l, 0) + (y - 1) l - log1p(e)
            v = fmaf(yv - 1.f, l, fminf(l, 0.f)) - __logf(u);
            res = yv - __fdividef(l >= 0.f ? 1.f : ex, u);
          }
          vacc[i] += ok ? v : 0.f;
          acc[i][j] = ok ? res : 0.f;
        }
      }
      // resid, staged as the gradient's operand; with offsets rs keeps it
      // whole until the store below has read it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* rp = rcur + (4 * cg + i) * kLd + 4 * rg;
        float4 w0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        float4 w1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        if (!offs) {
          w0 = stage_operand4<kPrec>(w0);
          w1 = stage_operand4<kPrec>(w1);
        }
        *reinterpret_cast<float4*>(rp) = w0;
        *reinterpret_cast<float4*>(rp + kRows / 2) = w1;
      }
      if (cp > kChains) fold_values(k);  // more chunks: values to shared memory
      __syncthreads();  // resid is in place

      // ---- resid (C, N) from rcur: a warp per chain row of 128 rows
      if (offs) {
        for (int i = t; i < kChains * (kRows / 4); i += kThreads) {
          const int cl = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
          if (k + cl >= C || r >= nvalid) continue;
          const size_t off = (size_t)(k + cl) * N + row0 + r;
          float4* rv = reinterpret_cast<float4*>(rcur + cl * kLd + r);
          const float4 v = *rv;
          if (r16 && (off & 3) == 0 && r + 4 <= nvalid) {
            __stcs(reinterpret_cast<float4*>(p.resid + off), v);
          } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (r + e < nvalid) __stcs(p.resid + off + e, vv[e]);
          }
          if (kPrec != kHighest) *rv = stage_operand4<kPrec>(v);  // the gradient's operand
        }
        if (kPrec != kHighest) __syncthreads();  // the rounded resid is in place
      }

      // ---- gradient: chains k + gcg + 8 i, features f0 + fg + 4 j,
      // rows 32 sl .. 32 sl + 31
      for (int f0 = 0; f0 < D; f0 += kFeat) {
        const float* rp = rcur + gcg * kLd + 32 * sl;
        const float* xp = xcur + (f0 + fg) * kLd + 32 * sl;
#pragma unroll 2
        for (int r = 0; r < 32; r += 4) {
          float4 rv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rv[i] = *reinterpret_cast<const float4*>(rp + kGroupsC * i * kLd + r);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(xp + 4 * j * kLd + r);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float s = gacc[i][j];
              s = fma_staged<kPrec>(rv[i].x, xv.x, s);
              s = fma_staged<kPrec>(rv[i].y, xv.y, s);
              s = fma_staged<kPrec>(rv[i].z, xv.z, s);
              gacc[i][j] = fma_staged<kPrec>(rv[i].w, xv.w, s);
            }
          }
        }
        if (!kOneTile) fold_gradient(k, f0, sub == sub0);  // more tiles than one
      }
    }
    if (!two && sub + 1 < sub1) {  // one buffer: the next sub-tile once this one is done
      __syncthreads();
      const int nrow0 = row0 + kRows;
      stage<kNarrow>(p, xs, ys, rs, nrow0, min(kRows, N - nrow0), x16, o16);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // every thread is done with the buffers

  if (kOneTile) fold_gradient(0, 0, true);  // the one tile: gsl overlays the x buffers
  if (cp == kChains) fold_values(0);
  __syncthreads();

  if (!L.gsl_global) {
    for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gsl[i];
  }
  for (int c = t; c < C; c += kThreads) p.vpart[(size_t)b * C + c] = vsl[2 * c] + vsl[2 * c + 1];
}

// Second pass: one warp per beta-gradient entry and per chain value, of
// every shard (the shard's entries, then the next shard's).  Lane l adds
// the partials of the shard's blocks l, l + 32, l + 64, ... in order, and
// the lanes' sums meet in a fixed xor-shuffle tree, which leaves the same
// bits in every lane.  A lane's loads are independent, and the rounding
// grows with nblk / 32 + 5 adds, not with nblk.  kShards: S > 1.
template <bool kShards>
__global__ void b2_finish(Params p, int nblk, int S, float* val, float* gbeta) {
  long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long ncd = (long long)p.C * p.D;
  if (w >= (ncd + p.C) * (kShards ? S : 1)) return;  // a whole warp
  if (kShards) {
    const int shard = (int)(w / (ncd + p.C));
    w -= shard * (ncd + p.C);
    p = shard_view(p, shard, nblk);
    val += (size_t)shard * p.C;
    gbeta += (size_t)shard * ncd;
  }
  const float* part = w < ncd ? p.gpart + w : p.vpart + (w - ncd);
  const size_t stride = w < ncd ? (size_t)ncd : (size_t)p.C;
  float s = 0.f;
#pragma unroll 4
  for (int b = lane; b < nblk; b += 32) s += part[(size_t)b * stride];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    if (w < ncd) gbeta[w] = s;
    else val[w - ncd] = s;
  }
}

using Kernel = void (*)(Params, int);

template <bool kOneTile, bool kShards, int kPrec, bool kNarrow>
inline Kernel pick_link(int link) {
  return link == kGaussian ? b2_pass<kOneTile, kGaussian, kShards, kPrec, kNarrow>
                           : b2_pass<kOneTile, kBernoulli, kShards, kPrec, kNarrow>;
}

template <bool kOneTile, bool kShards, bool kNarrow>
inline Kernel pick_prec(int link, int prec) {
  return prec == kHigh      ? pick_link<kOneTile, kShards, kHigh, kNarrow>(link)
         : prec == kDefault ? pick_link<kOneTile, kShards, kDefault, kNarrow>(link)
                            : pick_link<kOneTile, kShards, kHighest, kNarrow>(link);
}

template <bool kOneTile, bool kShards>
inline Kernel pick(int link, int prec, bool narrow) {
  return narrow ? pick_prec<kOneTile, kShards, true>(link, prec)
                : pick_prec<kOneTile, kShards, false>(link, prec);
}

}  // namespace b2
}  // namespace stark

extern "C" int stark_logistic_batched(
    const float* xT, const float* y, const float* offsets, const float* beta,
    float* val, float* gbeta, float* resid, float* scratch, int C, int D, int N,
    int S, int nblk, int link, int prec, int xdt, void* stream) {
  namespace b2 = stark::b2;
  stark::Params p{};
  p.xT = xT;
  p.xdt = xdt;
  p.y = y;
  p.beta = beta;
  p.C = C;
  p.D = D;
  p.N = N;
  p.offsets = offsets;
  p.resid = resid;
  // the block split of stark_tpu_torch/ops/logistic_fused.py:b2_blocks, no other
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  const int nsub = (N + b2::kRows - 1) / b2::kRows;
  const int most = b2::kBlocks / S > 1 ? b2::kBlocks / S : 1;
  if (nblk != (nsub < most ? nsub : most)) return (int)cudaErrorInvalidValue;
  if (link != stark::kBernoulli && link != stark::kGaussian) return (int)cudaErrorInvalidValue;
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  stark::carve_scratch(p, scratch, nblk * S);  // shard s: blocks s * nblk ..

  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)b2::layout(C, D).words * sizeof(float);
  const bool one = b2::one_tile(C, D);
  const bool narrow = xdt != stark::kXF32;
  const b2::Kernel kern =
      S > 1 ? (one ? b2::pick<true, true>(link, prec, narrow)
                   : b2::pick<false, true>(link, prec, narrow))
            : (one ? b2::pick<true, false>(link, prec, narrow)
                   : b2::pick<false, false>(link, prec, narrow));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nblk, S), b2::kThreads, bytes, s>>>(p, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long warps = ((long long)C * D + C) * S;
  const int blocks = (int)((32 * warps + b2::kThreads - 1) / b2::kThreads);
  if (S > 1) b2::b2_finish<true><<<blocks, b2::kThreads, 0, s>>>(p, nblk, S, val, gbeta);
  else b2::b2_finish<false><<<blocks, b2::kThreads, 0, s>>>(p, nblk, S, val, gbeta);
  return (int)cudaGetLastError();
}

// Shared memory the pass needs per block at (C, D), and the most the
// card `device` gives one block, both in bytes.
extern "C" int stark_logistic_batched_smem(int C, int D, int device, int* need, int* limit) {
  *need = stark::b2::layout(C, D).words * (int)sizeof(float);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
