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
// bound by arithmetic: the design keeps the CUDA cores fed from
// registers rather than from shared memory.
//
// Work split.  Block b owns the sub-tiles [b*S/B, (b+1)*S/B) of kRows
// rows (S sub-tiles in all, B = min(kBlocks, S) blocks, two resident per
// SM): one wave, and every block within one sub-tile of the others
// (stark_tpu_torch/ops/hier_fused.py:b1_blocks computes the same split;
// the launcher refuses any other block count).  Sub-tiles of x, y and gl
// are copied to shared memory with cp.async.  While two blocks of two x
// buffers fit on an SM (D <= 32 at C = 64) the next sub-tile is copied
// while the current one is computed, one barrier per sub-tile; past that
// one buffer is staged after the sub-tile is done, and past that again
// the gradient sums live in device memory, so widths run as far as one
// block of the rest fits the SM's shared memory (layout below; at C = 64
// up to D = 249).  Rows past N are staged as zeros.  X is read from device memory once per evaluation
// and serves every chain.
//
// Per sub-tile and chunk of kChains chains:
//   logits   thread (chain group cg, row group rg) computes a 4 x 8 tile
//            of logits, chains 4 cg + {0..3} and rows 4 rg + {0..3} and
//            64 + 4 rg + {0..3}: per feature one float4 of beta (held
//            transposed in shared memory) and two of x for 32 FMAs.
//            alpha[c, group] comes from the read-only path, reloaded only
//            when the row's group changes.
//   link     one exp, one log and one division per element, in the
//            hardware's approximate forms (__expf, __logf, __fdividef):
//              e = exp(-|l|), u = 1 + e,
//              val += min(l, 0) + (y - 1) l - log(u),
//              resid = y - (l >= 0 ? 1 : e) / u.
//            Absolute errors per row: __logf errs by up to 2^-21.41
//            (3.6e-7) on [1, 2]; log(u) for log1p(e) loses e below 2^-24
//            (6e-8); __expf is within 2 + 1.17 |l| ulp of e, which moves
//            log1p(e) and resid by at most 2.4e-7 ((2 + 1.17 x) e^-x
//            2^-23 is largest at x = 0); __fdividef adds 2 ulp (1.2e-7)
//            of resid.  So a value term is within 6.6e-7 and resid within
//            3.6e-7 of the accurate forms'.  (log1pf in place of __logf
//            cost the pass 20 % on an H100 at the flagship's shape.)
//            Value sums stay in registers; resid goes to shared memory
//            [chain][row] for the two consumers below.
//   segments thread (chain, lane of 4) sums resid over each run of one
//            group in the sub-tile: a group inside the block goes straight
//            to galpha, the block's first and last groups to head and tail
//            for the finish pass.
//   gradient thread (chain group, feature group, row slice) owns a 4 x 8
//            tile of gbeta (chains gcg + 16 i, features fg + 4 j) over a
//            quarter of the rows: per 4 rows four float4 of resid and
//            eight of x for 128 FMAs, accumulated in registers over the
//            block's sub-tiles (added to the block's sums per sub-tile
//            only when C > kChains or D > kFeat).
// The strides put the float4 operands of a warp in distinct banks.
//
// Dot precision (STARK_FUSED_PRECISION; kPrec, csrc/fused_pass.cuh).  The
// reference passes it to the kernel's four dots: beta x, alpha against
// the one-hot groups, resid x^T and resid against the one-hot groups.
// Each operand is rounded once, where it is staged, never in the FMA
// loops: x in shared memory when its sub-tile has landed (each thread
// its own copies, after its wait and before the barrier: no barrier
// more), beta when the block stages it, alpha when it is loaded, resid
// when it is written to shared memory (after the value sums took it
// whole).  At default a staged operand is its bf16 value and the loops
// are highest's; at high it is a_hi and a_lo packed in one word (the
// layout and its widths are highest's), and each product is three FMAs
// in the passes' order.  Against the one-hot groups alpha enters as
// bf16(alpha) or alpha_hi + alpha_lo, and the segment sums add resid's
// staged values.  Rows past N are zeros before any rounding.  On CUDA
// cores the operations are 1 (default) or 3 (high) times highest's, so
// high's bound is 3 x 122 us; bf16 tensor cores would make both bound by
// bytes (40.6 us).
//
// Every sum runs in a fixed order: per thread in row and feature order;
// the row groups of a warp by a fixed shuffle tree; the row slices of the
// gradient and the two warps of a row-group pair one after the other in
// index order; across blocks in finish (csrc/fused_pass.cuh), which adds
// the per-block partials in block order.  No float atomics: repeated
// launches are bitwise equal.  Masking is by selects, never by
// multiplying with a mask (0 * NaN = NaN).  No (C, N) array is ever
// written.
#include "fused_pass.cuh"

namespace stark {
namespace b1 {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBlocksPerSm = 2;
constexpr int kBlocks = 132 * kBlocksPerSm;  // H100 SXM: 132 SMs
constexpr int kTwoPerSm = 113 * 1024;  // most shared memory of a block, in
                                       // bytes, with two blocks on an SM
constexpr int kOnePerSm = 227 * 1024;  // most shared memory of one block
constexpr int kRows = 128;        // rows per staged sub-tile
constexpr int kLd = kRows + 4;    // row stride of the shared tiles: 16-byte
                                  // rows, neighbouring rows 4 banks apart
constexpr int kChains = 64;       // chains per chunk
constexpr int kGroupsC = kChains / 4;  // chain groups of 4 (logits, gradient)
constexpr int kRowGroups = 16;    // row groups of 8 rows (logits)
constexpr int kFeat = 32;         // features per gradient chunk
constexpr int kSlices = 4;        // row slices of the gradient product
static_assert(kGroupsC * kRowGroups == kThreads, "logits mapping");
static_assert(kGroupsC * (kFeat / 8) * kSlices == kThreads, "gradient mapping");
static_assert(kRowGroups * 8 == kRows && kSlices * 32 == kRows, "row mapping");

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
  int nbuf;   // x buffers
  int xrows;  // feature rows of one x buffer
  bool gsl_global;  // gradient sums in the block's slice of gpart
  int xs, ys, gls, rs, bsh, vsl, run, rung, ishead, segs, misc, gsl, words;
};

// With two buffers, each holds D rounded up to whole gradient chunks, the
// rows past D zero.  With one, it holds D rows, and the gradient's reads
// of rows past D (at most kFeat - 1 of them) land in ys, gls and rs,
// which nothing writes during the gradient: their products fall in
// accumulators that are never stored.  Either way the gradient's operand
// offsets are constants.
__host__ __device__ inline Layout layout_with(int C, int D, int nbuf, bool gsl_global) {
  Layout L;
  const int cp = chains_padded(C);
  L.nbuf = nbuf;
  L.gsl_global = gsl_global;
  L.xrows = nbuf == 2 ? (D + kFeat - 1) / kFeat * kFeat : D;
  int o = 0;
  L.xs = o;     o += nbuf * L.xrows * kLd;   // x sub-tiles [buffer][d][r]
  L.ys = o;     o += nbuf * kRows;           // y [buffer][r]
  L.gls = o;    o += nbuf * kRows;           // local group ids [buffer][r]
  L.rs = o;     o += kChains * kLd;          // resid [chain][r]
  L.bsh = o;    o += D * round4(C) + cp - round4(C);  // beta [d][c], rows
                                             // round4(C) apart; the zeros past
                                             // the last row take the last
                                             // chunk's reads of absent chains
  L.vsl = o;    o += 2 * cp;                 // value partials [c][warp pair]
  L.run = o;    o += cp;                     // open group segment sum
  L.rung = o;   o += cp;                     // open group id
  L.ishead = o; o += cp;                     // open group is the block's first
  L.segs = o;   o += round4(kRows + 1);      // segment starts in the sub-tile
  L.misc = o;   o += 4;                      // [0] segment count
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

// Two x buffers while two blocks still fit on an SM, else one; the
// gradient sums in device memory (L2) when one block would not fit with
// them in shared memory.
__host__ __device__ inline Layout layout(int C, int D) {
  const Layout two = layout_with(C, D, 2, false);
  if (two.words * (int)sizeof(float) <= kTwoPerSm) return two;
  const Layout one = layout_with(C, D, 1, false);
  if (one.words * (int)sizeof(float) <= kOnePerSm) return one;
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

// Start the copies of the sub-tile at row0 (nvalid rows) into one buffer.
// A row of xT starts 16-byte aligned only where d * N is a multiple of 4;
// elsewhere, and at the ragged end, the copies are 4 bytes each.
__device__ __forceinline__ void stage(const Params& p, float* xs, float* ys, int* gls,
                                      int row0, int nvalid, bool x16) {
  const int t = threadIdx.x, D = p.D;
  for (int i = t; i < D * (kRows / 4); i += kThreads) {
    const int d = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    const size_t off = (size_t)d * p.N + row0 + r;
    float* dst = xs + d * kLd + r;
    if (x16 && (off & 3) == 0 && r + 4 <= nvalid) {
      cp_async16(dst, p.xT + off);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r + e < nvalid;
        cp_async4(dst + e, p.xT + (ok ? off + e : (size_t)d * p.N + row0), ok);
      }
    }
  }
  if (t < kRows) {
    const bool ok = t < nvalid;
    cp_async4(ys + t, p.y + row0 + (ok ? t : 0), ok);
  } else if (t < 2 * kRows) {
    const int r = t - kRows;
    const bool ok = r < nvalid;
    cp_async4(gls + r, p.gl + row0 + (ok ? r : 0), ok);
  }
}

// kOneTile: one_tile(C, D), the flagship's case (two x buffers, one
// chunk, the gradient tile in registers throughout), compiled apart so
// that none of the other cases' state takes its registers.  kPrec: the
// dot precision.
template <bool kOneTile, int kPrec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) hier_pass(Params p, int nblk) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, D = p.D, N = p.N, G = p.G;
  const Layout L = layout(C, D);
  float* xs = smem + L.xs;
  float* ys = smem + L.ys;
  int* gls = reinterpret_cast<int*>(smem + L.gls);
  float* rs = smem + L.rs;
  float* bsh = smem + L.bsh;
  float* vsl = smem + L.vsl;
  float* run = smem + L.run;
  int* rung = reinterpret_cast<int*>(smem + L.rung);
  int* ishead = reinterpret_cast<int*>(smem + L.ishead);
  int* segs = reinterpret_cast<int*>(smem + L.segs);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  float* gsl = !kOneTile && L.gsl_global ? p.gpart + (size_t)blockIdx.x * C * D : smem + L.gsl;

  const int cp = kOneTile ? kChains : chains_padded(C);
  const int cb = round4(C);  // row stride of bsh
  const int xbuf = (kOneTile ? kFeat : L.xrows) * kLd;
  const bool two = kOneTile || L.nbuf == 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const int row_begin = sub0 * kRows, row_end = min(N, sub1 * kRows);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;

  // first sub-tile in flight while the block sets up
  stage(p, xs, ys, gls, row_begin, min(kRows, N - row_begin), x16);
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
  for (int c = t; c < cp; c += kThreads) {
    run[c] = 0.f;
    rung[c] = group_of(p, row_begin);
    ishead[c] = 1;
  }

  // logits mapping: 4 chain groups x 8 row groups per warp
  const int cg = (warp >> 1) * 4 + (lane >> 3);
  const int rg = (warp & 1) * 8 + (lane & 7);
  // gradient mapping: 8 chain groups x 4 feature groups per warp, one
  // row slice per warp pair
  const int sl = warp & 3;
  const int gcg = (warp >> 2) * 8 + (lane & 7);
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
  // The gradient tile (chains k + gcg + 16 i, features f0 + fg + 4 j) to
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
    stage_rows<kPrec, kRows, kLd, kThreads>(xs + buf * xbuf, D);
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) {
      const int nrow0 = row0 + kRows;
      stage(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows, gls + (buf ^ 1) * kRows,
            nrow0, min(kRows, N - nrow0), x16);
    }
    cp_async_commit();

    const float* xcur = xs + buf * xbuf;
    const float* ycur = ys + buf * kRows;
    const int* glcur = gls + buf * kRows;
    // a sub-tile lies inside one lane tile (lane_tile is a multiple of kRows)
    const int gbase = __ldg(p.first_gid + row0 / p.lane_tile);

    if (warp == 0) {  // segment starts: rows whose group differs from the previous row's
      int nseg = 0;
      for (int r0 = 0; r0 < kRows; r0 += 32) {
        const int r = r0 + lane;
        const bool flag = r < nvalid && (r == 0 || glcur[r] != glcur[r - 1]);
        const unsigned ball = __ballot_sync(0xffffffffu, flag);
        if (flag) segs[nseg + __popc(ball & ((1u << lane) - 1u))] = r;
        nseg += __popc(ball);
      }
      if (lane == 0) {
        segs[nseg] = nvalid;
        misc[0] = nseg;
      }
    }

    for (int k = 0; k < cp; k += kChains) {
      if (k > 0) __syncthreads();  // the previous chunk is done with rs

      // ---- logits: chains k + 4 cg + i, rows 4 rg + j and 64 + 4 rg + j
      {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        const float* bp = bsh + k + 4 * cg;
        const float* xp = xcur + 4 * rg;
#pragma unroll 1
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

        // ---- link, one exp per element
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        int gprev = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = (j < 4 ? 0 : kRows / 2) + 4 * rg + (j & 3);
          const bool valid = r < nvalid;
          const int g = gbase + glcur[r];
          if (g != gprev) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = k + 4 * cg + i;
              a[i] = c < C ? onehot_operand<kPrec>(__ldg(p.alpha + (size_t)c * G + g)) : 0.f;
            }
            gprev = g;
          }
          const float yv = ycur[r], ym1 = yv - 1.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = valid && k + 4 * cg + i < C;
            const float l = acc[i][j] + a[i];
            const float e = __expf(-fabsf(l));
            const float u = 1.f + e;
            // y log s(l) + (1 - y) log s(-l) = min(l, 0) + (y - 1) l - log1p(e)
            const float v = fmaf(ym1, l, fminf(l, 0.f)) - __logf(u);
            const float s = __fdividef(l >= 0.f ? 1.f : e, u);
            vacc[i] += ok ? v : 0.f;
            acc[i][j] = ok ? yv - s : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // resid, staged as the dots' operand
          float* rp = rs + (4 * cg + i) * kLd + 4 * rg;
          *reinterpret_cast<float4*>(rp) =
              stage_operand4<kPrec>(make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          *reinterpret_cast<float4*>(rp + kRows / 2) =
              stage_operand4<kPrec>(make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
        if (cp > kChains) fold_values(k);  // more chunks: values to shared memory
      }
      __syncthreads();  // resid and the segment starts are in place

      // ---- segment sums: thread (chain cl, lane q)
      {
        const int cl = t >> 2, q = t & 3, c = k + cl;
        const float* rp = rs + cl * kLd;
        const int nseg = misc[0];
        for (int si = 0; si < nseg; ++si) {
          const int r0 = segs[si], r1 = segs[si + 1];
          const int gid = gbase + glcur[r0];
          float sg = 0.f;
          for (int r = r0 + q; r < r1; r += 4) sg += staged_value<kPrec>(rp[r]);
          sg += __shfl_xor_sync(0xffffffffu, sg, 2);
          sg += __shfl_xor_sync(0xffffffffu, sg, 1);
          if (q == 0 && c < C) {
            if (gid == rung[c]) {
              run[c] += sg;
            } else {
              if (ishead[c]) p.head[(size_t)b * C + c] = run[c];
              else p.galpha[(size_t)c * G + rung[c]] = run[c];
              // ids between two groups of the block have no rows, and
              // finish leaves them to the block
              for (int e = rung[c] + 1; e < gid; ++e) p.galpha[(size_t)c * G + e] = 0.f;
              run[c] = sg;
              ishead[c] = 0;
              rung[c] = gid;
            }
          }
        }
      }

      // ---- gradient: chains k + gcg + 16 i, features f0 + fg + 4 j,
      // rows 32 sl .. 32 sl + 31
      for (int f0 = 0; f0 < D; f0 += kFeat) {
        const float* rp = rs + gcg * kLd + 32 * sl;
        const float* xp = xcur + (f0 + fg) * kLd + 32 * sl;
#pragma unroll 1
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
      stage(p, xs, ys, gls, nrow0, min(kRows, N - nrow0), x16);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // every thread is done with the x buffers

  if (kOneTile) fold_gradient(0, 0, true);  // the one tile: gsl overlays the x buffers
  if (cp == kChains) fold_values(0);
  __syncthreads();

  if (!L.gsl_global) {
    for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gsl[i];
  }
  for (int c = t; c < C; c += kThreads) {
    p.vpart[(size_t)b * C + c] = vsl[2 * c] + vsl[2 * c + 1];
    const size_t i = (size_t)b * C + c;
    if (ishead[c]) {
      p.head[i] = run[c];
      p.tail[i] = 0.f;
    } else {
      p.tail[i] = run[c];
    }
  }
  if (t == 0) {
    p.blo[b] = group_of(p, row_begin);
    p.bhi[b] = group_of(p, row_end - 1);
  }
}

using Kernel = void (*)(Params, int);

template <bool kOneTile>
inline Kernel pick(int prec) {
  return prec == kHigh      ? hier_pass<kOneTile, kHigh>
         : prec == kDefault ? hier_pass<kOneTile, kDefault>
                            : hier_pass<kOneTile, kHighest>;
}

}  // namespace b1
}  // namespace stark

extern "C" int stark_hier_grouped(
    const float* xT, const float* y, const int* gl, const int* first_gid,
    const float* beta, const float* alpha, float* val, float* gbeta,
    float* galpha, float* scratch, int C, int D, int N, int G, int lane_tile,
    int nblk, int prec, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.y = y;
  p.beta = beta;
  p.C = C;
  p.D = D;
  p.N = N;
  p.gl = gl;
  p.first_gid = first_gid;
  p.lane_tile = lane_tile;
  p.alpha = alpha;
  p.G = G;
  p.galpha = galpha;
  // the block split of stark_tpu_torch/ops/hier_fused.py:b1_blocks, no other
  const int nsub = (N + stark::b1::kRows - 1) / stark::b1::kRows;
  if (nblk != (nsub < stark::b1::kBlocks ? nsub : stark::b1::kBlocks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  stark::carve_scratch(p, scratch, nblk);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)stark::b1::layout(C, D).words * sizeof(float);
  const stark::b1::Kernel kern =
      stark::b1::one_tile(C, D) ? stark::b1::pick<true>(prec) : stark::b1::pick<false>(prec);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, stark::b1::kThreads, bytes, s>>>(p, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)C * D + C + (long long)C * G;
  const int blocks = (int)((total + stark::b1::kThreads - 1) / stark::b1::kThreads);
  stark::finish<true><<<blocks, stark::b1::kThreads, 0, s>>>(p, nblk, val, gbeta);
  return (int)cudaGetLastError();
}

// Shared memory the pass needs per block at (C, D), and the most the
// card `device` gives one block, both in bytes.
extern "C" int stark_hier_grouped_smem(int C, int D, int device, int* need, int* limit) {
  *need = stark::b1::layout(C, D).words * (int)sizeof(float);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
