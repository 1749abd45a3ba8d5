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
// 3.35 TB/s; it must do 2*C*D*N products (logits and gradient) = 8.2
// GFLOP, 122 us at the 67 TFLOP/s of the FP32 CUDA cores, 8.3 us at the
// 989 of the bf16 tensor cores; and its link runs three special-function
// instructions per chain and row (below), 192e6, 46 us at 16 per SM and
// clock on 132 SMs at 1.98 GHz.  At highest on float32 X (hier_pass) the
// products run on the CUDA cores, so it is bound by arithmetic and the
// design keeps them fed from registers rather than from shared memory.
// At high and default, and at highest on narrow X (hier_mma), they run on
// the tensor cores, and at C = 64 the link, not the bytes, sets the floor
// (at C = 8 the bytes: 21.7 us of bf16 X, 12.1 of one byte).
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
// Per sub-tile and chunk of kChains chains, at highest (hier_pass):
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
// At highest on float32 X with C <= 32 and D <= kFeat (hier_chunk<kCh>,
// the NUTS legs' C = 8 and sample()'s default C = 4) the 64-chain chunk
// would do 64 chains' work; hier_chunk runs one chunk of the smallest of
// 8, 16 and 32 chains that holds C, each compiled apart, so that no lane
// works on a chain past it (ChunkShape).  At C = 8, D = 32, N = 1M its
// bound is the bytes' 40.6 us (products 15.3 us, link 6 us), at C = 32
// the products' 61 us; past the bytes, what it takes is instructions and
// their latency at two blocks of eight warps an SM, so its design keeps
// the products fed from registers and takes the sub-tile's phases without
// a barrier between them:
//   logits   thread (cg, rg) computes chains cg + 8 i (kCh / 8 of them) by
//            rows 4 rg .. 4 rg + 3: per 4 features kCh / 8 float4 of beta
//            (held [c][d]) and four of x; features past D are zeros.
//   link     hier_pass's, word for word; alpha as hier_pass loads it,
//            carried from sub-tile to sub-tile.
//   segments a sub-tile of one or two runs of one group (its last row's
//            local id at most one past its first's; at the flagship nearly
//            every sub-tile) takes its sums from the link's registers:
//            per chain over the thread's rows, the warp's by a fixed
//            shuffle tree, the warps' in order by the last warp; any other
//            sub-tile hier_mma's segment_sums (256 / kCh lanes a chain).
//   gradient thread (fg, gc, sl) owns 8 chains by 4 features over the
//            4-row groups sl + kSl q, 32 sums in registers for the block,
//            added over the slices in index order after the last sub-tile.
// One barrier a sub-tile: iteration k takes the logits and link of
// sub-tile k and the segment sums and gradient of k - 1, whose resid,
// segment starts and run sums sit in the other of two parity buffers, so
// one phase's latency hides behind another's work.  x, y and the local
// ids come through a ring of kStages buffers by cp.async, the next
// sub-tile copied while two are computed (a whole aligned sub-tile
// without stage's per-copy tests).  Block split and scratch are
// hier_pass's; the partials are added by hier_mma's mma_finish (a warp
// per output, 2.4 us less than finish at C = 8 on an H100).  Shared
// memory: layout_chunk, 64-96 KB, two blocks an SM.
//
// Dot precision (STARK_FUSED_PRECISION; kPrec, csrc/fused_pass.cuh).  The
// reference passes it to the kernel's four dots: beta x, alpha against
// the one-hot groups, resid x^T and resid against the one-hot groups.
// At high and default (hier_mma) each operand is rounded once, where it
// is staged: x in shared memory when its sub-tile has landed (each thread
// its own copies, after its wait and before the barrier: no barrier
// more), beta when the block stages it, alpha when it is loaded, resid
// when it is written to shared memory (after the value sums took it
// whole).  A staged operand is one 32-bit word an element, in highest's
// layout: a_hi = bf16(a) in its high 16 bits and a_lo = bf16(a - a_hi) in
// its low 16 at high, bf16(a) with a low half of 0 at default (a float32
// whose low 16 bits are 0).  Against the one-hot groups alpha enters as
// bf16(alpha) or alpha_hi + alpha_lo, and the segment sums add resid's
// staged values.  Rows past N are zeros before any rounding.
//
// hier_mma computes both products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, float32 accumulators), with the chains on the
// MMA's narrow side (n = 8) and x the A operand of both:
//   logits^T (rows x chains) = x^T beta^T,
//   gbeta^T (features x chains) = x resid^T.
// The link, the staging and the block split are hier_pass's.  It runs
// high and default on every X, and highest on narrow X: there x is
// exact in bf16, and beta and resid each enter as three bf16 pieces
// (split3, csrc/fused_pass.cuh: a = p0 + p1 + p2, each the rest cut to
// bf16 toward zero, exact for every float32 that is a multiple of
// 2^-133), so each product is three MMAs (x p0, x p1, x p2), each exact
// in float32 and summed in float32: highest's arithmetic in another order
// of its sums than hier_pass's.  That is high's count of MMAs (its x_lo
// pass is not needed, a narrow x_lo being 0), 25 us at the flagship at
// the dense rate, under the link's 46 us where hier_pass's FP32 products
// take 122 us at best.  beta's pieces are built once per block into the
// fragment block (6 words an entry at highest), resid stays whole in rs
// and is split where the gradient builds its pairs, alpha enters whole
// and the segment sums add resid whole, as hier_pass's.  What its design
// does, and why:
//   - Operands stay in highest's layout, one staged word an element, so
//     shared memory, its tiers and the widths they take are highest's
//     (layout_mma adds 9 KB at one tile): every (C, D) highest takes runs
//     at high and default, and the same widths are refused.  (A third x
//     buffer was 1.5 % slower on an H100 at C = 64 and C = 8.)  A thread builds the MMA's
//     bf16 pairs from two words with one byte permute each (hi_pair,
//     lo_pair): the a_hi plane, and at high the a_lo plane.  Default is
//     one MMA, x_hi b_hi; high three, x_hi b_hi, x_lo b_hi and x_hi b_lo,
//     the reference's passes in its order, each product exact in float32
//     and summed in float32, so the kernel and the plain version differ in
//     the order of their sums only.  A narrow x has x_lo = 0 and skips its
//     pass.  At the flagship that is 6.0M MMAs at high, 2.0M at default,
//     some 25 and 8 us at the dense rate: under the link's 46 us.
//   - Chains are padded to 8, 16, 32 or 64 per chunk (chunk_ntiles), not
//     to 64: C = 8, the NUTS legs', does 8 chains' work.  Per chunk of nt
//     n-tiles of 8 chains (MmaShape), a warp computes the logits of mt
//     m-tiles of 16 rows by ng n-tiles (mt ng = nt; 8 warps, 128 rows),
//     and the gradient of one m-tile of 16 features by ngg n-tiles over
//     the sub-tile's rows or, when the chunk has under 8 output tiles, a
//     slice of them (added in slice order).  The one-tile kernels for nt =
//     1 (C <= 8) and, at default and on narrow X, nt = 8 (the flagship)
//     have nt compiled in (kNt), so their loops are unrolled to the shape
//     (25 us less each on an H100 than with nt read at run time); on
//     float32 X at high the flagship's spilled so, and reads nt at run
//     time.  The narrow ones at highest and high spilled too until they
//     loaded beta's pairs for each MMA (kLazyB, lds_v4), and at highest
//     left the run sums below to the segment sums (run_sums).
//   - Logits: a k-step takes 16 features; a thread loads 8 words of x
//     per m-tile (lds.32), rows permuted within 32-row groups (mma_row) so
//     that a warp's 32 loads meet 32 banks (kLd = 4 mod 32).  beta's pairs
//     are built once per block into shared memory in fragment order and
//     loaded per sub-tile, one 16-byte load a thread per k-step and n-tile
//     (one tile), or built per k-step (in registers for the block, the
//     flagship's kernels spilled).
//     Features past D are loaded as 0 in both operands (selects).  An
//     n-tile's column n is chain n / 2 + 4 (n % 2), so a thread holds
//     chains t and t + 4, and its resid stores meet 32 banks.
//   - Link: each thread takes its accumulator elements (2 mt rows by 2 ng
//     chains) through the link above; alpha is reloaded when its rows'
//     group changes, carried from sub-tile to sub-tile with one chunk.
//     The value sums fold over the thread's rows by a fixed shuffle tree
//     into one slot per (chain, row group), added in slot order.
//   - Segment sums: with one tile, the link also sums resid's staged
//     values per chain over the sub-tile's first run of one group and over
//     the rest, folded like the values: these are the segment sums when
//     the sub-tile holds one or two runs (at the flagship nearly every
//     sub-tile); otherwise, and past one tile, threads of 32 / nt lanes per
//     chain sum each run from shared memory in four partial sums.
//   - Gradient: x and resid by ldmatrix (a matrix row is 4 words = 4 rows
//     of the sub-tile; row strides of 33 x 16 bytes meet every bank once),
//     pairs of rows r and r + 4 in one register.  Feature rows past D are
//     computed and never stored.
//   - The second kernel (mma_finish) adds gbeta's and val's per-block
//     partials a warp per output (a lane's blocks in order, then a fixed
//     shuffle tree), not a thread per output adding the 264 blocks'
//     partials one after another.
//
// X's storage type (STARK_FUSED_X_DTYPE; p.xdt, csrc/fused_pass.cuh).
// A bf16, int8 or fp8 xT is read at its width, 2 or 1 bytes an element
// (at the flagship 64 MB or 32 MB in place of 128), and is in flight
// while the block computes, as float32's is.  cp.async has no copy of 1
// or 2 bytes, and a row of xT starts at element d * N (at most N's rows
// start 16-byte aligned), so each feature row of the next sub-tile is
// copied, a sub-tile ahead where float32's copies are issued, as the
// aligned 16-byte windows that cover it (x_window_copy: 17 of bf16, 9 of
// one byte; zeros past the slab's end, nothing read outside it) into one
// packed slot after the layout (xslot_at: 8.7 KB for bf16, 4.6 KB for one
// byte at D = 32).  After its wait each warp widens the rows it copied
// into the sub-tile's float32 buffer (widen_slot), where float32's
// stage_rows stands, before the barrier: no barrier more.  So the staging
// moves bytes, not values: the float32 buffers, the tiers, the block
// split, the link and every sum are as they were, and at high and
// default narrow X gives bitwise what it gave with plain loads.  A slab
// whose base is off 16-byte alignment (a view), and a width whose slot
// does not fit its tier (xslot_at), keeps the plain loads (stage_x4), in
// the kernels that read their n-tiles from C.  The staged rounding of x
// is skipped, being the identity on narrow values.  Every precision of
// narrow X runs on hier_mma, highest too (split3, below).
//
// Every sum runs in a fixed order: per thread in row and feature order
// (in an MMA, the tensor core's own fixed order); the row groups of a
// warp by a fixed shuffle tree; the row slices of the gradient and the
// warps of a row-group set one after the other in index order; across
// blocks in finish (csrc/fused_pass.cuh), which adds the per-block
// partials in block order, or mma_finish's lanes and shuffle tree.  No float atomics: repeated
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
  int xs, ys, gls, rs, bsh, vsl, run, rung, ishead, segs, misc, gsl, bfr, segp, words;
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
  L.bfr = L.segp = -1;
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

// Entries of hier_mma's beta pairs in fragment order, one tile: [k-step
// of 16 features][n-tile][lane], each 4 words (hi b0, b1, lo b0, b1; at
// highest the pieces p0 and p1 of split3), and at highest a second block
// of the same entries of 2 words (p2 b0, b1).
constexpr int kBetaFragEntries = 2 * (kChains / 8) * 32;
__host__ __device__ constexpr int beta_frag_words(int prec) {
  return kBetaFragEntries * (prec == kHighest ? 6 : 4);
}

// hier_mma's: highest's, with in the one-tile case beta's pairs in
// fragment order and the segment partials [2][c][row group] after it (89
// KB at C = 64, D = 32 at high and default, 93 KB at highest).
__host__ __device__ inline Layout layout_mma(int C, int D, int prec) {
  Layout L = layout(C, D);
  if (one_tile(C, D)) {
    L.bfr = L.words;
    L.words += beta_frag_words(prec);
    L.segp = L.words;
    L.words += 2 * 2 * kChains;
  }
  return L;
}

// Words of the packed slot into which a narrow sub-tile is copied in
// flight (x_window_copy): D rows of x_window_chunks windows.
__host__ __device__ inline int xslot_words(int D, int xdt) {
  return D * x_window_chunks(kRows, x_size(xdt)) * 4;
}

// The slot's offset in words, after the pass's layout L, or -1: float32
// X, or a slot that does not fit L's tier (113 KB a block with two x
// buffers, so that two blocks share an SM; 227 KB with one).  Such a
// width keeps the plain loads (stage_x4), and no width is refused for the
// slot.  They are the widths whose layout leaves less than the slot
// (D x 272 bytes for bf16, D x 144 for one byte) under its tier's limit:
// at C = 64, D >= 150 (bf16) and 166-188, 212-249 (one byte); at C = 8,
// 33 <= D <= 64 (bf16; one byte from 50) and D >= 227 (266); at C = 33,
// 33-37 and from 182 (207).  ops/hier_fused.py:b1_route lists them for
// any (C, D).
__host__ __device__ inline int xslot_at(const Layout& L, int D, int xdt) {
  if (xdt == kXF32) return -1;
  const int limit = (L.nbuf == 2 ? kTwoPerSm : kOnePerSm) / (int)sizeof(float);
  return L.words + xslot_words(D, xdt) <= limit ? L.words : -1;
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
// elsewhere, and at the ragged end, the copies are 4 bytes each.  kNarrow:
// a narrow xT's rows are copied in flight into the packed slot at word
// xsw of the block's shared memory (x_window_copy, warp w rows w, w + 8,
// ...) and widened into the buffer after the wait (widen_slot); with no
// slot (xsw < 0) they are loaded and widened here (stage_x4), done when
// the thread leaves.  kPlain: that second way is compiled (a kernel that
// is launched only with a slot leaves it out).
template <bool kNarrow, bool kPlain>
__device__ __forceinline__ void stage(const Params& p, float* xs, float* ys, int* gls,
                                      int row0, int nvalid, bool x16, int xsw) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, D = p.D;
  if constexpr (kNarrow) {
    if (!kPlain || xsw >= 0) {
      const int size = x_size(p.xdt), nch = x_window_chunks(kRows, size);
      const long long slab = (long long)D * p.N * size;
#pragma unroll 1
      for (int d = t >> 5; d < D; d += kThreads / 32) {
        x_window_copy(reinterpret_cast<char*>(smem + xsw) + 16 * nch * d, p.xT, size, slab,
                      (long long)d * p.N + row0, nvalid, t & 31);
      }
    } else {
#pragma unroll 1
      for (int i = t; i < D * (kRows / 4); i += kThreads) {
        const int d = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
        stage_x4(xs + d * kLd + r, p.xT, p.xdt, (size_t)d * p.N + row0 + r, nvalid - r);
      }
    }
  }
  for (int i = t; !kNarrow && i < D * (kRows / 4); i += kThreads) {
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

// Widen the rows of the sub-tile at row0 (nvalid rows) that this warp
// copied into the packed slot at word xsw (stage) into a float32 x
// buffer, after the thread's wait and before the barrier: lane l elements
// 4 l .. 4 l + 3 of rows w, w + 8, ... (warp w), one 16-byte store each.
__device__ __forceinline__ void widen_slot(const Params& p, int xsw, float* xs, int row0,
                                           int nvalid) {
  static_assert(kRows == 4 * 32, "a lane widens 4 elements of a row");
  extern __shared__ __align__(16) float smem[];
  const int size = x_size(p.xdt), nch = x_window_chunks(kRows, size), lane = threadIdx.x & 31;
  __syncwarp();  // the warp's copies, each landed for its own lane, to every lane
#pragma unroll 1
  for (int d = threadIdx.x >> 5; d < p.D; d += kThreads / 32) {
    const int head = (d * (p.N & 15) * size) & 15;  // row0 * size is a multiple of 16
    *reinterpret_cast<float4*>(xs + d * kLd + 4 * lane) = x_window_load4(
        reinterpret_cast<const char*>(smem + xsw) + 16 * nch * d, p.xdt, head, 4 * lane,
        nvalid);
  }
}

// The block's arrays (Layout); gsl in device memory, the block's slice of
// gpart, when the layout puts it there.
struct Tiles {
  float *xs, *ys, *rs, *bsh, *vsl, *run, *gsl;
  int *gls, *rung, *ishead, *segs, *misc;
};

__device__ __forceinline__ Tiles carve(float* smem, const Layout& L, const Params& p,
                                       bool one) {
  Tiles s;
  s.xs = smem + L.xs;
  s.ys = smem + L.ys;
  s.gls = reinterpret_cast<int*>(smem + L.gls);
  s.rs = smem + L.rs;
  s.bsh = smem + L.bsh;
  s.vsl = smem + L.vsl;
  s.run = smem + L.run;
  s.rung = reinterpret_cast<int*>(smem + L.rung);
  s.ishead = reinterpret_cast<int*>(smem + L.ishead);
  s.segs = reinterpret_cast<int*>(smem + L.segs);
  s.misc = reinterpret_cast<int*>(smem + L.misc);
  s.gsl = !one && L.gsl_global ? p.gpart + (size_t)blockIdx.x * p.C * p.D : smem + L.gsl;
  return s;
}

// The block's set-up while its first sub-tile is in flight: its first and
// last groups for finish (written here, so that no register holds its
// rows to the end), beta staged [d][c] as the dots at kPrec take it, zeros
// in the padded feature rows of both x buffers (two), the value partials
// and the open group sums.
template <int kPrec>
__device__ __forceinline__ void begin_block(const Params& p, const Tiles& s, const Layout& L,
                                            int cp, int xbuf, int row_begin, int row_end) {
  const int t = threadIdx.x, C = p.C, D = p.D, cb = round4(C);
  if (t == 0) {  // the block's first and last groups, for finish
    p.blo[blockIdx.x] = group_of(p, row_begin);
    p.bhi[blockIdx.x] = group_of(p, row_end - 1);
  }
  for (int i = t; i < D * cb + cp - cb; i += kThreads) {  // beta [d][c]
    const int d = i / cb, c = i - d * cb;
    s.bsh[i] = d < D && c < C ? stage_operand<kPrec>(p.beta[(size_t)c * D + d]) : 0.f;
  }
  if (L.nbuf == 2) {  // padded feature rows of both buffers
    for (int i = t; i < (L.xrows - D) * kLd; i += kThreads) {
      s.xs[D * kLd + i] = 0.f;
      s.xs[xbuf + D * kLd + i] = 0.f;
    }
  }
  for (int i = t; i < 2 * cp; i += kThreads) s.vsl[i] = 0.f;
  for (int c = t; c < cp; c += kThreads) {
    s.run[c] = 0.f;
    s.rung[c] = group_of(p, row_begin);
    s.ishead[c] = 1;
  }
}

// Warp 0: the segment starts of the sub-tile (rows whose group differs
// from the previous row's) to segs, their count to misc[0].
__device__ __forceinline__ void find_segments(const Tiles& s, const int* glcur, int nvalid) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  int nseg = 0;
  for (int r0 = 0; r0 < kRows; r0 += 32) {
    const int r = r0 + lane;
    const bool flag = r < nvalid && (r == 0 || glcur[r] != glcur[r - 1]);
    const unsigned ball = __ballot_sync(0xffffffffu, flag);
    if (flag) s.segs[nseg + __popc(ball & ((1u << lane) - 1u))] = r;
    nseg += __popc(ball);
  }
  if (lane == 0) {
    s.segs[nseg] = nvalid;
    s.misc[0] = nseg;
  }
}

// Chain c's sum sg of resid over a run of group gid in the sub-tile: added
// to the open group's sum, or the open group closed (a group inside the
// block straight to galpha, the block's first group to head) and gid
// opened.
__device__ __forceinline__ void add_segment(const Params& p, const Tiles& s, int c, int gid,
                                            float sg) {
  const int C = p.C, G = p.G;
  if (gid == s.rung[c]) {
    s.run[c] += sg;
  } else {
    if (s.ishead[c]) p.head[(size_t)blockIdx.x * C + c] = s.run[c];
    else p.galpha[(size_t)c * G + s.rung[c]] = s.run[c];
    // ids between two groups of the block have no rows, and
    // finish leaves them to the block
    for (int e = s.rung[c] + 1; e < gid; ++e) p.galpha[(size_t)c * G + e] = 0.f;
    s.run[c] = sg;
    s.ishead[c] = 0;
    s.rung[c] = gid;
  }
}

// The block's partials for finish: gradient sums (unless already in
// gpart, gsl_global), chain c's value (value_of(c)) and the open groups'
// sums as head or tail.
template <class ValueOf>
__device__ __forceinline__ void end_block(const Params& p, const Tiles& s, bool gsl_global,
                                          ValueOf value_of) {
  const int t = threadIdx.x, C = p.C, D = p.D, b = blockIdx.x;
  if (!gsl_global) {
    for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = s.gsl[i];
  }
  for (int c = t; c < C; c += kThreads) {
    p.vpart[(size_t)b * C + c] = value_of(c);
    const size_t i = (size_t)b * C + c;
    if (s.ishead[c]) {
      p.head[i] = s.run[c];
      p.tail[i] = 0.f;
    } else {
      p.tail[i] = s.run[c];
    }
  }
}

// The pass at highest on float32 X, float32 products on the CUDA cores
// (route sends high and default, and narrow X at every precision, to
// hier_mma): its text is kept as it was written for every precision, so
// that its instantiations at highest compile to the code they had (at 128
// registers a thread it has no room: a refactor of it spilled).
// kOneTile: one_tile(C, D), the flagship's case (two x buffers, one
// chunk, the gradient tile in registers throughout), compiled apart so
// that none of the other cases' state takes its registers.  kPrec: the
// dot precision.
template <bool kOneTile, int kPrec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    hier_pass(Params p, int nblk) {
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
  stage<false, false>(p, xs, ys, gls, row_begin, min(kRows, N - row_begin), x16, -1);
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
      stage<false, false>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows,
                          gls + (buf ^ 1) * kRows, nrow0, min(kRows, N - nrow0), x16, -1);
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
      stage<false, false>(p, xs, ys, gls, nrow0, min(kRows, N - nrow0), x16, -1);
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

// ---- high and default: the tensor-core pass (hier_mma) --------------------

// (mma_bf16, ldsm_x4, ldsm_x2, hi_pair, lo_pair, x_pairs, mma_prec and
// mma_row: csrc/fused_pass.cuh, shared with B2's b2_mma)

// 16 and 8 bytes from shared memory, loaded where written: volatile, so
// the compiler keeps each load at its use and holds no register for it
// across a loop.
__device__ __forceinline__ uint4 lds_v4(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ uint2 lds_v2(const void* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(smem_addr(p)));
  return v;
}

// The chains of the chunk at k as n-tiles of 8: 1, 2, 4 or 8.
__host__ __device__ inline int chunk_ntiles(int C, int k) {
  const int n8 = ((C - k < kChains ? C - k : kChains) + 7) / 8;
  return n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : 8;
}

// A warp's share of a chunk of nt n-tiles (a constant where the kernel is
// compiled for one).  Logits: mt m-tiles of rows
// (rgi's) by ng n-tiles (cgi's), mt ng = nt, nslot row groups (value
// slots per chain).  Gradient: m-tile mm of the 32-feature chunk by ngg
// n-tiles from gn0, over row slice `slice` of nsl.  Segment sums: lanes
// lanes per chain.
struct MmaShape {
  int ng, mt, cgi, rgi, nslot;
  int ngg, mm, gn0, slice, nsl;
  int lanes;
  __device__ __forceinline__ MmaShape(int nt, int warp) {
    ng = min(nt, 2);
    mt = nt / ng;
    cgi = warp % (nt / ng);
    rgi = warp / (nt / ng);
    nslot = 8 / mt;
    ngg = nt == 8 ? 2 : 1;
    const int ngroups = nt / ngg;
    mm = warp & 1;
    gn0 = ((warp >> 1) % ngroups) * ngg;
    slice = (warp >> 1) / ngroups;
    nsl = 4 / ngroups;
    lanes = 32 / nt;
  }
};

// Segment sums of chunk k's resid (staged values) for hier_mma and
// hier_chunk: thread (chain cl, lane q of nl) sums every nl-th row of
// each run of one group in the sub-tile, in four partial sums, then the
// lanes by a fixed shuffle tree.
template <int kPrec>
__device__ __forceinline__ void segment_sums(const Params& p, const Tiles& s, int nl, int k,
                                             int gbase, const int* glcur) {
  const int t = threadIdx.x;
  const int cl = t / nl, q = t % nl, c = k + cl;
  const float* rp = s.rs + cl * kLd;
  const int nseg = s.misc[0];
  for (int si = 0; si < nseg; ++si) {
    const int r0 = s.segs[si], r1 = s.segs[si + 1];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int r = r0 + q;
    for (; r + 3 * nl < r1; r += 4 * nl) {
      s0 += staged_value<kPrec>(rp[r]);
      s1 += staged_value<kPrec>(rp[r + nl]);
      s2 += staged_value<kPrec>(rp[r + 2 * nl]);
      s3 += staged_value<kPrec>(rp[r + 3 * nl]);
    }
    for (; r < r1; r += nl) s0 += staged_value<kPrec>(rp[r]);
    float sg = (s0 + s1) + (s2 + s3);
    for (int o = nl / 2; o > 0; o >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, o);
    if (q == 0 && c < p.C) add_segment(p, s, c, gbase + glcur[r0], sg);
  }
}

// kNt: the n-tiles of the one chunk, compiled in (1: C <= 8, the NUTS
// legs'; 8: 56 < C <= 64, the flagship's, at default), or 0: read from C.
template <bool kOneTile, int kPrec, bool kNarrow, int kNt>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    hier_mma(Params p, int nblk) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, D = p.D, N = p.N, G = p.G;
  static_assert(kPrec != kHighest || kNarrow, "highest on float32 X is hier_pass's");
  const Layout L = layout_mma(C, D, kPrec);
  const Tiles s = carve(smem, L, p, kOneTile);

  const int cp = kOneTile ? kChains : chains_padded(C);
  const int cb = round4(C);  // row stride of bsh
  const int xbuf = (kOneTile ? kFeat : L.xrows) * kLd;
  const bool two = kOneTile || L.nbuf == 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' row and k index
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const int row_begin = sub0 * kRows, row_end = min(N, sub1 * kRows);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  const int nkd = (D + 15) / 16;  // the logits' k-steps of 16 features
  // narrow X: the packed slot, where it fits and the slab's base is
  // aligned; a kernel with its n-tiles compiled in is launched only so
  // (route), and leaves the plain loads out
  constexpr bool kPlain = kNarrow && kNt == 0;
  const int xsw = !kNarrow ? -1 : !kPlain ? L.words : x16 ? xslot_at(L, D, p.xdt) : -1;

  // the sub-tile at row0 into buffer j
  auto stage_into = [&](int j, int row0) {
    stage<kNarrow, kPlain>(p, s.xs + j * xbuf, s.ys + j * kRows, s.gls + j * kRows, row0,
                           min(kRows, N - row0), x16, xsw);
  };
  // first sub-tile in flight while the block sets up
  stage_into(0, row_begin);
  cp_async_commit();
  begin_block<kPrec>(p, s, L, cp, xbuf, row_begin, row_end);

  // beta's pairs of lane ln for the logits' k-step kd (16 features) and
  // n-tile nt of chunk k: column n = ln / 4 is chain n / 2 + 4 (n % 2); k
  // 2t and 2t+1 (t = ln % 4) are features 16 kd + t and + 4, k 2t+8 and
  // 2t+9 features + 8 and + 12; 0 past D.  bh (and at high bl): b0, b1;
  // at highest bh, bl and bp: b0, b1 of the pieces p0, p1, p2 (split3).
  auto beta_pairs = [&](int k, int nt, int kd, int ln, unsigned (&bh)[2], unsigned (&bl)[2],
                        unsigned (&bp)[2]) {
    const int n = ln >> 2;
    const int c = k + 8 * nt + (n >> 1) + 4 * (n & 1);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 16 * kd + (ln & 3) + 4 * i;
      w[i] = d < D ? __float_as_uint(s.bsh[d * cb + c]) : 0u;
    }
    if constexpr (kPrec == kHighest) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned q[3];
        split3_pairs(w[2 * h], w[2 * h + 1], q);
        bh[h] = q[0];
        bl[h] = q[1];
        bp[h] = q[2];
      }
    } else {
      bh[0] = hi_pair(w[0], w[1]);
      bh[1] = hi_pair(w[2], w[3]);
      bl[0] = lo_pair(w[0], w[1]);
      bl[1] = lo_pair(w[2], w[3]);
    }
  };
  const MmaShape sh0(kNt ? kNt : chunk_ntiles(C, 0), warp);  // one chunk: the block's only shape
  // one tile: beta's pairs for the block in fragment order (L.bfr), one
  // 16-byte load per k-step and n-tile (in registers they spilled); at
  // highest the third piece's in a block of 8-byte entries after them
  const uint4* bfr = reinterpret_cast<const uint4*>(smem + L.bfr);
  const uint2* bfr3 = reinterpret_cast<const uint2*>(bfr + kBetaFragEntries);
  // the narrow 64-chain kernels at highest and high load beta's pairs for
  // each MMA (lds_v4, not hoisted), not for a k-step: they spilled so
  constexpr bool kLazyB = kOneTile && kNarrow && kNt == 8 && kPrec != kDefault;
  if constexpr (kOneTile) {
    __syncthreads();  // beta is staged
    for (int i = t; i < kBetaFragEntries; i += kThreads) {
      const int ln = i % 32, nt = (i / 32) % (kChains / 8), kd = i / (32 * (kChains / 8));
      unsigned bh[2], bl[2], bp[2];
      beta_pairs(0, nt, kd, ln, bh, bl, bp);
      reinterpret_cast<uint4*>(smem + L.bfr)[i] = make_uint4(bh[0], bh[1], bl[0], bl[1]);
      if (kPrec == kHighest) {
        reinterpret_cast<uint2*>(smem + L.bfr + 4 * kBetaFragEntries)[i] = make_uint2(bp[0], bp[1]);
      }
    }
  }

  float vacc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // chains tq + 4 e of n-tile j
  // one tile: the link's run sums of resid (run_sums), segp [run][c][row
  // group]; not on narrow X at highest in the 64-chain case (nt = 8),
  // whose kernel spilled with them.  Decided from the chunk's n-tiles, not
  // from how they were compiled, so that a slab off alignment (launched on
  // the kernel that reads them from C) sums as an aligned one does.
  const bool run_sums =
      kOneTile && !(kNarrow && kPrec == kHighest && (kNt ? kNt : chunk_ntiles(C, 0)) == 8);
  float* segp = kOneTile ? smem + L.segp : nullptr;
  // alpha of the thread's chains at group gprev: with one chunk carried
  // from sub-tile to sub-tile (groups are sorted, so a change of group is
  // rare), else reloaded per chunk
  float av[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  int gprev = -1;
  // the first group of the sub-tile's lane tile, loaded a sub-tile ahead
  int gbase_next = __ldg(p.first_gid + row_begin / p.lane_tile);
  float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  // Logits' k-step kd: the warp's mt x ng tiles of 16 rows by 8 chains
  // take features 16 kd .. 16 kd + 15 (x's words: rows mma_row, features
  // as beta_pairs', 0 past D).
  auto logits_step = [&](const MmaShape& sh, const float* xcur, int kd,
                         const unsigned (&bh)[2][2], const unsigned (&bl)[2][2],
                         const unsigned (&bp)[2][2], float (&acc)[4][2][4]) {
    const int d0 = 16 * kd + tq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < sh.mt) {
        const int r = mma_row(sh.rgi * sh.mt + i, g, 0);
        unsigned w[8];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const bool ok = d0 + 4 * f < D;
          const float* xd = xcur + (d0 + 4 * f) * kLd;
          w[2 * f] = ok ? __float_as_uint(xd[r]) : 0u;
          w[2 * f + 1] = ok ? __float_as_uint(xd[r + 4]) : 0u;
        }
        // a[0] (row g): features d0, d0 + 4; a[1] (row g + 8); a[2], a[3]:
        // features d0 + 8, d0 + 12
        const XPairs x = x_pairs<kPrec, kNarrow>(w[0], w[2], w[1], w[3], w[4], w[6], w[5], w[7]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= sh.ng) continue;
          if constexpr (kLazyB) {  // beta's pairs loaded here, for this MMA only
            const int e = (kd * (kChains / 8) + sh.cgi * sh.ng + j) * 32 + lane;
            const uint4 w4 = lds_v4(bfr + e);
            if constexpr (kPrec == kHighest) {
              const uint2 w2 = lds_v2(bfr3 + e);
              const unsigned b0[3] = {w4.x, w4.z, w2.x}, b1[3] = {w4.y, w4.w, w2.y};
              mma_split3(acc[i][j], x, b0, b1);
            } else {
              mma_prec<kPrec, kNarrow>(acc[i][j], x, w4.x, w4.y, w4.z, w4.w);
            }
          } else if constexpr (kPrec == kHighest) {
            const unsigned b0[3] = {bh[j][0], bl[j][0], bp[j][0]};
            const unsigned b1[3] = {bh[j][1], bl[j][1], bp[j][1]};
            mma_split3(acc[i][j], x, b0, b1);
          } else {
            mma_prec<kPrec, kNarrow>(acc[i][j], x, bh[j][0], bh[j][1], bl[j][0], bl[j][1]);
          }
        }
      }
    }
  };
  // Value partials of chunk k to vsl: the thread's rows by a fixed shuffle
  // tree over g, then one add per (chain, row group), [k][c][slot].
  auto fold_values = [&](const MmaShape& sh, int k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = vacc[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        const int cl = 8 * (sh.cgi * sh.ng + j) + tq + 4 * e;
        if (j < sh.ng && lane < 4) s.vsl[2 * k + cl * sh.nslot + sh.rgi] += v;
        vacc[j][e] = 0.f;
      }
    }
  };
  // The gradient tiles (features f0 + 16 mm + g (+ 8), chains k + 8 (gn0 +
  // j) + 2 tq (+ 1)) to gsl [c][d], one row slice after the other in index
  // order; slice 0 starts the sums when `first`.  Every thread reaches the
  // barriers.
  auto fold_gradient = [&](const MmaShape& sh, int k, int f0, bool first) {
    for (int q = 0; q < sh.nsl; ++q) {
      if (sh.slice == q) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = f0 + 16 * sh.mm + g + 8 * (e >> 1);
            const int c = k + 8 * (sh.gn0 + j) + 2 * tq + (e & 1);
            if (j < sh.ngg && c < C && f < D) {
              float* gp = s.gsl + c * D + f;
              *gp = first && q == 0 ? gacc[j][e] : *gp + gacc[j][e];
            }
            gacc[j][e] = 0.f;
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
    if (!kNarrow) stage_rows<kPrec, kRows, kLd, kThreads>(s.xs + buf * xbuf, D);
    else if (!kPlain || xsw >= 0) widen_slot(p, xsw, s.xs + buf * xbuf, row0, nvalid);
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) stage_into(buf ^ 1, row0 + kRows);
    cp_async_commit();

    const float* xcur = s.xs + buf * xbuf;
    const float* ycur = s.ys + buf * kRows;
    const int* glcur = s.gls + buf * kRows;
    const int gbase = gbase_next;
    if (sub + 1 < sub1) gbase_next = __ldg(p.first_gid + (row0 + kRows) / p.lane_tile);
    find_segments(s, glcur, nvalid);

    for (int k = 0; k < cp; k += kChains) {
      const MmaShape sh = kOneTile ? sh0 : MmaShape(chunk_ntiles(C, k), warp);
      if (!kOneTile) gprev = -1;
      if (k > 0) __syncthreads();  // the previous chunk is done with rs

      // ---- logits on the tensor cores
      float acc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if constexpr (kOneTile) {
#pragma unroll
        for (int kd = 0; kd < 2; ++kd) {
          if (kd < nkd) {
            unsigned bh[2][2], bl[2][2], bp[2][2];
#pragma unroll
            for (int j = 0; j < 2 && !kLazyB; ++j) {
              const int e = (kd * (kChains / 8) + sh.cgi * sh.ng + j) * 32 + lane;
              const uint4 w = bfr[e];
              bh[j][0] = w.x;
              bh[j][1] = w.y;
              bl[j][0] = w.z;
              bl[j][1] = w.w;
              if constexpr (kPrec == kHighest) {
                const uint2 w3 = bfr3[e];
                bp[j][0] = w3.x;
                bp[j][1] = w3.y;
              }
            }
            logits_step(sh, xcur, kd, bh, bl, bp, acc);
          }
        }
      } else {
#pragma unroll 1
        for (int kd = 0; kd < nkd; ++kd) {
          unsigned bh[2][2], bl[2][2], bp[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            beta_pairs(k, sh.cgi * sh.ng + j, kd, lane, bh[j], bl[j], bp[j]);
          logits_step(sh, xcur, kd, bh, bl, bp, acc);
        }
      }

      // ---- link on the accumulators: rows mma_row(M, g, u), chains k +
      // 8 (cgi ng + j) + tq + 4 e
      {
        // one tile: resid's staged values summed per chain over the
        // thread's rows of the sub-tile's first run (group glcur[0]) and of
        // the rest, the segment sums when it has at most two runs
        float sr[2][2][2] = {{{0.f, 0.f}, {0.f, 0.f}}, {{0.f, 0.f}, {0.f, 0.f}}};
        const int gl0 = glcur[0];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= sh.mt) continue;
          const int M = sh.rgi * sh.mt + i;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int r = mma_row(M, g, u);
            const bool valid = r < nvalid;
            const int grp = gbase + glcur[r];
            const bool first = glcur[r] == gl0;
            if (grp != gprev) {
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = k + 8 * (sh.cgi * sh.ng + j) + tq + 4 * e;
                  av[j][e] = j < sh.ng && c < C
                                 ? onehot_operand<kPrec>(__ldg(p.alpha + (size_t)c * G + grp))
                                 : 0.f;
                }
              gprev = grp;
            }
            const float yv = ycur[r], ym1 = yv - 1.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j >= sh.ng) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cl = 8 * (sh.cgi * sh.ng + j) + tq + 4 * e;
                const bool ok = valid && k + cl < C;
                const float l = acc[i][j][2 * u + e] + av[j][e];
                const float ex = __expf(-fabsf(l));
                const float un = 1.f + ex;
                const float v = fmaf(ym1, l, fminf(l, 0.f)) - __logf(un);
                const float sg = __fdividef(l >= 0.f ? 1.f : ex, un);
                vacc[j][e] += ok ? v : 0.f;
                const float w = stage_operand<kPrec>(ok ? yv - sg : 0.f);
                s.rs[cl * kLd + r] = w;
                if (run_sums) {
                  const float sv = staged_value<kPrec>(w);
                  sr[0][j][e] += first ? sv : 0.f;
                  sr[1][j][e] += first ? 0.f : sv;
                }
              }
            }
          }
        }
        if (cp > kChains) fold_values(sh, k);  // more chunks: values to shared memory
        if (run_sums) {  // the run sums over g by a fixed shuffle tree
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float v = sr[q][j][e];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                const int cl = 8 * (sh.cgi * sh.ng + j) + tq + 4 * e;
                if (j < sh.ng && lane < 4) segp[q * 2 * kChains + cl * sh.nslot + sh.rgi] = v;
              }
        }
      }
      __syncthreads();  // resid, the run sums and the segment starts are in place
      if (run_sums && s.misc[0] <= 2) {  // one run or two: their sums in row-group order
        if (t < C) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q < s.misc[0]) {
              float sum = 0.f;
              for (int i = 0; i < sh.nslot; ++i) sum += segp[q * 2 * kChains + t * sh.nslot + i];
              add_segment(p, s, t, gbase + glcur[s.segs[q]], sum);
            }
          }
        }
      } else {
        segment_sums<kPrec>(p, s, sh.lanes, k, gbase, glcur);
      }

      // ---- gradient on the tensor cores: features f0 + 16 mm + 0..15 by
      // chains k + 8 (gn0 + j) + 0..7, over the warp's row slice, 16 rows
      // a step: k 2t and 2t+1 are rows r + t and r + t + 4, k 2t+8 and 2t+9
      // rows r + 8 + t and r + 12 + t
      const int r0 = sh.slice * (kRows / sh.nsl), r1 = r0 + kRows / sh.nsl;
      for (int f0 = 0; f0 < D; f0 += kFeat) {
        // ldmatrix rows: x's matrices j = lane / 8 are features + 8 (j % 2),
        // rows + 4 (j / 2); resid's are chains + 8 (j / 2), rows + 4 (j % 2)
        const float* xa = xcur + (f0 + 16 * sh.mm + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                          4 * (lane >> 4);
        const float* ra = s.rs + (8 * sh.gn0 + (lane & 7) + 8 * (lane >> 4)) * kLd +
                          4 * ((lane >> 3) & 1);
        // highest: the sub-tile's products summed apart and added to gacc in
        // float32 (the tensor cores' sums truncate, and a block's rows in
        // one accumulator drifted past highest's tolerance at N = 1M)
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
        for (int r = r0; r < r1; r += 16) {
          unsigned a0[4], a1[4];
          ldsm_x4(a0, xa + r);
          ldsm_x4(a1, xa + r + 8);
          const XPairs x =
              x_pairs<kPrec, kNarrow>(a0[0], a0[2], a0[1], a0[3], a1[0], a1[2], a1[1], a1[3]);
          if (sh.ngg == 2) {
            unsigned q0[4], q1[4];
            ldsm_x4(q0, ra + r);
            ldsm_x4(q1, ra + r + 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if constexpr (kPrec == kHighest) {  // resid's pieces (split3), built here
                unsigned b0[3], b1[3];
                split3_pairs(q0[2 * j], q0[2 * j + 1], b0);
                split3_pairs(q1[2 * j], q1[2 * j + 1], b1);
                mma_split3(part[j], x, b0, b1);
              } else {
                mma_prec<kPrec, kNarrow>(gacc[j], x, hi_pair(q0[2 * j], q0[2 * j + 1]),
                                         hi_pair(q1[2 * j], q1[2 * j + 1]),
                                         lo_pair(q0[2 * j], q0[2 * j + 1]),
                                         lo_pair(q1[2 * j], q1[2 * j + 1]));
              }
            }
          } else {
            unsigned q0[2], q1[2];
            ldsm_x2(q0, ra + r);
            ldsm_x2(q1, ra + r + 8);
            if constexpr (kPrec == kHighest) {
              unsigned b0[3], b1[3];
              split3_pairs(q0[0], q0[1], b0);
              split3_pairs(q1[0], q1[1], b1);
              mma_split3(part[0], x, b0, b1);
            } else {
              mma_prec<kPrec, kNarrow>(gacc[0], x, hi_pair(q0[0], q0[1]), hi_pair(q1[0], q1[1]),
                                       lo_pair(q0[0], q0[1]), lo_pair(q1[0], q1[1]));
            }
          }
        }
        if constexpr (kPrec == kHighest) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) gacc[j][e] += part[j][e];
        }
        if (!kOneTile) fold_gradient(sh, k, f0, sub == sub0);  // more tiles than one
      }
    }
    if (!two && sub + 1 < sub1) {  // one buffer: the next sub-tile once this one is done
      __syncthreads();
      stage_into(0, row0 + kRows);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // every thread is done with the x buffers

  if (kOneTile) fold_gradient(sh0, 0, 0, true);  // the one tile: gsl overlays the x buffers
  if (cp == kChains) fold_values(sh0, 0);
  __syncthreads();
  end_block(p, s, !kOneTile && L.gsl_global, [&](int c) {
    const int k = c / kChains * kChains;
    const int nslot = MmaShape(chunk_ntiles(C, k), 0).nslot;
    const float* v = s.vsl + 2 * k + (c - k) * nslot;
    float sum = 0.f;
    for (int q = 0; q < nslot; ++q) sum += v[q];
    return sum;
  });
}

// hier_mma's second kernel: gbeta and val a warp per output (lane l adds
// the partials of blocks l, l + 32, ... in order, then a fixed shuffle
// tree), galpha as finish's.
__global__ void mma_finish(Params p, int nblk, float* val, float* gbeta) {
  const int C = p.C;
  const long long ncd = (long long)C * p.D, nw = ncd + C;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 32 * nw) {  // whole warps: 32 nw is a multiple of the warp
    const long long w = i >> 5;
    const int lane = threadIdx.x & 31;
    const float* src = w < ncd ? p.gpart + w : p.vpart + (w - ncd);
    const long long stride = w < ncd ? ncd : C;
    float sum = 0.f;
    for (int b = lane; b < nblk; b += 32) sum += src[b * stride];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      if (w < ncd) gbeta[w] = sum;
      else val[w - ncd] = sum;
    }
    return;
  }
  const long long j = i - 32 * nw;
  if (j < (long long)C * p.G) finish_group(p, nblk, j);
}

// ---- highest on float32 X at C <= 32, D <= 32: the chunk pass (hier_chunk)

// Chains of hier_chunk's one chunk, the smallest of 8, 16 and 32 that
// holds C, or 0: (C, D) is past the chunk pass (C > 32 or D > kFeat).
__host__ __device__ inline int chunk_chains(int C, int D) {
  if (C > 32 || D > kFeat) return 0;
  return C <= 8 ? 8 : C <= 16 ? 16 : 32;
}

// hier_chunk's ring of x buffers: the sub-tile whose gradient is taken,
// the one whose logits are, and one in flight (4, two in flight, was no
// faster at C = 8 and 16 on an H100, and at C = 32 would not leave two
// blocks an SM)
constexpr int kStages = 3;
constexpr int kLdB = kFeat + 4;  // row stride of hier_chunk's beta [c][d]

// hier_chunk's shared memory for a chunk of ch chains, in words: kStages
// x buffers of kFeat rows (rows past D zero), y and local ids [buffer][r];
// by the sub-tile's parity resid [c][r], the segment starts and count and
// the run sums [run][warp][c]; beta [c][d], the value partials [warp][c]
// and the open groups' sums, ids and flags; the gradient partials overlay
// the x buffers after the last sub-tile (gsl).  16,456 words (65,824
// bytes) at ch = 8, 19,200 (76,800) at 16, 24,688 (98,752) at 32: two
// blocks an SM (kTwoPerSm) at every ch.
__host__ __device__ inline Layout layout_chunk(int ch) {
  Layout L;
  L.nbuf = kStages;
  L.xrows = kFeat;
  L.gsl_global = false;
  int o = 0;
  L.xs = o;     o += kStages * kFeat * kLd;
  L.ys = o;     o += kStages * kRows;
  L.gls = o;    o += kStages * kRows;
  L.rs = o;     o += 2 * ch * kLd;
  L.bsh = o;    o += ch * kLdB;
  L.vsl = o;    o += (kThreads / 32) * ch;
  L.run = o;    o += ch;
  L.rung = o;   o += ch;
  L.ishead = o; o += ch;
  L.segs = o;   o += 2 * round4(kRows + 1);
  L.misc = o;   o += 2 * 4;
  L.segp = o;   o += 2 * 2 * (kThreads / 32) * ch;
  L.gsl = L.xs;
  L.bfr = -1;
  L.words = o;
  return L;
}

// The thread mappings of hier_chunk<kCh>, so that no lane works on a
// chain past the chunk.  Logits and link: thread (cg = lane % 8, rg = lane
// / 8 + 4 warp) owns chains cg + 8 i (i < kLC) and rows 4 rg .. 4 rg + 3.
// Gradient: thread (fg = t % 8, gc = t / 8 % kGroups, sl = t / kCh) owns
// 8 chains (chain_of) by 4 features fg + 8 j over the 4-row groups sl +
// kSl q (q < kQuads) of every sub-tile: 32 sums in registers for the whole
// block, 4 loads of x and 8 of resid (float4) for 128 FMAs.  A warp's
// loads of resid meet 32 banks: its chain groups are 2 chains apart and
// its row slices (two at kCh = 16, four at 8) one 4-row group apart.
template <int kCh>
struct ChunkShape {
  static constexpr int kLC = kCh / 8;
  static constexpr int kGroups = kCh / 8;
  static constexpr int kSl = kThreads / kCh;
  static constexpr int kQuads = kRows / 4 / kSl;
  static_assert(kLC * 8 == kCh && 8 * 32 == kThreads && 4 * 32 == kRows, "logits mapping");
  static_assert(kQuads * kSl * 4 == kRows && 8 * 4 == kFeat, "gradient mapping");
  static_assert(kSl * kCh * kFeat <= kStages * kFeat * kLd, "gradient partials fit the x buffers");
  // chain i (< 8) of gradient chain group gc
  __device__ static int chain_of(int gc, int i) { return 2 * gc + (i & 1) + 2 * kGroups * (i >> 1); }
};

// B1 at highest on float32 X for C <= kCh chains and D <= kFeat features:
// one chunk of kCh chains (8, 16 or 32, chunk_chains), one gradient tile,
// with hier_pass's block split, link and segment sums and hier_mma's
// mma_finish (header).  Each product is one float32 FMA on the CUDA cores,
// as in hier_pass; only the order of the sums differs.  One barrier a
// sub-tile: iteration k takes the logits and the link of sub-tile k and
// the segment sums and the gradient of sub-tile k - 1 (resid, the segment
// starts and the run sums by the sub-tile's parity), and copies sub-tile
// k + kStages - 2 into the buffer of k - 2.  Strides: beta's rows kLdB =
// 36 words apart, so that a warp's eight chain groups load from 32 banks;
// the gradient's features fg + 8 j, so that its x loads meet 32 banks
// (kLd = 4 mod 32).
template <int kCh>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) hier_chunk(Params p, int nblk) {
  using K = ChunkShape<kCh>;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, D = p.D, N = p.N, G = p.G;
  const Layout L = layout_chunk(kCh);
  const Tiles s = carve(smem, L, p, true);
  const int xbuf = kFeat * kLd;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const int row_begin = sub0 * kRows, row_end = min(N, sub1 * kRows);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  // sub-tile sub into its buffer, and a group of copies either way (empty
  // past the block), so that every wait counts the same groups.  A whole
  // sub-tile of a slab whose rows start 16-byte aligned (N a multiple of
  // 4) is copied as stage copies it, without its per-copy tests: thread t
  // 16 bytes of x's rows t / 32 + 8 k at row 4 (t % 32), 4 of y or of the
  // local ids.
  const bool whole16 = x16 && (N & 3) == 0;
  auto stage_sub = [&](int sub) {
    if (sub < sub1) {
      const int j = (sub - sub0) % kStages, row0 = sub * kRows;
      if (whole16 && row0 + kRows <= N) {
        float* dst = s.xs + j * xbuf + (t >> 5) * kLd + 4 * (t & 31);
        const float* src = p.xT + (size_t)(t >> 5) * N + row0 + 4 * (t & 31);
        for (int d = t >> 5; d < D; d += kThreads / 32) {
          cp_async16(dst, src);
          dst += (kThreads / 32) * kLd;
          src += (size_t)(kThreads / 32) * N;
        }
        if (t < kRows) cp_async4(s.ys + j * kRows + t, p.y + row0 + t, true);
        else cp_async4(s.gls + j * kRows + t - kRows, p.gl + row0 + t - kRows, true);
      } else {
        stage<false, false>(p, s.xs + j * xbuf, s.ys + j * kRows, s.gls + j * kRows, row0,
                            min(kRows, N - row0), x16, -1);
      }
    }
    cp_async_commit();
  };
  // the arrays of sub-tile sub's parity (resid, segment starts and count)
  auto tiles_of = [&](int sub) {
    Tiles u = s;
    const int par = (sub - sub0) & 1;
    u.rs = s.rs + par * kCh * kLd;
    u.segs = s.segs + par * round4(kRows + 1);
    u.misc = s.misc + par * 4;
    return u;
  };
  auto segp_of = [&](int sub) { return smem + L.segp + ((sub - sub0) & 1) * 2 * kWarps * kCh; };

  // the first sub-tiles in flight while the block sets up: its first and
  // last groups for finish, beta [c][d] (0 past C and D), zeros in the
  // feature rows past D of every buffer, the open group sums
  for (int k = 0; k < kStages - 2; ++k) stage_sub(sub0 + k);
  if (t == 0) {
    p.blo[b] = group_of(p, row_begin);
    p.bhi[b] = group_of(p, row_end - 1);
  }
  for (int i = t; i < kCh * kLdB; i += kThreads) {
    const int c = i / kLdB, d = i - c * kLdB;
    s.bsh[i] = c < C && d < D ? p.beta[(size_t)c * D + d] : 0.f;
  }
  for (int i = t; i < (kFeat - D) * kLd; i += kThreads) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) s.xs[j * xbuf + D * kLd + i] = 0.f;
  }
  for (int c = t; c < kCh; c += kThreads) {
    s.run[c] = 0.f;
    s.rung[c] = group_of(p, row_begin);
    s.ishead[c] = 1;
  }

  const int cg = lane & 7, rg = (lane >> 3) + 4 * warp;  // logits and link
  const int fg = t & 7, gc = (t >> 3) % K::kGroups, sl = t / kCh;  // gradient
  float vacc[K::kLC], av[K::kLC];
  float gacc[8][4];
#pragma unroll
  for (int i = 0; i < K::kLC; ++i) vacc[i] = av[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
  // alpha of the thread's chains at group gprev, carried from sub-tile to
  // sub-tile (groups are sorted, so a change of group is rare); the first
  // group of the sub-tile's lane tile, loaded a sub-tile ahead; the
  // previous sub-tile's first group and local ids of its first and last
  // rows, for its segment sums
  int gprev = -1;
  int gbase_next = __ldg(p.first_gid + row_begin / p.lane_tile);
  int gbase_p = 0, gl0_p = 0, gl1_p = 0;

  for (int sub = sub0; sub <= sub1; ++sub) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3) : "memory");
    __syncthreads();  // sub is in place; sub - 2's buffer, resid and run sums are free
    stage_sub(sub + kStages - 2);

    int gbase = 0, gl0 = 0, gl1 = 0;
    if (sub < sub1) {
      const int buf = (sub - sub0) % kStages;
      const int nvalid = min(kRows, N - sub * kRows);
      const float* xcur = s.xs + buf * xbuf;
      const float* ycur = s.ys + buf * kRows;
      const int* glcur = s.gls + buf * kRows;
      const Tiles cur = tiles_of(sub);
      float* segp = segp_of(sub);
      gbase = gbase_next;
      if (sub + 1 < sub1) gbase_next = __ldg(p.first_gid + (sub + 1) * kRows / p.lane_tile);
      // rows are sorted by group within a lane tile, so the sub-tile holds
      // one or two runs of one group when its last row's local id is at
      // most one past its first's: then the link's run sums are its
      // segment sums
      gl0 = glcur[0];
      gl1 = glcur[nvalid - 1];
      if (gl1 - gl0 > 1) find_segments(cur, glcur, nvalid);

      // ---- logits: chains cg + 8 i, rows 4 rg + j, features in order (the
      // rows and entries past D are zeros)
      float acc[K::kLC][4];
#pragma unroll
      for (int i = 0; i < K::kLC; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // (16 and 32 chains by two steps: 32 whole spilled, 16 whole was slower)
#pragma unroll(kCh == 8 ? kFeat / 4 : 2)
      for (int d0 = 0; d0 < kFeat; d0 += 4) {
        float4 bv[K::kLC], xv[4];
#pragma unroll
        for (int i = 0; i < K::kLC; ++i)
          bv[i] = *reinterpret_cast<const float4*>(s.bsh + (cg + 8 * i) * kLdB + d0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[e] = *reinterpret_cast<const float4*>(xcur + (d0 + e) * kLd + 4 * rg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < K::kLC; ++i) {
            const float bb = e == 0 ? bv[i].x : e == 1 ? bv[i].y : e == 2 ? bv[i].z : bv[i].w;
            acc[i][0] = fmaf(bb, xv[e].x, acc[i][0]);
            acc[i][1] = fmaf(bb, xv[e].y, acc[i][1]);
            acc[i][2] = fmaf(bb, xv[e].z, acc[i][2]);
            acc[i][3] = fmaf(bb, xv[e].w, acc[i][3]);
          }
        }
      }

      // ---- link (hier_pass's), resid to rs [c][r]
      const float4 y4 = *reinterpret_cast<const float4*>(ycur + 4 * rg);
      const int4 g4 = *reinterpret_cast<const int4*>(glcur + 4 * rg);
      const float yy[4] = {y4.x, y4.y, y4.z, y4.w};
      const int gg[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = 4 * rg + j < nvalid;
        const int g = gbase + gg[j];
        if (g != gprev) {
#pragma unroll
          for (int i = 0; i < K::kLC; ++i) {
            const int c = cg + 8 * i;
            av[i] = c < C ? __ldg(p.alpha + (size_t)c * G + g) : 0.f;
          }
          gprev = g;
        }
        const float ym1 = yy[j] - 1.f;
#pragma unroll
        for (int i = 0; i < K::kLC; ++i) {
          const bool ok = valid && cg + 8 * i < C;
          const float l = acc[i][j] + av[i];
          const float e = __expf(-fabsf(l));
          const float u = 1.f + e;
          // y log s(l) + (1 - y) log s(-l) = min(l, 0) + (y - 1) l - log1p(e)
          const float v = fmaf(ym1, l, fminf(l, 0.f)) - __logf(u);
          const float sg = __fdividef(l >= 0.f ? 1.f : e, u);
          vacc[i] += ok ? v : 0.f;
          acc[i][j] = ok ? yy[j] - sg : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < K::kLC; ++i) {
        *reinterpret_cast<float4*>(cur.rs + (cg + 8 * i) * kLd + 4 * rg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      if (gl1 - gl0 <= 1) {
        // one run or two: resid summed per chain over the thread's rows of
        // the first run (local id gl0) and of the rest, in row order (when
        // its four rows are valid and of one group, their sum goes whole
        // to the run); then over the warp's row groups by a fixed shuffle
        // tree
        float sr[2][K::kLC];
        const bool one = 4 * rg + 3 < nvalid && gg[0] == gg[3], first = gg[0] == gl0;
#pragma unroll
        for (int i = 0; i < K::kLC; ++i) {
          if (one) {
            const float sum = ((acc[i][0] + acc[i][1]) + acc[i][2]) + acc[i][3];
            sr[0][i] = first ? sum : 0.f;
            sr[1][i] = first ? 0.f : sum;
          } else {
            sr[0][i] = sr[1][i] = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sr[0][i] += gg[j] == gl0 ? acc[i][j] : 0.f;
              sr[1][i] += gg[j] == gl0 ? 0.f : acc[i][j];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < K::kLC; ++i) {
            float v = sr[q][i];
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 8) segp[(q * kWarps + warp) * kCh + cg + 8 * i] = v;
          }
      }
    }

    if (sub > sub0) {  // sub - 1: its resid, run sums and segment starts are in place
      const int pre = sub - 1;
      const float* xpre = s.xs + ((pre - sub0) % kStages) * xbuf;
      const int* glpre = s.gls + ((pre - sub0) % kStages) * kRows;
      const Tiles prv = tiles_of(pre);
      const float* segp = segp_of(pre);
      if (gl1_p - gl0_p > 1) {
        segment_sums<kHighest>(p, prv, kThreads / kCh, 0, gbase_p, glpre);
      } else if (t >= kThreads - 32 && t - (kThreads - 32) < C) {
        // one run or two: the last warp adds the warps' run sums in order
        const int c = t - (kThreads - 32);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 0 || gl1_p != gl0_p) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += segp[(q * kWarps + w) * kCh + c];
            add_segment(p, s, c, gbase_p + (q ? gl1_p : gl0_p), sum);
          }
        }
      }

      // ---- gradient: chains chain_of(gc, i) by features fg + 8 j, over
      // the 4-row groups sl + kSl q, rows in order
#pragma unroll
      for (int q = 0; q < K::kQuads; ++q) {
        const int r = 4 * (sl + K::kSl * q);
        float4 xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = *reinterpret_cast<const float4*>(xpre + (fg + 8 * j) * kLd + r);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 rv =
              *reinterpret_cast<const float4*>(prv.rs + K::chain_of(gc, i) * kLd + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = gacc[i][j];
            a = fmaf(rv.x, xv[j].x, a);
            a = fmaf(rv.y, xv[j].y, a);
            a = fmaf(rv.z, xv[j].z, a);
            gacc[i][j] = fmaf(rv.w, xv[j].w, a);
          }
        }
      }
    }
    gbase_p = gbase;
    gl0_p = gl0;
    gl1_p = gl1;
  }
  cp_async_wait_all();  // (empty groups; nothing left in flight)
  __syncthreads();      // every thread is done with the x buffers

  // the gradient tiles over the x buffers [sl][c][f], then each entry
  // summed over the row slices in index order; the values: the warp's row
  // groups by a fixed shuffle tree, then the warps in order
  float* part = s.gsl;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(sl * kCh + K::chain_of(gc, i)) * kFeat + fg + 8 * j] = gacc[i][j];
#pragma unroll
  for (int i = 0; i < K::kLC; ++i) {
    float v = vacc[i];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 8) s.vsl[warp * kCh + cg + 8 * i] = v;
  }
  __syncthreads();
  for (int e = t; e < C * D; e += kThreads) {
    const int c = e / D, f = e - c * D;
    float sum = 0.f;
#pragma unroll 8
    for (int q = 0; q < K::kSl; ++q) sum += part[(q * kCh + c) * kFeat + f];
    p.gpart[(size_t)b * C * D + e] = sum;
  }
  end_block(p, s, true, [&](int c) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s.vsl[w * kCh + c];
    return sum;
  });
}

using Kernel = void (*)(Params, int);

// The pass that runs (C, D) at dot precision prec with X stored as xdt,
// and what it takes.  Highest on float32 X is hier_chunk at C <= 32 and
// D <= kFeat (FP32 CUDA cores, one chunk of 8, 16 or 32 chains: nt holds
// its chains / 8), else hier_pass (FP32 CUDA cores, 64-chain chunks);
// high and default, and every precision on narrow X, hier_mma
// (bf16 tensor cores; highest there by split3).  The one-tile cases of 8
// chains, and of 64 at default and on narrow X, have their n-tiles
// compiled in (on float32 X at high the 64-chain case spilled so); a
// narrow case with them is launched only with its slot (the launcher
// sends a slab off 16-byte alignment to the case that reads them from
// C, which keeps the plain loads).  (Python mirror:
// stark_tpu_torch/ops/hier_fused.py:b1_route.)
struct Route {
  bool mma;      // hier_mma, else hier_pass or hier_chunk
  bool chunk;    // hier_chunk
  bool one;      // one_tile(C, D)
  int nt;        // n-tiles compiled in, or 0: read from C
  bool windows;  // a narrow xT copied in flight through the packed slot
  int words;     // shared memory of a block, in words
};

// The n-tiles a one-tile hier_mma case has compiled in (0: read from C).
inline int compiled_nt(int nt, int prec, bool narrow) {
  if (nt == 1) return 1;
  return nt == 8 && (prec == kDefault || narrow) ? 8 : 0;
}

inline Route route(int C, int D, int prec, int xdt) {
  Route r;
  const bool narrow = xdt != kXF32;
  r.mma = prec != kHighest || narrow;
  r.one = one_tile(C, D);
  const int ch = r.mma ? 0 : chunk_chains(C, D);
  r.chunk = ch > 0;
  if (r.chunk) {
    r.nt = ch / 8;
    r.windows = false;
    r.words = layout_chunk(ch).words;
    return r;
  }
  const Layout L = r.mma ? layout_mma(C, D, prec) : layout(C, D);
  const int slot = xslot_at(L, D, xdt);
  r.windows = slot >= 0;
  r.words = L.words + (r.windows ? xslot_words(D, xdt) : 0);
  r.nt = r.mma && r.one && (!narrow || r.windows) ? compiled_nt(chunk_ntiles(C, 0), prec, narrow)
                                                  : 0;
  return r;
}

template <bool kOneTile, bool kNarrow, int kNt>
inline Kernel pick(int prec) {
  if (prec == kHigh) return hier_mma<kOneTile, kHigh, kNarrow, kNt>;
  if (prec == kDefault) return hier_mma<kOneTile, kDefault, kNarrow, kNt>;
  if constexpr (kNarrow) {
    return hier_mma<kOneTile, kHighest, true, kNt>;
  } else {
    return hier_pass<kOneTile, kHighest>;
  }
}

// The kernel of a route.
inline Kernel pick(const Route& r, int prec, int xdt) {
  if (r.chunk) return r.nt == 1 ? hier_chunk<8> : r.nt == 2 ? hier_chunk<16> : hier_chunk<32>;
  if (xdt != kXF32) {
    if (!r.one) return pick<false, true, 0>(prec);
    return r.nt == 1 ? pick<true, true, 1>(prec)
           : r.nt == 8 ? pick<true, true, 8>(prec) : pick<true, true, 0>(prec);
  }
  if (!r.one) return pick<false, false, 0>(prec);
  if (r.nt == 8) return hier_mma<true, kDefault, false, 8>;
  return r.nt == 1 ? pick<true, false, 1>(prec) : pick<true, false, 0>(prec);
}

}  // namespace b1
}  // namespace stark

extern "C" int stark_hier_grouped(
    const float* xT, const float* y, const int* gl, const int* first_gid,
    const float* beta, const float* alpha, float* val, float* gbeta,
    float* galpha, float* scratch, int C, int D, int N, int G, int lane_tile,
    int nblk, int prec, int xdt, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.xdt = xdt;
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
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  stark::carve_scratch(p, scratch, nblk);
  auto s = static_cast<cudaStream_t>(stream);
  stark::b1::Route r = stark::b1::route(C, D, prec, xdt);
  // a narrow slab off 16-byte alignment is loaded plainly, by the kernel
  // that reads its n-tiles from C (the others have no plain loads)
  if (xdt != stark::kXF32 && (reinterpret_cast<uintptr_t>(xT) & 15) != 0) r.nt = 0;
  const size_t bytes = (size_t)r.words * sizeof(float);
  const stark::b1::Kernel kern = stark::b1::pick(r, prec, xdt);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, stark::b1::kThreads, bytes, s>>>(p, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nw = (long long)C * D + C;  // outputs summed across blocks
  const bool warps = r.mma || r.chunk;  // mma_finish: a warp per output
  const long long total = (warps ? 32 * nw : nw) + (long long)C * G;
  const int blocks = (int)((total + stark::b1::kThreads - 1) / stark::b1::kThreads);
  if (warps) {
    stark::b1::mma_finish<<<blocks, stark::b1::kThreads, 0, s>>>(p, nblk, val, gbeta);
  } else {
    stark::finish<true><<<blocks, stark::b1::kThreads, 0, s>>>(p, nblk, val, gbeta);
  }
  return (int)cudaGetLastError();
}

// Shared memory the pass needs per block at (C, D), dot precision prec
// and X stored as xdt, and the most the card `device` gives one block,
// both in bytes.
extern "C" int stark_hier_grouped_smem(int C, int D, int prec, int xdt, int device, int* need,
                                       int* limit) {
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  *need = stark::b1::route(C, D, prec, xdt).words * (int)sizeof(float);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The route (stark::b1::route) of (C, D) at prec with X stored as xdt:
// the pass (0 hier_pass, 1 hier_mma, 2 hier_chunk), one tile or not, the
// n-tiles of 8 chains compiled in (0: read from C), narrow X through the
// packed slot or not, and the block's shared memory in bytes.
extern "C" int stark_hier_grouped_route(int C, int D, int prec, int xdt, int* pass, int* one,
                                        int* nt, int* windows, int* bytes) {
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  const stark::b1::Route r = stark::b1::route(C, D, prec, xdt);
  *pass = r.chunk ? 2 : r.mma ? 1 : 0;
  *one = r.one ? 1 : 0;
  *nt = r.nt;
  *windows = r.windows ? 1 : 0;
  *bytes = r.words * (int)sizeof(float);
  return 0;
}
