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
// Three passes, picked by the launcher from C, D, the dot precision and
// X's storage type (route):
//   b2_chunk  C <= 16 and D <= 32, every precision: one chunk of kCh = 8
//             or 16 chains (the smallest that holds C) and kF = 8, 16 or 32
//             features (the smallest that holds D), each pair compiled
//             apart.  The main paths' narrow shapes run it: config 2's
//             shard axis (S=8, C=8, D=16), the NUTS legs (C=8, D=32,
//             offsets), config 3's offset path (gaussian, C=16, D=8) and
//             zoo_glm's linear regression (gaussian, C=8, D=32).
//   b2_pass   every other (C, D) at highest on float32 X: chunks of
//             kChains = 32 chains and kFeat = 32 features, taken in turn
//             past them, products on the FP32 CUDA cores; the offset-path
//             flagship (C=32, D=32) and everything past 16 chains or 32
//             features.
//   b2_mma    the same (C, D) at high and default, and on narrow X at
//             highest too (split3): b2_pass's chunks, staging and shared
//             memory (on narrow X its own staging, below), both products
//             on the bf16 tensor cores.
// All split the rows alike and end in b2_finish.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32, 4.18e12
// special-function instructions a second at 1,980 MHz):
//   offset-path flagship (C=32, D=32, N=1M, offsets): xT (128 MB), y (4
//     MB) and offsets (128 MB) read, resid (128 MB) written: 388 MB, 116
//     us, against 2 C D N FMAs = 4.1 GFLOP, 61 us: bound by bytes; without
//     offsets (132 MB, 39 us) by the FMAs.
//   config 2's shard axis (S=8 shards of n=125,000 rows, C=8, D=16, no
//     offsets): xT (64 MB) and y (4 MB), 68 MB: 20.3 us, against C D N =
//     128M FMAs twice (256M, 7.6 us) and 3 C N = 24M special-function
//     instructions (5.7 us): bound by bytes.
//   the NUTS legs (C=8, D=32, N=1M, offsets): 196 MB, 58.5 us; config 3's
//     offset path (C=16, D=8, N=100k, gaussian): 16.4 MB, 4.9 us.
//   the offset-path flagship at high and default (b2_mma): the same 388
//     MB (116 us; 132 MB, 39 us without offsets) against the two products
//     on the bf16 tensor cores, 2 C D N = 2.1G multiply-adds a pass (4.1
//     GFLOP, 4.1 us at 989 TFLOP/s; three passes at high, 12.4 us), and
//     the bernoulli link's 3 C N = 96M special-function instructions
//     (23.0 us): bound by bytes at both precisions, with and without
//     offsets.  On the FP32 CUDA cores high's three FMAs a product took
//     183 us by operations alone.
//   the same at highest on narrow X (b2_mma by split3): X at 2 or 1
//     bytes an element, 324 MB (bf16, 96.7 us) or 292 MB (one byte, 87.2
//     us) with offsets, against three passes a product on the tensor
//     cores (12.4 us) and the link's 23.0 us: bound by bytes; without
//     offsets (68 or 36 MB) by the link's special functions.
// b2_pass and b2_chunk keep the CUDA cores fed from registers, and every
// pass keeps the next sub-tile's bytes in flight while one is computed;
// b2_chunk leaves no lane on a chain or feature past its chunk, where
// b2_pass at C=8, D=16 spends 3/4 of its logits, 3/4 of its link and 7/8
// of its gradient on padding.
//
// Shard axis.  With S shards every array gains a leading S axis (beta
// (S, C, D), xT (S, D, N), y (S, N), offsets and resid (S, C, N), val (S,
// C), gbeta (S, C, D)), and one launch serves them all: the grid is (row
// blocks, S), blockIdx.y picks the shard, and each shard's partials sit in
// a region of the scratch buffer of their own, summed by b2_finish within
// the shard only.  The row split of a shard is b2_blocks' at most kBlocks
// / S blocks, so the launch stays about one wave.  b2_pass compiles the
// shard offsets into instantiations of its own (kShards), launched for S
// > 1; b2_chunk takes its shard from blockIdx.y in every launch (0
// without a shard axis).  Either way S = 1 runs the unsharded pass: the
// same code, blocks and sums, so the same bits and time.
//
// Work split.  Block b owns the sub-tiles [b*S/B, (b+1)*S/B) of kRows
// rows (S sub-tiles in all, B = min(kBlocks, S) blocks of 128 threads,
// three resident per SM while a block takes at most 75 KB of shared
// memory and 168 registers a thread: b2_pass at C <= 32, D <= 32 and
// b2_chunk always): one wave, and every block within one sub-tile of the
// others (stark_tpu_torch/ops/logistic_fused.py:b2_blocks computes the
// same split; the launcher refuses any other block count).  Sub-tiles of
// x, y and offsets are copied to shared memory with cp.async.  A row of
// xT or offsets that starts off 16-byte alignment (row c starts at c * N)
// is copied 4 bytes at a time; rows past N are staged as zeros.  X is
// read from device memory once per evaluation and serves every chain.
//
// b2_pass.  While two blocks of two buffers fit on an SM (D <= 32 at C
// <= 32: 73 KB a block) the next sub-tile is copied while the current
// one is computed, one barrier per sub-tile; past that one buffer is
// staged after the sub-tile is done, and past that again the gradient
// sums live in device memory, so widths run as far as one block of the
// rest fits the SM's shared memory (layout below; at C = 32 up to D =
// 327, at C = 64 up to D = 273).  Per sub-tile and chunk of kChains = 32
// chains (at C <= 32 no lane computes a chain past 32):
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
// b2_chunk (Chunk<kCh, kF> holds its compile-time shape).  Two buffers,
// each x [kF][kLd] (rows past D zero), offsets then resid [kCh][kLd] and
// y (27 KB a block at kCh = 8, kF = 16; 53 KB at most), three blocks an
// SM: the next sub-tile is copied while the current one is computed, two
// barriers a sub-tile (rings of three and of up to six stages, which
// kept more of X in flight, were slower on the card, PERF.md).  Per
// sub-tile:
//   logits   thread t computes rows 4 (t / 4) + {0..3} of chains kCh / 4
//            (t % 4) + {0 .. kCh / 4 - 1}: per feature one float4 of x
//            and one float2 (kCh = 8) or float4 (16) of beta for 8 or 16
//            FMAs.
//   link     b2_pass's, on the thread's own rows and chains: at C <= 8
//            eight special-function triples a row, not 32.  With offsets
//            resid goes to device memory straight from the registers (16
//            bytes a thread where the row is aligned and whole, else 4),
//            streaming past L2; rs takes it as the gradient's operand.
//   gradient thread t owns every chain of the chunk and kGF features kGF
//            fg + {0..kGF - 1} (fg = t % kFG, kFG = kF / kGF groups) over
//            the 4-row groups sl + kSl q (sl = t / kFG): per 4 rows kGF
//            float4 of x and kCh of resid for 4 kCh kGF FMAs, kCh kGF = 32
//            sums (16 at kCh = kF = 8) in registers for the whole block.
//            A warp's slices are neighbouring row groups, so its float4
//            loads of a feature row meet 32 banks.
// After the last sub-tile the tiles go to shared memory [slice][c][f]
// over the buffers and each entry is summed over the slices in index order;
// the values over the warp's row groups by a fixed shuffle tree and the
// four warps in order.
//
// Dot precision (STARK_FUSED_PRECISION; kPrec, csrc/fused_pass.cuh), as
// B1 (csrc/hier_grouped.cu) takes it: the reference passes it to the two
// dots beta x and resid x^T.  x is rounded when its sub-tile has landed
// (each thread its own copies, before the barrier; b2_mma: where it
// builds x's pairs), beta when the block stages it, resid where the
// gradient takes it: with offsets resid goes to device memory whole
// (b2_chunk: the link writes it out unrounded and
// rounds its copy in rs; b2_mma: rs holds it unrounded and the gradient
// rounds each word as it builds its pairs).  At high a staged operand is
// a_hi and a_lo packed in one word (the layout and its widths are
// highest's).  b2_chunk takes each product as FMAs on the CUDA cores (one,
// or three at high); b2_mma as bf16 MMAs (below).  The offsets and the
// value sums are not rounded: the reference adds the offsets after its
// dot.
//
// b2_mma (high and default past b2_chunk's shapes, and highest on narrow
// X there) computes both products
// with mma.sync m16n8k16 (bf16 operands, float32 accumulators), chains on
// the MMA's n = 8 side and x the A operand of both:
//   logits^T (rows x chains) = x^T beta^T,
//   gbeta^T (features x chains) = x resid^T.
// Its pieces are B1's hier_mma's (csrc/fused_pass.cuh: mma_bf16, ldsm_x4,
// hi_pair, lo_pair, mma_prec, mma_row).  What its design does, and why:
//   - Shared memory is b2_pass's Layout, its tiers and widths (B2_REFUSED
//     alike): 73 KB a block at C = 32, D = 32, three blocks an SM (on
//     narrow X with one x buffer and two packed slots, layout_x).  beta
//     is staged rounded (a_hi | a_lo in one word) and its pairs built with
//     one byte permute each; x and resid stay float32 in shared memory and
//     are rounded where their pairs are built (round_pairs: one cvt for
//     two a_hi, at high a second for two a_lo), so no thread rewrites the
//     sub-tile before the barrier (rounding x there cost 0.014 ms at C =
//     32 on an H100, PERF.md).  Default is one MMA, x_hi b_hi; high three,
//     x_hi b_hi, x_lo b_hi and x_hi b_lo, the reference's passes in its
//     order, each product exact in float32 and summed in float32, so the
//     kernel and the plain version differ in the order of their sums only.
//     A narrow x has x_lo = 0 and skips its pass.
//   - Warp w owns rows 32 w .. 32 w + 31 of the sub-tile in every phase:
//     the logits' m-tiles 2 w and 2 w + 1 (16 rows each, one after the
//     other, so 16 accumulators are live, not 32) by every n-tile of 8
//     chains (chains padded to 8 within a chunk of 32: C = 17..24 computes
//     24), the link on those accumulators, the store of its rows of resid,
//     and the gradient's two k-steps of 16 rows by every feature m-tile
//     and n-tile (the four warps' tiles added in warp order after the
//     block, or per sub-tile past one tile).  So a warp reads back only
//     the resid it wrote: a __syncwarp, not a barrier, stands between link
//     and gradient, one barrier a sub-tile in all (b2_pass: two; none in
//     the one-tile case on narrow X, whose warps stage their own rows).
//   - Logits: a k-step takes 16 features; x's words by lds.32 at rows
//     mma_row (a warp's loads meet 32 banks at kLd = 132); beta's pairs in
//     registers for the block in the one-tile case (at highest split3's
//     pieces, 48 words a lane), else built per k-step from bsh (at
//     highest per k-step and n-tile: for a k-step's n-tiles at once the
//     shard-axis kernel spilled).  An n-tile's column n is
//     chain n / 2 + 4 (n % 2), so a thread holds rows g and g + 8
//     (mma_row) of chains tq and tq + 4 of each n-tile: its offsets reads
//     and resid writes in rs meet 32 banks.
//   - Link: b2_pass's, with its approximate forms and bounds, on the
//     accumulators in registers; the value sums stay in registers (one
//     tile) and meet by a fixed shuffle tree, then warps 0 and 2, 1 and 3
//     in order.
//   - resid: rs keeps it unrounded; with offsets a warp writes its 32 rows
//     of each chain to device memory, eight lanes a chain (128 bytes, 16 a
//     lane), streaming past L2.
//   - Gradient: x and resid by ldmatrix (row strides of 33 x 16 bytes meet
//     every bank once), each word rounded where its pair is built; feature
//     rows past D computed and never stored.
//   - The one-tile kernels of 25 to 32 chains have their 4 n-tiles
//     compiled in (kNt; on narrow X launched only with the packed slots,
//     whose kernels have no plain loads, and not at highest: with beta's
//     pieces for the block they spilled); the rest read nt at run time.

// X's storage type (STARK_FUSED_X_DTYPE; p.xdt), as B1 takes it
// (csrc/hier_grouped.cu): a bf16, int8 or fp8 xT is read at its width.
// Past b2_chunk's shapes it runs on b2_mma at every precision, copied in
// flight: cp.async has no copy of 1 or 2 bytes, so each warp copies, a
// sub-tile ahead, the aligned 16-byte windows that cover its own rows of
// each feature row (x_window_copy1; 5 of bf16, 3 of one byte; zeros past
// the slab's end, nothing read outside it) into a packed slot, and after
// its own wait widens them into the float32 x buffer (widen_rows), the
// values stage_x4 gave; warp w computes only rows 32 w .. 32 w + 31 in
// every phase, so with y and the first chunk's offsets copied the same
// way it needs no barrier of the block a sub-tile, and one float32 x
// buffer with two packed slots takes the place of two x buffers
// (layout_x: 76,544 bytes a block on bf16 at C = 32, D = 32, three
// blocks an SM).  At high and default the widened x is the parent's, so
// the outputs are bitwise the plain-loads staging's; at highest x enters
// as its own bf16 bits and beta and resid as split3's three exact pieces
// (csrc/fused_pass.cuh), three MMAs a product, each exact in float32 and
// summed in float32, each k-step's gradient products summed apart and
// added to the block's sums in float32 (the tensor cores' sums truncate;
// a block's rows in one accumulator drifted in B1).  A slab whose base
// is off 16-byte alignment (a view), and the widths whose layout has one
// buffer or whose slots leave the tier (layout_x), keep the plain loads of
// stage_x4 (4 elements at once where whole and aligned, else one at a
// time), which are not in flight: the thread waits for them where it
// stages.  b2_chunk stages a narrow X so (a shard's rows start at s * D *
// n elements, so at config 2's n = 125,000 every row of a 1-byte slab
// starts off 4-byte alignment: 125,000 = 8 mod 16).  The offsets, y and
// resid stay float32 and cp.async.  b2_chunk and b2_mma compile the
// narrow X apart (kNarrow), so the float32 ones keep their code.
//
// Every sum runs in a fixed order: per thread in row and feature order
// (in an MMA, the tensor core's own fixed order); the row groups of a
// warp by a fixed shuffle tree; the row slices of the
// gradient and the warps one after the other in index order; across
// blocks in b2_finish, a warp per output whose lanes take every 32nd
// block in order and meet in a fixed shuffle tree.  (A sequential sum
// across the blocks, csrc/fused_pass.cuh's finish, put gbeta 3-5x further
// from the float64 sum than the plain float32 version at N = 40,003, D =
// 32, C = 20.)  No float atomics: repeated launches are bitwise equal.
// Masking is by selects, never by multiplying with a mask (0 * NaN =
// NaN).
#include "fused_pass.cuh"

// Parts (stark_tpu_torch/_build.py:PARTS): compiled with -DSTARK_PART=k
// this source holds part k alone, so that nvcc compiles the parts side
// by side: 0 b2_pass, b2_finish and the C entry points; 1 and 2 b2_chunk
// at 8 chains (float32 X, narrow X), 3 and 4 at 16 chains; 5 and 6
// b2_mma (float32 X, narrow X).  Compiled whole it holds every part.
#ifdef STARK_PART
#define STARK_HOLDS(k) (STARK_PART == (k))
#else
#define STARK_HOLDS(k) 1
#endif

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
  int nbuf;   // y and resid buffers, and x buffers but with a packed slot
  int xrows;  // feature rows of one x buffer
  bool gsl_global;  // gradient sums in the block's slice of gpart
  int xs, ys, rs, bsh, vsl, gsl, words;
  int xslot;  // b2_mma on narrow X copied in flight: the first of two
              // packed slots (xslot_words each), or -1
};

// Words of one packed slot of b2_mma: D feature rows of a narrow
// sub-tile, each as four warps' segments of 32 rows, a segment the
// x_window_chunks(32, size) windows that cover it (5 of bf16, 3 of one
// byte: 2,560 and 1,536 words at D = 32).
__host__ __device__ inline int xslot_words(int D, int xdt) {
  return D * (kThreads / 32) * x_window_chunks(kRows / (kThreads / 32), x_size(xdt)) * 4;
}

// With two buffers, each x buffer holds D rounded up to whole gradient
// chunks, the rows past D zero.  With one, it holds D rows, and the
// gradient's reads of rows past D (at most kFeat - 1 of them) land in ys
// and rs, which nothing writes during the gradient: their products fall
// in accumulators that are never stored.  Either way the gradient's
// operand offsets are constants.  slot > 0 (two buffers only): one x
// buffer and, after everything else, two packed slots of `slot` words.
__host__ __device__ inline Layout layout_with(int C, int D, int nbuf, bool gsl_global,
                                              int slot = 0) {
  Layout L;
  const int cp = chains_padded(C);
  L.nbuf = nbuf;
  L.gsl_global = gsl_global;
  L.xrows = nbuf == 2 ? (D + kFeat - 1) / kFeat * kFeat : D;
  int o = 0;
  L.xs = o;     o += (slot > 0 ? 1 : nbuf) * L.xrows * kLd;  // x sub-tiles [buffer][d][r]
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
  L.xslot = slot > 0 ? o : -1;
  o += 2 * slot;
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

// b2_mma's layout for X stored as xdt: a narrow X takes one float32 x
// buffer and two packed slots in place of the two float32 x buffers where
// the layout has two buffers and the slots keep it in its tier (113 KB
// a block), else `layout`'s.  Each warp widens only the rows it computes
// (32 w .. 32 w + 31), so one x buffer serves every sub-tile: at C = 32,
// D = 32 19,136 words for bf16 (76,544 bytes, three blocks an SM) and
// 17,088 for one byte (68,352 bytes), against float32's 18,240.  The
// widths whose layout has one buffer, and on bf16 a few two-buffer
// widths below them whose slots leave the tier, keep the plain loads
// (stage_x4): C = 17, D >= 60 on bf16 and 65 on one byte; C = 25, 55
// and 62; C = 32, 52; C = 33, 46; C = 64, 33 (every width past one
// chunk) (ops/logistic_fused.py:b2_x_route lists them for any (C, D)).
__host__ __device__ inline Layout layout_x(int C, int D, int xdt) {
  const Layout L = layout(C, D);
  if (xdt == kXF32 || L.nbuf != 2) return L;
  const Layout W = layout_with(C, D, 2, false, xslot_words(D, xdt));
  return W.words * (long long)sizeof(float) <= kTwoPerSm ? W : L;
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

// Start the copies of the offsets of chains k .. k + kC - 1 (those below
// C) for the sub-tile at row0 into rs (kC rows of kLd).
template <int kC = kChains>
__device__ __forceinline__ void stage_offsets(const Params& p, float* rs, int k, int row0,
                                              int nvalid, bool o16) {
  for (int i = threadIdx.x; i < kC * (kRows / 4); i += kThreads) {
    const int cl = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    if (k + cl < p.C && r < nvalid)
      copy4(rs + cl * kLd + r, p.offsets, (size_t)(k + cl) * p.N + row0 + r, nvalid - r, o16);
  }
}

// Start the copies of the sub-tile at row0 (nvalid rows) into one buffer:
// x, y and, with offsets, the first chunk's offsets.  kNarrow: a narrow x
// is loaded and widened here instead (stage_x4), done when the thread
// leaves.  kC: the chains of rs (a chunk's).
template <bool kNarrow, int kC = kChains>
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
  if (p.offsets != nullptr) stage_offsets<kC>(p, rs, 0, row0, nvalid, o16);
}

// b2_mma's narrow X in flight, staged by each warp for its own rows.
// Warp w computes rows 32 w .. 32 w + 31 of a sub-tile in every phase, so
// it copies just those rows of x (kWarpRows of each feature row, as the
// x_window_chunks(kWarpRows, size) aligned 16-byte windows that cover
// them: 5 of bf16, 3 of one byte), of y and of the first chunk's offsets,
// waits for its own copies and widens them: no barrier of the block.
// The launch's slab (S shards of D rows of N elements at xbase, 16-byte
// aligned) is where the windows are taken, not shard_view's advanced
// pointer, so a shard whose rows start off 16 bytes (s D N elements in)
// copies in flight as well.  Row d of shard s starts (s D + d) N
// elements in, and a warp's first row at a multiple of kWarpRows, so the
// head of its segment is ((s D + d) N size) mod 16.
constexpr int kWarpRows = kRows / (kThreads / 32);

__device__ __forceinline__ int x_head(const Params& p, int s, int d) {
  return (int)((((long long)s * p.D + d) * p.N * x_size(p.xdt)) & 15);
}

// Start the copies of this warp's segment of every feature row of shard
// s's sub-tile at row0 (nvalid rows) into `slot`, [d][warp][kNch
// windows]: lane l windows l, l + 32, ... of the warp's D kNch, so that
// neighbouring lanes copy neighbouring windows of a row (zeros past the
// slab's end, nothing read outside it).  Where N size is a multiple of 16
// (every head 0) a row's last window holds none of the segment and is
// not visited.  (A lane to each feature row, its windows in turn, was
// slower with offsets: 0.1590 against 0.1487 ms at high on bf16 X at the
// flagship's width on an H100, PERF.md.)
template <int kSize, int kNch>
__device__ __forceinline__ void copy_windows_in(const Params& p, const void* xbase, int S,
                                                char* slot, long long off0, int nv) {
  constexpr int kStride = x_window_chunks(kWarpRows, kSize);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long slab = (long long)S * p.D * p.N * kSize;
#pragma unroll 1
  for (int i = lane; i < p.D * kNch; i += 32) {
    const int d = i / kNch, j = i - d * kNch;
    x_window_copy1(slot + 16 * (kStride * (4 * d + warp) + j), xbase, kSize, slab,
                   off0 + (long long)d * p.N, nv, j);
  }
}

template <int kSize>
__device__ __forceinline__ void copy_windows_of(const Params& p, const void* xbase, int s, int S,
                                                char* slot, int row0, int nvalid) {
  constexpr int kNch = x_window_chunks(kWarpRows, kSize);
  const int warp = threadIdx.x >> 5;
  const int nv = min(kWarpRows, nvalid - kWarpRows * warp);
  if (nv <= 0) return;
  const long long off0 = (long long)s * p.D * p.N + row0 + kWarpRows * warp;
  if (((long long)p.N * kSize & 15) == 0) {
    copy_windows_in<kSize, kWarpRows * kSize / 16>(p, xbase, S, slot, off0, nv);
  } else {
    copy_windows_in<kSize, kNch>(p, xbase, S, slot, off0, nv);
  }
}

// Widen this warp's segment of every feature row, copied into `slot` as
// kX, into the x buffer xs (the values stage_x4 writes, zeros from nvalid
// on); then a __syncwarp, after which the warp reads its rows.  Where N
// size is a multiple of 16 every segment starts a window (head 0), and a
// whole segment is widened from aligned loads: lane l elements 8 (l % 4)
// .. + 7 of rows l / 4, l / 4 + 8, ..., one 16- (bf16) or 8-byte load
// each.  Else (and for the last, partial segment) lane l elements 4 (l %
// 8) .. + 3 of rows l / 8, l / 8 + 4, ... cut out of the words around
// them (x_window_widen4), the head of row d + 4 from row d's.
template <int kX>
__device__ __forceinline__ void widen_rows_of(const Params& p, int s, const char* slot, float* xs,
                                              int nvalid) {
  constexpr int kSize = kX == kXBf16 ? 2 : 1, kNch = x_window_chunks(kWarpRows, kSize);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = nvalid - kWarpRows * warp;  // <= 0: zeros
  float* xw = xs + kWarpRows * warp;
  if (nv >= kWarpRows && ((long long)p.N * kSize & 15) == 0) {
    const int r = 8 * (lane & 3);
#pragma unroll 2
    for (int d = lane >> 2; d < p.D; d += 8) {
      const char* seg = slot + 16 * kNch * (4 * d + warp) + r * kSize;
      float v[8];
      if constexpr (kSize == 2) {
        const uint4 w = *reinterpret_cast<const uint4*>(seg);
        const unsigned ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = __uint_as_float(ww[e] << 16);
          v[2 * e + 1] = __uint_as_float(ww[e] & 0xffff0000u);
        }
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(seg);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = widen<kX>(((e < 4 ? w.x : w.y) >> (8 * (e & 3))) & 0xffu);
      }
      *reinterpret_cast<float4*>(xw + d * kLd + r) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(xw + d * kLd + r + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
    const int r = 4 * (lane & 7), step = (int)((4LL * p.N * kSize) & 15);
    int head = x_head(p, s, lane >> 3);
#pragma unroll 1
    for (int d = lane >> 3; d < p.D; d += 4) {
      *reinterpret_cast<float4*>(xw + d * kLd + r) =
          x_window_widen4<kX>(slot + 16 * kNch * (4 * d + warp), head, r, nv);
      head = (head + step) & 15;
    }
  }
  __syncwarp();
}

// The warp's part of the sub-tile at row0 (nvalid rows) into slot, ys and
// rs: x's windows, y (thread t row t) and with offsets the first chunk's
// (lane l rows 32 w + 4 (l % 8) of chains l / 8, l / 8 + 4, ...).
__device__ __forceinline__ void stage_warp(const Params& p, const void* xbase, int s, int S,
                                           char* slot, float* ys, float* rs, int row0,
                                           int nvalid, bool o16) {
  if (x_size(p.xdt) == 2) {
    copy_windows_of<2>(p, xbase, s, S, slot, row0, nvalid);
  } else {
    copy_windows_of<1>(p, xbase, s, S, slot, row0, nvalid);
  }
  const int t = threadIdx.x, lane = t & 31;
  cp_async4(ys + t, p.y + row0 + (t < nvalid ? t : 0), t < nvalid);
  const int r = kWarpRows * (t >> 5) + 4 * (lane & 7);
  if (p.offsets != nullptr && r < nvalid) {
    for (int cl = lane >> 3; cl < kChains && cl < p.C; cl += 4) {
      copy4(rs + cl * kLd + r, p.offsets, (size_t)cl * p.N + row0 + r, nvalid - r, o16);
    }
  }
}

__device__ __forceinline__ void widen_rows(const Params& p, int s, const char* slot, float* xs,
                                           int nvalid) {
  switch (p.xdt) {
    case kXBf16: widen_rows_of<kXBf16>(p, s, slot, xs, nvalid); break;
    case kXInt8: widen_rows_of<kXInt8>(p, s, slot, xs, nvalid); break;
    case kXE4M3: widen_rows_of<kXE4M3>(p, s, slot, xs, nvalid); break;
    default: widen_rows_of<kXE5M2>(p, s, slot, xs, nvalid); break;
  }
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

// kShards: S > 1, blockIdx.y the shard.  At highest only (float32
// products; high and default, and narrow X at every precision, run
// b2_mma).
template <bool kOneTile, int kLink, bool kShards>
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
  stage<false>(p, xs, ys, rs, sub0 * kRows, min(kRows, N - sub0 * kRows), x16, o16);
  cp_async_commit();

  for (int i = t; i < D * cb + cp - cb; i += kThreads) {  // beta [d][c]
    const int d = i / cb, c = i - d * cb;
    bsh[i] = d < D && c < C ? p.beta[(size_t)c * D + d] : 0.f;
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
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) {
      const int nrow0 = row0 + kRows;
      stage<false>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows, rs + (buf ^ 1) * rbuf, nrow0,
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
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(bb[i], xx[j], acc[i][j]);
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
      // resid, the gradient's operand and, with offsets, the store's
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* rp = rcur + (4 * cg + i) * kLd + 4 * rg;
        *reinterpret_cast<float4*>(rp) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(rp + kRows / 2) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      if (cp > kChains) fold_values(k);  // more chunks: values to shared memory
      __syncthreads();  // resid is in place

      // ---- resid (C, N) from rcur: a warp per chain row of 128 rows
      if (offs) {
        for (int i = t; i < kChains * (kRows / 4); i += kThreads) {
          const int cl = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
          if (k + cl >= C || r >= nvalid) continue;
          const size_t off = (size_t)(k + cl) * N + row0 + r;
          const float4 v = *reinterpret_cast<const float4*>(rcur + cl * kLd + r);
          if (r16 && (off & 3) == 0 && r + 4 <= nvalid) {
            __stcs(reinterpret_cast<float4*>(p.resid + off), v);
          } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (r + e < nvalid) __stcs(p.resid + off + e, vv[e]);
          }
        }
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
              s = fmaf(rv[i].x, xv.x, s);
              s = fmaf(rv[i].y, xv.y, s);
              s = fmaf(rv[i].z, xv.z, s);
              gacc[i][j] = fmaf(rv[i].w, xv.w, s);
            }
          }
        }
        if (!kOneTile) fold_gradient(k, f0, sub == sub0);  // more tiles than one
      }
    }
    if (!two && sub + 1 < sub1) {  // one buffer: the next sub-tile once this one is done
      __syncthreads();
      const int nrow0 = row0 + kRows;
      stage<false>(p, xs, ys, rs, nrow0, min(kRows, N - nrow0), x16, o16);
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

// ---- Narrow chunks: C <= 16 chains and D <= 32 features (b2_chunk) ----

// Chains of a chunk, features of the gradient chunk: the smallest of 8,
// 16 (32) that holds C (D).  C <= 16 and D <= 32 take b2_chunk; any other
// (C, D) takes b2_pass's 32-chain chunks.
__host__ __device__ inline int chunk_chains(int C) { return C <= 8 ? 8 : C <= 16 ? 16 : kChains; }
__host__ __device__ inline int chunk_features(int D) { return D <= 8 ? 8 : D <= 16 ? 16 : kFeat; }
__host__ __device__ inline bool chunked(int C, int D) { return C <= 16 && D <= kFeat; }

// The compile-time shape of b2_chunk<kCh, kF>: the thread mappings and
// the two buffers of staged sub-tiles.
template <int kCh, int kF>
struct Chunk {
  // logits: thread t owns rows 4 (t / 4) + {0..3}, chains kLC (t % 4) + i
  static constexpr int kLC = kCh / 4;
  // gradient: thread t owns chains 0 .. kCh - 1 and features kGF fg + j
  // (fg = t % kFG) over the 4-row groups sl + kSl q (sl = t / kFG) of
  // every sub-tile: kCh x kGF sums (32, or 16 at kCh = kF = 8)
  static constexpr int kGF = 32 / kCh < kF / 4 ? 32 / kCh : kF / 4;
  static constexpr int kFG = kF / kGF;
  static constexpr int kSl = kThreads / kFG;
  static constexpr int kQuads = kRows / 4 / kSl;
  // one buffer: x [kF][kLd] (rows past D zero), offsets then resid
  // [kCh][kLd], y [kRows]
  static constexpr int kBuf = (kF + kCh) * kLd + kRows;
  static constexpr int kFixed = kF * kCh + 4 * kCh;  // beta [d][c], values [warp][c]
  static constexpr int kWords = 2 * kBuf + kFixed;
  static_assert(kLC * 4 == kCh && kFG * kGF == kF && kSl * kFG == kThreads, "mappings");
  static_assert(kFG >= 4 && kQuads * kSl * 4 == kRows, "row groups");
  static_assert(4 * kWords <= 75 * 1024, "three blocks an SM");
  static_assert(kThreads * kCh * kGF <= 2 * kBuf, "gradient tiles fit over the buffers");
};

__host__ __device__ inline int chunk_words(int C, int D) {
  const int ch = chunk_chains(C), f = chunk_features(D);
  return ch == 8 ? (f == 8 ? Chunk<8, 8>::kWords : f == 16 ? Chunk<8, 16>::kWords
                                                            : Chunk<8, 32>::kWords)
                 : (f == 8 ? Chunk<16, 8>::kWords : f == 16 ? Chunk<16, 16>::kWords
                                                             : Chunk<16, 32>::kWords);
}

// The pass for a chunk of kCh chains (C <= kCh) and kF features (D <= kF):
// one chunk, one gradient tile a thread in registers for the whole block,
// no lane on a chain past the chunk, two buffers: the next sub-tile in
// flight while one is computed.  The shard is blockIdx.y (0 without a
// shard axis: the same code and sums at S = 1).
template <int kCh, int kF, int kLink, int kPrec, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) b2_chunk(Params p, int nblk) {
  using K = Chunk<kCh, kF>;
  extern __shared__ __align__(16) float smem[];
  p = shard_view(p, blockIdx.y, nblk);
  const int C = p.C, D = p.D, N = p.N;
  float* bsh = smem + 2 * K::kBuf;  // beta [d][c], kCh apart
  float* vsl = bsh + kF * kCh;      // value partials [warp][c]
  const bool offs = p.offsets != nullptr;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  const bool o16 = offs && (reinterpret_cast<uintptr_t>(p.offsets) & 15) == 0;
  const bool r16 = offs && (reinterpret_cast<uintptr_t>(p.resid) & 15) == 0;
  auto xs_of = [&](int buf) { return smem + buf * K::kBuf; };
  auto rs_of = [&](int buf) { return smem + buf * K::kBuf + kF * kLd; };
  auto ys_of = [&](int buf) { return smem + buf * K::kBuf + (kF + kCh) * kLd; };
  auto stage_sub = [&](int sub, int buf) {
    const int row0 = sub * kRows;
    stage<kNarrow, kCh>(p, xs_of(buf), ys_of(buf), rs_of(buf), row0, min(kRows, N - row0), x16,
                        o16);
  };

  // the first sub-tile in flight while the block sets up
  stage_sub(sub0, 0);
  cp_async_commit();
  for (int i = t; i < kF * kCh; i += kThreads) {
    const int d = i / kCh, c = i % kCh;
    bsh[i] = d < D && c < C ? stage_operand<kPrec>(p.beta[(size_t)c * D + d]) : 0.f;
  }
  for (int i = t; i < (kF - D) * kLd; i += kThreads) {  // x rows past D, both buffers
    xs_of(0)[D * kLd + i] = 0.f;
    xs_of(1)[D * kLd + i] = 0.f;
  }

  const int cg = t & 3, rg = t >> 2;           // logits and link
  const int fg = t % K::kFG, sl = t / K::kFG;  // gradient
  float vacc[K::kLC];
  float gacc[kCh][K::kGF];
#pragma unroll
  for (int i = 0; i < K::kLC; ++i) vacc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kCh; ++c)
#pragma unroll
    for (int j = 0; j < K::kGF; ++j) gacc[c][j] = 0.f;

  for (int sub = sub0; sub < sub1; ++sub) {
    const int buf = (sub - sub0) & 1;
    const int row0 = sub * kRows;
    const int nvalid = min(kRows, N - row0);
    cp_async_wait_all();  // this thread's copies of sub have landed
    float* xcur = xs_of(buf);
    float* rcur = rs_of(buf);
    const float* ycur = ys_of(buf);
    if (!kNarrow) stage_rows<kPrec, kRows, kLd, kThreads>(xcur, D);
    __syncthreads();  // sub is in place; every thread is done with sub - 1
    if (sub + 1 < sub1) stage_sub(sub + 1, buf ^ 1);  // into the buffer sub - 1 freed
    cp_async_commit();

    // ---- logits: chains kLC cg + i, rows 4 rg + j
    float acc[K::kLC][4];
#pragma unroll
    for (int i = 0; i < K::kLC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    {
      const float* bp = bsh + K::kLC * cg;
      const float* xp = xcur + 4 * rg;
      // (16 chains on a narrow X by two: by four they spilled at 168
      // registers)
#pragma unroll(kCh == 16 && kNarrow ? 2 : 4)
      for (int d = 0; d < D; ++d) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + d * kLd);
        float bb[K::kLC];
        if constexpr (K::kLC == 2) {
          const float2 bv = *reinterpret_cast<const float2*>(bp + d * kCh);
          bb[0] = bv.x;
          bb[1] = bv.y;
        } else {
          const float4 bv = *reinterpret_cast<const float4*>(bp + d * kCh);
          bb[0] = bv.x;
          bb[1] = bv.y;
          bb[2] = bv.z;
          bb[3] = bv.w;
        }
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < K::kLC; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma_staged<kPrec>(bb[i], xx[j], acc[i][j]);
      }
    }

    // ---- link; resid to device memory (offsets) straight from the
    // registers, and staged for the gradient over the offsets in rcur
    {
      const float4 yv = *reinterpret_cast<const float4*>(ycur + 4 * rg);
      const float yy[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < K::kLC; ++i) {
        const int c = K::kLC * cg + i;
        float* rp = rcur + c * kLd + 4 * rg;
        float oo[4] = {0.f, 0.f, 0.f, 0.f};
        if (offs) {
          const float4 ov = *reinterpret_cast<const float4*>(rp);
          oo[0] = ov.x;
          oo[1] = ov.y;
          oo[2] = ov.z;
          oo[3] = ov.w;
        }
        float rr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = 4 * rg + j < nvalid && c < C;
          const float l = offs ? acc[i][j] + oo[j] : acc[i][j];
          float v, res;
          if (kLink == kGaussian) {
            res = yy[j] - l;
            v = res * res;
          } else {
            const float ex = __expf(-fabsf(l));
            const float u = 1.f + ex;
            v = fmaf(yy[j] - 1.f, l, fminf(l, 0.f)) - __logf(u);
            res = yy[j] - __fdividef(l >= 0.f ? 1.f : ex, u);
          }
          vacc[i] += ok ? v : 0.f;
          rr[j] = ok ? res : 0.f;
        }
        const float4 w = make_float4(rr[0], rr[1], rr[2], rr[3]);
        if (offs && c < C) {
          const int r = 4 * rg;
          const size_t off = (size_t)c * N + row0 + r;
          if (r16 && (off & 3) == 0 && r + 4 <= nvalid) {
            __stcs(reinterpret_cast<float4*>(p.resid + off), w);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (r + j < nvalid) __stcs(p.resid + off + j, rr[j]);
          }
        }
        *reinterpret_cast<float4*>(rp) = stage_operand4<kPrec>(w);
      }
    }
    __syncthreads();  // resid is in place

    // ---- gradient: chains 0 .. kCh - 1, features kGF fg + j, 4-row
    // groups sl + kSl q
#pragma unroll
    for (int q = 0; q < K::kQuads; ++q) {
      const int r = 4 * (sl + K::kSl * q);
      float4 xv[K::kGF];
#pragma unroll
      for (int j = 0; j < K::kGF; ++j)
        xv[j] = *reinterpret_cast<const float4*>(xcur + (K::kGF * fg + j) * kLd + r);
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const float4 rv = *reinterpret_cast<const float4*>(rcur + c * kLd + r);
#pragma unroll
        for (int j = 0; j < K::kGF; ++j) {
          float s = gacc[c][j];
          s = fma_staged<kPrec>(rv.x, xv[j].x, s);
          s = fma_staged<kPrec>(rv.y, xv[j].y, s);
          s = fma_staged<kPrec>(rv.z, xv[j].z, s);
          gacc[c][j] = fma_staged<kPrec>(rv.w, xv[j].w, s);
        }
      }
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // every thread is done with the buffers

  // the gradient tiles over the buffers [sl][c][f], then each entry summed
  // over the row slices in index order; the values: the warp's row groups
  // by a fixed shuffle tree, then the four warps in order
  float* part = smem;
#pragma unroll
  for (int c = 0; c < kCh; ++c)
#pragma unroll
    for (int j = 0; j < K::kGF; ++j) part[(sl * kCh + c) * kF + K::kGF * fg + j] = gacc[c][j];
#pragma unroll
  for (int i = 0; i < K::kLC; ++i) {
    float v = vacc[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) vsl[warp * kCh + K::kLC * cg + i] = v;
  }
  __syncthreads();
  for (int e = t; e < C * D; e += kThreads) {
    const int c = e / D, f = e - c * D;
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < K::kSl; ++q) s += part[(q * kCh + c) * kF + f];
    p.gpart[(size_t)b * C * D + e] = s;
  }
  for (int c = t; c < C; c += kThreads) {
    p.vpart[(size_t)b * C + c] = ((vsl[c] + vsl[kCh + c]) + vsl[2 * kCh + c]) + vsl[3 * kCh + c];
  }
}

// ---- high and default: the tensor-core pass (b2_mma) ----------------------

// The chains of chunk k as n-tiles of 8 (1 to 4): the chunk's chains
// padded to a multiple of 8, not to 32.
__host__ __device__ inline int mma_ntiles(int C, int k) {
  return ((C - k < kChains ? C - k : kChains) + 7) / 8;
}

// The chains b2_mma computes at C: 32 for each whole chunk, the last
// padded to a multiple of 8 (csrc's mirror: ops/logistic_fused.py:b2_route).
__host__ __device__ inline int mma_chains(int C) {
  return C / kChains * kChains + (C % kChains + 7) / 8 * 8;
}

// b2_pass at high and default, and at highest on narrow X (split3), with
// both products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 sums), the chains on the MMA's n = 8 side and x the A operand
// of both:
//   logits^T (rows x chains) = x^T beta^T,  gbeta^T (features x chains) = x resid^T.
// Warp w owns rows 32 w .. 32 w + 31 of each sub-tile in both products
// and the link: the logits' m-tiles 2 w and 2 w + 1 (rows mma_row), the
// gradient's two k-steps of 16 rows.  So resid, which the link writes to
// rs over the offsets, is read back by the warp that wrote it: a
// __syncwarp, no barrier, lets the store and the gradient read it (one
// barrier a sub-tile, where b2_pass has two).  rs holds resid unrounded:
// the store writes it whole, with offsets, coalesced (a warp stores four
// chains' 128 bytes at a time), streaming past L2; the gradient rounds
// it as it builds its pairs (round_pairs), each word once, and x too
// (x_round_pairs), where the logits and where the gradient load it.  kOneTile
// (C <= 32, D <= 32): beta's pairs in registers for the block, the
// gradient tile in registers for the block; kNt: its n-tiles compiled
// in (4: 24 < C <= 32; on narrow X at high and default, launched only
// with its packed slots),
// or 0: read from C.  kNarrow: x stored as bf16, int8 or fp8, copied in
// flight through two packed slots (layout_x) where the launch's slab is
// 16-byte aligned, else loaded plainly (stage_x4).
template <bool kOneTile, int kNt, int kLink, bool kShards, int kPrec, bool kNarrow>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) b2_mma(Params p, int nblk) {
  static_assert(kPrec != kHighest || kNarrow, "highest on float32 X runs b2_pass");
  extern __shared__ __align__(16) float smem[];
  const void* xbase = p.xT;  // the launch's slab, every shard's rows
  const int shard = kShards ? blockIdx.y : 0;
  if (kShards) p = shard_view(p, blockIdx.y, nblk);
  const int C = p.C, D = p.D, N = p.N;
  // narrow X through the packed slots (win): the route's choice
  // (route); a kernel with its n-tiles compiled in is launched only so
  // and leaves the plain loads out
  constexpr bool kPlain = kNarrow && kNt == 0;
  // words of beta's pairs a (k-step, n-tile): hi and lo b0, b1, or at
  // highest b0, b1 of each of split3's three pieces
  constexpr int kBW = kPrec == kHighest ? 6 : 4;
  const bool base16 = (reinterpret_cast<uintptr_t>(xbase) & 15) == 0;
  const Layout L = kNarrow && (!kPlain || base16) ? layout_x(C, D, p.xdt) : layout(C, D);
  const bool win = kNarrow && (!kPlain || L.xslot >= 0);
  char* slot = reinterpret_cast<char*>(smem + L.xslot);
  const int slotb = win ? 4 * xslot_words(D, p.xdt) : 0;  // bytes of one slot
  float* xs = smem + L.xs;
  float* ys = smem + L.ys;
  float* rs = smem + L.rs;
  float* bsh = smem + L.bsh;
  float* vsl = smem + L.vsl;
  float* gsl = !kOneTile && L.gsl_global ? p.gpart + (size_t)blockIdx.x * C * D : smem + L.gsl;

  const int cp = kOneTile ? kChains : chains_padded(C);
  const int cb = round4(C);  // row stride of bsh
  const int xbuf = win ? 0 : (kOneTile ? kFeat : L.xrows) * kLd;  // (win: one x buffer)
  const int rbuf = kChains * kLd;
  const bool two = kOneTile || L.nbuf == 2;
  const bool offs = p.offsets != nullptr;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' row and k index
  const int b = blockIdx.x;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  const bool o16 = offs && (reinterpret_cast<uintptr_t>(p.offsets) & 15) == 0;
  const bool r16 = offs && (reinterpret_cast<uintptr_t>(p.resid) & 15) == 0;
  const int nkd = (D + 15) / 16;  // the logits' k-steps of 16 features

  // the sub-tile at row0 into buffer j (win: the warp's rows, x's windows
  // into slot j)
  auto stage_into = [&](int j, int row0) {
    const int nv = min(kRows, N - row0);
    if (win) {
      stage_warp(p, xbase, shard, gridDim.y, slot + j * slotb, ys + j * kRows, rs + j * rbuf,
                 row0, nv, o16);
    } else {
      stage<kNarrow>(p, xs + j * xbuf, ys + j * kRows, rs + j * rbuf, row0, nv, x16, o16);
    }
  };
  // first sub-tile in flight while the block sets up
  stage_into(0, sub0 * kRows);
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

  // beta's pairs of this lane for the logits' k-step kd (16 features) and
  // n-tile j of chunk k: column n = g is chain k + 8 j + n / 2 + 4 (n % 2),
  // so a thread's accumulators hold chains tq and tq + 4 of each n-tile;
  // k 2t and 2t+1 (t = tq) are features 16 kd + t and + 4, k 2t+8 and
  // 2t+9 features + 8 and + 12; 0 past D (bsh's zeros past C).  bp: b0,
  // b1 of hi and lo, or at highest of split3's pieces p0, p1, p2.
  auto beta_pairs = [&](int k, int j, int kd, unsigned (&bp)[kBW]) {
    const int c = k + 8 * j + (g >> 1) + 4 * (g & 1);
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 16 * kd + tq + 4 * i;
      w[i] = d < D ? __float_as_uint(bsh[d * cb + c]) : 0u;
    }
    if constexpr (kPrec == kHighest) {
      unsigned q0[3], q1[3];
      split3_pairs(w[0], w[1], q0);
      split3_pairs(w[2], w[3], q1);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        bp[2 * e] = q0[e];
        bp[2 * e + 1] = q1[e];
      }
    } else {
      bp[0] = hi_pair(w[0], w[1]);
      bp[1] = hi_pair(w[2], w[3]);
      bp[2] = lo_pair(w[0], w[1]);
      bp[3] = lo_pair(w[2], w[3]);
    }
  };
  // c += x . beta at kPrec (highest: x times each piece, mma_split3)
  auto mma_beta = [&](float (&c)[4], const XPairs& x, const unsigned (&bp)[kBW]) {
    if constexpr (kPrec == kHighest) {
      const unsigned b0[3] = {bp[0], bp[2], bp[4]}, b1[3] = {bp[1], bp[3], bp[5]};
      mma_split3(c, x, b0, b1);
    } else {
      mma_prec<kPrec, kNarrow>(c, x, bp[0], bp[1], bp[2], bp[3]);
    }
  };
  const int nt0 = kNt ? kNt : mma_ntiles(C, 0);
  // one tile: beta's pairs for the block, [k-step][n-tile][kBW]
  unsigned bfr[2][4][kBW];
  if constexpr (kOneTile) {
    __syncthreads();  // beta is staged
#pragma unroll
    for (int kd = 0; kd < 2; ++kd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kd < nkd && j < nt0) {
          beta_pairs(0, j, kd, bfr[kd][j]);
        } else {
#pragma unroll
          for (int e = 0; e < kBW; ++e) bfr[kd][j][e] = 0u;
        }
      }
  }

  float vacc[4][2];     // chains k + 8 j + tq + 4 e, the thread's rows
  float gacc[2][4][4];  // features f0 + 16 mm + g + 8 (e / 2), chains k + 8 j + 2 tq + e % 2
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    vacc[j][0] = vacc[j][1] = 0.f;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[mm][j][e] = 0.f;
  }

  // Value partials of chunk k: the thread's rows by a fixed shuffle tree
  // over g, then the warps of half h (0: warps 0 and 1, 1: warps 2 and 3)
  // add theirs to vsl [c][warp % 2]; half 0 adds before a barrier, half
  // 1 after it, so each slot takes warp w, then warp w + 2.
  auto fold_values = [&](int k, int h) {
    if ((warp >> 1) != h) return;  // (warp-uniform: every lane shuffles)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = vacc[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) vsl[(k + 8 * j + tq + 4 * e) * 2 + (warp & 1)] += v;
        vacc[j][e] = 0.f;
      }
  };
  // The gradient tiles to gsl [c][d], one warp (row slice) after the
  // other in index order; warp 0 starts the sums when `first`.  Every
  // thread reaches the barriers.
  auto fold_gradient = [&](int k, int f0, bool first) {
    for (int q = 0; q < kThreads / 32; ++q) {
      if (warp == q) {
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = f0 + 16 * mm + g + 8 * (e >> 1);
              const int c = k + 8 * j + 2 * tq + (e & 1);
              if (c < C && f < D) {
                float* gp = gsl + c * D + f;
                *gp = first && q == 0 ? gacc[mm][j][e] : *gp + gacc[mm][j][e];
              }
              gacc[mm][j][e] = 0.f;
            }
      }
      __syncthreads();
    }
  };

  if (win) __syncthreads();  // beta, the zero rows and vsl are in place
  for (int sub = sub0; sub < sub1; ++sub) {
    const int buf = two ? (sub - sub0) & 1 : 0;
    const int row0 = sub * kRows;
    const int nvalid = min(kRows, N - row0);
    float* xb = xs + buf * xbuf;
    cp_async_wait_all();
    // this sub-tile has landed; the other buffer is free (win: the warp's
    // own rows, which only it reads)
    if (win) __syncwarp(); else __syncthreads();
    if (two && sub + 1 < sub1) stage_into(buf ^ 1, row0 + kRows);
    cp_async_commit();
    if (win) widen_rows(p, shard, slot + buf * slotb, xb, nvalid);  // the warp's rows

    const float* xcur = xb;
    const float* ycur = ys + buf * kRows;
    float* rcur = rs + buf * rbuf;

    for (int k = 0; k < cp; k += kChains) {
      const int nt = kOneTile ? nt0 : mma_ntiles(C, k);
      if (k > 0) {
        __syncthreads();  // the previous chunk is done with rcur
        if (offs) {  // this chunk's offsets (the wait also lands the next sub-tile)
          stage_offsets(p, rcur, k, row0, nvalid, o16);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
        }
      }

      // ---- logits on the tensor cores and the link, one m-tile 2 warp + i
      // (16 rows) at a time (so 16 accumulators are live, not 32): n-tiles
      // j, k-steps of 16 features (x's words 0 past D: in the one tile the
      // buffers' zero rows, else selects); then the link on the
      // accumulators, rows mma_row(2 warp + i, g, u), chains k + 8 j + tq +
      // 4 e, each chain's logit plus its offset from rcur, resid over it,
      // unrounded
#pragma unroll 1
      for (int i = 0; i < 2; ++i) {
        const int r0 = mma_row(2 * warp + i, g, 0);
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // x's pairs of the k-step kd: a[0] (row g): features d0, d0 + 4;
        // a[1] (row g + 8: row r0 + 4); a[2], a[3]: features d0 + 8, d0 + 12
        auto x_step = [&](int kd) {
          const int d0 = 16 * kd + tq;
          unsigned w[8];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const bool ok = kOneTile || d0 + 4 * f < D;
            const float* xd = xcur + (d0 + 4 * f) * kLd;
            w[2 * f] = ok ? __float_as_uint(xd[r0]) : 0u;
            w[2 * f + 1] = ok ? __float_as_uint(xd[r0 + 4]) : 0u;
          }
          return x_round_pairs<kPrec, kNarrow>(w[0], w[2], w[1], w[3], w[4], w[6], w[5], w[7]);
        };
        auto logits_step = [&](int kd, const unsigned (&bp)[4][kBW]) {
          const XPairs x = x_step(kd);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nt) mma_beta(acc[j], x, bp[j]);
        };
        if constexpr (kOneTile) {
#pragma unroll
          for (int kd = 0; kd < 2; ++kd)
            if (kd < nkd) logits_step(kd, bfr[kd]);
        } else if constexpr (kPrec == kHighest) {
          // beta's pieces built for one n-tile at a time (for every n-tile
          // of a k-step at once the shard-axis kernel spilled)
#pragma unroll 1
          for (int kd = 0; kd < nkd; ++kd) {
            const XPairs x = x_step(kd);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nt) continue;
              unsigned bp[kBW];
              beta_pairs(k, j, kd, bp);
              mma_beta(acc[j], x, bp);
            }
          }
        } else {
#pragma unroll 1
          for (int kd = 0; kd < nkd; ++kd) {
            unsigned bp[4][kBW];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < nt) beta_pairs(k, j, kd, bp[j]);
            logits_step(kd, bp);
          }
        }

#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + 4 * u;  // mma_row(2 warp + i, g, u)
          const bool valid = r < nvalid;
          const float yv = ycur[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= nt) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * j + tq + 4 * e;
              const bool ok = valid && k + cl < C;
              float* rp = rcur + cl * kLd + r;
              const float l = offs ? acc[j][2 * u + e] + *rp : acc[j][2 * u + e];
              float v, res;
              if (kLink == kGaussian) {
                res = yv - l;
                v = res * res;
              } else {
                const float ex = __expf(-fabsf(l));
                const float un = 1.f + ex;
                v = fmaf(yv - 1.f, l, fminf(l, 0.f)) - __logf(un);
                res = yv - __fdividef(l >= 0.f ? 1.f : ex, un);
              }
              vacc[j][e] += ok ? v : 0.f;
              *rp = ok ? res : 0.f;
            }
          }
        }
      }
      __syncwarp();  // the warp's resid rows are in place
      if (cp > kChains) {  // more chunks: values to shared memory
        fold_values(k, 0);
        __syncthreads();
        fold_values(k, 1);
      }

      // ---- resid (C, N): the warp's 32 rows of each chain of the chunk,
      // eight lanes a chain (128 bytes), 16 bytes a lane (4 where the
      // row is off alignment)
      if (offs) {
        for (int i = lane; i < nt * 8 * 8; i += 32) {
          const int cl = i >> 3, r = 32 * warp + 4 * (i & 7);
          if (k + cl >= C || r >= nvalid) continue;
          const size_t off = (size_t)(k + cl) * N + row0 + r;
          const float4 v = *reinterpret_cast<const float4*>(rcur + cl * kLd + r);
          if (r16 && (off & 3) == 0 && r + 4 <= nvalid) {
            __stcs(reinterpret_cast<float4*>(p.resid + off), v);
          } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (r + e < nvalid) __stcs(p.resid + off + e, vv[e]);
          }
        }
      }

      // ---- gradient on the tensor cores: features f0 + 16 mm + 0..15 by
      // chains k + 8 j + 0..7 over the warp's rows, 16 a k-step: k 2t and
      // 2t+1 are rows r + t and r + t + 4, k 2t+8 and 2t+9 rows r + 8 + t
      // and r + 12 + t.  ldmatrix rows: x's matrices q = lane / 8 are
      // features + 8 (q % 2), rows + 4 (q / 2); resid's chains + 8 (q / 2),
      // rows + 4 (q % 2) (row strides of 33 x 16 bytes meet every bank
      // once).  Features past D are computed and never stored.
      for (int f0 = 0; f0 < D; f0 += kFeat) {
        const float* xa = xcur + (f0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 4 * (lane >> 4);
        const float* ra = rcur + ((lane & 7) + 8 * (lane >> 4)) * kLd + 4 * ((lane >> 3) & 1);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int r = 32 * warp + 16 * s;
          XPairs x[2];
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            unsigned a0[4], a1[4];
            ldsm_x4(a0, xa + 16 * mm * kLd + r);
            ldsm_x4(a1, xa + 16 * mm * kLd + r + 8);
            x[mm] = x_round_pairs<kPrec, kNarrow>(a0[0], a0[2], a0[1], a0[3], a1[0], a1[2],
                                                  a1[1], a1[3]);
          }
          // (at highest on the shard axis one pair of n-tiles at a time:
          // unrolled, the one-tile kernel spilled)
#pragma unroll(kPrec == kHighest && kShards ? 1 : 2)
          for (int jp = 0; jp < 2; ++jp) {
            if (2 * jp >= nt) continue;
            unsigned q0[4], q1[4];
            ldsm_x4(q0, ra + 16 * jp * kLd + r);
            ldsm_x4(q1, ra + 16 * jp * kLd + r + 8);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = 2 * jp + jj;
              if (j >= nt) continue;
              if constexpr (kPrec == kHighest) {
                // resid's pieces (split3); each k-step's products summed
                // apart and added to gacc in float32 (the tensor cores'
                // sums truncate: a block's rows in one accumulator drift)
                unsigned b0[3], b1[3];
                split3_pairs(q0[2 * jj], q0[2 * jj + 1], b0);
                split3_pairs(q1[2 * jj], q1[2 * jj + 1], b1);
#pragma unroll
                for (int mm = 0; mm < 2; ++mm) {
                  float part[4] = {0.f, 0.f, 0.f, 0.f};
                  mma_split3(part, x[mm], b0, b1);
#pragma unroll
                  for (int e = 0; e < 4; ++e) gacc[mm][j][e] += part[e];
                }
              } else {
                unsigned bh0, bh1, bl0 = 0u, bl1 = 0u;
                round_pairs<kPrec>(q0[2 * jj], q0[2 * jj + 1], bh0, bl0);
                round_pairs<kPrec>(q1[2 * jj], q1[2 * jj + 1], bh1, bl1);
#pragma unroll
                for (int mm = 0; mm < 2; ++mm)
                  mma_prec<kPrec, kNarrow>(gacc[mm][j], x[mm], bh0, bh1, bl0, bl1);
              }
            }
          }
        }
        if (!kOneTile) fold_gradient(k, f0, sub == sub0);  // more tiles than one
      }
    }
    if (!two && sub + 1 < sub1) {  // one buffer: the next sub-tile once this one is done
      __syncthreads();
      stage_into(0, row0 + kRows);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // every thread is done with the buffers

  if (kOneTile) fold_gradient(0, 0, true);  // the one tile: gsl overlays the x buffers
  if (cp == kChains) {
    fold_values(0, 0);
    __syncthreads();
    fold_values(0, 1);
  }
  __syncthreads();

  if (!L.gsl_global) {
    for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gsl[i];
  }
  for (int c = t; c < C; c += kThreads) p.vpart[(size_t)b * C + c] = vsl[2 * c] + vsl[2 * c + 1];
}

using Kernel = void (*)(Params, int);

// The pass that runs (C, D) at dot precision prec with X stored as xdt,
// and what it takes: b2_chunk at C <= 16, D <= 32 (every precision and
// X); past it b2_pass at highest on float32 X (FP32 CUDA cores), b2_mma
// at high and default and, on narrow X, at highest too (split3).  A
// narrow X runs through b2_mma's packed slots where its layout has them
// (layout_x) and the launch's slab is 16-byte aligned (`aligned`), else
// with plain loads.  The one-tile b2_mma kernels of 25 to 32 chains have
// their 4 n-tiles compiled in, on narrow X only with the slots and not at
// highest, whose beta pieces for the block (48 words a lane) spilled so.
// (Python mirror: stark_tpu_torch/ops/logistic_fused.py:b2_x_route.)
struct Route {
  int pass;      // 0 b2_chunk, 1 b2_pass, 2 b2_mma
  int chains;    // chains of a chunk (b2_chunk) or computed (b2_pass, b2_mma)
  bool windows;  // narrow X copied in flight through the packed slots
  int nt;        // b2_mma's n-tiles compiled in, or 0: read from C
  int words;     // shared memory of a block, in words
};

inline Route route(int C, int D, int prec, int xdt, bool aligned) {
  Route r;
  const bool narrow = xdt != kXF32;
  r.windows = false;
  r.nt = 0;
  if (chunked(C, D)) {
    r.pass = 0;
    r.chains = chunk_chains(C);
    r.words = chunk_words(C, D);
    return r;
  }
  r.pass = prec == kHighest && !narrow ? 1 : 2;
  r.chains = r.pass == 1 ? chains_padded(C) : mma_chains(C);
  const Layout L = r.pass == 2 && aligned ? layout_x(C, D, xdt) : layout(C, D);
  r.windows = narrow && L.xslot >= 0;
  r.words = L.words;
  if (r.pass == 2 && one_tile(C, D) && mma_ntiles(C, 0) == 4 &&
      (!narrow || (r.windows && prec != kHighest))) {
    r.nt = 4;
  }
  return r;
}

// b2_pass runs at highest on float32 X only.
template <bool kOneTile, bool kShards>
inline Kernel pick(int link) {
  return link == kGaussian ? b2_pass<kOneTile, kGaussian, kShards>
                           : b2_pass<kOneTile, kBernoulli, kShards>;
}

template <int kCh, int kF, int kPrec, bool kNarrow>
inline Kernel chunk_link(int link) {
  return link == kGaussian ? b2_chunk<kCh, kF, kGaussian, kPrec, kNarrow>
                           : b2_chunk<kCh, kF, kBernoulli, kPrec, kNarrow>;
}

template <int kCh, int kF, bool kNarrow>
inline Kernel chunk_prec(int link, int prec) {
  return prec == kHigh      ? chunk_link<kCh, kF, kHigh, kNarrow>(link)
         : prec == kDefault ? chunk_link<kCh, kF, kDefault, kNarrow>(link)
                            : chunk_link<kCh, kF, kHighest, kNarrow>(link);
}

// b2_chunk<kCh, chunk_features(D), link, prec, kNarrow> over the grid
// (nblk, S): its shared memory allowed, launched; the launch's error.
template <int kCh, bool kNarrow>
int launch_chunk_of(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s) {
  const int f = chunk_features(p.D);
  const Kernel kern = f == 8    ? chunk_prec<kCh, 8, kNarrow>(link, prec)
                      : f == 16 ? chunk_prec<kCh, 16, kNarrow>(link, prec)
                                : chunk_prec<kCh, kFeat, kNarrow>(link, prec);
  const int bytes = chunk_words(p.C, p.D) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nblk, S), kThreads, bytes, s>>>(p, nblk);
  return (int)cudaGetLastError();
}

template <bool kOneTile, int kNt, bool kShards, int kPrec, bool kNarrow>
inline Kernel mma_link(int link) {
  return link == kGaussian ? b2_mma<kOneTile, kNt, kGaussian, kShards, kPrec, kNarrow>
                           : b2_mma<kOneTile, kNt, kBernoulli, kShards, kPrec, kNarrow>;
}

// kSplit3: highest on narrow X; else high or default.
template <bool kOneTile, int kNt, bool kShards, bool kNarrow, bool kSplit3>
inline Kernel mma_prec_of(int link, int prec) {
  if constexpr (kSplit3) {
    return mma_link<kOneTile, kNt, kShards, kHighest, true>(link);
  } else {
    return prec == kHigh ? mma_link<kOneTile, kNt, kShards, kHigh, kNarrow>(link)
                         : mma_link<kOneTile, kNt, kShards, kDefault, kNarrow>(link);
  }
}

// b2_mma's kernel of route r (one tile or not; its n-tiles).
template <bool kShards, bool kNarrow, bool kSplit3>
inline Kernel mma_pick(int C, int D, const Route& r, int link, int prec) {
  if (!one_tile(C, D)) return mma_prec_of<false, 0, kShards, kNarrow, kSplit3>(link, prec);
  if constexpr (!kSplit3) {
    if (r.nt == 4) return mma_prec_of<true, 4, kShards, kNarrow, false>(link, prec);
  }
  return mma_prec_of<true, 0, kShards, kNarrow, kSplit3>(link, prec);
}

// b2_mma on route r over the grid (nblk, S): its shared memory allowed,
// launched; the launch's error.
template <bool kNarrow, bool kSplit3>
int launch_mma_of(const Params& p, const Route& r, int nblk, int S, int link, int prec,
                  cudaStream_t s) {
  const Kernel kern = S > 1 ? mma_pick<true, kNarrow, kSplit3>(p.C, p.D, r, link, prec)
                            : mma_pick<false, kNarrow, kSplit3>(p.C, p.D, r, link, prec);
  const int bytes = r.words * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nblk, S), kThreads, bytes, s>>>(p, nblk);
  return (int)cudaGetLastError();
}

// One entry a part (1-7), defined where its kernels compile.
int launch_chunk8(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s);
int launch_chunk8_narrow(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s);
int launch_chunk16(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s);
int launch_chunk16_narrow(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s);
using MmaLaunch = int (*)(const Params&, const Route&, int, int, int, int, cudaStream_t);
int launch_mma(const Params& p, const Route& r, int nblk, int S, int link, int prec,
               cudaStream_t s);
int launch_mma_narrow(const Params& p, const Route& r, int nblk, int S, int link, int prec,
                      cudaStream_t s);
int launch_mma_split3(const Params& p, const Route& r, int nblk, int S, int link, int prec,
                      cudaStream_t s);
#if STARK_HOLDS(1)
int launch_chunk8(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s) {
  return launch_chunk_of<8, false>(p, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(2)
int launch_chunk8_narrow(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s) {
  return launch_chunk_of<8, true>(p, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(3)
int launch_chunk16(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s) {
  return launch_chunk_of<16, false>(p, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(4)
int launch_chunk16_narrow(const Params& p, int nblk, int S, int link, int prec, cudaStream_t s) {
  return launch_chunk_of<16, true>(p, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(5)
int launch_mma(const Params& p, const Route& r, int nblk, int S, int link, int prec,
               cudaStream_t s) {
  return launch_mma_of<false, false>(p, r, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(6)
int launch_mma_narrow(const Params& p, const Route& r, int nblk, int S, int link, int prec,
                      cudaStream_t s) {
  return launch_mma_of<true, false>(p, r, nblk, S, link, prec, s);
}
#endif
#if STARK_HOLDS(7)
int launch_mma_split3(const Params& p, const Route& r, int nblk, int S, int link, int prec,
                      cudaStream_t s) {
  return launch_mma_of<true, true>(p, r, nblk, S, link, prec, s);
}
#endif

}  // namespace b2
}  // namespace stark

#if STARK_HOLDS(0)
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
  const bool narrow = xdt != stark::kXF32;
  const b2::Route r = b2::route(C, D, prec, xdt, (reinterpret_cast<uintptr_t>(xT) & 15) == 0);
  if (r.pass == 0) {  // C <= 16, D <= 32: b2_chunk
    const int e = r.chains == 8
                      ? (narrow ? b2::launch_chunk8_narrow : b2::launch_chunk8)(p, nblk, S, link,
                                                                                prec, s)
                      : (narrow ? b2::launch_chunk16_narrow : b2::launch_chunk16)(p, nblk, S, link,
                                                                                  prec, s);
    if (e != 0) return e;
  } else if (r.pass == 1) {  // past them at highest on float32 X: b2_pass
    const size_t bytes = (size_t)r.words * sizeof(float);
    const bool one = b2::one_tile(C, D);
    const b2::Kernel kern = S > 1 ? (one ? b2::pick<true, true>(link) : b2::pick<false, true>(link))
                                  : (one ? b2::pick<true, false>(link) : b2::pick<false, false>(link));
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(nblk, S), b2::kThreads, bytes, s>>>(p, nblk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {  // at high and default, and at highest on narrow X: b2_mma
    const b2::MmaLaunch launch = !narrow ? b2::launch_mma
                                 : prec == stark::kHighest ? b2::launch_mma_split3
                                                           : b2::launch_mma_narrow;
    const int e = launch(p, r, nblk, S, link, prec, s);
    if (e) return e;
  }
  const long long warps = ((long long)C * D + C) * S;
  const int blocks = (int)((32 * warps + b2::kThreads - 1) / b2::kThreads);
  if (S > 1) b2::b2_finish<true><<<blocks, b2::kThreads, 0, s>>>(p, nblk, S, val, gbeta);
  else b2::b2_finish<false><<<blocks, b2::kThreads, 0, s>>>(p, nblk, S, val, gbeta);
  return (int)cudaGetLastError();
}

// Shared memory the pass needs per block at (C, D) with X stored as xdt
// (a slab 16-byte aligned, at any precision: the slots are the same),
// and the most the card `device` gives one block, both in bytes.
extern "C" int stark_logistic_batched_smem(int C, int D, int xdt, int device, int* need,
                                           int* limit) {
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  *need = stark::b2::route(C, D, stark::kHigh, xdt, true).words * (int)sizeof(float);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The pass the launcher runs at (C, D) and dot precision prec, and its
// chunks (stark_tpu_torch/ops/logistic_fused.py:b2_chunks and b2_route
// mirror them): route 0 b2_chunk (chains and features its chunk's), 1
// b2_pass, 2 b2_mma (32 and 32); `padded` the chains the pass computes
// (b2_chunk's chunk, b2_pass's C rounded up to 32, b2_mma's last chunk
// rounded up to 8).
extern "C" int stark_logistic_batched_chunks(int C, int D, int prec, int* chains, int* features,
                                             int* route, int* padded) {
  namespace b2 = stark::b2;
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  const bool chunk = b2::chunked(C, D);
  *chains = chunk ? b2::chunk_chains(C) : b2::kChains;
  *features = chunk ? b2::chunk_features(D) : b2::kFeat;
  *route = chunk ? 0 : prec == stark::kHighest ? 1 : 2;
  *padded = chunk ? *chains : *route == 1 ? b2::chains_padded(C) : b2::mma_chains(C);
  return 0;
}
// The route (stark::b2::route) of (C, D) at prec with X stored as xdt,
// its slab 16-byte aligned or not: the pass (0 b2_chunk, 1 b2_pass, 2
// b2_mma), the chains of its chunk or that it computes, narrow X through
// the packed slots or not, the n-tiles compiled in (0: read from C), and
// the block's shared memory in bytes.
extern "C" int stark_logistic_batched_route(int C, int D, int prec, int xdt, int aligned,
                                            int* pass, int* chains, int* windows, int* nt,
                                            int* bytes) {
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  if (!stark::x_code_ok(xdt)) return (int)cudaErrorInvalidValue;
  const stark::b2::Route r = stark::b2::route(C, D, prec, xdt, aligned != 0);
  *pass = r.pass;
  *chains = r.chains;
  *windows = r.windows ? 1 : 0;
  *nt = r.nt;
  *bytes = r.words * (int)sizeof(float);
  return 0;
}
#endif
