// B4: grouped linear mixed model, Gaussian log-likelihood pass over
// group-sorted rows with Q random effects per group, for all chains.
//
// Replaces the TPU kernel stark_tpu/ops/hier_fused.py:
// _make_grouped_lmm_kernel (called through _grouped_lmm_call).  For C
// chains, mu = ic[c] + beta_c . x_n + sum_q z[q, n] u[c, group(n), q] and
// resid = y - mu, it returns the scale-free sums (sigma is applied by the
// caller):
//   ssr    (C,)        sum_n  resid^2
//   sresid (C,)        sum_n  resid            (the intercept gradient)
//   gbeta  (C, D)      sum_n  resid x_n
//   gu     (C, G, Q)   sum_{n in g}  resid z[q, n]   (0 for an id without rows)
// with group(n) = first_gid[n / lane_tile] + gl[n], the reference's layout
// read as is.
//
// Bound on an H100 SXM at BASELINE config 3 (C=16, D=8, Q=2, N=100k,
// G=10k): it must read xT (3.2 MB), zT (0.8 MB), y and gl (0.4 MB each)
// and u (1.28 MB) and write gu (1.28 MB): 7.4 MB, 2.2 us at 3.35 TB/s;
// and it does about 2*C*N*(D+Q) FMAs = 64 MFLOP, 1 us at 67 TFLOP/s.  So
// it is bound by bytes, and at this size by latency: each block's chain
// of dependent loads (rows, then the rows' groups' u) and its two
// launches.  The design shortens that chain and keeps every lane busy.
// (On an H100 80GB HBM3 at 700 W, config 3: 0.0194 ms, of which two
// empty launches take 3.7 us; by knock-outs the second kernel 4.4, the
// group sums 3.3, the beta gradient and value sums 2.1, the u rows 1.5.)
//
// Work split.  Block b owns the sub-tiles [b*S/B, (b+1)*S/B) of kRows
// rows (S sub-tiles in all, B = min(kBlocks, S) blocks of 256 threads,
// three resident per SM while a block takes at most 75 KB of shared
// memory: one wave, every block within one sub-tile of the others;
// stark_tpu_torch/ops/hier_fused.py:b4_blocks computes the same split,
// the launcher refuses any other block count).  Sub-tiles of x, z, y and
// gl are copied to shared memory with cp.async; while two buffers fit in
// 75 KB the next sub-tile is copied while the current one is computed,
// past that one buffer is staged after each sub-tile, and past that again
// the gradient sums live in device memory, so widths run as far as one
// block fits the SM's shared memory.  Rows past N are staged as zeros.  X
// and z are read from device memory once per evaluation.
//
// Chains go in chunks of kCC, one instantiation each for C <= 8, <= 16
// and <= 32 at D <= kFeat (the one-tile kernels: config 3 runs at kCC =
// 16, no lane computes a chain that does not exist, and the chains' lanes
// meet once per block), and a general one in chunks of 32 chains and
// kFeat features.  Every instantiation fits 80 registers a thread (three
// blocks of 256 threads per SM) without spilling, but the one-tile 32-chain
// ones at high and default, which fit 128 (two blocks; blocks_per_sm).
// Per sub-tile:
//   segments warp 0 finds the rows whose group differs from the previous
//            row's, each row's segment, each segment's group, and whether
//            ids are skipped (an id without rows).
//   u        the chunk's rows u[c, group(segment), 0:Q] of the sub-tile's
//            segments are copied to shared memory with cp.async: loads
//            independent of each other, coalesced along (group, q), in
//            flight while the products beta . x run.  (The TPU kernel's
//            counterpart is its per-tile u window, u_tiles, multiplied by
//            a one-hot matrix.)  Staged by segment, not by id range: with
//            ids that have no rows a sub-tile's id range can be wider than
//            its 128 rows.
//   logits   thread (row r, half h) computes kCC/2 chains' mu for row r,
//            at most 8 chains in registers at a time: beta held transposed
//            in shared memory (broadcast float4 loads), then, once the u
//            rows have landed, z . u; resid = y - mu goes to shared memory
//            [chain][row], where ic + beta . x waits for the u rows when
//            a thread takes more than one pass (kCC = 32).
//   sums     thread (chain cl, lane q of kThreads/kCC) accumulates over
//            rows 4q + 4(kThreads/kCC)i: resid x (kFeat features, in two
//            passes of half the features: fewer loads in flight), resid^2
//            and resid.  The lanes of a chain meet in a fixed xor-shuffle
//            tree after the block's last sub-tile (one tile; the gradient
//            sums wait in shared memory between sub-tiles, which frees
//            their registers for the logits: no spills at three blocks per
//            SM) or after each sub-tile (general, added to the block's
//            sums).
//   groups   one work item per (chain, effect, segment), spread over the
//            block's threads, chains fastest so that the lanes of a warp
//            walk the same segment: the sum of resid z over the segment's
//            rows in row order.  A segment strictly inside the sub-tile is a whole
//            group strictly inside the block, written straight to gu.  The
//            first and last segment carry books across sub-tiles: thread
//            (chain, effect) keeps the open group's sum and closes it when
//            its group ends, to gu, or to the block's head partial if it is
//            the block's first group.  After the last sub-tile the open
//            group, the block's last, goes to tail (to head if the block
//            holds one group).
//   zeros    ids without rows between two rows of the block, and between
//            the block's first row and the previous block's last, get
//            gu = 0 from the block; block 0 writes the ids before the first
//            row's group and the last block those after the last row's.
//
// Dot precision (STARK_FUSED_PRECISION; kPrec, csrc/fused_pass.cuh), as
// B1 takes it: the reference passes it to the dots beta x, u_q against
// the one-hot groups, resid x^T and resid z_q against the one-hot groups.
// x is rounded when its sub-tile has landed (each thread its own copies,
// before the barrier), beta when the block stages it, u when the logits
// load it from the staged rows (a loop of its own spilled registers): u
// enters as bf16(u) or u_hi + u_lo and is multiplied by z in float32,
// outside the dot, as there.  resid stays whole in rs (ssr,
// sresid and the group sums read it): before the sums, each thread of the
// sums phase takes resid^2 and resid over its own rows, in the sums'
// order, and stages those rows for the gradient in the u rows' buffer,
// which nothing reads again until the next chunk stages its u rows; the
// gradient reads them there.  The group sums round each product
// resid z_q.  At high a staged x, beta or resid is a_hi and a_lo
// packed in one word (the layout and its widths are highest's) and each
// product is three FMAs.
//
// Second kernel (b4_finish): a warp per entry of gbeta, ssr and sresid,
// whose lanes take every 32nd block in order and meet in a fixed shuffle
// tree (as B2's b2_finish); and one thread per (block, first or last
// group, chain, effect) for the groups that cross block edges: the thread
// of the first block that holds rows of the group adds its head or tail
// and the heads of the following blocks that hold the group, in block
// order.  Every sum runs in a fixed order and there are no float atomics:
// repeated launches are bitwise equal.  Masking is by selects, never by
// multiplying with a mask (0 * NaN = NaN).  No (C, N) array is written.
#include "fused_pass.cuh"

namespace stark {
namespace b4 {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBlocksPerSm = 3;
// blocks per SM that an instantiation is compiled for: three (80 registers
// a thread), but two (128) for the one-tile 32-chain chunks at high and
// default, whose rounding spills at 80 (the grid stays kBlocks, one and a
// half waves of them)
constexpr int blocks_per_sm(int kcc, bool one, int prec) {
  return kcc == 32 && one && prec != kHighest ? 2 : kBlocksPerSm;
}
constexpr int kBlocks = 132 * kBlocksPerSm;  // H100 SXM: 132 SMs
constexpr int kThreePerSm = 75 * 1024;  // most shared memory of a block, in
                                        // bytes, with three blocks on an SM
constexpr int kOnePerSm = 227 * 1024;   // most shared memory of one block
constexpr int kRows = 128;        // rows per staged sub-tile
constexpr int kLd = kRows + 4;    // row stride of the shared tiles (16-byte rows)
constexpr int kFeat = 8;          // features per gradient chunk
constexpr int kWide = 32;         // chains per chunk of the general kernel
static_assert(kThreads == 2 * kRows, "logits mapping: two threads per row");

struct Args {
  const float* xT;         // (D, N)
  const float* zT;         // (Q, N)
  const float* y;          // (N,)
  const int* gl;           // (N,) local group id within the reference tile
  const int* first_gid;    // (N / lane_tile,) first group of each tile
  const float* beta;       // (C, D)
  const float* u;          // (C, G, Q)
  const float* ic;         // (C,)
  float* gu;               // (C, G, Q) output
  int C, D, Q, N, G, lane_tile;
  // per-block partials (carve)
  float* gpart;            // (nblk, C, D)
  float* vpart;            // (nblk, C) sum of resid^2
  float* rpart;            // (nblk, C) sum of resid
  float* head;             // (nblk, C, Q) the block's first group
  float* tail;             // (nblk, C, Q) the block's last group
  int* blo;                // (nblk,) first group of the block
  int* bhi;                // (nblk,) last group of the block
};

// Word offsets of the per-block partials in the caller's scratch buffer,
// in this order, and the total (stark_tpu_torch/ops/hier_fused.py:
// b4_scratch mirrors it).
struct Carve {
  long long gpart, vpart, rpart, head, tail, blo, bhi, words;
};

inline Carve carve(int nblk, int C, int D, int Q) {
  Carve k;
  const long long nc = (long long)nblk * C;
  long long o = 0;
  k.gpart = o; o += nc * D;
  k.vpart = o; o += nc;
  k.rpart = o; o += nc;
  k.head = o;  o += nc * Q;
  k.tail = o;  o += nc * Q;
  k.blo = o;   o += nblk;
  k.bhi = o;   o += nblk;
  k.words = o;
  return k;
}

__host__ __device__ inline bool one_tile(int C, int D) { return C <= 32 && D <= kFeat; }

// Dynamic shared memory, in 4-byte words, every array 16-byte aligned.
struct Layout {
  int nbuf;         // x, z, y and gl buffers
  int xrows;        // feature rows of one x buffer: D rounded up to kFeat, zeros past D
  int segld;        // row stride of the staged u: Q * kCC + 4 (a segment's rows 4 banks apart)
  bool gsl_global;  // gradient sums in the block's slice of gpart
  int segs, sgid, segof, misc, rs, xs, zs, ys, gls, us, bsh, ics, gsl, vsum, rsum, opn, headv,
      bnd, part, words;
};

// kcc chains per chunk and one = one_tile(C, D), which a kernel knows at
// compile time (layout below): the arrays whose size depends on nothing
// else come first, at offsets that are constants there.
__host__ __device__ inline Layout layout_with(int kcc, bool one, int C, int D, int Q, int nbuf,
                                              bool gsl_global) {
  Layout L;
  const int cp = one ? kcc : (C + kcc - 1) / kcc * kcc;
  L.nbuf = nbuf;
  L.gsl_global = gsl_global;
  L.xrows = one ? kFeat : (D + kFeat - 1) / kFeat * kFeat;
  L.segld = Q * kcc + 4;
  int o = 0;
  L.segs = o;   o += round4(kRows + 1);        // segment starts, then nvalid
  L.sgid = o;   o += kRows;                    // group of each segment
  L.segof = o;  o += kRows;                    // segment of each row
  L.misc = o;   o += 4;                        // [0] segments, [1] ids skipped
  L.rs = o;     o += kcc * kLd;                // resid [chain][r]
  L.part = o;   o += one ? kFeat * kThreads : 0;  // a thread's gradient sums [f][thread]
  L.ics = o;    o += cp;                       // intercepts
  L.bsh = o;    o += L.xrows * cp;             // beta [d][c], zeros past D and C
  L.ys = o;     o += nbuf * kRows;             // y [buffer][r]
  L.gls = o;    o += nbuf * kRows;             // local group ids [buffer][r]
  L.xs = o;     o += nbuf * L.xrows * kLd;     // x sub-tiles [buffer][d][r]
  L.zs = o;     o += nbuf * Q * kLd;           // z sub-tiles [buffer][q][r]
  L.us = o;     o += kRows * L.segld;          // u [segment][q][chain]
  L.opn = o;    o += round4(cp * Q);           // open group's sums [c][q]
  L.headv = o;  o += round4(cp * Q);           // the block's first group [c][q]
  L.bnd = o;    o += round4(2 * kcc * Q);      // first, last segment's sums [2][chain][q]
  L.gsl = -1;
  if (!one && !gsl_global) {
    L.gsl = o;  o += round4(C * D);            // gradient sums [c][d]
  }
  L.vsum = o;   o += one ? 0 : cp;             // sum of resid^2 (general)
  L.rsum = o;   o += one ? 0 : cp;             // sum of resid (general)
  L.words = o;
  return L;
}

// Two buffers while three blocks still fit on an SM, else one; the
// gradient sums in device memory (L2) when one block would not fit with
// them in shared memory.
template <int kcc, bool one>
__host__ __device__ inline Layout layout_of(int C, int D, int Q) {
  const Layout two = layout_with(kcc, one, C, D, Q, 2, false);
  if (two.words * (long long)sizeof(float) <= kThreePerSm) return two;
  const Layout single = layout_with(kcc, one, C, D, Q, 1, false);
  if (single.words * (long long)sizeof(float) <= kOnePerSm || one) return single;
  return layout_with(kcc, one, C, D, Q, 1, true);
}

__host__ __device__ inline Layout layout(int C, int D, int Q) {
  if (!one_tile(C, D)) return layout_of<kWide, false>(C, D, Q);
  return C <= 8 ? layout_of<8, true>(C, D, Q)
         : C <= 16 ? layout_of<16, true>(C, D, Q) : layout_of<32, true>(C, D, Q);
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

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// Start the copies of the sub-tile at row0 (nvalid rows) into one buffer.
__device__ __forceinline__ void stage(const Args& p, float* xs, float* zs, float* ys, int* gls,
                                      int row0, int nvalid, bool x16, bool z16) {
  const int t = threadIdx.x;
  for (int i = t; i < p.D * (kRows / 4); i += kThreads) {
    const int d = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    copy4(xs + d * kLd + r, p.xT, (size_t)d * p.N + row0 + r, nvalid - r, x16);
  }
  for (int i = t; i < p.Q * (kRows / 4); i += kThreads) {
    const int e = i / (kRows / 4), r = (i % (kRows / 4)) * 4;
    copy4(zs + e * kLd + r, p.zT, (size_t)e * p.N + row0 + r, nvalid - r, z16);
  }
  if (t < kRows) {
    cp_async4(ys + t, p.y + row0 + (t < nvalid ? t : 0), t < nvalid);
  } else {
    const int r = t - kRows;
    cp_async4(gls + r, p.gl + row0 + (r < nvalid ? r : 0), r < nvalid);
  }
}

__device__ __forceinline__ int group_at(const Args& p, int n) {
  return __ldg(p.first_gid + n / p.lane_tile) + __ldg(p.gl + n);
}

// gu = 0 for the ids after `from` and before `to`, every chain and effect
__device__ __forceinline__ void zero_ids(const Args& p, int from, int to) {
  const long long nid = (long long)(to - from - 1);
  if (nid <= 0) return;
  const long long total = nid * p.C * p.Q;
  for (long long i = threadIdx.x; i < total; i += kThreads) {
    const int e = (int)(i % p.Q);
    const long long j = i / p.Q;
    const int h = from + 1 + (int)(j % nid), c = (int)(j / nid);
    p.gu[((size_t)c * p.G + h) * p.Q + e] = 0.f;
  }
}

// Sum over the kLanes lanes of a chain (neighbours in the warp) by a
// fixed xor tree; every lane of the chain ends with the same bits.
template <int kLanes>
__device__ __forceinline__ float lane_sum(float s) {
#pragma unroll
  for (int m = kLanes / 2; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// kCC: chains per chunk.  kOneTile: one_tile(C, D), one chunk of chains
// (C <= kCC) and of features: the chains' lanes meet once per block.
// kPrec: the dot precision.
template <int kCC, bool kOneTile, int kPrec>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kCC, kOneTile, kPrec)) b4_pass(Args p, int nblk) {
  constexpr int kHalf = kCC / 2;             // chains per thread in the logits
  constexpr int kLanes = kThreads / kCC;     // threads per chain in the sums
  static_assert(kLanes >= kFeat && kLanes <= 32, "a lane per feature, within one warp");
  static_assert(kHalf % 4 == 0, "float4 reads of beta, u");
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, D = p.D, Q = p.Q, N = p.N, G = p.G;
  const Layout L = layout_of<kCC, kOneTile>(C, D, Q);
  float* xs = smem + L.xs;
  float* zs = smem + L.zs;
  float* ys = smem + L.ys;
  int* gls = reinterpret_cast<int*>(smem + L.gls);
  float* rs = smem + L.rs;
  float* us = smem + L.us;
  float* bsh = smem + L.bsh;
  float* ics = smem + L.ics;
  float* vsum = smem + L.vsum;
  float* rsum = smem + L.rsum;
  float* opn = smem + L.opn;
  float* headv = smem + L.headv;
  float* bnd = smem + L.bnd;
  int* segs = reinterpret_cast<int*>(smem + L.segs);
  int* sgid = reinterpret_cast<int*>(smem + L.sgid);
  int* segof = reinterpret_cast<int*>(smem + L.segof);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  const int b = blockIdx.x;
  float* gsl = kOneTile ? nullptr
               : L.gsl_global ? p.gpart + (size_t)b * C * D : smem + L.gsl;

  const int cp = kOneTile ? kCC : (C + kCC - 1) / kCC * kCC;
  const int xrows = kOneTile ? kFeat : L.xrows;
  const int xbuf = xrows * kLd, zbuf = Q * kLd;
  const bool two = L.nbuf == 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long nsub = (N + kRows - 1) / kRows;
  const int sub0 = (int)(b * nsub / nblk), sub1 = (int)((b + 1) * nsub / nblk);
  const int row_begin = sub0 * kRows;
  const bool x16 = (reinterpret_cast<uintptr_t>(p.xT) & 15) == 0;
  const bool z16 = (reinterpret_cast<uintptr_t>(p.zT) & 15) == 0;

  // first sub-tile in flight while the block sets up
  stage(p, xs, zs, ys, gls, row_begin, min(kRows, N - row_begin), x16, z16);
  cp_async_commit();

  for (int i = t; i < xrows * cp; i += kThreads) {
    const int d = i / cp, c = i - d * cp;
    bsh[i] = d < D && c < C ? stage_operand<kPrec>(p.beta[(size_t)c * D + d]) : 0.f;
  }
  for (int c = t; c < cp; c += kThreads) ics[c] = c < C ? p.ic[c] : 0.f;
  for (int i = t; i < cp * Q; i += kThreads) {
    opn[i] = 0.f;
    headv[i] = 0.f;
  }
  for (int i = t; i < (xrows - D) * kLd; i += kThreads) {  // padded feature rows
    xs[D * kLd + i] = 0.f;
    if (two) xs[xbuf + D * kLd + i] = 0.f;
  }
  if (!kOneTile) {
    for (int i = t; i < C * D; i += kThreads) gsl[i] = 0.f;
    for (int c = t; c < cp; c += kThreads) {
      vsum[c] = 0.f;
      rsum[c] = 0.f;
    }
  }
  const int gfirst = group_at(p, row_begin);  // the block's first group
  int prevg = b == 0 ? -1 : group_at(p, row_begin - 1);  // the row before the sub-tile
  int openg = gfirst;  // group whose sums opn holds

  // sums mapping: thread (chain cl, lane q).  One tile: the thread's
  // gradient sums over the block's sub-tiles wait in shared memory (part)
  // between the sums phases, and the value and resid sums in registers.
  const int scl = t / kLanes, sq = t % kLanes;
  float* part = smem + L.part;
  if (kOneTile) {
    for (int f = 0; f < kFeat; ++f) part[f * kThreads + t] = 0.f;
  }
  float vacc = 0.f, racc = 0.f;

  for (int sub = sub0; sub < sub1; ++sub) {
    const int buf = two ? (sub - sub0) & 1 : 0;
    const int row0 = sub * kRows;
    const int nvalid = min(kRows, N - row0);
    cp_async_wait_all();
    stage_rows<kPrec, kRows, kLd, kThreads>(xs + buf * xbuf, D);
    __syncthreads();  // this sub-tile has landed; the last one's readers are done
    const float* xcur = xs + buf * xbuf;
    const float* zcur = zs + buf * zbuf;
    const float* ycur = ys + buf * kRows;
    const int* glcur = gls + buf * kRows;
    // a sub-tile lies inside one lane tile (lane_tile is a multiple of kRows)
    const int gbase = __ldg(p.first_gid + row0 / p.lane_tile);

    if (warp == 0) {  // segments: rows whose group differs from the previous row's
      int nseg = 0;
      bool skip = false;
      for (int r0 = 0; r0 < kRows; r0 += 32) {
        const int r = r0 + lane;
        const bool ok = r < nvalid;
        const int g = gbase + glcur[r];
        const int gp = r == 0 ? prevg : gbase + glcur[r - 1];
        const bool flag = ok && (r == 0 || g != gp);
        skip = skip || (ok && g - gp > 1);
        const unsigned ball = __ballot_sync(0xffffffffu, flag);
        if (flag) {
          const int s = nseg + __popc(ball & ((1u << lane) - 1u));
          segs[s] = r;
          sgid[s] = g;
        }
        segof[r] = nseg + __popc(ball & ((2u << lane) - 1u)) - 1;  // rows past nvalid: the last
        nseg += __popc(ball);
      }
      skip = __any_sync(0xffffffffu, skip);
      if (lane == 0) {
        segs[nseg] = nvalid;
        misc[0] = nseg;
        misc[1] = skip;
      }
    }
    __syncthreads();
    const int nseg = misc[0];

    for (int k = 0; k < cp; k += kCC) {
      if (k > 0) __syncthreads();  // the last chunk is done with us, rs and bnd

      // ---- u rows of the sub-tile's groups for chains k .. k + kCC - 1
      for (int i = t; i < kCC * nseg * Q; i += kThreads) {
        const int e = i % Q, s = (i / Q) % nseg, cl = i / (Q * nseg);
        const bool ok = k + cl < C;
        cp_async4(us + s * L.segld + e * kCC + cl,
                  p.u + (ok ? ((size_t)(k + cl) * G + sgid[s]) * Q + e : 0), ok);
      }
      cp_async_commit();
      if (k == 0) {
        if (two && sub + 1 < sub1) {  // the next sub-tile, into the other buffer
          const int nrow0 = row0 + kRows;
          stage(p, xs + (buf ^ 1) * xbuf, zs + (buf ^ 1) * zbuf, ys + (buf ^ 1) * kRows,
                gls + (buf ^ 1) * kRows, nrow0, min(kRows, N - nrow0), x16, z16);
        }
        cp_async_commit();
        if (misc[1]) {  // ids without rows before a segment's group
          for (int s = 0; s < nseg; ++s) zero_ids(p, s == 0 ? prevg : sgid[s - 1], sgid[s]);
        }
      }

      // ---- logits: thread (row r, half h), chains k + h kHalf + j, kPass
      // of them in registers at a time; with more than one pass, ic +
      // beta . x waits in rs while the u rows land
      {
        constexpr int kPass = kHalf < 8 ? kHalf : 8;
        const int r = t & (kRows - 1), h = t / kRows;
        float* rcol = rs + h * kHalf * kLd + r;  // this thread's entries, a chain apart by kLd
        float acc[kPass];
#pragma unroll 1
        for (int j0 = 0; j0 < kHalf; j0 += kPass) {
          const float* bp = bsh + k + h * kHalf + j0;
#pragma unroll
          for (int j = 0; j < kPass; j += 4) {
            const float4 iv = *reinterpret_cast<const float4*>(ics + k + h * kHalf + j0 + j);
            acc[j] = iv.x;
            acc[j + 1] = iv.y;
            acc[j + 2] = iv.z;
            acc[j + 3] = iv.w;
          }
#pragma unroll 1
          for (int d = 0; d < D; ++d) {
            const float xv = xcur[d * kLd + r];
#pragma unroll
            for (int j = 0; j < kPass; j += 4) {
              const float4 bv = *reinterpret_cast<const float4*>(bp + d * cp + j);
              acc[j] = fma_staged<kPrec>(bv.x, xv, acc[j]);
              acc[j + 1] = fma_staged<kPrec>(bv.y, xv, acc[j + 1]);
              acc[j + 2] = fma_staged<kPrec>(bv.z, xv, acc[j + 2]);
              acc[j + 3] = fma_staged<kPrec>(bv.w, xv, acc[j + 3]);
            }
          }
          if (kPass < kHalf) {
#pragma unroll
            for (int j = 0; j < kPass; ++j) rcol[(j0 + j) * kLd] = acc[j];
          }
        }
        if (k == 0) cp_async_wait_one();  // u, not the next sub-tile
        else cp_async_wait_all();
        __syncthreads();  // the u rows have landed
        const float* up = us + segof[r] * L.segld + h * kHalf;
        const bool valid = r < nvalid;
        const float yv = ycur[r];
#pragma unroll 1
        for (int j0 = 0; j0 < kHalf; j0 += kPass) {
          if (kPass < kHalf) {
#pragma unroll
            for (int j = 0; j < kPass; ++j) acc[j] = rcol[(j0 + j) * kLd];
          }
          for (int e = 0; e < Q; ++e) {
            const float zv = zcur[e * kLd + r];
#pragma unroll
            for (int j = 0; j < kPass; j += 4) {
              const float4 uv = *reinterpret_cast<const float4*>(up + e * kCC + j0 + j);
              acc[j] = fmaf(zv, onehot_operand<kPrec>(uv.x), acc[j]);
              acc[j + 1] = fmaf(zv, onehot_operand<kPrec>(uv.y), acc[j + 1]);
              acc[j + 2] = fmaf(zv, onehot_operand<kPrec>(uv.z), acc[j + 2]);
              acc[j + 3] = fmaf(zv, onehot_operand<kPrec>(uv.w), acc[j + 3]);
            }
          }
#pragma unroll
          for (int j = 0; j < kPass; ++j) {
            const bool ok = valid && k + h * kHalf + j0 + j < C;
            rcol[(j0 + j) * kLd] = ok ? yv - acc[j] : 0.f;
          }
        }
      }
      __syncthreads();  // resid is in place

      // ---- sums: thread (chain scl, lane sq); rows 4 sq + 4 kLanes i
      {
        const float* rp = rs + scl * kLd;
        if (kPrec != kHighest) {
          // resid^2 and resid in the same order as below, and the thread's
          // resid rows staged for the gradient in the u rows' buffer
          float* qp = us + scl * kLd;
#pragma unroll 1
          for (int r = 4 * sq; r < kRows; r += 4 * kLanes) {
            const float4 rv = *reinterpret_cast<const float4*>(rp + r);
            vacc = fmaf(rv.x, rv.x, vacc);
            vacc = fmaf(rv.y, rv.y, vacc);
            vacc = fmaf(rv.z, rv.z, vacc);
            vacc = fmaf(rv.w, rv.w, vacc);
            racc += (rv.x + rv.y) + (rv.z + rv.w);
            *reinterpret_cast<float4*>(qp + r) = stage_operand4<kPrec>(rv);
          }
          rp = qp;
        }
        float gacc[kFeat];
        for (int f0 = 0; f0 < xrows; f0 += kFeat) {
#pragma unroll
          for (int f = 0; f < kFeat; ++f) gacc[f] = kOneTile ? part[f * kThreads + t] : 0.f;
          const float* xp = xcur + f0 * kLd;
          // two passes over the rows, half the features each: fewer
          // loads in flight, no spills at three blocks per SM
#pragma unroll
          for (int fh = 0; fh < kFeat; fh += kFeat / 2) {
#pragma unroll 1
            for (int r = 4 * sq; r < kRows; r += 4 * kLanes) {
              const float4 rv = *reinterpret_cast<const float4*>(rp + r);
              if (kPrec == kHighest && f0 == 0 && fh == 0) {
                vacc = fmaf(rv.x, rv.x, vacc);
                vacc = fmaf(rv.y, rv.y, vacc);
                vacc = fmaf(rv.z, rv.z, vacc);
                vacc = fmaf(rv.w, rv.w, vacc);
                racc += (rv.x + rv.y) + (rv.z + rv.w);
              }
#pragma unroll
              for (int f = fh; f < fh + kFeat / 2; ++f) {
                const float4 xv = *reinterpret_cast<const float4*>(xp + f * kLd + r);
                float s = gacc[f];
                s = fma_staged<kPrec>(rv.x, xv.x, s);
                s = fma_staged<kPrec>(rv.y, xv.y, s);
                s = fma_staged<kPrec>(rv.z, xv.z, s);
                gacc[f] = fma_staged<kPrec>(rv.w, xv.w, s);
              }
            }
          }
          if (!kOneTile) {  // to the block's sums: lane sq adds feature f0 + sq
            float mine = 0.f;
#pragma unroll
            for (int f = 0; f < kFeat; ++f) {
              const float s = lane_sum<kLanes>(gacc[f]);
              mine = sq == f ? s : mine;
            }
            const int c = k + scl;
            if (sq < kFeat && f0 + sq < D && c < C) gsl[c * D + f0 + sq] += mine;
          } else {
#pragma unroll
            for (int f = 0; f < kFeat; ++f) part[f * kThreads + t] = gacc[f];
          }
        }
        if (!kOneTile) {
          const float v = lane_sum<kLanes>(vacc), s = lane_sum<kLanes>(racc);
          if (sq == 0 && k + scl < C) {
            vsum[k + scl] += v;
            rsum[k + scl] += s;
          }
          vacc = 0.f;
          racc = 0.f;
        }
      }

      // ---- groups: item (chain cl, effect e, segment s), chains fastest:
      // the lanes of a warp walk rows of the same segment
      for (int i = t; i < kCC * nseg * Q; i += kThreads) {
        const int cl = i % kCC, e = (i / kCC) % Q, s = i / (kCC * Q);
        if (k + cl >= C) continue;
        const float* rp = rs + cl * kLd;
        const float* zp = zcur + e * kLd;
        float sg = 0.f;
        for (int r = segs[s]; r < segs[s + 1]; ++r) {
          sg = kPrec == kHighest ? fmaf(rp[r], zp[r], sg)
                                 : sg + onehot_operand<kPrec>(rp[r] * zp[r]);
        }
        if (s == 0) bnd[cl * Q + e] = sg;
        else if (s == nseg - 1) bnd[(kCC + cl) * Q + e] = sg;
        else p.gu[((size_t)(k + cl) * G + sgid[s]) * Q + e] = sg;
      }
      __syncthreads();  // bnd is in place

      // ---- books: thread (chain, effect) keeps the open group's sums
      for (int i = t; i < kCC * Q; i += kThreads) {
        const int cl = i / Q, e = i % Q, c = k + cl;
        if (c >= C) continue;
        float& open = opn[c * Q + e];
        auto close_group = [&](int g) {
          if (g == gfirst) headv[c * Q + e] = open;
          else p.gu[((size_t)c * G + g) * Q + e] = open;
        };
        const int g0 = sgid[0];
        if (g0 == openg) {
          open += bnd[cl * Q + e];
        } else {
          close_group(openg);
          open = bnd[cl * Q + e];
        }
        if (nseg > 1) {
          close_group(g0);
          open = bnd[(kCC + cl) * Q + e];
        }
      }
    }
    openg = prevg = sgid[nseg - 1];
    if (!two && sub + 1 < sub1) {  // one buffer: the next sub-tile once this one is done
      __syncthreads();
      const int nrow0 = row0 + kRows;
      stage(p, xs, zs, ys, gls, nrow0, min(kRows, N - nrow0), x16, z16);
      cp_async_commit();
    }
  }
  cp_async_wait_all();  // (an empty group; nothing left in flight)
  __syncthreads();      // the books and the block's sums are complete

  if (b == nblk - 1) zero_ids(p, openg, G);  // ids after the last row's group
  if (kOneTile) {  // the chain's lanes meet; lane sq writes feature sq
    float mine = 0.f;
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
      const float s = lane_sum<kLanes>(part[f * kThreads + t]);
      mine = sq == f ? s : mine;
    }
    const float v = lane_sum<kLanes>(vacc), s = lane_sum<kLanes>(racc);
    if (scl < C) {
      if (sq < D) p.gpart[((size_t)b * C + scl) * D + sq] = mine;
      if (sq == 0) {
        p.vpart[(size_t)b * C + scl] = v;
        p.rpart[(size_t)b * C + scl] = s;
      }
    }
  } else {
    if (!L.gsl_global) {
      for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gsl[i];
    }
    for (int c = t; c < C; c += kThreads) {
      p.vpart[(size_t)b * C + c] = vsum[c];
      p.rpart[(size_t)b * C + c] = rsum[c];
    }
  }
  for (int i = t; i < C * Q; i += kThreads) {
    const size_t o = (size_t)b * C * Q + i;
    if (openg == gfirst) {  // one group in the block
      p.head[o] = opn[i];
      p.tail[o] = 0.f;
    } else {
      p.head[o] = headv[i];
      p.tail[o] = opn[i];
    }
  }
  if (t == 0) {
    p.blo[b] = gfirst;
    p.bhi[b] = openg;
  }
}

// Second kernel.  Warps [0, C*D + 2C): one per entry of gbeta, ssr and
// sresid; lane l adds the partials of blocks l, l + 32, ... in order and
// the lanes meet in a fixed xor-shuffle tree.  Then one thread per (block
// b, its first or last group g, chain, effect), for the first block that
// holds rows of g: its head (first group) or tail (last group), plus the
// heads of the blocks after it that start with g, in block order, while
// they hold nothing but g.
__global__ void b4_finish(Args p, int nblk, float* ssr, float* sresid, float* gbeta) {
  const int C = p.C, Q = p.Q;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ncd = (long long)C * p.D;
  const long long nwarp = ncd + 2LL * C;
  if (i < 32 * nwarp) {  // whole warps
    const long long w = i >> 5;
    const int lane = threadIdx.x & 31;
    const float* part;
    size_t stride;
    float* out;
    if (w < ncd) {
      part = p.gpart + w; stride = (size_t)ncd; out = gbeta + w;
    } else if (w < ncd + C) {
      part = p.vpart + (w - ncd); stride = C; out = ssr + (w - ncd);
    } else {
      part = p.rpart + (w - ncd - C); stride = C; out = sresid + (w - ncd - C);
    }
    float s = 0.f;
#pragma unroll 4
    for (int b = lane; b < nblk; b += 32) s += part[(size_t)b * stride];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) *out = s;
    return;
  }
  const long long cq = (long long)C * Q;
  const long long j = i - 32 * nwarp;
  if (j >= 2 * nblk * cq) return;
  const long long ce = j % cq;  // c * Q + e
  const int b = (int)(j / (2 * cq)), last = (int)((j / cq) & 1);
  const int lo = p.blo[b], hi = p.bhi[b];
  int g;
  float s;
  if (!last) {  // the block's first group, unless an earlier block holds rows of it
    if (b > 0 && p.bhi[b - 1] == lo) return;
    g = lo;
    s = p.head[(size_t)b * cq + ce];
  } else {      // the block's last group, unless it is also its first
    if (hi == lo) return;
    g = hi;
    s = p.tail[(size_t)b * cq + ce];
  }
  for (int b2 = b + 1; b2 < nblk && p.blo[b2] == g; ++b2) {
    s += p.head[(size_t)b2 * cq + ce];
    if (p.bhi[b2] != g) break;
  }
  const int c = (int)(ce / Q), e = (int)(ce % Q);
  p.gu[((size_t)c * p.G + g) * Q + e] = s;
}

using Kernel = void (*)(Args, int);

template <int kPrec>
inline Kernel pick_width(int C, int D) {
  if (!one_tile(C, D)) return b4_pass<kWide, false, kPrec>;
  return C <= 8 ? b4_pass<8, true, kPrec> : C <= 16 ? b4_pass<16, true, kPrec>
                                                    : b4_pass<32, true, kPrec>;
}

inline Kernel pick(int C, int D, int prec) {
  return prec == kHigh      ? pick_width<kHigh>(C, D)
         : prec == kDefault ? pick_width<kDefault>(C, D)
                            : pick_width<kHighest>(C, D);
}

}  // namespace b4
}  // namespace stark

extern "C" int stark_lmm_grouped(
    const float* xT, const float* zT, const float* y, const int* gl,
    const int* first_gid, const float* beta, const float* u,
    const float* intercept, float* ssr, float* sresid, float* gbeta,
    float* gu, float* scratch, int C, int D, int Q, int N, int G,
    int lane_tile, int nblk, int prec, void* stream) {
  namespace b4 = stark::b4;
  // the block split of stark_tpu_torch/ops/hier_fused.py:b4_blocks, no other
  const int nsub = (N + b4::kRows - 1) / b4::kRows;
  if (nblk != (nsub < b4::kBlocks ? nsub : b4::kBlocks) || nblk < 1 || lane_tile % b4::kRows) {
    return (int)cudaErrorInvalidValue;
  }
  if (prec != stark::kHighest && prec != stark::kHigh && prec != stark::kDefault) {
    return (int)cudaErrorInvalidValue;
  }
  b4::Args p{};
  p.xT = xT;
  p.zT = zT;
  p.y = y;
  p.gl = gl;
  p.first_gid = first_gid;
  p.beta = beta;
  p.u = u;
  p.ic = intercept;
  p.gu = gu;
  p.C = C;
  p.D = D;
  p.Q = Q;
  p.N = N;
  p.G = G;
  p.lane_tile = lane_tile;
  const b4::Carve k = b4::carve(nblk, C, D, Q);
  p.gpart = scratch + k.gpart;
  p.vpart = scratch + k.vpart;
  p.rpart = scratch + k.rpart;
  p.head = scratch + k.head;
  p.tail = scratch + k.tail;
  p.blo = reinterpret_cast<int*>(scratch + k.blo);
  p.bhi = reinterpret_cast<int*>(scratch + k.bhi);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)b4::layout(C, D, Q).words * sizeof(float);
  const b4::Kernel kern = b4::pick(C, D, prec);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, b4::kThreads, bytes, s>>>(p, nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long threads = 32LL * ((long long)C * D + 2LL * C) + 2LL * nblk * C * Q;
  const int blocks = (int)((threads + b4::kThreads - 1) / b4::kThreads);
  b4::b4_finish<<<blocks, b4::kThreads, 0, s>>>(p, nblk, ssr, sresid, gbeta);
  return (int)cudaGetLastError();
}

// Shared memory the pass needs per block at (C, D, Q), and the most the
// card `device` gives one block, both in bytes.
extern "C" int stark_lmm_grouped_smem(int C, int D, int Q, int device, int* need, int* limit) {
  *need = stark::b4::layout(C, D, Q).words * (int)sizeof(float);
  return (int)cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Word offsets of the per-block partials in the scratch buffer (gpart,
// vpart, rpart, head, tail, blo, bhi) and its size: out[0..7].
extern "C" int stark_lmm_grouped_scratch(int nblk, int C, int D, int Q, long long* out) {
  const stark::b4::Carve k = stark::b4::carve(nblk, C, D, Q);
  const long long v[8] = {k.gpart, k.vpart, k.rpart, k.head, k.tail, k.blo, k.bhi, k.words};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
