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
//   gu     (C, G, Q)   sum_{n in g}  resid z[q, n]
// with group(n) = first_gid[n / lane_tile] + gl[n], the reference's layout
// read as is.
//
// Bound on an H100 SXM at BASELINE config 3 (C=16, D=8, Q=2, N=100k,
// G=10k): it must read xT (3.2 MB), zT (0.8 MB), y and gl (0.4 MB each)
// and u (1.28 MB) and write gu (1.28 MB): 7.4 MB, 2.2 us at 3.35 TB/s;
// and it does about 2*C*N*(D+Q) FMAs = 64 MFLOP, 1 us at 67 TFLOP/s.  So
// it is bound by bytes, and at this size by its two launches.
//
// Design: lmm_pass below, the port's first pass, which B1 and B2 shared
// until each took a pass of its own.  u is gathered per row from (C, G,
// Q), which lives in L2; the per-(group, q) gradients are segment sums
// of resid * z over the sorted rows.  The TPU kernel's per-tile u windows
// laid side by side (u_tiles), its chain padding to a sublane multiple of
// 8 and its VMEM guard (_check_chain_vmem) are artifacts of the TPU's
// VMEM and (8, 128) tiling and have no counterpart here.
//
// The pass (lmm_pass).  One pass over the transposed design matrix of
// group-sorted rows for a whole chain ensemble: mu = ic[c] + beta . x +
// sum_q z[q, n] u[c, group(n), q], resid = y - mu, and the scale-free sums
// sum_n resid^2, sum_n resid, sum_n resid * x[:, n] and the per-(group, q)
// sums of resid * z[q, n].
//
// Work split.  Block b owns the contiguous rows [b*R, min(N, (b+1)*R)),
// R a multiple of kRows chosen by the caller from N alone (about 256
// blocks), and walks them in sub-tiles of kRows rows.  A sub-tile of x
// is staged in shared memory once and serves every chain (chunks of
// kChunk chains), so X is read from device memory exactly once.
//   logits phase:  thread (row r, half h) computes 16 chains' mu for
//                  row r with beta held transposed in shared memory
//                  (broadcast float4 loads), then resid and resid^2.
//   reduce phase:  thread (chain cl, lane q) accumulates the beta
//                  gradient for d = q (mod 8), the value, the resid sum
//                  and the per-group segment sums (8 lanes + xor
//                  shuffles).
// Every sum runs in a fixed order: per thread in row order, across the
// 8 lanes by a fixed butterfly, across sub-tiles in order, and across
// blocks in a second kernel (finish) that adds the per-block partials in
// block order.  No float atomics: repeated launches are bitwise equal.
//
// Groups.  Rows are sorted by group, so a block's groups form one
// contiguous run [blo, bhi].  A group strictly inside a block belongs to
// that block alone, which writes its gradient straight to galpha, and so
// does an id strictly inside the run that has no rows: its gradient is 0,
// written after the last sub-tile, where two neighbouring rows of the
// block skip ids (written in the flush of a segment's sums, a divergent
// path taken per segment and effect, it cost the pass 3.6 %; once per row
// where the segment starts are found, 1.5 %).  The block's first and last
// group may continue in neighbouring blocks; their partial sums go to
// head/tail and finish adds them up across the blocks that touch the
// group.  No (C, N) array is ever written.  Every group carries Q sums
// (resid * z[q, n]), and head, tail and the output are (.., Q) arrays.
//
// Masking.  Rows past N are staged as zeros and their terms are chosen
// away with selects, never multiplied by a mask (0 * NaN = NaN).
#include "fused_pass.cuh"

namespace stark {

constexpr int kRows = 128;      // rows per staged sub-tile
constexpr int kLd = kRows + 1;  // padded row stride of the shared tiles
constexpr int kChunk = 32;      // chains per chunk
constexpr int kLanes = 8;       // threads per chain in the reduce phase
constexpr int kHalf = 16;       // chains per thread in the logits phase
static_assert(kThreads == kChunk * kLanes, "reduce phase mapping");
static_assert(kThreads == 2 * kRows && kChunk == 2 * kHalf, "logits phase mapping");

__host__ __device__ inline int chains_padded(int c) {
  return (c + kChunk - 1) / kChunk * kChunk;
}

// B4's dynamic shared memory layout, in 4-byte words, every array 16-byte
// aligned, for Q random effects.
struct Layout {
  int xs, zs, rs, vt, ys, gs, bsh, gacc, vsum, rsum, run, rung, ishead, segs, misc, words;
};

__host__ __device__ inline Layout smem_layout(int C, int D, int Q) {
  Layout L;
  const int cp = chains_padded(C);
  int o = 0;
  L.xs = o;     o += round4(D * kLd);      // x sub-tile [d][r]
  L.zs = o;     o += round4(Q * kLd);      // z sub-tile [q][r]
  L.rs = o;     o += round4(kChunk * kLd); // resid [chain][r]
  L.vt = o;     o += round4(kChunk * kLd); // value terms [chain][r]
  L.ys = o;     o += kRows;
  L.gs = o;     o += kRows;                // absolute group per row
  L.bsh = o;    o += round4(D * cp);       // beta transposed [d][c]
  L.gacc = o;   o += round4(cp * D);       // beta-gradient sums [c][d]
  L.vsum = o;   o += cp;
  L.rsum = o;   o += cp;                   // sum of resid
  L.run = o;    o += round4(cp * Q);       // open group segment sums [c][q]
  L.rung = o;   o += cp;                   // open group id
  L.ishead = o; o += cp;                   // open group is the block's first
  L.segs = o;   o += round4(kRows + 1);    // segment starts in the sub-tile
  L.misc = o;   o += 8;                    // [0] segment count, [1..4] per warp
  L.words = o;
  return L;
}

__device__ __forceinline__ float lane_sum8(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

__global__ void __launch_bounds__(kThreads) lmm_pass(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q;
  const Layout L = smem_layout(p.C, p.D, Q);
  float* xs = smem + L.xs;
  float* zs = smem + L.zs;
  float* rs = smem + L.rs;
  float* vt = smem + L.vt;
  float* ys = smem + L.ys;
  int* gs = reinterpret_cast<int*>(smem + L.gs);
  float* bsh = smem + L.bsh;
  float* gacc = smem + L.gacc;
  float* vsum = smem + L.vsum;
  float* rsum = smem + L.rsum;
  float* run = smem + L.run;
  int* rung = reinterpret_cast<int*>(smem + L.rung);
  int* ishead = reinterpret_cast<int*>(smem + L.ishead);
  int* segs = reinterpret_cast<int*>(smem + L.segs);
  int* misc = reinterpret_cast<int*>(smem + L.misc);

  const int C = p.C, D = p.D, N = p.N;
  const int cp = chains_padded(C);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int row_begin = b * p.rows_per_block;
  const int row_end = min(N, row_begin + p.rows_per_block);

  for (int i = t; i < D * cp; i += kThreads) {
    const int d = i / cp, c = i - d * cp;
    bsh[i] = c < C ? p.beta[(size_t)c * D + d] : 0.f;
  }
  for (int i = t; i < cp * D; i += kThreads) gacc[i] = 0.f;
  for (int c = t; c < cp; c += kThreads) {
    vsum[c] = 0.f;
    rsum[c] = 0.f;
    for (int e = 0; e < Q; ++e) run[c * Q + e] = 0.f;
    rung[c] = group_of(p, row_begin);
    ishead[c] = 1;
  }
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int nvalid = min(kRows, row_end - row0);
    for (int i = t; i < D * kRows; i += kThreads) {
      const int d = i / kRows, r = i % kRows;
      xs[d * kLd + r] = r < nvalid ? p.xT[(size_t)d * N + row0 + r] : 0.f;
    }
    for (int i = t; i < Q * kRows; i += kThreads) {
      const int e = i / kRows, r = i % kRows;
      zs[e * kLd + r] = r < nvalid ? p.zT[(size_t)e * N + row0 + r] : 0.f;
    }
    if (t < kRows) {
      const bool ok = t < nvalid;
      ys[t] = ok ? p.y[row0 + t] : 0.f;
      gs[t] = ok ? group_of(p, row0 + t) : -1;
    }
    __syncthreads();

    {
      // segment starts: rows whose group differs from the previous row's
      int flag = 0;
      if (t < kRows) flag = (t < nvalid) && (t == 0 || gs[t] != gs[t - 1]);
      const unsigned ball = __ballot_sync(0xffffffffu, flag);
      if (lane == 0 && warp < kRows / 32) misc[1 + warp] = __popc(ball);
      __syncthreads();
      if (flag) {
        int off = 0;
        for (int w = 0; w < warp; ++w) off += misc[1 + w];
        segs[off + __popc(ball & ((1u << lane) - 1u))] = t;
      }
      if (t == 0) {
        int tot = 0;
        for (int w = 0; w < kRows / 32; ++w) tot += misc[1 + w];
        misc[0] = tot;
        segs[tot] = nvalid;
      }
      __syncthreads();
    }

    for (int k = 0; k < cp; k += kChunk) {
      // ---- logits phase: thread (r, h) -> chains k + 16h .. k + 16h + 15
      {
        const int r = t % kRows, cl0 = (t / kRows) * kHalf;
        float acc[kHalf];
#pragma unroll
        for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;
        const float* bcol = bsh + k + cl0;
        for (int d = 0; d < D; ++d) {
          const float xv = xs[d * kLd + r];
          const float4* bp = reinterpret_cast<const float4*>(bcol + d * cp);
#pragma unroll
          for (int q = 0; q < kHalf / 4; ++q) {
            const float4 bv = bp[q];
            acc[4 * q + 0] = fmaf(bv.x, xv, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(bv.y, xv, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(bv.z, xv, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(bv.w, xv, acc[4 * q + 3]);
          }
        }
        const bool valid = r < nvalid;
        const float yv = ys[r];
        const int g = gs[r];
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int c = k + cl0 + j;
          const bool ok = valid && c < C;
          float l = acc[j];
          if (ok) {
            const float* uc = p.alpha + ((size_t)c * p.G + g) * Q;
            l += p.ic[c];
            for (int e = 0; e < Q; ++e) l = fmaf(zs[e * kLd + r], uc[e], l);
          }
          const float res = yv - l;
          const float v = res * res;
          rs[(cl0 + j) * kLd + r] = ok ? res : 0.f;
          vt[(cl0 + j) * kLd + r] = ok ? v : 0.f;
        }
      }
      __syncthreads();

      // ---- reduce phase: thread (cl, q) -> chain k + cl
      {
        const int cl = t / kLanes, q = t % kLanes;
        const int c = k + cl;
        const float* rp = rs + cl * kLd;
        float* g = gacc + c * D;
        for (int d0 = q; d0 < D; d0 += 4 * kLanes) {
          const float* x0 = xs + d0 * kLd;
          const float* x1 = xs + min(d0 + 8, D - 1) * kLd;
          const float* x2 = xs + min(d0 + 16, D - 1) * kLd;
          const float* x3 = xs + min(d0 + 24, D - 1) * kLd;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
          for (int r = 0; r < kRows; ++r) {
            const float rv = rp[r];
            a0 = fmaf(rv, x0[r], a0);
            a1 = fmaf(rv, x1[r], a1);
            a2 = fmaf(rv, x2[r], a2);
            a3 = fmaf(rv, x3[r], a3);
          }
          g[d0] += a0;
          if (d0 + 8 < D) g[d0 + 8] += a1;
          if (d0 + 16 < D) g[d0 + 16] += a2;
          if (d0 + 24 < D) g[d0 + 24] += a3;
        }

        float s = 0.f;
        for (int r = q; r < kRows; r += kLanes) s += vt[cl * kLd + r];
        s = lane_sum8(s);
        if (q == 0) vsum[c] += s;
        float sr = 0.f;
        for (int r = q; r < kRows; r += kLanes) sr += rp[r];
        sr = lane_sum8(sr);
        if (q == 0) rsum[c] += sr;

        // segment sums; lane 0 of the chain keeps the open group's books
        // and flushes a finished group to head or galpha
        const int nseg = misc[0];
        for (int si = 0; si < nseg; ++si) {
          const int r0 = segs[si], r1 = segs[si + 1];
          const int gid = gs[r0];
          for (int e = 0; e < Q; ++e) {
            float sg = 0.f;
            const float* zr = zs + e * kLd;
            for (int r = r0 + q; r < r1; r += kLanes) sg = fmaf(rp[r], zr[r], sg);
            sg = lane_sum8(sg);
            if (q == 0 && c < C) {
              float& open = run[c * Q + e];
              if (gid == rung[c]) {
                open += sg;
              } else {
                if (ishead[c]) p.head[((size_t)b * C + c) * Q + e] = open;
                else p.galpha[((size_t)c * p.G + rung[c]) * Q + e] = open;
                open = sg;
              }
            }
          }
          if (q == 0 && c < C && gid != rung[c]) {
            ishead[c] = 0;
            rung[c] = gid;
          }
        }
      }
      __syncthreads();
    }
  }

  // ids between the groups of two neighbouring rows of the block have no
  // rows, and finish leaves them to the block: their gradient is 0
  for (int n = row_begin + 1 + t; n < row_end; n += kThreads) {
    const int prev = group_of(p, n - 1), g = group_of(p, n);
    for (int h = prev + 1; h < g; ++h)
      for (int i = 0; i < C * Q; ++i)
        p.galpha[((size_t)(i / Q) * p.G + h) * Q + i % Q] = 0.f;
  }
  for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gacc[i];
  for (int c = t; c < C; c += kThreads) {
    p.vpart[(size_t)b * C + c] = vsum[c];
    p.rpart[(size_t)b * C + c] = rsum[c];
    for (int e = 0; e < Q; ++e) {
      const size_t i = ((size_t)b * C + c) * Q + e;
      if (ishead[c]) {
        p.head[i] = run[c * Q + e];
        p.tail[i] = 0.f;
      } else {
        p.tail[i] = run[c * Q + e];
      }
    }
  }
  if (t == 0) {
    p.blo[b] = group_of(p, row_begin);
    p.bhi[b] = group_of(p, row_end - 1);
  }
}

// B4: lmm_pass, then finish.
inline int lmm_launch(const Params& p, int nblk, float* ssr, float* gbeta, float* sresid,
                      cudaStream_t stream) {
  const Layout L = smem_layout(p.C, p.D, p.Q);
  const size_t bytes = (size_t)L.words * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      lmm_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  lmm_pass<<<nblk, kThreads, bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)p.C * p.D + 2LL * p.C + (long long)p.C * p.G * p.Q;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  finish<true, true><<<blocks, kThreads, 0, stream>>>(p, nblk, ssr, gbeta, sresid);
  return (int)cudaGetLastError();
}

}  // namespace stark

extern "C" int stark_lmm_grouped(
    const float* xT, const float* zT, const float* y, const int* gl,
    const int* first_gid, const float* beta, const float* u,
    const float* intercept, float* ssr, float* sresid, float* gbeta,
    float* gu, float* scratch, int C, int D, int Q, int N, int G,
    int lane_tile, int rows_per_block, int nblk, void* stream) {
  stark::Params p{};
  p.xT = xT;
  p.y = y;
  p.beta = beta;
  p.C = C;
  p.D = D;
  p.N = N;
  p.rows_per_block = rows_per_block;
  p.gl = gl;
  p.first_gid = first_gid;
  p.lane_tile = lane_tile;
  p.alpha = u;
  p.G = G;
  p.Q = Q;
  p.galpha = gu;
  p.zT = zT;
  p.ic = intercept;
  stark::carve_scratch(p, scratch, nblk);
  return stark::lmm_launch(p, nblk, ssr, gbeta, sresid, static_cast<cudaStream_t>(stream));
}
