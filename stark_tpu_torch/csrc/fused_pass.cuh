// One pass over the transposed design matrix for a whole chain ensemble:
// logits = beta . x (+ alpha[c, group(n)] | + offsets[c, n] | + ic[c] +
// sum_q z[q, n] u[c, group(n), q]), the link's value terms and residual,
// and the reductions sum_n val, sum_n resid * x[:, n] and (grouped) the
// per-group sums of resid (times z[q, n] with random effects).  Links:
//   bernoulli_logit: val = y log s(l) + (1 - y) log s(-l), resid = y - s(l)
//   gaussian:        val = (y - l)^2,                      resid = y - l
// (the gaussian pass is scale-free: sigma is applied by the caller).
// Shared by csrc/hier_grouped.cu (B1), csrc/logistic_batched.cu (B2) and
// csrc/lmm_grouped.cu (B4); each instantiates its own variant.
//
// Work split.  Block b owns the contiguous rows [b*R, min(N, (b+1)*R)),
// R a multiple of kRows chosen by the caller from N alone (about 256
// blocks), and walks them in sub-tiles of kRows rows.  A sub-tile of x
// is staged in shared memory once and serves every chain (chunks of
// kChunk chains), so X is read from device memory exactly once.
//   logits phase:  thread (row r, half h) computes 16 chains' logits for
//                  row r with beta held transposed in shared memory
//                  (broadcast float4 loads), then the link terms.
//   reduce phase:  thread (chain cl, lane q) accumulates the beta
//                  gradient for d = q (mod 8), the value, and the
//                  per-group segment sums (8 lanes + xor shuffles).
// Every sum runs in a fixed order: per thread in row order, across the
// 8 lanes by a fixed butterfly, across sub-tiles in order, and across
// blocks in a second kernel (finish) that adds the per-block partials in
// block order.  No float atomics: repeated launches are bitwise equal.
//
// Groups (B1, B4).  Rows are sorted by group, so a block's groups form one
// contiguous run [blo, bhi].  A group strictly inside a block belongs to
// that block alone, which writes its gradient straight to galpha.  The
// block's first and last group may continue in neighbouring blocks;
// their partial sums go to head/tail and finish adds them up across the
// blocks that touch the group.  No (C, N) array is ever written.  With
// Q random effects (B4) every group carries Q sums (resid * z[q, n]), and
// head, tail and the output are (.., Q) arrays; B1 is the case Q = 1,
// z = 1, without the intercept.
//
// Masking.  Rows past N are staged as zeros and their terms are chosen
// away with selects, never multiplied by a mask (0 * NaN = NaN).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stark {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 128;      // rows per staged sub-tile
constexpr int kLd = kRows + 1;  // padded row stride of the shared tiles
constexpr int kChunk = 32;      // chains per chunk
constexpr int kLanes = 8;       // threads per chain in the reduce phase
constexpr int kHalf = 16;       // chains per thread in the logits phase
constexpr int kBernoulli = 0;   // link template argument
constexpr int kGaussian = 1;
static_assert(kThreads == kChunk * kLanes, "reduce phase mapping");
static_assert(kThreads == 2 * kRows && kChunk == 2 * kHalf, "logits phase mapping");

struct Params {
  const float* xT;    // (D, N) row-major
  const float* y;     // (N,)
  const float* beta;  // (C, D)
  int C, D, N, rows_per_block;
  // grouped (B1, B4)
  const int* gl;         // (N,) local group id within the reference tile
  const int* first_gid;  // (N / lane_tile,) first group of each tile
  int lane_tile;
  const float* alpha;    // (C, G, Q) group effects (B1: the intercepts, Q = 1)
  int G, Q;
  float* galpha;         // (C, G, Q) output
  float* head;           // (nblk, C, Q) first-group partial
  float* tail;           // (nblk, C, Q) last-group partial
  int* blo;              // (nblk,) first group of the block
  int* bhi;              // (nblk,) last group of the block
  // random effects (B4)
  const float* zT;       // (Q, N) random-effect design
  const float* ic;       // (C,) intercept
  // offset path (B2)
  const float* offsets;  // (C, N) or null
  float* resid;          // (C, N) output when offsets are given
  // per-block partials
  float* gpart;          // (nblk, C, D)
  float* vpart;          // (nblk, C)
  float* rpart;          // (nblk, C) sum of resid (B4)
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int chains_padded(int c) {
  return (c + kChunk - 1) / kChunk * kChunk;
}

// Dynamic shared memory layout, in 4-byte words, every array 16-byte aligned.
// ``zq`` is the number of staged z rows (Q for B4, else 0); ``q`` the
// sums per group.
struct Layout {
  int xs, zs, rs, vt, ys, gs, bsh, gacc, vsum, rsum, run, rung, ishead, segs, misc, words;
};

__host__ __device__ inline Layout smem_layout(int C, int D, int zq, int q) {
  Layout L;
  const int cp = chains_padded(C);
  int o = 0;
  L.xs = o;     o += round4(D * kLd);      // x sub-tile [d][r]
  L.zs = o;     o += round4(zq * kLd);     // z sub-tile [q][r]
  L.rs = o;     o += round4(kChunk * kLd); // resid [chain][r]
  L.vt = o;     o += round4(kChunk * kLd); // value terms [chain][r]
  L.ys = o;     o += kRows;
  L.gs = o;     o += kRows;                // absolute group per row
  L.bsh = o;    o += round4(D * cp);       // beta transposed [d][c]
  L.gacc = o;   o += round4(cp * D);       // beta-gradient sums [c][d]
  L.vsum = o;   o += cp;
  L.rsum = o;   o += cp;                   // sum of resid (B4)
  L.run = o;    o += round4(cp * q);       // open group segment sums [c][q]
  L.rung = o;   o += cp;                   // open group id
  L.ishead = o; o += cp;                   // open group is the block's first
  L.segs = o;   o += round4(kRows + 1);    // segment starts in the sub-tile
  L.misc = o;   o += 8;                    // [0] segment count, [1..4] per warp
  L.words = o;
  return L;
}

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

__device__ __forceinline__ float lane_sum8(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

template <bool kGrouped, int kLink, bool kEffects>
__global__ void __launch_bounds__(kThreads) fused_pass(Params p) {
  static_assert(kGrouped || !kEffects, "random effects need the grouped layout");
  extern __shared__ __align__(16) float smem[];
  const int Q = kEffects ? p.Q : 1;
  const Layout L = smem_layout(p.C, p.D, kEffects ? Q : 0, Q);
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
    if (kGrouped) {
      for (int e = 0; e < Q; ++e) run[c * Q + e] = 0.f;
      rung[c] = group_of(p, row_begin);
      ishead[c] = 1;
    }
  }
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int nvalid = min(kRows, row_end - row0);
    for (int i = t; i < D * kRows; i += kThreads) {
      const int d = i / kRows, r = i % kRows;
      xs[d * kLd + r] = r < nvalid ? p.xT[(size_t)d * N + row0 + r] : 0.f;
    }
    if (kEffects) {
      for (int i = t; i < Q * kRows; i += kThreads) {
        const int e = i / kRows, r = i % kRows;
        zs[e * kLd + r] = r < nvalid ? p.zT[(size_t)e * N + row0 + r] : 0.f;
      }
    }
    if (t < kRows) {
      const bool ok = t < nvalid;
      ys[t] = ok ? p.y[row0 + t] : 0.f;
      if (kGrouped) gs[t] = ok ? group_of(p, row0 + t) : -1;
    }
    __syncthreads();

    if (kGrouped) {
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
        const int n = row0 + r;
        const float yv = ys[r];
        const int g = kGrouped ? gs[r] : 0;
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int c = k + cl0 + j;
          const bool ok = valid && c < C;
          float l = acc[j];
          if (kEffects) {
            if (ok) {
              const float* uc = p.alpha + ((size_t)c * p.G + g) * Q;
              l += p.ic[c];
              for (int e = 0; e < Q; ++e) l = fmaf(zs[e * kLd + r], uc[e], l);
            }
          } else if (kGrouped) {
            l += ok ? p.alpha[(size_t)c * p.G + g] : 0.f;
          } else if (p.offsets != nullptr) {
            l += ok ? p.offsets[(size_t)c * N + n] : 0.f;
          }
          float v, res;
          if (kLink == kGaussian) {
            res = yv - l;
            v = res * res;
          } else {
            v = yv * log_sigmoid(l) + (1.f - yv) * log_sigmoid(-l);
            res = yv - sigmoid(l);
          }
          rs[(cl0 + j) * kLd + r] = ok ? res : 0.f;
          vt[(cl0 + j) * kLd + r] = ok ? v : 0.f;
          if (!kGrouped && p.resid != nullptr && ok) p.resid[(size_t)c * N + n] = res;
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
        if (kEffects) {
          float sr = 0.f;
          for (int r = q; r < kRows; r += kLanes) sr += rp[r];
          sr = lane_sum8(sr);
          if (q == 0) rsum[c] += sr;
        }

        if (kGrouped) {
          // segment sums; lane 0 of the chain keeps the open group's
          // books and flushes a finished group to head or galpha
          const int nseg = misc[0];
          for (int si = 0; si < nseg; ++si) {
            const int r0 = segs[si], r1 = segs[si + 1];
            const int gid = gs[r0];
            for (int e = 0; e < Q; ++e) {
              float sg = 0.f;
              if (kEffects) {
                const float* zr = zs + e * kLd;
                for (int r = r0 + q; r < r1; r += kLanes) sg = fmaf(rp[r], zr[r], sg);
              } else {
                for (int r = r0 + q; r < r1; r += kLanes) sg += rp[r];
              }
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
      }
      __syncthreads();
    }
  }

  for (int i = t; i < C * D; i += kThreads) p.gpart[(size_t)b * C * D + i] = gacc[i];
  for (int c = t; c < C; c += kThreads) {
    p.vpart[(size_t)b * C + c] = vsum[c];
    if (kEffects) p.rpart[(size_t)b * C + c] = rsum[c];
    if (kGrouped) {
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
  }
  if (kGrouped && t == 0) {
    p.blo[b] = group_of(p, row_begin);
    p.bhi[b] = group_of(p, row_end - 1);
  }
}

// Second pass: add the per-block partials in block order.  One thread per
// beta-gradient entry, per chain value, (B4) per chain resid sum and
// (grouped) per (chain, group, effect).
template <bool kGrouped, bool kEffects>
__global__ void finish(Params p, int nblk, float* val, float* gbeta, float* sresid) {
  const int C = p.C, D = p.D, Q = kEffects ? p.Q : 1;
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
  if (kEffects) {
    if (j < C) {
      float s = 0.f;
      for (int b = 0; b < nblk; ++b) s += p.rpart[(size_t)b * C + j];
      sresid[j] = s;
      return;
    }
    j -= C;
  }
  if (kGrouped && j < (long long)C * p.G * Q) {
    const int e = (int)(j % Q);
    const int c = (int)(j / ((long long)p.G * Q)), g = (int)((j / Q) % p.G);
    int lo = 0, hi = nblk;  // first block whose last group is >= g
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (p.bhi[mid] < g) lo = mid + 1; else hi = mid;
    }
    float s = 0.f;
    bool interior = false;
    for (int b = lo; b < nblk && p.blo[b] <= g; ++b) {
      if (p.blo[b] == g) s += p.head[((size_t)b * C + c) * Q + e];
      else if (p.bhi[b] == g) s += p.tail[((size_t)b * C + c) * Q + e];
      else interior = true;  // written by the block that owns it
    }
    if (!interior) p.galpha[((size_t)c * p.G + g) * Q + e] = s;  // zero when empty
  }
}

template <bool kGrouped, int kLink, bool kEffects>
inline int launch(const Params& p, int nblk, float* val, float* gbeta, float* sresid,
                  cudaStream_t stream) {
  const int q = kEffects ? p.Q : 1;
  const Layout L = smem_layout(p.C, p.D, kEffects ? q : 0, q);
  const size_t bytes = (size_t)L.words * sizeof(float);
  auto* kern = fused_pass<kGrouped, kLink, kEffects>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, kThreads, bytes, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)p.C * p.D + p.C + (kEffects ? p.C : 0) +
                          (kGrouped ? (long long)p.C * p.G * q : 0);
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  finish<kGrouped, kEffects><<<blocks, kThreads, 0, stream>>>(p, nblk, val, gbeta, sresid);
  return (int)cudaGetLastError();
}

// Carve the caller's scratch buffer: gpart (nblk*C*D), vpart, rpart
// (nblk*C each), head, tail (nblk*C*Q each), blo, bhi (nblk ints each);
// stark_tpu_torch/ops/logistic_fused.py:scratch_words sizes it.
inline void carve_scratch(Params& p, float* scratch, int nblk) {
  const size_t nc = (size_t)nblk * p.C;
  const size_t ncq = nc * (p.Q > 0 ? p.Q : 1);
  p.gpart = scratch;
  p.vpart = p.gpart + nc * p.D;
  p.rpart = p.vpart + nc;
  p.head = p.rpart + nc;
  p.tail = p.head + ncq;
  p.blo = reinterpret_cast<int*>(p.tail + ncq);
  p.bhi = p.blo + nblk;
}

}  // namespace stark

extern "C" const char* stark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
