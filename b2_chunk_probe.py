#!/usr/bin/env python3
"""Time kernel B2 at the shapes of its narrow chunks (csrc/logistic_batched.cu:
b2_chunk) from several trees of stark_tpu_torch, in turns on one card, and
make the variant trees that say what binds it.

    python3 b2_chunk_probe.py --variants       # build/b2_variants/<name>/stark_tpu_torch
    python3 b2_chunk_probe.py TREE [TREE ...]  # each tree's B2 from its own build

A TREE is a directory holding stark_tpu_torch/ (``.`` for this checkout).
Each is timed in a process of its own (CUDA events, 100 warm launches
queued behind a sleep, chip_smoke.timed) at chip_smoke.B2_NARROW_KEYS,
the calls --compare-with makes there: config 2's shard axis at each dot
precision, C=8 with offsets on the flagship's X (the NUTS legs), the
zoo's gaussian C=8, D=32 and config 3's gaussian C=16, D=8; and the
last and the first of these on each narrow X dtype (chip_smoke.X_NARROW).
It also times b2_mma, B2's tensor-core pass at high and default, at
the offset path's shape (C=32, D=32, N=1M, bernoulli, with and without
offsets: chip_smoke.B2_MMA_KEYS), and on narrow X there at each
precision (chip_smoke.B2_X_KEYS).  The variants (VARIANTS) are b2_chunk
with one part taken out (the gradient's products, the logits' products,
both with the link, the whole pass, b2_finish) or with four blocks an SM
(528 blocks a launch), and b2_mma with one part taken out (mma_: the
gradient, the logits, the link's arithmetic, all three, the whole pass),
with x rounded where it is staged (mma_staged_x) or with an L2 prefetch
of the sub-tile after next (mma_prefetch); on narrow X b2_mma with the
n-tiles of its one-tile kernels read from C at high and default
(mma_nt0), at highest with its pieces of beta built per k-step and
n-tile and its n-tiles compiled in (mma_lazy), without the widening
after the wait, the copies of the windows, or both (mma_nowiden,
mma_nocopy, mma_nostage: wrong outputs, the times are the point), and
highest on narrow X on b2_pass with the packed words copied in flight
(pass); each an edit of this checkout's source.  On a machine with one
card:

    python3 b2_chunk_probe.py --variants &&
        python3 b2_chunk_probe.py . build/b2_variants/nograd ... .
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "b2_variants"

_GRADIENT = """#pragma unroll
    for (int q = 0; q < K::kQuads; ++q) {"""
_LOGITS = """      for (int d = 0; d < D; ++d) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + d * kLd);"""
_LINK = """          vacc[i] += ok ? v : 0.f;
          rr[j] = ok ? res : 0.f;"""
_PASS = """  p = shard_view(p, blockIdx.y, nblk);
  const int C = p.C, D = p.D, N = p.N;"""
_LAUNCH = """    if (e != 0) return e;
  } else if (r.pass == 1) {"""
_NO_GRADIENT = (_GRADIENT, _GRADIENT.replace("q < K::kQuads", "q < 0"))
_NO_LOGITS = (_LOGITS, _LOGITS.replace("d < D", "d < 0"))
# b2_mma's parts (high and default past b2_chunk's shapes)
_MMA_GRADIENT = """      for (int f0 = 0; f0 < D; f0 += kFeat) {
        const float* xa = xcur"""
_MMA_LOGITS_ONE = "            if (kd < nkd) logits_step(kd, bfr[kd]);"
_MMA_LOGITS = """          for (int kd = 0; kd < nkd; ++kd) {
            unsigned bp[4][kBW];"""
_MMA_LINK = """              vacc[j][e] += ok ? v : 0.f;
              *rp = ok ? res : 0.f;"""
_MMA_PASS = '''  static_assert(kPrec != kHighest || kNarrow, "highest on float32 X runs b2_pass");'''
_MMA_NO_GRADIENT = (_MMA_GRADIENT, _MMA_GRADIENT.replace("f0 < D", "f0 < 0"))
_MMA_NO_LOGITS = [(_MMA_LOGITS_ONE, _MMA_LOGITS_ONE.replace("kd < nkd", "kd < 0")),
                  (_MMA_LOGITS, _MMA_LOGITS.replace("kd < nkd", "kd < 0"))]
_MMA_NO_LINK = (_MMA_LINK, _MMA_LINK.replace("? v :", "? l :").replace("? res :", "? l :"))
# x rounded where its sub-tile is staged (stage_rows, before the barrier)
# and its pairs taken by byte permutes, in place of rounding each pair
# where it is built
_MMA_STAGED_X = [
    ("""    float* xb = xs + buf * xbuf;
    cp_async_wait_all();
""", """    float* xb = xs + buf * xbuf;
    cp_async_wait_all();
    if (!kNarrow) stage_rows<kPrec, kRows, kLd, kThreads>(xb, D);
"""),
    ("x_round_pairs<kPrec, kNarrow>(w[0],", "x_pairs<kPrec, kNarrow>(w[0],"),
    ("x[mm] = x_round_pairs<kPrec, kNarrow>(", "x[mm] = x_pairs<kPrec, kNarrow>("),
]
# an L2 prefetch of the sub-tile after next (prefetch.global.L2 of each
# 128-byte line of its x rows, y and first chunk's offsets), issued after
# the next sub-tile's copies start
_MMA_PREFETCH_FN = """// Ask L2 for the sub-tile at row0 (nvalid rows) a sub-tile before its
// copy starts: each 128-byte line of its x rows (at their storage width),
// of y and, with offsets, of the first chunk's offsets.  A hint: nothing
// waits for it, and no shared memory holds it.
__device__ __forceinline__ void prefetch_l2(const Params& p, int row0, int nvalid) {
  const int xsize = x_size(p.xdt);
  const int xlines = (nvalid * xsize + 127) / 128, flines = (nvalid + 31) / 32;
  const char* xT = reinterpret_cast<const char*>(p.xT);
  for (int i = threadIdx.x; i < p.D * xlines; i += kThreads) {
    const int d = i / xlines, q = i - d * xlines;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        xT + ((size_t)d * p.N + row0) * xsize + 128 * q));
  }
  if (threadIdx.x < flines) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p.y + row0 + 32 * threadIdx.x));
  }
  if (p.offsets != nullptr) {
    const int nc = min(p.C, kChains);
    for (int i = threadIdx.x; i < nc * flines; i += kThreads) {
      const int c = i / flines, q = i - c * flines;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p.offsets + (size_t)c * p.N + row0 + 32 * q));
    }
  }
}

"""
_MMA_PREFETCH = [
    ("// kOneTile: one_tile(C, D), the flagship's case",
     _MMA_PREFETCH_FN + "// kOneTile: one_tile(C, D), the flagship's case"),
    ("""    cp_async_commit();
    if (win) widen_rows(""",
     """    cp_async_commit();
    if (two && sub + 2 < sub1) prefetch_l2(p, row0 + 2 * kRows, min(kRows, N - row0 - 2 * kRows));
    if (win) widen_rows("""),
]

# b2_mma on narrow X: at highest the one-tile kernels building beta's
# pieces per k-step and n-tile with their 4 n-tiles compiled in (in place
# of holding the pieces for the block, with the n-tiles read from C:
# compiled in so they spilled); the narrow one-tile kernels of 25 to 32
# chains at high and default with their n-tiles read from C; the
# widening after the wait, the copies of the windows, or both taken out
# (wrong outputs; the times are the point)
_MMA_LAZY = [
    ("  if constexpr (kOneTile) {\n    __syncthreads();  // beta is staged",
     "  if constexpr (kOneTile && kPrec != kHighest) {\n    __syncthreads();  // beta is staged"),
    ("        if constexpr (kOneTile) {\n#pragma unroll\n          for (int kd = 0; kd < 2; ++kd)",
     "        if constexpr (kOneTile && kPrec != kHighest) {\n#pragma unroll\n"
     "          for (int kd = 0; kd < 2; ++kd)"),
    ("      (!narrow || (r.windows && prec != kHighest))) {", "      (!narrow || r.windows)) {"),
    ("    if (r.nt == 4) return mma_prec_of<true, 4, kShards, kNarrow, false>(link, prec);",
     "    if (r.nt == 4) return mma_prec_of<true, 4, kShards, kNarrow, false>(link, prec);\n"
     "  } else {\n"
     "    if (r.nt == 4) return mma_prec_of<true, 4, kShards, kNarrow, true>(link, prec);"),
]
_MMA_NT0 = ("      (!narrow || (r.windows && prec != kHighest))) {", "      !narrow) {")
_MMA_NOWIDEN = ("    if (win) widen_rows(p, shard, slot + buf * slotb, xb, nvalid);", "")
_MMA_NOCOPY = ("""  if (x_size(p.xdt) == 2) {
    copy_windows_of<2>(p, xbase, s, S, slot, row0, nvalid);
  } else {
    copy_windows_of<1>(p, xbase, s, S, slot, row0, nvalid);
  }
""", "")
# highest on narrow X on b2_pass (FP32 CUDA cores) with the packed words
# copied in flight, as B1's hier_pass took them: one packed slot after
# b2_pass's layout (two float32 x buffers; 81,664 bytes at C = 32, D = 32
# on bf16 X, so two blocks an SM), warp w copying feature rows w, w + 4,
# ... and widening them after its wait, before the barrier
_PASS_NARROW = [
    ("template <bool kOneTile, int kLink, bool kShards>\n__global__ void "
     "__launch_bounds__(kThreads, kBlocksPerSm) b2_pass(",
     "template <bool kOneTile, int kLink, bool kShards, bool kNarrow = false>\n__global__ void "
     "__launch_bounds__(kThreads, kBlocksPerSm) b2_pass("),
    ("  stage<false>(p, xs, ys, rs, sub0 * kRows, min(kRows, N - sub0 * kRows), x16, o16);",
     """  const int xsw = kNarrow && x16 && L.nbuf == 2 ? L.words : -1;
  const int xsize = x_size(p.xdt), xnch = x_window_chunks(kRows, xsize);
  auto pstage = [&](float* xb, float* yb, float* rb, int row0) {
    const int nv = min(kRows, N - row0);
    if (kNarrow && xsw >= 0) {
      for (int d = t >> 5; d < D; d += kThreads / 32)
        x_window_copy(reinterpret_cast<char*>(smem + xsw) + 16 * xnch * d, p.xT, xsize,
                      (long long)D * N * xsize, (long long)d * N + row0, nv, lane);
      cp_async4(yb + t, p.y + row0 + (t < nv ? t : 0), t < nv);
      if (p.offsets != nullptr) stage_offsets(p, rb, 0, row0, nv, o16);
    } else {
      stage<kNarrow>(p, xb, yb, rb, row0, nv, x16, o16);
    }
  };
  pstage(xs, ys, rs, sub0 * kRows);"""),
    ("""    cp_async_wait_all();
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) {
      const int nrow0 = row0 + kRows;
      stage<false>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows, rs + (buf ^ 1) * rbuf, nrow0,
            min(kRows, N - nrow0), x16, o16);
    }""",
     """    cp_async_wait_all();
    if (kNarrow && xsw >= 0) {  // the rows this warp copied, widened
      __syncwarp();
      for (int d = t >> 5; d < D; d += kThreads / 32)
        *reinterpret_cast<float4*>(xs + buf * xbuf + d * kLd + 4 * lane) = x_window_load4(
            reinterpret_cast<const char*>(smem + xsw) + 16 * xnch * d, p.xdt,
            (int)(((long long)d * N * xsize) & 15), 4 * lane, nvalid);
    }
    __syncthreads();  // this sub-tile has landed; the other buffer is free
    if (two && sub + 1 < sub1) {
      pstage(xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows, rs + (buf ^ 1) * rbuf, row0 + kRows);
    }"""),
    ("      stage<false>(p, xs, ys, rs, nrow0, min(kRows, N - nrow0), x16, o16);",
     "      pstage(xs, ys, rs, nrow0);"),
    ("""template <bool kOneTile, bool kShards>
inline Kernel pick(int link) {""", """template <bool kOneTile, bool kShards>
inline Kernel pick(int link, bool narrow) {
  if (narrow) {
    return link == kGaussian ? b2_pass<kOneTile, kGaussian, kShards, true>
                             : b2_pass<kOneTile, kBernoulli, kShards, true>;
  }"""),
    ("""    const b2::Kernel kern = S > 1 ? (one ? b2::pick<true, true>(link) : b2::pick<false, true>(link))
                                  : (one ? b2::pick<true, false>(link) : b2::pick<false, false>(link));""",
     """    const b2::Kernel kern =
        S > 1 ? (one ? b2::pick<true, true>(link, narrow) : b2::pick<false, true>(link, narrow))
              : (one ? b2::pick<true, false>(link, narrow) : b2::pick<false, false>(link, narrow));"""),
    ("  r.pass = prec == kHighest && !narrow ? 1 : 2;", "  r.pass = prec == kHighest ? 1 : 2;"),
    ("  r.words = L.words;\n",
     "  r.words = L.words + (r.pass == 1 && narrow && aligned && L.nbuf == 2 ? xslot_words(D, xdt) "
     ": 0);\n"),
]

#: name -> (edits of csrc/logistic_batched.cu, edits of ops/logistic_fused.py)
VARIANTS = {
    "nograd": ([_NO_GRADIENT], []),
    "nologits": ([_NO_LOGITS], []),
    "staging": ([_NO_GRADIENT, _NO_LOGITS, (_LINK, "          rr[j] = 0.f;")], []),
    "empty": ([(_PASS, _PASS + "\n  if (N > 0) return;")], []),
    "nofinish": ([(_LAUNCH, _LAUNCH.replace("e;", "e;\n    return 0;"))], []),
    "blocks4": ([
        ("constexpr int kBlocks = 132 * kBlocksPerSm;", "constexpr int kBlocks = 132 * 4;"),
        ("__launch_bounds__(kThreads, kBlocksPerSm) b2_chunk(",
         "__launch_bounds__(kThreads, 4) b2_chunk("),
    ], [("B2_BLOCKS = 396", "B2_BLOCKS = 528")]),
    "mma_nograd": ([_MMA_NO_GRADIENT], []),
    "mma_nologits": (_MMA_NO_LOGITS, []),
    "mma_nolink": ([_MMA_NO_LINK], []),
    "mma_staging": ([_MMA_NO_GRADIENT, *_MMA_NO_LOGITS, _MMA_NO_LINK], []),
    "mma_staged_x": (_MMA_STAGED_X, []),
    "mma_prefetch": (_MMA_PREFETCH, []),
    "mma_empty": ([(_MMA_PASS, _MMA_PASS + "\n  if (p.N > 0) return;")], []),
    "mma_lazy": (_MMA_LAZY, []),
    "mma_nt0": ([_MMA_NT0], []),
    "mma_nowiden": ([_MMA_NOWIDEN], []),
    "mma_nocopy": ([_MMA_NOCOPY], []),
    "mma_nostage": ([_MMA_NOWIDEN, _MMA_NOCOPY], []),
    "pass": (_PASS_NARROW, []),
}


def _edit(text, edits, name):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not once in the source")
        text = text.replace(old, new)
    return text


def variant_sources(name):
    """(kernel source, wrapper source) of variant ``name``."""
    cu_edits, py_edits = VARIANTS[name]
    pkg = REPO / "stark_tpu_torch"
    return (_edit((pkg / "csrc" / "logistic_batched.cu").read_text(), cu_edits, name),
            _edit((pkg / "ops" / "logistic_fused.py").read_text(), py_edits, name))


def make_variants():
    for name in VARIANTS:
        cu, py = variant_sources(name)
        dst = OUT / name / "stark_tpu_torch"
        shutil.rmtree(dst.parent, ignore_errors=True)
        shutil.copytree(REPO / "stark_tpu_torch", dst,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "csrc" / "logistic_batched.cu").write_text(cu)
        (dst / "ops" / "logistic_fused.py").write_text(py)
        print(dst)


def time_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as c
    import stark_tpu_torch
    from stark_tpu_torch import _build
    from stark_tpu_torch.ops import logistic_fused as lf

    assert stark_tpu_torch.__file__.startswith(tree), stark_tpu_torch.__file__
    t = time.perf_counter()
    logs = _build.build(["logistic_batched"])
    out = {"tree": tree, "build_s": time.perf_counter() - t,
           "spilled": [k for k in c.spills(logs["logistic_batched"]) if k[1] or k[2]]}
    run = c.Run(False)
    (full, _, _), (lfull, _, _) = c.make_data(run)
    gen = torch.Generator(device=run.dev).manual_seed(3)
    calls = c.b2_narrow_calls(run, full, lfull, gen)
    # config 3's gaussian shape and the shard axis on each narrow X
    shards = c.b2_shard_inputs(c.CONS_SHARDS, run.cons_n // c.CONS_SHARDS, c.CONS_D,
                               c.CONS_CHAINS, gen, run.dev)[:3]
    for xdt in c.X_NARROW:
        largs = c.x_narrow_args("B2", c._lmm_offset_inputs(run, lfull, c.LMM_CHAINS, gen),
                                xdt)[0]
        sargs = c.x_narrow_args("B2", (*shards, None), xdt)[0][:3]
        calls[f"B2 gaussian (LMM) X {xdt}"] = (
            lambda largs=largs: lf.logistic_batched(*largs, link="gaussian"))
        calls[f"B2 shards X {xdt}"] = lambda sargs=sargs: lf.logistic_batched(*sargs)
    # b2_mma: the offset path's shape (C=32, D=32) at high and default
    for with_off in (False, True):
        bargs = c._batched_inputs(run, full, 32, gen, with_off)
        for prec in c.PRECISION_MODES:
            calls[f"B2 {prec} offsets={with_off}"] = (
                lambda bargs=bargs, prec=prec: c.at_precision(prec, lf.logistic_batched, *bargs))
    # b2_mma on narrow X at the same shape (chip_smoke.B2_X_KEYS)
    calls.update(c.b2_x_calls(run, full, gen))
    for key, call in calls.items():
        out[key] = c.timed(run, call, 100)
    return out


def main(argv):
    if argv == ["--variants"]:
        make_variants()
        return 0
    if argv[:1] == ["--one"]:
        print(json.dumps(time_tree(str(Path(argv[1]).resolve()))), flush=True)
        return 0
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    rows = []
    for tree in argv:
        p = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                           text=True)
        if p.returncode:
            print(p.stdout[-2000:], p.stderr[-4000:])
            return 1
        rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print("ms a launch, each tree in turn:")
    for key in rows[0]:
        if key.startswith("B2"):
            print(f"  {key:22s}" + "".join(f"{r[key]:9.4f}" for r in rows))
    print("  trees: " + ", ".join(Path(r["tree"]).name or r["tree"] for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
