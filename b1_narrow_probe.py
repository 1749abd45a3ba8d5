#!/usr/bin/env python3
"""Time kernel B1 on narrow X, and at highest on float32 X at the chain
counts of its chunk pass (csrc/hier_grouped.cu), from several trees of
stark_tpu_torch, in turns on one card, and make the variant trees that say
what binds it and what its design bought.

    python3 b1_narrow_probe.py --variants       # build/b1_variants/<name>/stark_tpu_torch
    python3 b1_narrow_probe.py TREE [TREE ...]  # each tree's B1 from its own build

A TREE is a directory holding stark_tpu_torch/ (``.`` for this checkout).
Each is timed in a process of its own (CUDA events, 20 warm launches
queued behind a sleep, chip_smoke.timed) at the flagship's shape (C=64,
D=32, N=1M, G=1000) and at the NUTS legs' C=8: float32 X at default, and
X stored as bf16 and as int8 (chip_smoke.x_narrow_args on dyadic values)
at each dot precision; and float32 X at highest at C=8, 16 and 32
(hier_chunk) and at high at C=8.  It prints each tree's build time and
the kernels that spilled.  The variants (VARIANTS), each an edit of this
checkout's source:

- ``pass``: highest on narrow X routed to hier_pass<..., kNarrow> (FP32
  CUDA cores) with the packed words copied in flight, as the tensor-core
  route (split3) was measured against;
- ``plain``: the packed slot never fits, so narrow X is loaded with plain
  loads (stage_x4), as before the windows;
- ``nt0``: the narrow 64-chain kernels read their n-tiles from C;
- ``eager_b``: the narrow 64-chain kernels at highest and high load
  beta's pairs once per k-step, with the run sums in the link;
- ``nowiden``, ``nocopy``, ``nostage``: the widening after the wait, the
  copies of the windows, or both taken out (wrong outputs; the times are
  the point);
- ``chunk_s4``: hier_chunk with 4 x buffers (two sub-tiles in flight) in
  place of 3 (at 32 chains one block an SM); ``chunk_unroll16``: its
  logits' loop over features unrolled whole at 16 chains;
  ``chunk_finish``: its partials added by finish (a thread per output)
  in place of mma_finish; ``chunk_stage``: every sub-tile copied by
  stage, with its per-copy tests;
- ``chunk_nolink``, ``chunk_noseg``, ``chunk_nograd``, ``chunk_nocopy``:
  hier_chunk without the link's special functions, the segment sums (run
  sums and segment_sums), the gradient product, or the copies of x;
  ``chunk_bare`` without the first three, ``chunk_skeleton`` without the
  logits too: its staging, barriers and partials alone (wrong outputs;
  the times are the point).

The chunk keys are also split by torch.profiler into the pass and its
second kernel (``... pass``, ``... finish``).

On a machine with one card:

    python3 b1_narrow_probe.py --variants &&
        python3 b1_narrow_probe.py . build/b1_variants/pass ... .
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "b1_variants"

_PASS = [
    ("template <bool kOneTile, int kPrec>\n__global__ void __launch_bounds__(kThreads, "
     "kBlocksPerSm)\n    hier_pass(",
     "template <bool kOneTile, int kPrec, bool kNarrow = false>\n__global__ void "
     "__launch_bounds__(kThreads, kBlocksPerSm)\n    hier_pass("),
    ("  stage<false, false>(p, xs, ys, gls, row_begin, min(kRows, N - row_begin), x16, -1);",
     "  const int xsw = kNarrow && x16 ? xslot_at(L, D, p.xdt) : -1;\n"
     "  stage<kNarrow, kNarrow>(p, xs, ys, gls, row_begin, min(kRows, N - row_begin), x16, xsw);"),
    ("    stage_rows<kPrec, kRows, kLd, kThreads>(xs + buf * xbuf, D);\n",
     "    if (!kNarrow) stage_rows<kPrec, kRows, kLd, kThreads>(xs + buf * xbuf, D);\n"
     "    else if (xsw >= 0) widen_slot(p, xsw, xs + buf * xbuf, row0, nvalid);\n"),
    ("      stage<false, false>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows,\n"
     "                          gls + (buf ^ 1) * kRows, nrow0, min(kRows, N - nrow0), x16, -1);",
     "      stage<kNarrow, kNarrow>(p, xs + (buf ^ 1) * xbuf, ys + (buf ^ 1) * kRows,\n"
     "                          gls + (buf ^ 1) * kRows, nrow0, min(kRows, N - nrow0), x16, xsw);"),
    ("      stage<false, false>(p, xs, ys, gls, nrow0, min(kRows, N - nrow0), x16, -1);",
     "      stage<kNarrow, kNarrow>(p, xs, ys, gls, nrow0, min(kRows, N - nrow0), x16, xsw);"),
    ("  r.mma = prec != kHighest || narrow;", "  r.mma = prec != kHighest;"),
    ("  if constexpr (kNarrow) {\n    return hier_mma<kOneTile, kHighest, true, kNt>;\n"
     "  } else {\n    return hier_pass<kOneTile, kHighest>;\n  }",
     "  return hier_pass<kOneTile, kHighest, kNarrow>;"),
]
_WIDEN = ("  __syncwarp();  // the warp's copies, each landed for its own lane, to every lane\n")
_COPY = "        x_window_copy(reinterpret_cast<char*>(smem + xsw)"
_NO_WIDEN = (_WIDEN, _WIDEN + "  return;\n")
_NO_COPY = (_COPY, _COPY.replace("x_window_copy", "if (d < 0) x_window_copy"))

_LINK = ("""          const float e = __expf(-fabsf(l));
          const float u = 1.f + e;
          // y log s(l) + (1 - y) log s(-l) = min(l, 0) + (y - 1) l - log1p(e)
          const float v = fmaf(ym1, l, fminf(l, 0.f)) - __logf(u);
          const float sg = __fdividef(l >= 0.f ? 1.f : e, u);
""", """          const float v = fmaf(ym1, l, fminf(l, 0.f));
          const float sg = fmaf(0.25f, l, 0.5f);
""")

_NO_SEG = [("      if (gl1 - gl0 > 1) find_segments", "      if (false) find_segments"),
           ("      if (gl1 - gl0 <= 1) {\n        // one run or two",
            "      if (false) {\n        // one run or two"),
           ("      if (gl1_p - gl0_p > 1) {\n        segment_sums",
            "      if (false) {\n        segment_sums"),
           ("      } else if (t >= kThreads - 32", "      } else if (false && t >= kThreads - 32")]
_NO_GRAD = ("      for (int q = 0; q < K::kQuads; ++q) {", "      for (int q = 0; q < 0; ++q) {")

#: name -> edits of csrc/hier_grouped.cu
VARIANTS = {
    "pass": _PASS,
    "plain": [("  return L.words + xslot_words(D, xdt) <= limit ? L.words : -1;",
               "  return -1;")],
    "nt0": [("  return nt == 8 && (prec == kDefault || narrow) ? 8 : 0;",
             "  return nt == 8 && prec == kDefault ? 8 : 0;")],
    "eager_b": [("  constexpr bool kLazyB = kOneTile && kNarrow && kNt == 8 && kPrec != kDefault;",
                 "  constexpr bool kLazyB = false;")],
    "nowiden": [_NO_WIDEN],
    "nocopy": [_NO_COPY],
    "nostage": [_NO_WIDEN, _NO_COPY],
    "chunk_nolink": [_LINK],
    "chunk_noseg": _NO_SEG,
    "chunk_nograd": [_NO_GRAD],
    "chunk_nocopy": [("  for (int i = t; !kNarrow && i < D * (kRows / 4); i += kThreads) {",
                      "  for (int i = t; !kNarrow && i < 0; i += kThreads) {"),
                     ("          cp_async16(dst, src);", "          if (d < 0) cp_async16(dst, src);")],
    "chunk_s4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "chunk_stage": [("      if (whole16 && row0 + kRows <= N) {", "      if (false) {")],
    "chunk_unroll16": [("#pragma unroll(kCh == 8 ? kFeat / 4 : 2)", "#pragma unroll(kCh == 32 ? 2 : kFeat / 4)")],
    "chunk_bare": [_LINK, *_NO_SEG, _NO_GRAD],
    "chunk_skeleton": [_LINK, *_NO_SEG, _NO_GRAD,
                       ("      for (int d0 = 0; d0 < kFeat; d0 += 4) {",
                        "      for (int d0 = 0; d0 < 0; d0 += 4) {")],
    "chunk_finish": [("  const bool warps = r.mma || r.chunk;", "  const bool warps = r.mma;")],
}


def _edit(text, edits, name):
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not once in the source")
        text = text.replace(old, new)
    return text


def variant_source(name):
    """csrc/hier_grouped.cu of variant ``name``."""
    src = REPO / "stark_tpu_torch" / "csrc" / "hier_grouped.cu"
    return _edit(src.read_text(), VARIANTS[name], name)


def make_variants():
    for name in VARIANTS:
        cu = variant_source(name)
        dst = OUT / name / "stark_tpu_torch"
        shutil.rmtree(dst.parent, ignore_errors=True)
        shutil.copytree(REPO / "stark_tpu_torch", dst,
                        ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "csrc" / "hier_grouped.cu").write_text(cu)
        print(dst)


def time_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as c
    import stark_tpu_torch
    from stark_tpu_torch import _build
    from stark_tpu_torch.ops import hier_fused as hf

    assert stark_tpu_torch.__file__.startswith(tree), stark_tpu_torch.__file__
    t = time.perf_counter()
    logs = _build.build(["hier_grouped"])
    out = {"tree": tree, "build_s": time.perf_counter() - t,
           "spilled": [k for k in c.spills(logs["hier_grouped"]) if k[1] or k[2]]}
    run = c.Run(False)
    full = c.make_flagship_data(run)[0]
    gen = torch.Generator(device=run.dev).manual_seed(1)
    for chains in (8, 16, 32):
        args, _ = c._grouped_inputs(run, full, chains, gen)
        key = f"B1 highest f32 C={chains}"
        out[key] = c.timed(run, lambda: hf.hier_grouped(*args), 20)
        # the pass and its second kernel apart (torch.profiler, 10 launches)
        _, rows = c.device_rows(lambda: [hf.hier_grouped(*args) for _ in range(10)])
        for ms, n, name in rows:
            part = "finish" if "finish" in name else "pass"
            out[f"{key} {part}"] = out.get(f"{key} {part}", 0.0) + ms / n
        if chains == c.NUTS_CHAINS:
            out[f"B1 high f32 C={chains}"] = c.timed(
                run, lambda: c.at_precision("high", hf.hier_grouped, *args), 20)
    for chains in (64, c.NUTS_CHAINS):
        args, _ = c._grouped_inputs(run, full, chains, gen)
        fine = c.dyadic_inputs("B1", args, gen)
        out[f"B1 default f32 C={chains}"] = c.timed(
            run, lambda: c.at_precision("default", hf.hier_grouped, *args), 20)
        for xdt in ("bf16", "int8"):
            kargs = c.x_narrow_args("B1", fine, xdt)[0]
            for prec in ("highest", *c.PRECISION_MODES):
                out[f"B1 {prec} {xdt} C={chains}"] = c.timed(
                    run, lambda: c.at_precision(prec, hf.hier_grouped, *kargs), 20)
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
        if key.startswith("B1"):
            print(f"  {key:26s}" + "".join(f"{r[key]:9.4f}" for r in rows))
    print("  trees: " + ", ".join(Path(r["tree"]).name or r["tree"] for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
