#!/usr/bin/env python3
"""Time kernel B1 on narrow X (csrc/hier_grouped.cu) from several trees of
stark_tpu_torch, in turns on one card, and make the variant trees that say
what binds it and what its design bought.

    python3 b1_narrow_probe.py --variants       # build/b1_variants/<name>/stark_tpu_torch
    python3 b1_narrow_probe.py TREE [TREE ...]  # each tree's B1 from its own build

A TREE is a directory holding stark_tpu_torch/ (``.`` for this checkout).
Each is timed in a process of its own (CUDA events, 20 warm launches
queued behind a sleep, chip_smoke.timed) at the flagship's shape (C=64,
D=32, N=1M, G=1000) and at the NUTS legs' C=8: float32 X at default, and
X stored as bf16 and as int8 (chip_smoke.x_narrow_args on dyadic values)
at each dot precision.  It prints each tree's build time and the kernels
that spilled.  The variants (VARIANTS), each an edit of this checkout's
source:

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
  the point).

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
