#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stark_tpu_torch) on one card, end to end.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (none is caught):
  1. card     — name and power limit (nvidia-smi), torch and CUDA versions
  2. build    — nvcc for sm_90a of every kernel in stark_tpu_torch/csrc,
                all started together; prints each -Xptxas -v report and
                fails if a kernel of B1, B2 or B4 spills registers
  3. parity   — each kernel against its plain PyTorch version on the card,
                at full width, a second launch bitwise equal:
                flagship (D=32, G=1000, N=1,000,000 and a ragged
                1,000,037): B1 at C=64, B2 at C=32 with and without
                offsets, B2's gaussian link at C=32, B3 (one chain) with
                and without offsets and both links;
                LMM, BASELINE config 3 (D=8, Q=2, G=10,000, N=100,000 and
                a ragged 100,037): B4 at C=16, B2's gaussian link at C=16
                with offsets; B4 on config 3's rows without every 7th
                group's (ids without rows);
                B2's edge cases (B2_EDGE_CASES: chain and feature counts
                off its chunks, N below a sub-tile and N = 1, 2, 3 mod 4,
                blocks of two sub-tiles, the widest D of each shared-memory
                tier), both links, with and without offsets, on dyadic
                inputs against the plain version in float64, and its
                refusal one width further; B4's edge cases (B4_EDGE_CASES:
                ids without rows between groups and at both ends, groups
                across sub-tiles and blocks, each chain instantiation, Q =
                2, 3, N below a sub-tile and N = 1, 2, 3 mod 4, each
                shared-memory tier) the same way, ids without rows exactly
                0, and its refusal one width further; B1's, B2's and B4's
                largest distance from float64 on normal inputs beside the
                float32 plain version's
  4. times    — CUDA-event times of each kernel and its plain version,
                beside the least time the card could take (bound); B2 at
                C=1 beside B3 on the same inputs
  5. small    — the port's potential and gradient on the card (kernels)
                against plain autograd on the CPU, on small inputs, for
                the flagship and the LMM families
  6. main     — ChEES flagship: FusedHierLogisticGrouped(32, 1000), 64
                chains, N=1,000,000, through chees_sample; B1's launch
                count must equal the ensemble gradient evaluations
  7. offset   — the same through FusedHierLogistic (kernel B2) at C=32
  8. lmm main — config 3: FusedLinearMixedModelGrouped(8, 10000, 2), 16
                chains, N=100,000, through sample(kernel="chees"); B4's
                launch count must equal the ensemble gradient evaluations
                and no other kernel may launch
  9. lmm offset — the same through FusedLinearMixedModel (B2, gaussian)
 10. single   — logistic_loglik_value_and_grad on the flagship X: one B3
                launch per call, no other kernel
 11. runner   — the adaptive runner (ROADMAP A6) through
                stark_tpu_torch.supervised_sample on the flagship
                (FusedHierLogisticGrouped(32, 1000), N=1,000,000, 64
                chains, B1 on every gradient), two legs, each with its
                launch counts: (a) gated: the bench's MAP 500, warmup 400,
                blocks of 100 up to 5, under the R-hat < 1.01 / ESS > 400
                stop gate; prints whether and where the gate stopped, wall
                time split into set-up, MAP, warmup and sampling, the
                validation pass's R-hat and ESS, ESS/s (min bulk ESS over
                wall, set-up included), and per block the seconds in the
                gate, the checkpoint and the draw-store append; asserts
                the stop was validated (or the run spent its budget), the
                draw store reads back equal to the posterior, the
                checkpoint's block count equals the history's, and B1's
                launches equal the evaluations; (b) resume: a small budget
                run uninterrupted, then under supervision with the first
                attempt faulted after block 1's checkpoint; one restart
                record, and the resumed draws bitwise equal to the
                uninterrupted ones
 12. profile  — one ensemble gradient evaluation of each sampled path at
                its final state: host-clock time per evaluation, and under
                torch.profiler the device time by kernel and the share of
                the window the device sat idle
Each path (and each runner leg) sets every launch count to 0 just
before it and reads them just after.  Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``.

``--cpu-rehearsal`` walks the same phases on the CPU at a tiny size with
the plain versions (no build, no launch counts, no device times); it is
a rehearsal of the control flow, not a result.  There the edge cases'
"kernel" is the float32 plain version itself, so it is held to the
float32 plain version, not to float64.

``--compare-with TREE`` instead times the kernels that TREE (another
checkout, e.g. the parent commit's) shares with this one: B1, B2 (both
links, with and without offsets) and B3 at the flagship's full width, B2's
gaussian link and B4 at config 3's, each tree's own build in its own
process, in the order TREE, this, this, TREE on the same card, and says
for each kernel whether its outputs are bitwise equal across the trees
(every kernel but B4, whose sums run in another order since its
redesign, is expected to be).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the reference's tolerances: value rtol 2e-5; gradients rtol 2e-4 /
# atol 1e-4 (B1-B3), rtol 3e-4 / atol 3e-4 for the LMM (B4 and models)
VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
LMM_RTOL, LMM_ATOL = 3e-4, 3e-4

D, G = 32, 1000
N_FULL, N_RAGGED = 1_000_000, 1_000_037
# BASELINE config 3 (stark_tpu/benchmarks.py:bench_lmm)
LMM_D, LMM_G, LMM_Q = 8, 10_000, 2
LMM_N_FULL, LMM_N_RAGGED = 100_000, 100_037
LMM_CHAINS = 16

# B2's edge cases (N, D, C): chain and feature counts off the 32-chain and
# 32-feature chunks; N below one 128-row sub-tile and N = 1, 2, 3 (mod 4),
# so rows of xT, offsets and resid start off 16-byte alignment; more
# sub-tiles than B2's 396 blocks, so that blocks take two and stage the
# next while they compute (several chunks of chains, features past one
# chunk, each shared-memory tier); the widest D of each tier
# (csrc/logistic_batched.cu:layout) at C=32 (one tile, two buffers, one
# buffer, gradient sums in device memory) and C=64.  One width further
# is refused.
B2_EDGE_CASES = (
    *[(3001, d, c) for c in (1, 7, 33, 100) for d in (1, 3, 33)],
    (50, 5, 9), (40_001, 32, 32), (40_002, 7, 32), (40_003, 32, 20),
    (60_001, 33, 33), (60_002, 3, 100), (60_003, 51, 32), (60_001, 100, 32),
    (60_002, 300, 32),
    *[(1001, d, 32) for d in (32, 51, 273, 327)],
    *[(1001, d, 64) for d in (32, 206, 273)],
)
B2_REFUSED = ((32, 328), (64, 274))

# B4's edge cases (ids, N, D, Q, C, G), csrc/lmm_grouped.cu: ids without
# rows between groups ("gaps") and before the first row's group and after
# the last ("ends"); one group of 5000 rows over 33 blocks ("long");
# groups of 150-250 rows in blocks of two sub-tiles ("wide"); chain
# counts in each instantiation (C <= 8, <= 16, <= 32 at D <= 8) and past
# it; Q = 2, 3; N below one sub-tile and N = 1, 2, 3 (mod 4); each
# shared-memory tier (two buffers, one from D = 9 or at C = 17, Q = 3,
# the gradient sums in device memory, the widest D at C = 64).  One
# width further is refused.  (N = 0: the ids' layout sets it.)
B4_EDGE_CASES = (
    ("gaps", 0, 8, 2, 16, 300), ("gaps", 0, 3, 3, 33, 300), ("ends", 20_011, 8, 2, 16, 300),
    ("long", 0, 8, 2, 16, 400), ("wide", 0, 8, 3, 17, 300),
    *[("uniform", 3001, 8, q, c, 20) for c in (1, 16, 17, 33, 64) for q in (2, 3)],
    ("uniform", 50, 5, 2, 9, 3), ("uniform", 40_001, 8, 2, 16, 4000),
    ("uniform", 40_002, 3, 3, 33, 300), ("uniform", 40_003, 9, 2, 64, 4000),
    ("uniform", 3001, 200, 2, 64, 20), ("uniform", 1001, 216, 2, 64, 20),
)
B4_REFUSED = (64, 2, 217)  # (C, Q, D)
#: kernel libraries whose every kernel must build without spilling
NO_SPILL = ("hier_grouped", "logistic_batched", "lmm_grouped")


def log(*a):
    print(*a, flush=True)


class Run:
    def __init__(self, rehearsal: bool):
        self.rehearsal = rehearsal
        self.dev = torch.device("cpu" if rehearsal else "cuda")
        if rehearsal:
            self.n_full, self.n_ragged = 4_000, 4_037
            self.lmm_n_full, self.lmm_n_ragged, self.lmm_g = 2_000, 2_037, 200
            self.main_budget = dict(map_init_steps=10, num_warmup=30, num_samples=10)
            self.off_budget = dict(map_init_steps=5, num_warmup=20, num_samples=5)
            self.lmm_budget = dict(map_init_steps=10, num_warmup=30, num_samples=10)
            self.lmm_off_budget = dict(map_init_steps=5, num_warmup=20, num_samples=5)
            self.runner_budget = dict(map_init_steps=10, num_warmup=30, block_size=10, max_blocks=5)
            self.resume_budget = dict(map_init_steps=5, num_warmup=20, block_size=10, max_blocks=3)
        else:
            self.n_full, self.n_ragged = N_FULL, N_RAGGED
            self.lmm_n_full, self.lmm_n_ragged, self.lmm_g = LMM_N_FULL, LMM_N_RAGGED, LMM_G
            self.main_budget = dict(map_init_steps=100, num_warmup=150, num_samples=100)
            self.off_budget = dict(map_init_steps=30, num_warmup=100, num_samples=10)
            self.lmm_budget = dict(map_init_steps=100, num_warmup=150, num_samples=100)
            self.lmm_off_budget = dict(map_init_steps=30, num_warmup=60, num_samples=10)
            # the bench's MAP, warmup, block and draw budget (bench.py:552-555,
            # :641, :698-712), the stop gate on
            self.runner_budget = dict(map_init_steps=500, num_warmup=400, block_size=100,
                                      max_blocks=5)
            self.resume_budget = dict(map_init_steps=50, num_warmup=60, block_size=20, max_blocks=3)
        self.t0 = time.perf_counter()
        self.kernels = {}
        self.last_z = {}

    def elapsed(self):
        return time.perf_counter() - self.t0

    def sync(self):
        if not self.rehearsal:
            torch.cuda.synchronize()


def counters():
    """Kernel name -> (wrapper, attribute) of its launch count."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    return {
        "B1": (hf.hier_grouped, "launches"),
        "B2": (lf.logistic_batched, "launches"),
        "B2g": (lf.logistic_batched, "gaussian_launches"),
        "B3": (lf.logistic_single, "launches"),
        "B4": (hf.lmm_grouped, "launches"),
    }


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def timed(run: Run, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events
    on the card; the host clock in a rehearsal).  On the card a sleep
    kernel (about 0.5 ms per call) holds the stream while the host
    enqueues the calls, so the events time the device alone, not the
    host's launch cost."""
    fn()
    fn()
    if run.rehearsal:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, quiet=False):
    """Max abs / rel error of each output (logged unless ``quiet``);
    assert the reference's tolerances (value rtol 2e-5; the rest at rtol
    / atol)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        rel = err / w.abs().clamp_min(1e-30)
        if not quiet:
            log(f"  {name} out{i} {tuple(g.shape)}: max_abs_err={float(err.max()):.6g} "
                f"max_rel_err={float(rel.max()):.6g}")
        if i == 0:
            torch.testing.assert_close(g, w, rtol=VAL_RTOL, atol=0)
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
        worst = max(worst, float(err.max()))
    return worst


def check_repeat(name, got, again):
    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{name} not bitwise repeatable"
    log(f"  {name} second launch bitwise equal: yes")


def phase_card(run: Run):
    log("== card")
    if run.rehearsal:
        log("  cpu rehearsal: no card")
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    run.smi = smi[0] if smi else "unknown"
    log(f"  nvidia-smi: {run.smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build(run: Run):
    log("== build")
    if run.rehearsal:
        log("  cpu rehearsal: kernels not built")
        return
    from stark_tpu_torch import _build

    t = time.perf_counter()
    logs = _build.build()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for name, text in sorted(logs.items()):
        log(f"  --- nvcc csrc/{name}.cu")
        for line in text.strip().splitlines():
            log(f"    {line}")
    for name in NO_SPILL:
        if logs[name] == "(already built)":
            log(f"  csrc/{name}.cu was built before this run: its spills are not read")
            continue
        kernels = spills(logs[name])
        assert kernels, f"no -Xptxas -v report for csrc/{name}.cu"
        bad = [k for k in kernels if k[1] or k[2]]
        assert not bad, f"register spills in csrc/{name}.cu: {bad}"
        log(f"  csrc/{name}.cu: {len(kernels)} kernels, 0 bytes of spill")


def spills(report):
    """(kernel, spill store bytes, spill load bytes) of every kernel in an
    nvcc -Xptxas -v report."""
    out, kernel = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), int(m.group(2))))
            kernel = None
    return out


def make_flagship_data(run: Run):
    from stark_tpu_torch.models import synth_logistic_data

    t = time.perf_counter()
    raw, true = synth_logistic_data(0, run.n_ragged, D, num_groups=G)
    full = {k: v[: run.n_full] for k, v in raw.items()}
    log(f"  flagship: N={run.n_full} and N={run.n_ragged}, D={D}, G={G} "
        f"({time.perf_counter() - t:.1f} s)")
    return full, raw, true


def make_data(run: Run):
    from stark_tpu_torch.models import synth_lmm_data

    flag = make_flagship_data(run)
    t = time.perf_counter()
    lraw, ltrue = synth_lmm_data(0, run.lmm_n_ragged, LMM_D, run.lmm_g, num_random=LMM_Q)
    lfull = {k: v[: run.lmm_n_full] for k, v in lraw.items()}
    log(f"  lmm (config 3): N={run.lmm_n_full} and N={run.lmm_n_ragged}, D={LMM_D}, "
        f"Q={LMM_Q}, G={run.lmm_g} ({time.perf_counter() - t:.1f} s)")
    return flag, (lfull, lraw, ltrue)


def _grouped_inputs(run: Run, raw, chains, gen):
    from stark_tpu_torch.ops.hier_fused import prepare_grouped

    prep = prepare_grouped(raw, D)
    t = {k: torch.as_tensor(prep[k], device=run.dev) for k in ("xT", "y", "gl", "first_gid")}
    beta = 0.3 * torch.randn(chains, D, generator=gen, device=run.dev)
    alpha = torch.randn(chains, G, generator=gen, device=run.dev)
    return (beta, alpha, t["xT"], t["y"], t["gl"], t["first_gid"], prep["lane_tile"]), prep


def _batched_inputs(run: Run, raw, chains, gen, with_offsets):
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T), device=run.dev)
    y = torch.as_tensor(raw["y"], device=run.dev)
    beta = 0.3 * torch.randn(chains, D, generator=gen, device=run.dev)
    off = None
    if with_offsets:
        alpha = torch.randn(chains, G, generator=gen, device=run.dev)
        off = alpha[:, torch.as_tensor(raw["g"], device=run.dev).long()].contiguous()
    return beta, xT, y, off


def _single_inputs(run: Run, raw, gen, with_offsets):
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T), device=run.dev)
    y = torch.as_tensor(raw["y"], device=run.dev)
    beta = 0.3 * torch.randn(D, generator=gen, device=run.dev)
    off = torch.randn(xT.shape[1], generator=gen, device=run.dev) if with_offsets else None
    return beta, xT, y, off


def _lmm_inputs(run: Run, raw, chains, gen):
    """B4's arguments on config 3's layout, at a state near the posterior
    (random-effect scales like the generating ones)."""
    from stark_tpu_torch.ops.hier_fused import prepare_grouped

    prep = prepare_grouped(raw, LMM_D + LMM_Q, transpose_keys=("x", "z"))
    assert prep is not None, "config 3's grouped layout fell back"
    t = {k: torch.as_tensor(prep[k], device=run.dev) for k in ("xT", "zT", "y", "gl", "first_gid")}
    beta = torch.randn(chains, LMM_D, generator=gen, device=run.dev)
    u = 0.6 * torch.randn(chains, run.lmm_g, LMM_Q, generator=gen, device=run.dev)
    ic = 1.0 + 0.1 * torch.randn(chains, generator=gen, device=run.dev)
    args = (beta, u, ic, t["xT"], t["zT"], t["y"], t["gl"], t["first_gid"], prep["lane_tile"])
    return args, prep


def _lmm_offset_inputs(run: Run, raw, chains, gen):
    """B2-gaussian's arguments as FusedLinearMixedModel makes them:
    offsets = intercept + sum_q z_q u[g, q]."""
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T), device=run.dev)
    y = torch.as_tensor(raw["y"], device=run.dev)
    z = torch.as_tensor(raw["z"], device=run.dev)
    g = torch.as_tensor(raw["g"], device=run.dev).long()
    beta = torch.randn(chains, LMM_D, generator=gen, device=run.dev)
    u = 0.6 * torch.randn(chains, run.lmm_g, LMM_Q, generator=gen, device=run.dev)
    off = (1.0 + torch.einsum("nq,cnq->cn", z, u[:, g, :])).contiguous()
    return beta, xT, y, off


def bound(nbytes, flops):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOP_PER_S
    return dict(
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops,
    )


def fmt_bound(e):
    return (f"bound {e['bound_ms']:.4f} ms by {e['bound_by']} "
            f"({e['bytes'] / 1e6:.2f} MB, {e['flops'] / 1e9:.3f} GFLOP)")


def phase_parity_and_times(run: Run, flag, lmm):
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    full, ragged, _ = flag
    lfull, lragged, _ = lmm
    log("== parity (kernel vs plain PyTorch on the same inputs)")
    gen = torch.Generator(device=run.dev).manual_seed(1)
    results = {}
    for label, raw in (("N=%d" % run.n_full, full), ("N=%d" % run.n_ragged, ragged)):
        args, prep = _grouped_inputs(run, raw, 64, gen)
        got = hf.hier_grouped(*args)
        again = hf.hier_grouped(*args)
        run.sync()
        want = hf.hier_grouped_plain(*args)
        err = compare(f"B1 C=64 {label} lane_tile={prep['lane_tile']} k_loc={prep['k_loc']} "
                      f"blocks={hf.b1_blocks(raw['y'].shape[0])[0]}", got, want)
        check_repeat("B1", got, again)
        results.setdefault("B1", (args, err))
        for link in ("bernoulli_logit", "gaussian"):
            for with_off in (False, True):
                bargs = _batched_inputs(run, raw, 32, gen, with_off)
                got = lf.logistic_batched(*bargs, link=link)
                again = lf.logistic_batched(*bargs, link=link)
                run.sync()
                want = lf.logistic_batched_plain(*bargs, link=link)
                err = compare(f"B2 {link} C=32 offsets={with_off} {label}", got, want)
                check_repeat("B2", got, again)
                results.setdefault(f"B2 {link} offsets={with_off}", (bargs, err))
                sargs = _single_inputs(run, raw, gen, with_off)
                got = lf.logistic_single(*sargs, link)
                again = lf.logistic_single(*sargs, link)
                run.sync()
                want = lf.logistic_single_plain(*sargs, link)
                err = compare(f"B3 {link} offsets={with_off} {label}", got, want)
                check_repeat("B3", got, again)
                results.setdefault(f"B3 {link} offsets={with_off}", (sargs, err))
    for label, raw in (("N=%d" % run.lmm_n_full, lfull), ("N=%d" % run.lmm_n_ragged, lragged)):
        args, prep = _lmm_inputs(run, raw, LMM_CHAINS, gen)
        got = hf.lmm_grouped(*args)
        again = hf.lmm_grouped(*args)
        run.sync()
        want = hf.lmm_grouped_plain(*args)
        err = compare(f"B4 C={LMM_CHAINS} {label} lane_tile={prep['lane_tile']} "
                      f"k_loc={prep['k_loc']} blocks={hf.b4_blocks(raw['y'].shape[0])[0]}",
                      got, want, LMM_RTOL, LMM_ATOL)
        check_repeat("B4", got, again)
        results.setdefault("B4", (args, err))
        bargs = _lmm_offset_inputs(run, raw, LMM_CHAINS, gen)
        got = lf.logistic_batched(*bargs, link="gaussian")
        again = lf.logistic_batched(*bargs, link="gaussian")
        run.sync()
        want = lf.logistic_batched_plain(*bargs, link="gaussian")
        err = compare(f"B2 gaussian C={LMM_CHAINS} offsets=True (LMM) {label}", got, want)
        check_repeat("B2 gaussian", got, again)
        results.setdefault("B2g lmm", (bargs, err))
    # ids without rows between groups of one row block: every 7th
    # group's rows dropped from config 3's
    keep = lfull["g"] % 7 != 3
    gaps = {k: v[keep] for k, v in lfull.items()}
    empty = int(np.sum(np.bincount(gaps["g"], minlength=run.lmm_g) == 0))
    args, prep = _lmm_inputs(run, gaps, LMM_CHAINS, gen)
    got = hf.lmm_grouped(*args)
    again = hf.lmm_grouped(*args)
    run.sync()
    want = hf.lmm_grouped_plain(*args)
    compare(f"B4 C={LMM_CHAINS} N={gaps['y'].shape[0]} G={run.lmm_g} with {empty} ids "
            f"without rows", got, want, LMM_RTOL, LMM_ATOL)
    check_repeat("B4 (ids without rows)", got, again)
    phase_b2_edges(run, gen)
    phase_b4_edges(run, results["B4"][0])
    b1_float64_distance(run, gen)

    log("== times (full width: flagship N=%d, LMM N=%d)" % (run.n_full, run.lmm_n_full))
    b1_args, b1_err = results["B1"]
    beta, alpha, xT, y, gl, fg, lane_tile = b1_args
    c, n = beta.shape[0], xT.shape[1]
    b1_bytes = 4 * (xT.numel() + y.numel() + gl.numel() + fg.numel()
                    + 2 * alpha.numel() + 2 * beta.numel() + c)
    b1_flops = 4 * c * D * n  # 2*C*D*N FMAs: logits and the beta gradient
    b1_ms = timed(run, lambda: hf.hier_grouped(*b1_args), 20)
    b1_plain = timed(run, lambda: hf.hier_grouped_plain(*b1_args), 5)
    run.kernels["B1"] = dict(
        name="hier_grouped (B1)", route="cuda",
        source="stark_tpu_torch/csrc/hier_grouped.cu",
        replaces="stark_tpu/ops/hier_fused.py:192",
        max_abs_err=b1_err, ms=b1_ms, plain_ms=b1_plain,
        **bound(b1_bytes, b1_flops), library_ms=None,
    )
    log(f"  B1 C={c}: {b1_ms:.4f} ms, plain {b1_plain:.4f} ms, {fmt_bound(run.kernels['B1'])}")

    def batched_entry(key, name, link, path):
        bargs, err = results[key]
        beta, xT, y, off = bargs
        c, d = beta.shape
        n = xT.shape[1]
        nbytes = 4 * (xT.numel() + y.numel() + 2 * beta.numel() + c
                      + (2 * off.numel() if off is not None else 0))
        flops = 4 * c * d * n
        ms = timed(run, lambda: lf.logistic_batched(*bargs, link=link), 20)
        plain = timed(run, lambda: lf.logistic_batched_plain(*bargs, link=link), 5)
        entry = dict(
            name=name, route="cuda", source="stark_tpu_torch/csrc/logistic_batched.cu",
            replaces="stark_tpu/ops/logistic_fused.py:130",
            max_abs_err=err, ms=ms, plain_ms=plain, **bound(nbytes, flops),
            library_ms=None,
        )
        log(f"  B2 {link} C={c} D={d} N={n} offsets={off is not None} ({path}): "
            f"{ms:.4f} ms, plain {plain:.4f} ms, {fmt_bound(entry)}")
        return entry

    batched_entry("B2 bernoulli_logit offsets=False", "", "bernoulli_logit", "flagship X")
    # the offset path's configurations go into the kernels line
    run.kernels["B2"] = batched_entry(
        "B2 bernoulli_logit offsets=True", "logistic_batched (B2, offsets)",
        "bernoulli_logit", "flagship offset path")
    batched_entry("B2 gaussian offsets=False", "", "gaussian", "flagship X")
    batched_entry("B2 gaussian offsets=True", "", "gaussian", "flagship X")
    run.kernels["B2g"] = batched_entry(
        "B2g lmm", "logistic_batched (B2, gaussian link, offsets)", "gaussian",
        "LMM offset path")

    b4_args, b4_err = results["B4"]
    beta, u, ic, xT, zT, y, gl, fg, lane_tile = b4_args
    c, d = beta.shape
    n, q = xT.shape[1], zT.shape[0]
    b4_bytes = 4 * (xT.numel() + zT.numel() + y.numel() + gl.numel() + fg.numel()
                    + 2 * u.numel() + 2 * beta.numel() + 3 * c)
    b4_flops = 4 * c * n * (d + q)  # 2*C*N*(D+Q) FMAs: mu and the gradients
    b4_ms = timed(run, lambda: hf.lmm_grouped(*b4_args), 50)
    b4_plain = timed(run, lambda: hf.lmm_grouped_plain(*b4_args), 10)
    run.kernels["B4"] = dict(
        name="lmm_grouped (B4)", route="cuda",
        source="stark_tpu_torch/csrc/lmm_grouped.cu",
        replaces="stark_tpu/ops/hier_fused.py:387",
        max_abs_err=b4_err, ms=b4_ms, plain_ms=b4_plain,
        **bound(b4_bytes, b4_flops), library_ms=None,
    )
    log(f"  B4 C={c} D={d} Q={q} N={n} G={u.shape[1]}: {b4_ms:.4f} ms, "
        f"plain {b4_plain:.4f} ms, {fmt_bound(run.kernels['B4'])}")

    for with_off in (False, True):
        sargs, err = results[f"B3 bernoulli_logit offsets={with_off}"]
        beta, xT, y, off = sargs
        d, n = xT.shape
        nbytes = 4 * (xT.numel() + y.numel() + 2 * d + 1
                      + (2 * off.numel() if off is not None else 0))
        ms = timed(run, lambda: lf.logistic_single(*sargs), 20)
        plain = timed(run, lambda: lf.logistic_single_plain(*sargs), 10)
        # the same work through B2 at C=1 (ROADMAP: is B3 just B2 at C=1?)
        b2args = (beta[None], xT, y, None if off is None else off[None])
        b2_ms = timed(run, lambda: lf.logistic_batched(*b2args), 20)
        entry = dict(
            name="logistic_single (B3)", route="cuda",
            source="stark_tpu_torch/csrc/logistic_single.cu",
            replaces="stark_tpu/ops/logistic_fused.py:101",
            max_abs_err=err, ms=ms, plain_ms=plain, **bound(nbytes, 4 * d * n),
            library_ms=None,
        )
        log(f"  B3 D={d} N={n} offsets={with_off}: {ms:.4f} ms, plain {plain:.4f} ms, "
            f"B2 at C=1 {b2_ms:.4f} ms, {fmt_bound(entry)}")
        if not with_off:  # the public op's configuration
            run.kernels["B3"] = entry
    log("  library_ms: none (no single PyTorch call computes these functions)")


def b2_edge_inputs(n, d, c, link, gen, dev):
    """B2's arguments on small dyadic grids: x in {-1, -1/2, 0, 1/2, 1},
    beta in eighths of [-1/2, 1/2], offsets in quarters of [-1, 1], a
    gaussian y in quarters of [-2, 2].  The logits are then exact in
    float32, and so is every step of the gaussian link, so a wrong or
    missing row shows at any width and float32 rounding does not."""
    def grid(shape, k, step):
        return torch.randint(-k, k + 1, shape, generator=gen, device=dev).float() * step

    xT = grid((d, n), 2, 0.5)
    if link == "gaussian":
        y = grid((n,), 8, 0.25)
    else:
        y = (torch.rand(n, generator=gen, device=dev) < 0.4).float()
    return xT, y, grid((c, d), 4, 0.125), grid((c, n), 4, 0.25)


def yardstick(run: Run, fn, *args, **kw):
    """What an edge case is held to: the plain version in float64 on the
    card; in a rehearsal, where the "kernel" is the float32 plain version
    itself, that float32 plain version (its own float32 rounding would
    otherwise stand as the kernel's error)."""
    if run.rehearsal:
        return fn(*args, **kw)
    return plain_in_float64(fn, *args, **kw)


def yardstick_name(run: Run) -> str:
    return "float32 (rehearsal)" if run.rehearsal else "float64"


def plain_in_float64(fn, *args, **kw):
    """The plain version evaluated in float64 on the same inputs (index
    arrays and ints as they are), the yardstick of the edge cases: the
    float32 plain version's own rounding (cuBLAS over tens of thousands of
    rows) exceeds atol 1e-4 on entries near 0."""
    out = fn(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
               for a in args), **kw)
    return tuple(o.float() for o in out)


def phase_b2_edges(run: Run, gen):
    """B2 on its edge cases (B2_EDGE_CASES), both links, with and without
    offsets, against the plain version in float64, a second launch
    bitwise equal; then each width of B2_REFUSED refused before any
    launch."""
    from stark_tpu_torch.ops import logistic_fused as lf

    worst = 0.0
    for n, d, c in B2_EDGE_CASES:
        for link in ("bernoulli_logit", "gaussian"):
            xT, y, beta, offsets = b2_edge_inputs(n, d, c, link, gen, run.dev)
            for off in (None, offsets):
                got = lf.logistic_batched(beta, xT, y, off, link)
                again = lf.logistic_batched(beta, xT, y, off, link)
                run.sync()
                want = yardstick(run, lf.logistic_batched_plain, beta, xT, y, off, link=link)
                worst = max(worst, compare(f"B2 N={n} D={d} C={c} {link}", got, want, quiet=True))
                assert all(torch.equal(a, b) for a, b in zip(got, again)), (n, d, c, link)
    log(f"  B2 edge cases: {len(B2_EDGE_CASES)} shapes x 2 links x with/without offsets "
        f"match the plain version in {yardstick_name(run)} (max abs err {worst:.6g}), second launches "
        f"bitwise equal")
    # why float64 is the yardstick: normal inputs, the kernel and the
    # float32 plain version each held against the float64 plain version
    n, d, c = 40_003, 32, 20
    for link in ("bernoulli_logit", "gaussian"):
        xT = torch.randn(d, n, generator=gen, device=run.dev)
        y = torch.randn(n, generator=gen, device=run.dev) if link == "gaussian" else \
            (torch.rand(n, generator=gen, device=run.dev) < 0.4).float()
        beta = 0.3 * torch.randn(c, d, generator=gen, device=run.dev)
        off = torch.randn(c, n, generator=gen, device=run.dev)
        want = plain_in_float64(lf.logistic_batched_plain, beta, xT, y, off, link=link)
        kern = lf.logistic_batched(beta, xT, y, off, link)
        plain = lf.logistic_batched_plain(beta, xT, y, off, link)
        log(f"  B2 {link} N={n} D={d} C={c} normal inputs, largest |error| of the beta gradient "
            f"against float64: kernel {float((kern[1] - want[1]).abs().max()):.4g}, plain float32 "
            f"{float((plain[1] - want[1]).abs().max()):.4g}")
    if run.rehearsal:
        return
    for c, d in B2_REFUSED:
        need, limit = lf.b2_shared_memory(c, d - 1, 0)
        assert need <= limit, (c, d - 1, need, limit)
        before = (lf.logistic_batched.launches, lf.logistic_batched.gaussian_launches)
        try:
            lf.logistic_batched(torch.zeros(c, d, device=run.dev), torch.zeros(d, 300, device=run.dev),
                                torch.zeros(300, device=run.dev))
        except ValueError as e:
            log(f"  B2 C={c} D={d} refused: {e}")
        else:
            raise AssertionError(f"B2 C={c} D={d} was not refused")
        assert (lf.logistic_batched.launches, lf.logistic_batched.gaussian_launches) == before


def b4_edge_inputs(ids, n, d, q, c, groups, rs):
    """B4's raw rows (x, z, y, g) and (beta, u, intercept), numpy, on small
    dyadic grids: x and z's slopes in halves of [-1, 1], y in quarters of
    [-2, 2], beta in eighths of [-1/2, 1/2], u and the intercepts in
    quarters of [-1, 1]; mu and resid are then exact in float32.  ``ids``
    picks the group ids (B4_EDGE_CASES)."""
    def grid(shape, k, step):
        return (rs.randint(-k, k + 1, size=shape) * step).astype(np.float32)

    if ids in ("gaps", "long", "wide"):
        lo, hi = {"gaps": (40, 400), "long": (100, 200), "wide": (150, 250)}[ids]
        sizes = rs.randint(lo, hi, size=groups)
        if ids == "gaps":
            sizes[::5] = 1
            sizes[3::7] = 0
        if ids == "long":
            sizes[groups // 2] = 5000
        g = np.repeat(np.arange(groups, dtype=np.int32), sizes)
    else:
        margin = 5 if ids == "ends" else 0
        g = rs.randint(margin, groups - margin, size=n).astype(np.int32)
    n = g.shape[0]
    raw = {"x": grid((n, d), 2, 0.5),
           "z": np.concatenate([np.ones((n, 1), np.float32), grid((n, q - 1), 2, 0.5)], 1),
           "y": grid((n,), 8, 0.25), "g": g}
    return raw, (grid((c, d), 4, 0.125), grid((c, groups, q), 4, 0.25), grid((c,), 4, 0.25))


def phase_b4_edges(run: Run, b4_args):
    """B4 on its edge cases (B4_EDGE_CASES) against the plain version in
    float64, a second launch bitwise equal, ids without rows exactly 0;
    B4_REFUSED refused before any launch; and on config 3's inputs
    (``b4_args``) the kernel's and the float32 plain version's largest
    distance from float64."""
    from stark_tpu_torch.ops import hier_fused as hf

    rs = np.random.RandomState(6)
    worst = 0.0
    for ids, n, d, q, c, groups in B4_EDGE_CASES:
        raw, params = b4_edge_inputs(ids, n, d, q, c, groups, rs)
        prep = hf.prepare_grouped(raw, d + q, transpose_keys=("x", "z"))
        assert prep is not None, (ids, n, d, q, c)
        t = [torch.as_tensor(prep[k], device=run.dev) for k in ("xT", "zT", "y", "gl", "first_gid")]
        args = (*(torch.as_tensor(a, device=run.dev) for a in params), *t, prep["lane_tile"])
        got = hf.lmm_grouped(*args)
        again = hf.lmm_grouped(*args)
        run.sync()
        want = yardstick(run, hf.lmm_grouped_plain, *args)
        name = f"B4 {ids} N={prep['y'].shape[0]} D={d} Q={q} C={c}"
        worst = max(worst, compare(name, got, want, LMM_RTOL, LMM_ATOL, quiet=True))
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        empty = np.setdiff1d(np.arange(groups), raw["g"])
        assert torch.all(got[3][:, torch.as_tensor(empty, device=run.dev).long(), :] == 0), name
    log(f"  B4 edge cases: {len(B4_EDGE_CASES)} shapes match the plain version in {yardstick_name(run)} "
        f"(max abs err {worst:.6g}), second launches bitwise equal, ids without rows 0")
    want = plain_in_float64(hf.lmm_grouped_plain, *b4_args)
    kern, plain = hf.lmm_grouped(*b4_args), hf.lmm_grouped_plain(*b4_args)
    log(f"  B4 config 3 (N={b4_args[3].shape[1]}) normal inputs, largest |error| against "
        f"float64 of the beta gradient: kernel {float((kern[2] - want[2]).abs().max()):.4g}, "
        f"plain float32 {float((plain[2] - want[2]).abs().max()):.4g}; of the u gradient: kernel "
        f"{float((kern[3] - want[3]).abs().max()):.4g}, plain float32 "
        f"{float((plain[3] - want[3]).abs().max()):.4g}")
    if run.rehearsal:
        return
    c, q, d = B4_REFUSED
    need, limit = hf.b4_shared_memory(c, d - 1, q, 0)
    assert need <= limit, (c, d - 1, q, need, limit)
    before = hf.lmm_grouped.launches
    n, groups = 300, 10
    lane = hf.grouped_lane_tile(d + q)
    zeros = lambda *shape: torch.zeros(*shape, device=run.dev)
    izeros = lambda *shape: torch.zeros(*shape, dtype=torch.int32, device=run.dev)
    try:
        hf.lmm_grouped(zeros(c, d), zeros(c, groups, q), zeros(c), zeros(d, n), zeros(q, n),
                       zeros(n), izeros(n), izeros(-(-n // lane)), lane)
    except ValueError as e:
        log(f"  B4 C={c} D={d} Q={q} refused: {e}")
    else:
        raise AssertionError(f"B4 C={c} D={d} Q={q} was not refused")
    assert hf.lmm_grouped.launches == before


def b1_float64_distance(run: Run, gen):
    """B1's and the float32 plain version's largest distance from the
    plain version in float64, on normal inputs at N = 40,003, D = 32,
    C = 70 (B1's 'N=3 mod 4' edge case)."""
    from stark_tpu_torch.ops import hier_fused as hf

    n, d, c, groups = 40_003, 32, 70, 300
    rs = np.random.RandomState(7)
    raw = {"x": rs.standard_normal((n, d)).astype(np.float32),
           "y": (rs.rand(n) < 0.4).astype(np.float32),
           "g": rs.randint(0, groups, size=n).astype(np.int32)}
    prep = hf.prepare_grouped(raw, d)
    t = [torch.as_tensor(prep[k], device=run.dev) for k in ("xT", "y", "gl", "first_gid")]
    beta = 0.3 * torch.randn(c, d, generator=gen, device=run.dev)
    alpha = torch.randn(c, groups, generator=gen, device=run.dev)
    args = (beta, alpha, *t, prep["lane_tile"])
    want = plain_in_float64(hf.hier_grouped_plain, *args)
    kern, plain = hf.hier_grouped(*args), hf.hier_grouped_plain(*args)
    log(f"  B1 N={n} D={d} C={c} normal inputs, largest |error| against float64 of the beta "
        f"gradient: kernel {float((kern[1] - want[1]).abs().max()):.4g}, plain float32 "
        f"{float((plain[1] - want[1]).abs().max()):.4g}; of the alpha gradient: kernel "
        f"{float((kern[2] - want[2]).abs().max()):.4g}, plain float32 "
        f"{float((plain[2] - want[2]).abs().max()):.4g}")


def phase_small(run: Run):
    """Potential and gradient of each model of a family on the card (the
    fused ones through the kernels) vs plain autograd (no kernels) on the
    CPU, on small inputs."""
    from stark_tpu_torch import prepare_model_data
    from stark_tpu_torch.model import flatten_model
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        HierLogistic,
        LinearMixedModel,
        synth_lmm_data,
        synth_logistic_data,
    )

    log("== small input: kernels on the card vs plain autograd on the CPU")
    cases = (
        ((HierLogistic, FusedHierLogisticGrouped, FusedHierLogistic), (D, G),
         synth_logistic_data(7, 20_000, D, num_groups=G)[0], 64, (GRAD_RTOL, GRAD_ATOL)),
        ((LinearMixedModel, FusedLinearMixedModelGrouped, FusedLinearMixedModel),
         (LMM_D, 2000, LMM_Q), synth_lmm_data(7, 20_000, LMM_D, 2000, num_random=LMM_Q)[0],
         LMM_CHAINS, (LMM_RTOL, LMM_ATOL)),
    )
    for (plain_cls, *fused), shape, raw, chains, tol in cases:
        ref_fm = flatten_model(plain_cls(*shape))
        ref_data = prepare_model_data(plain_cls(*shape), raw, device="cpu")
        z = 0.2 * torch.randn(chains, ref_fm.ndim, generator=torch.Generator().manual_seed(3))
        want = ref_fm.potential_and_grad(z, ref_data)
        for cls in (plain_cls, *fused):
            model = cls(*shape)
            data = prepare_model_data(model, raw, device=run.dev)
            v, g = flatten_model(model).potential_and_grad(z.to(run.dev), data)
            compare(cls.__name__, (v.cpu(), g.cpu()), want, *tol)


def run_path(run: Run, label, fn, counted, budget, chains):
    """One sampled path: counts to 0 just before, read just after; the
    counted kernel launched once per ensemble gradient evaluation and
    every other kernel not at all."""
    if not run.rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    post = fn()
    run.sync()
    wall = time.perf_counter() - t
    launches = read_counts()
    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    peak = torch.cuda.max_memory_allocated() / 2**20 if not run.rehearsal else float("nan")
    log(f"  wall {wall:.2f} s ({1e3 * wall / max(evals, 1):.4f} ms per evaluation, set-up "
        f"included); ensemble gradient evaluations {evals} "
        f"(per-chain: warmup {int(st['num_warmup_grad_evals'])}, sampling {int(st['num_grad_evals'])})")
    log(f"  launches {launches}; peak device memory {peak:.1f} MiB")
    log(f"  divergences {post.num_divergent} (warmup {int(st['num_warmup_divergent'])}); "
        f"max split R-hat {post.max_rhat():.4f}; mean accept {float(np.mean(st['accept_prob'])):.4f}; "
        f"step size {float(st['step_size'][0]):.5g}; trajectory length {float(st['traj_length']):.5g}")
    for k, v in post.draws.items():
        assert v.shape[:2] == (chains, budget["num_samples"]), (k, v.shape)
        assert np.all(np.isfinite(v)), f"non-finite draws in {k}"
    if not run.rehearsal:
        assert launches[counted] > 0, f"{counted} was never launched on the {label} path"
        assert launches[counted] == evals, (launches, evals)
        others = {k: v for k, v in launches.items() if k != counted and v}
        assert not others, f"{others} launched on the {label} path"
        run.kernels[counted].setdefault("launches", launches[counted])
    run.last_z[label] = torch.as_tensor(post.draws_flat[:, -1], device=run.dev)
    return post, dict(wall_s=wall, evals=evals, launches=launches, peak_mib=peak,
                      max_rhat=post.max_rhat())


def phase_chees(run: Run, raw, true, model_cls, chains, budget, counted):
    from stark_tpu_torch import chees_sample

    log(f"== {model_cls.__name__}: chees_sample, chains={chains}, N={run.n_full}, "
        f"budget {budget}")
    kw = {} if not run.rehearsal else {"device": "cpu"}
    post, res = run_path(
        run, model_cls.__name__,
        lambda: chees_sample(model_cls(D, G), raw, chains=chains, init_step_size=0.1,
                             seed=0, **budget, **kw),
        counted, budget, chains,
    )
    beta_mean = post.draws["beta"].reshape(-1, D).mean(0)
    log(f"  max |posterior mean beta - true beta| {float(np.max(np.abs(beta_mean - true['beta']))):.4g}")
    return res


def phase_lmm(run: Run, raw, true, model_cls, budget, counted):
    """Config 3 through the port's normal entry point, as
    stark_tpu/benchmarks.py:bench_lmm runs it on an accelerator (the
    reference's dispatch_steps bounds a TPU device program and has no
    counterpart here)."""
    from stark_tpu_torch import sample

    log(f"== {model_cls.__name__} (config 3): sample(kernel='chees'), chains={LMM_CHAINS}, "
        f"N={run.lmm_n_full}, D={LMM_D}, Q={LMM_Q}, G={run.lmm_g}, budget {budget}")
    kw = {} if not run.rehearsal else {"device": "cpu"}
    post, res = run_path(
        run, model_cls.__name__,
        lambda: sample(model_cls(LMM_D, run.lmm_g, LMM_Q), raw, kernel="chees",
                       chains=LMM_CHAINS, init_step_size=0.1, seed=0, **budget, **kw),
        counted, budget, LMM_CHAINS,
    )
    means = {k: post.draws[k].reshape((-1,) + post.draws[k].shape[2:]).mean(0)
             for k in ("sigma", "intercept", "tau", "beta")}
    log(f"  posterior means: sigma {float(means['sigma']):.4f} (generating {true['sigma']}), "
        f"intercept {float(means['intercept']):.4f} ({true['intercept']}), "
        f"tau {np.round(means['tau'], 4).tolist()} ({true['tau'].tolist()}); "
        f"max |beta - true| {float(np.max(np.abs(means['beta'] - true['beta']))):.4g}")
    res["means"] = {k: np.asarray(v).tolist() for k, v in means.items()}
    return res


def phase_single(run: Run, raw, calls=10):
    """The public single-chain op on the flagship X: one B3 launch per
    call and no other kernel."""
    from stark_tpu_torch.ops import logistic_fused as lf

    log(f"== single: logistic_loglik_value_and_grad, D={D}, N={run.n_full}, {calls} calls")
    xT = torch.as_tensor(np.ascontiguousarray(raw["x"].T), device=run.dev)
    y = torch.as_tensor(raw["y"], device=run.dev)
    beta = torch.zeros(D, device=run.dev)
    run.sync()
    reset_counts()
    t = time.perf_counter()
    for _ in range(calls):  # a few gradient-ascent steps on the log-lik
        val, grad = lf.logistic_loglik_value_and_grad(beta, xT, y)
        beta = beta + 1e-6 * grad
    run.sync()
    wall = time.perf_counter() - t
    launches = read_counts()
    want = lf.logistic_single_plain(beta, xT, y)
    got = lf.logistic_loglik_value_and_grad(beta, xT, y)
    compare("single final", got, want)
    log(f"  log-lik {float(val):.6g} -> {float(got[0]):.6g}; wall {1e3 * wall:.3f} ms "
        f"for {calls} calls; launches {launches}")
    assert np.isfinite(float(val))
    if not run.rehearsal:
        assert launches["B3"] == calls, launches
        assert sum(launches.values()) == calls, launches
        run.kernels["B3"]["launches"] = launches["B3"]
    return dict(calls=calls, launches=launches, wall_ms=1e3 * wall)


def _runner_leg(run: Run, label, fn):
    """One leg of the runner phase: counts to 0 just before, read just
    after; returns (result, wall seconds, launches)."""
    run.sync()
    reset_counts()
    t = time.perf_counter()
    out = fn()
    run.sync()
    wall = time.perf_counter() - t
    launches = read_counts()
    log(f"  {label}: wall {wall:.2f} s, launches {launches}")
    return out, wall, launches


def _check_b1_launches(run: Run, launches, evals, label):
    if run.rehearsal:
        return
    assert launches["B1"] == evals, (label, launches, evals)
    others = {k: v for k, v in launches.items() if k != "B1" and v}
    assert not others, f"{others} launched on the runner's {label}"
    run.kernels["B1"]["launches"] = run.kernels["B1"].get("launches", 0) + launches["B1"]


def phase_runner(run: Run, full):
    """The adaptive runner with its stop gate, checkpoints, draw store and
    supervised restart, on the flagship at full width (ROADMAP A6, A7)."""
    from stark_tpu_torch import diagnostics, runner, supervised_sample
    from stark_tpu_torch.checkpoint import load_checkpoint
    from stark_tpu_torch.drawstore import read_draws
    from stark_tpu_torch.models import FusedHierLogisticGrouped

    root = REPO / "build" / "chip_smoke_runner"
    shutil.rmtree(root, ignore_errors=True)
    common = dict(kernel="chees", chains=64, init_step_size=0.1, seed=0)
    if run.rehearsal:
        common["device"] = "cpu"
    budget = run.runner_budget
    log(f"== runner (gated): supervised_sample(FusedHierLogisticGrouped({D}, {G})), "
        f"N={run.n_full}, 64 chains, R-hat < 1.01 and ESS > 400, {budget}")
    wd = root / "gated"
    post, wall, launches = _runner_leg(run, "gated leg", lambda: supervised_sample(
        FusedHierLogisticGrouped(D, G), full, workdir=str(wd), min_blocks=2,
        rhat_target=1.01, ess_target=400.0, **budget, **common))
    evals = int(post.sample_stats["num_ensemble_grad_evals"])
    _check_b1_launches(run, launches, evals, "gated leg")
    recs = [json.loads(line) for line in open(wd / "metrics.jsonl")]
    assert not [r for r in recs if r["event"] == "restart"], "the gated leg restarted"
    (warm,) = [r for r in recs if r["event"] == "warmup_done"]
    blocks = post.history
    draws = post.draws_flat
    assert np.all(np.isfinite(draws)), "non-finite draws on the runner path"
    assert draws.shape[0] == 64 and draws.shape[1] == blocks[-1]["draws_per_chain"]
    last = blocks[-1]
    if post.converged:
        assert last["full_max_rhat"] < 1.01 and last["full_min_ess"] > 400.0, last
        stop = f"the gate stopped the run at block {last['block']}, validated by the full pass"
    else:
        assert draws.shape[1] == budget["max_blocks"] * budget["block_size"], draws.shape
        stop = (f"the gate did not stop the run: it spent its budget of "
                f"{budget['max_blocks'] * budget['block_size']} draws per chain")
    stored, chains, dim = read_draws(str(wd / "draws.stkr"))
    assert (chains, dim) == (64, draws.shape[2])
    assert np.array_equal(np.asarray(stored).transpose(1, 0, 2), draws), "draw store != posterior"
    _, meta = load_checkpoint(str(wd / "chain.ckpt.npz"))
    assert meta["blocks_done"] == len(blocks), (meta["blocks_done"], len(blocks))
    split = float(np.max(diagnostics.split_rhat(draws)))
    bulk = float(np.min(diagnostics.ess_bulk(draws)))
    sampling = sum(r["t_dispatch_s"] + r["t_diag_s"] + r["t_store_s"] + r["t_ckpt_s"]
                   for r in blocks)
    per_block = []
    for r in blocks:
        row = {k: r[k] for k in ("block", "draws_per_chain", "max_rhat", "min_ess", "t_dispatch_s",
                                 "t_diag_s", "t_store_s", "t_ckpt_s")}
        row["evals"] = r["block_grad_evals"] // 64
        row["ms_per_eval"] = 1e3 * r["t_dispatch_s"] / max(row["evals"], 1)
        row.update({k: r[k] for k in ("full_max_rhat", "full_min_ess") if k in r})
        per_block.append(row)
    warm_evals = warm["warmup_grad_evals"] // 64 - budget["map_init_steps"]
    res = dict(
        converged=bool(post.converged), stop_block=last["block"] if post.converged else None,
        blocks=len(blocks), draws_per_chain=int(draws.shape[1]), wall_s=wall,
        setup_s=warm["t_setup_s"], map_s=warm["t_map_s"], warmup_s=warm["t_warmup_s"],
        sampling_s=sampling, warmup_evals=warm_evals,
        warmup_ms_per_eval=1e3 * warm["t_warmup_s"] / max(warm_evals, 1),
        map_evals=budget["map_init_steps"] + 1, full_max_rhat=last.get("full_max_rhat"),
        full_min_ess=last.get("full_min_ess"), max_split_rhat=split, min_bulk_ess=bulk,
        ess_per_s=bulk / wall, wall_to_rhat_s=wall if post.converged else None,
        evals=evals, b1_launches=launches["B1"], ms_per_eval=1e3 * wall / evals,
        gate_s=[r["t_diag_s"] for r in blocks], ckpt_s=[r["t_ckpt_s"] for r in blocks],
        store_s=[r["t_store_s"] for r in blocks], per_block=per_block,
        divergences=int(post.num_divergent),
    )
    log(f"  {stop}; {len(blocks)} blocks, {draws.shape[1]} draws per chain")
    log(f"  wall {wall:.2f} s with set-up: set-up {warm['t_setup_s']:.2f}, MAP "
        f"{warm['t_map_s']:.2f} ({budget['map_init_steps'] + 1} evaluations), warmup "
        f"{warm['t_warmup_s']:.2f} ({warm_evals} evaluations, "
        f"{res['warmup_ms_per_eval']:.4f} ms each), sampling {sampling:.2f}")
    log(f"  validation pass: full_max_rhat {last.get('full_max_rhat')}, full_min_ess "
        f"{last.get('full_min_ess')}; max split R-hat {split:.5f}, min bulk ESS {bulk:.1f}; "
        f"ESS/s {bulk / wall:.4f}; divergences {int(post.num_divergent)}")
    log(f"  ensemble gradient evaluations {evals} = B1 launches {launches['B1']}; "
        f"{1e3 * wall / evals:.4f} ms per evaluation (set-up included)")
    for r in per_block:
        valid = (f", validation pass R-hat {r['full_max_rhat']:.5f} ESS {r['full_min_ess']:.1f}"
                 if "full_max_rhat" in r else "")
        log(f"  block {r['block']}: to {r['draws_per_chain']} draws; {r['evals']} evaluations in "
            f"{r['t_dispatch_s']:.3f} s ({r['ms_per_eval']:.4f} ms each); streaming R-hat "
            f"{r['max_rhat']} ESS {r['min_ess']}{valid}; gate {r['t_diag_s']:.4f} s, "
            f"draw-store append {r['t_store_s']:.4f} s, flush and checkpoint {r['t_ckpt_s']:.4f} s")

    small = dict(run.resume_budget, rhat_target=0.0)
    log(f"== runner (resume): the same model, {small}, uninterrupted and then faulted "
        f"after block 1's checkpoint, restarted without a reseed")
    whole, _, launches = _runner_leg(run, "uninterrupted", lambda: supervised_sample(
        FusedHierLogisticGrouped(D, G), full, workdir=str(root / "whole"), **small, **common))
    _check_b1_launches(run, launches, int(whole.sample_stats["num_ensemble_grad_evals"]),
                       "uninterrupted leg")
    real = runner.sample_until_converged
    attempts = []

    def faulted(model, data=None, **kw):
        # the first attempt stops after block 1's checkpoint (a zero time
        # budget), then faults
        attempts.append(kw.get("resume_from"))
        if len(attempts) == 1:
            first = real(model, data, **dict(kw, time_budget_s=0.0))
            attempts.append(int(first.sample_stats["num_ensemble_grad_evals"]))
            raise RuntimeError("fault injected after block 1's checkpoint")
        return real(model, data, **kw)

    runner.sample_until_converged = faulted
    try:
        resumed, _, launches = _runner_leg(run, "faulted and resumed", lambda: supervised_sample(
            FusedHierLogisticGrouped(D, G), full, workdir=str(root / "faulted"),
            reseed_on_restart=False, **small, **common))
    finally:
        runner.sample_until_converged = real
    assert attempts[0] is None and attempts[2] is not None, attempts
    _check_b1_launches(run, launches,
                       attempts[1] + int(resumed.sample_stats["num_ensemble_grad_evals"]),
                       "resume leg")
    restarts = [json.loads(line) for line in open(root / "faulted" / "metrics.jsonl")]
    restarts = [r for r in restarts if r["event"] == "restart"]
    assert len(restarts) == 1, restarts
    same = np.array_equal(resumed.draws_flat, whole.draws_flat)
    log(f"  one restart record ({restarts[0]['error']}); resumed draws "
        f"{resumed.draws_flat.shape} bitwise equal to the uninterrupted run's: "
        f"{'yes' if same else 'no'}")
    assert same, "the resumed draws differ from the uninterrupted run's"
    res["resume"] = dict(restarts=len(restarts), bitwise_equal=same,
                         draws_per_chain=int(whole.draws_flat.shape[1]))
    return res


def phase_profile(run: Run, model, raw, label):
    """Where an ensemble gradient evaluation's time goes, at the state
    the path's run ended in."""
    from stark_tpu_torch import prepare_model_data
    from stark_tpu_torch.model import flatten_model

    pot = flatten_model(model).bind(prepare_model_data(model, raw, device=run.dev))
    z = run.last_z[label]
    for _ in range(3):
        pot.value_and_grad(z)
    run.sync()
    reps = 30
    t = time.perf_counter()
    for _ in range(reps):
        pot.value_and_grad(z)
    run.sync()
    per_eval = 1e3 * (time.perf_counter() - t) / reps
    log(f"== profile {label}: {per_eval:.4f} ms per ensemble gradient "
        f"evaluation (host clock, {reps} evaluations)")
    if run.rehearsal:
        return dict(eval_ms=per_eval)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    reps = 10
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            pot.value_and_grad(z)
        torch.cuda.synchronize()
        window = 1e3 * (time.perf_counter() - t)
    # device time of the kernels alone: an operator's row repeats the
    # time of the kernels it launched, so only CUDA rows are summed
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows) / reps
    log(f"  window {window:.3f} ms for {reps} evaluations (profiler on); kernels "
        f"{busy:.3f} ms, {launches:.0f} launches per evaluation; idle share "
        f"{1 - busy / window:.4f}")
    for ms, count, key in rows[:8]:
        log(f"    {ms / reps:9.4f} ms/eval  x{count / reps:<4.0f} {key[:90]}")
    return dict(eval_ms=per_eval, window_ms=window, kernel_ms=busy,
                kernel_ms_per_eval=busy / reps, launches_per_eval=launches, idle_share=1 - busy / window,
                top=[(r[2][:60], r[0] / reps) for r in rows[:5]])


#: kernels both trees time in --compare-with, and the calls each makes
SHARED_KERNELS = ("B1", "B2 offsets=False", "B2 offsets=True", "B2 gaussian offsets=False",
                  "B2 gaussian offsets=True", "B2 gaussian (LMM)", "B3 offsets=False",
                  "B3 offsets=True", "B4")


def shared_kernel_times(tree: str) -> dict:
    """B1 (C=64), B2 (C=32, both links, with and without offsets) and B3
    (with and without offsets) at the flagship's full width, and B2's
    gaussian link (C=16, offsets) and B4 (C=16) at config 3's, from the
    stark_tpu_torch of ``tree``, built
    from that tree's sources; the calls are the ones both trees share.
    ``digests`` hashes each kernel's outputs apart, so two trees whose
    kernel computes bitwise alike show the same digest for it."""
    import hashlib

    sys.path.insert(0, tree)
    import stark_tpu_torch
    from stark_tpu_torch import _build
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    assert stark_tpu_torch.__file__.startswith(str(tree)), stark_tpu_torch.__file__
    _build.build()
    run = Run(False)
    (full, _, _), (lfull, _, _) = make_data(run)
    gen = torch.Generator(device=run.dev).manual_seed(1)
    b1_args, _ = _grouped_inputs(run, full, 64, gen)
    calls = {"B1": lambda: hf.hier_grouped(*b1_args)}
    for with_off in (False, True):
        bargs = _batched_inputs(run, full, 32, gen, with_off)
        calls[f"B2 offsets={with_off}"] = lambda bargs=bargs: lf.logistic_batched(*bargs)
        calls[f"B2 gaussian offsets={with_off}"] = (
            lambda bargs=bargs: lf.logistic_batched(*bargs, link="gaussian"))
        sargs = _single_inputs(run, full, gen, with_off)
        calls[f"B3 offsets={with_off}"] = lambda sargs=sargs: lf.logistic_single(*sargs)
    gargs = _lmm_offset_inputs(run, lfull, LMM_CHAINS, gen)
    calls["B2 gaussian (LMM)"] = lambda: lf.logistic_batched(*gargs, link="gaussian")
    b4_args, _ = _lmm_inputs(run, lfull, LMM_CHAINS, gen)
    calls["B4"] = lambda: hf.lmm_grouped(*b4_args)
    out = {"tree": tree, "digests": {}}
    for key in SHARED_KERNELS:
        out[key] = timed(run, calls[key], 50 if key in ("B4", "B2 gaussian (LMM)") else 20)
        out["digests"][key] = hashlib.sha1(
            b"".join(t.cpu().numpy().tobytes() for t in calls[key]())
        ).hexdigest()
    return out


def compare_with(other: str) -> int:
    here = str(REPO)
    other = str(Path(other).resolve())
    phase_card(Run(False))
    rows = []
    for tree in (other, here, here, other):
        proc = subprocess.run(
            [sys.executable, __file__, "--shared-kernel-times", tree],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            log(proc.stdout[-4000:], proc.stderr[-4000:])
            raise RuntimeError(f"timing the kernels of {tree} failed")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        log(json.dumps(rows[-1]))
    log("== shared kernels, ms (CUDA events, 20 warm launches queued behind a sleep; "
        "50 at config 3): other, this, this, other; outputs bitwise equal across the trees")
    for key in SHARED_KERNELS:
        same = len({r["digests"][key] for r in rows}) == 1
        expect = "no, B4 sums in another order" if key == "B4" else "yes"
        log(f"  {key}: " + ", ".join(f"{r[key]:.4f}" for r in rows)
            + f"; bitwise equal: {'yes' if same else 'no'} (expected against the parent: {expect})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="walk the phases on the CPU at a tiny size (not a result)")
    ap.add_argument("--compare-with", metavar="TREE",
                    help="time the kernels of TREE and of this checkout, in turns")
    ap.add_argument("--shared-kernel-times", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.shared_kernel_times:
        print(json.dumps(shared_kernel_times(args.shared_kernel_times)), flush=True)
        return 0
    if args.compare_with:
        return compare_with(args.compare_with)

    # fails here, before any result, outside a checkout of the repo
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
    )

    run = Run(args.cpu_rehearsal)
    phase_card(run)
    phase_build(run)
    log("== data")
    flag, lmm = make_data(run)
    phase_parity_and_times(run, flag, lmm)
    phase_small(run)
    full, _, true = flag
    lfull, _, ltrue = lmm
    paths = {
        "main_path": phase_chees(run, full, true, FusedHierLogisticGrouped, 64,
                                 run.main_budget, counted="B1"),
        "offset_path": phase_chees(run, full, true, FusedHierLogistic, 32,
                                   run.off_budget, counted="B2"),
        "lmm_main_path": phase_lmm(run, lfull, ltrue, FusedLinearMixedModelGrouped,
                                   run.lmm_budget, counted="B4"),
        "lmm_offset_path": phase_lmm(run, lfull, ltrue, FusedLinearMixedModel,
                                     run.lmm_off_budget, counted="B2g"),
        "single_path": phase_single(run, full),
        "runner_path": phase_runner(run, full),
    }
    prof = {
        label: phase_profile(run, model, raw, label)
        for label, model, raw in (
            ("FusedHierLogisticGrouped", FusedHierLogisticGrouped(D, G), full),
            ("FusedHierLogistic", FusedHierLogistic(D, G), full),
            ("FusedLinearMixedModelGrouped",
             FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q), lfull),
            ("FusedLinearMixedModel", FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull),
        )
    }
    if not run.rehearsal:
        # the runner path's device busy share: its evaluations times the
        # kernel time of one evaluation (profile phase, same potential)
        rp = paths["runner_path"]
        per_eval = prof["FusedHierLogisticGrouped"]["kernel_ms_per_eval"]
        busy = rp["evals"] * per_eval / 1e3
        rp["idle_share_derived"] = 1 - busy / rp["wall_s"]
        log(f"== runner path: {rp['evals']} evaluations x {per_eval:.4f} ms of kernels each = "
            f"{busy:.1f} s busy of {rp['wall_s']:.1f} s wall: idle share {rp['idle_share_derived']:.4f}")
    log(f"== done in {run.elapsed():.1f} s")
    log(json.dumps({**paths, "profile": prof}))
    if run.rehearsal:
        log(json.dumps({"rehearsal": True, "ok": True}))
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in run.kernels.values()]}))
    print(run.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
