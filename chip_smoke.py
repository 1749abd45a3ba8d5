#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stark_tpu_torch) on one card, end to end.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (none is caught):
  1. card     — name and power limit (nvidia-smi), torch and CUDA versions
  2. build    — nvcc for sm_90a of every kernel in stark_tpu_torch/csrc,
                all started together; prints each -Xptxas -v report
  3. parity   — each kernel against its plain PyTorch version on the card,
                at full width, a second launch bitwise equal:
                flagship (D=32, G=1000, N=1,000,000 and a ragged
                1,000,037): B1 at C=64, B2 at C=32 with and without
                offsets, B2's gaussian link at C=32, B3 (one chain) with
                and without offsets and both links;
                LMM, BASELINE config 3 (D=8, Q=2, G=10,000, N=100,000 and
                a ragged 100,037): B4 at C=16, B2's gaussian link at C=16
                with offsets
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
 11. profile  — one ensemble gradient evaluation of each sampled path at
                its final state: host-clock time per evaluation, and under
                torch.profiler the device time by kernel and the share of
                the window the device sat idle
Each path sets every launch count to 0 just before it and reads them
just after.  Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``.

``--cpu-rehearsal`` walks the same phases on the CPU at a tiny size with
the plain versions (no build, no launch counts, no device times); it is
a rehearsal of the control flow, not a result.

``--compare-with TREE`` instead times the kernels that TREE (another
checkout, e.g. the parent commit's) shares with this one, B1 and B2
(bernoulli) at the flagship's full width, each tree's own build in its
own process, in the order TREE, this, this, TREE on the same card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

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
        else:
            self.n_full, self.n_ragged = N_FULL, N_RAGGED
            self.lmm_n_full, self.lmm_n_ragged, self.lmm_g = LMM_N_FULL, LMM_N_RAGGED, LMM_G
            self.main_budget = dict(map_init_steps=100, num_warmup=150, num_samples=100)
            self.off_budget = dict(map_init_steps=30, num_warmup=100, num_samples=10)
            self.lmm_budget = dict(map_init_steps=100, num_warmup=150, num_samples=100)
            self.lmm_off_budget = dict(map_init_steps=30, num_warmup=60, num_samples=10)
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
    on the card; the host clock in a rehearsal)."""
    fn()
    fn()
    if run.rehearsal:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Max abs / rel error of each output; assert the reference's
    tolerances (value rtol 2e-5; the rest at rtol / atol)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        rel = err / w.abs().clamp_min(1e-30)
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
        err = compare(f"B1 C=64 {label} lane_tile={prep['lane_tile']} k_loc={prep['k_loc']}", got, want)
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
                      f"k_loc={prep['k_loc']} blocks={lf.row_blocks(raw['y'].shape[0])[1]}",
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
                launches_per_eval=launches, idle_share=1 - busy / window,
                top=[(r[2][:60], r[0] / reps) for r in rows[:5]])


def shared_kernel_times(tree: str) -> dict:
    """B1 (C=64) and B2 (C=32, with and without offsets) at the
    flagship's full width, from the stark_tpu_torch of ``tree``, built
    from that tree's sources; the calls are the ones both trees share.
    ``digest`` hashes the outputs' bytes, so two trees whose kernels
    compute bitwise alike show the same digest."""
    import hashlib

    sys.path.insert(0, tree)
    import stark_tpu_torch
    from stark_tpu_torch import _build
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    assert stark_tpu_torch.__file__.startswith(str(tree)), stark_tpu_torch.__file__
    _build.build(["hier_grouped", "logistic_batched"])
    run = Run(False)
    full, _, _ = make_flagship_data(run)
    gen = torch.Generator(device=run.dev).manual_seed(1)
    b1_args, _ = _grouped_inputs(run, full, 64, gen)
    out = {"tree": tree, "B1": timed(run, lambda: hf.hier_grouped(*b1_args), 20)}
    results = list(hf.hier_grouped(*b1_args))
    for with_off in (False, True):
        bargs = _batched_inputs(run, full, 32, gen, with_off)
        out[f"B2 offsets={with_off}"] = timed(run, lambda: lf.logistic_batched(*bargs), 20)
        results += lf.logistic_batched(*bargs)
    out["digest"] = hashlib.sha1(
        b"".join(t.cpu().numpy().tobytes() for t in results)
    ).hexdigest()
    return out


def compare_with(other: str) -> int:
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
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
    log("== shared kernels, ms (CUDA events, 20 warm launches): other, this, this, other")
    for key in ("B1", "B2 offsets=False", "B2 offsets=True"):
        log(f"  {key}: " + ", ".join(f"{r[key]:.4f}" for r in rows))
    same = len({r["digest"] for r in rows}) == 1
    log(f"  outputs bitwise equal across the trees: {'yes' if same else 'no'}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="walk the phases on the CPU at a tiny size (not a result)")
    ap.add_argument("--compare-with", metavar="TREE",
                    help="time B1 and B2 of TREE and of this checkout, in turns")
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
