#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stark_tpu_torch) on one card, end to end.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (none is caught):
  1. card     — name and power limit (nvidia-smi), torch and CUDA versions
  2. build    — nvcc for sm_90a of every kernel in stark_tpu_torch/csrc,
                all started together; prints each -Xptxas -v report
  3. parity   — each kernel against its plain PyTorch version on the card
                at the flagship's full width (D=32, G=1000, N=1,000,000,
                and a ragged N=1,000,037): B1 at C=64, B2 at C=32 with and
                without offsets; a second launch must be bitwise equal
  4. times    — CUDA-event times of each kernel and its plain version,
                beside the least time the card could take (bound)
  5. small    — the port's potential and gradient on the card (kernels)
                against plain autograd on the CPU, on a small input
  6. main     — ChEES flagship: FusedHierLogisticGrouped(32, 1000), 64
                chains, N=1,000,000, through chees_sample; B1's launch
                count must equal the ensemble gradient evaluations
  7. offset   — the same through FusedHierLogistic (kernel B2) at C=32
  8. profile  — one ensemble gradient evaluation of each path at full
                width: host-clock time per evaluation, and under
                torch.profiler the device time by kernel and the share of
                the window the device sat idle
Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.

``--cpu-rehearsal`` walks the same phases on the CPU at a tiny size with
the plain versions (no build, no launch counts, no device times); it is
a rehearsal of the control flow, not a result.
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

VAL_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4

D, G = 32, 1000
N_FULL, N_RAGGED = 1_000_000, 1_000_037


def log(*a):
    print(*a, flush=True)


class Run:
    def __init__(self, rehearsal: bool):
        self.rehearsal = rehearsal
        self.dev = torch.device("cpu" if rehearsal else "cuda")
        if rehearsal:
            self.n_full, self.n_ragged = 20_000, 20_037
            self.main_budget = dict(map_init_steps=10, num_warmup=30, num_samples=10)
            self.off_budget = dict(map_init_steps=5, num_warmup=20, num_samples=5)
        else:
            self.n_full, self.n_ragged = N_FULL, N_RAGGED
            self.main_budget = dict(map_init_steps=100, num_warmup=150, num_samples=100)
            self.off_budget = dict(map_init_steps=30, num_warmup=100, num_samples=10)
        self.t0 = time.perf_counter()
        self.kernels = {}
        self.last_z = {}

    def elapsed(self):
        return time.perf_counter() - self.t0

    def sync(self):
        if not self.rehearsal:
            torch.cuda.synchronize()


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


def compare(name, got, want):
    """Max abs / rel error of each output; assert the reference's
    tolerances (value rtol 2e-5; gradients rtol 2e-4, atol 1e-4)."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        rel = err / w.abs().clamp_min(1e-30)
        log(f"  {name} out{i} {tuple(g.shape)}: max_abs_err={float(err.max()):.6g} "
            f"max_rel_err={float(rel.max()):.6g}")
        if i == 0:
            torch.testing.assert_close(g, w, rtol=VAL_RTOL, atol=0)
        else:
            torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        worst = max(worst, float(err.max()))
    return worst


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


def make_data(run: Run):
    from stark_tpu_torch.models import synth_logistic_data

    t = time.perf_counter()
    raw, true = synth_logistic_data(0, run.n_ragged, D, num_groups=G)
    full = {k: v[: run.n_full] for k, v in raw.items()}
    log(f"  data: N={run.n_full} and N={run.n_ragged}, D={D}, G={G} "
        f"({time.perf_counter() - t:.1f} s)")
    return full, raw, true


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


def phase_parity_and_times(run: Run, full, ragged):
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

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
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "B1 not bitwise repeatable"
        log("  B1 second launch bitwise equal: yes")
        results.setdefault("B1", (args, err))
        for with_off in (False, True):
            bargs = _batched_inputs(run, raw, 32, gen, with_off)
            got = lf.logistic_batched(*bargs)
            again = lf.logistic_batched(*bargs)
            run.sync()
            want = lf.logistic_batched_plain(*bargs)
            err = compare(f"B2 C=32 offsets={with_off} {label}", got, want)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), "B2 not bitwise repeatable"
            log("  B2 second launch bitwise equal: yes")
            results.setdefault(f"B2 offsets={with_off}", (bargs, err))

    log("== times (full width, N=%d)" % run.n_full)
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

    for with_off in (False, True):
        bargs, err = results[f"B2 offsets={with_off}"]
        beta, xT, y, off = bargs
        c, n = beta.shape[0], xT.shape[1]
        nbytes = 4 * (xT.numel() + y.numel() + 2 * beta.numel() + c
                      + (2 * off.numel() if off is not None else 0))
        flops = 4 * c * D * n
        ms = timed(run, lambda: lf.logistic_batched(*bargs), 20)
        plain = timed(run, lambda: lf.logistic_batched_plain(*bargs), 5)
        entry = dict(
            name="logistic_batched (B2, offsets)" if with_off else "logistic_batched (B2)",
            route="cuda", source="stark_tpu_torch/csrc/logistic_batched.cu",
            replaces="stark_tpu/ops/logistic_fused.py:130",
            max_abs_err=err, ms=ms, plain_ms=plain, **bound(nbytes, flops),
            library_ms=None,
        )
        log(f"  B2 C={c} offsets={with_off}: {ms:.4f} ms, plain {plain:.4f} ms, {fmt_bound(entry)}")
        if with_off:  # the offset path's configuration
            run.kernels["B2"] = entry
    log("  library_ms: none (no single PyTorch call computes these functions)")


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
            f"({e['bytes'] / 1e6:.1f} MB, {e['flops'] / 1e9:.2f} GFLOP)")


def phase_small(run: Run):
    """Potential and gradient through the kernels on the card vs plain
    autograd (HierLogistic, no kernels) on the CPU, on a small input."""
    from stark_tpu_torch import prepare_model_data
    from stark_tpu_torch.model import flatten_model
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        HierLogistic,
        synth_logistic_data,
    )

    log("== small input: kernels on the card vs plain autograd on the CPU")
    raw, _ = synth_logistic_data(7, 20_000, D, num_groups=G)
    ref_fm = flatten_model(HierLogistic(D, G))
    ref_data = prepare_model_data(HierLogistic(D, G), raw, device="cpu")
    z = 0.2 * torch.randn(64, ref_fm.ndim, generator=torch.Generator().manual_seed(3))
    want_v, want_g = ref_fm.potential_and_grad(z, ref_data)
    for cls in (FusedHierLogisticGrouped, FusedHierLogistic):
        model = cls(D, G)
        data = prepare_model_data(model, raw, device=run.dev)
        v, g = flatten_model(model).potential_and_grad(z.to(run.dev), data)
        compare(cls.__name__, (v.cpu(), g.cpu()), (want_v, want_g))


def phase_chees(run: Run, raw, true, model_cls, chains, budget, counted, idle):
    from stark_tpu_torch import chees_sample
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    model = model_cls(D, G)
    log(f"== {model_cls.__name__}: chees_sample, chains={chains}, N={run.n_full}, "
        f"budget {budget}")
    counters = {"B1": hf.hier_grouped, "B2": lf.logistic_batched}
    if not run.rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    kw = {} if not run.rehearsal else {"device": "cpu"}
    post = chees_sample(model, raw, chains=chains, init_step_size=0.1, seed=0, **budget, **kw)
    run.sync()
    wall = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    peak = torch.cuda.max_memory_allocated() / 2**20 if not run.rehearsal else float("nan")
    beta_mean = post.draws["beta"].reshape(-1, D).mean(0)
    log(f"  wall {wall:.2f} s ({1e3 * wall / max(evals, 1):.4f} ms per evaluation, set-up "
        f"included); ensemble gradient evaluations {evals} "
        f"(per-chain: warmup {int(st['num_warmup_grad_evals'])}, sampling {int(st['num_grad_evals'])})")
    log(f"  launches {launches}; peak device memory {peak:.1f} MiB")
    log(f"  divergences {post.num_divergent} (warmup {int(st['num_warmup_divergent'])}); "
        f"max split R-hat {post.max_rhat():.4f}; mean accept {float(np.mean(st['accept_prob'])):.4f}; "
        f"step size {float(st['step_size'][0]):.5g}; trajectory length {float(st['traj_length']):.5g}")
    log(f"  max |posterior mean beta - true beta| {float(np.max(np.abs(beta_mean - true['beta']))):.4g}")
    for k, v in post.draws.items():
        assert v.shape[:2] == (chains, budget["num_samples"]), (k, v.shape)
        assert np.all(np.isfinite(v)), f"non-finite draws in {k}"
    if not run.rehearsal:
        assert launches[counted] > 0, f"{counted} was never launched on the main path"
        assert launches[counted] == evals, (launches, evals)
        assert launches[idle] == 0, f"{idle} launched on the {counted} path"
        run.kernels[counted]["launches"] = launches[counted]
    run.last_z[model_cls.__name__] = torch.as_tensor(post.draws_flat[:, -1], device=run.dev)
    return dict(wall_s=wall, evals=evals, launches=launches, peak_mib=peak)


def phase_profile(run: Run, raw, model_cls):
    """Where an ensemble gradient evaluation's time goes, at the state
    the path's run ended in."""
    from stark_tpu_torch import prepare_model_data
    from stark_tpu_torch.model import flatten_model

    model = model_cls(D, G)
    pot = flatten_model(model).bind(prepare_model_data(model, raw, device=run.dev))
    z = run.last_z[model_cls.__name__]
    for _ in range(3):
        pot.value_and_grad(z)
    run.sync()
    reps = 30
    t = time.perf_counter()
    for _ in range(reps):
        pot.value_and_grad(z)
    run.sync()
    per_eval = 1e3 * (time.perf_counter() - t) / reps
    log(f"== profile {model_cls.__name__}: {per_eval:.4f} ms per ensemble gradient "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="walk the phases on the CPU at a tiny size (not a result)")
    args = ap.parse_args(argv)
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    # fails here, before any result, outside a checkout of the repo
    from stark_tpu_torch.models import FusedHierLogistic, FusedHierLogisticGrouped

    run = Run(args.cpu_rehearsal)
    phase_card(run)
    phase_build(run)
    log("== data")
    full, ragged, true = make_data(run)
    phase_parity_and_times(run, full, ragged)
    phase_small(run)
    main_res = phase_chees(run, full, true, FusedHierLogisticGrouped, 64,
                           run.main_budget, counted="B1", idle="B2")
    off_res = phase_chees(run, full, true, FusedHierLogistic, 32,
                          run.off_budget, counted="B2", idle="B1")
    prof = {cls.__name__: phase_profile(run, full, cls)
            for cls in (FusedHierLogisticGrouped, FusedHierLogistic)}
    log(f"== done in {run.elapsed():.1f} s")
    log(json.dumps({"main_path": main_res, "offset_path": off_res, "profile": prof}))
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
