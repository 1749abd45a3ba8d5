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
                chains, B1 on every gradient), three legs, each with its
                launch counts (B1's launches = the kept evaluations + those
                of a speculative block the pipelined loop threw away):
                (a) gated: MAP 200, warmup 200, blocks of 100 up to 3 (the
                bench: MAP 500, warmup 400, up to 5 blocks), under the
                R-hat < 1.01 / ESS > 400 stop gate, in
                the pipelined loop, exporting its adaptation; prints
                whether and where the gate stopped, wall time split into
                set-up, MAP, warmup and sampling, the validation pass's
                R-hat and ESS, ESS/s (min bulk ESS over wall, set-up
                included), the thrown-away block's evaluations and
                seconds, and per block the seconds in the gate, the
                checkpoint and the draw-store append, those hidden behind
                the next block and the wait for the verdict; asserts the
                stop was validated (or the run spent its budget), the draw
                store reads back equal to the posterior, the checkpoint's
                block count equals the history's, and the artifact was
                written; (b) adapt_import: sample_until_converged
                importing that artifact (no MAP, warmup 100 so a
                20-transition touch-up, 2 blocks of 15, seed 1); asserts
                the import, the artifact unchanged and the touch-up's
                evaluations below 0.6 of the gated warmup's; prints the
                touch-up's seconds and evaluations beside the gated
                warmup's, the streaming R-hat after 2 blocks and the
                largest |posterior mean - the gated leg's| in the gated
                leg's posterior sds; (c) resume: a small budget run
                uninterrupted, then under supervision with the first
                attempt faulted after block 1's checkpoint; one restart
                record, and the resumed draws bitwise equal to the
                uninterrupted ones
 12. nuts     — NUTS and HMC, the per-chain samplers (ROADMAP A8), at the
                flagship's full width with 8 chains, four legs, each with
                its launch counts: nuts_offset, the reference bench's NUTS
                leg (bench.py:410-415, :485-487) through sample() on
                FusedHierLogistic (B2 with offsets), tree depth 6, 6
                warmup and 6 draws (the bench: 200 and 200);
                nuts_grouped, the same on FusedHierLogisticGrouped (B1);
                hmc_grouped, HMC with 32 leapfrog steps, 6 warmup and 6
                draws (B1); nuts_runner, NUTS through supervised_sample
                (warmup 6, 3 blocks of 3), whole and then faulted after
                block 1's checkpoint,
                the resumed draws bitwise equal.  Each leg prints, beside
                the card's name and power limit, its wall with set-up,
                evaluations and launches (equal, or the phase fails), ms
                per evaluation, tree depth, leaves per transition, lane
                use (the chains' own gradient evaluations over C x the
                ensemble evaluations of sampling), divergences, split
                R-hat, bulk ESS and ESS/s, step sizes and peak device
                memory; a NUTS leg also profiles one transition at its
                final state.  The times phase also times B1 and B2 with
                offsets at the legs' C=8
 12b. pipeline_equiv — the serial block loop (sync_blocks=True) on the
                budgets of the runner's uninterrupted ChEES leg and of
                nuts_runner, at full width: draws, block records but their
                timing fields, checkpoint arrays and accounting meta and
                draw-store bytes bitwise equal to the pipelined runs';
                prints both loops' walls
 13. b2_shards — B2 with its shard axis (consensus Monte Carlo) at
                config 2's width (S=8 shards of n=125,000 rows, C=8, D=16,
                and a ragged 125,003) against the plain version, a second
                launch bitwise equal, the S=1 call bitwise equal to the
                unsharded call; its edge cases (B2_SHARD_EDGE_CASES: S = 1,
                2, 3, 8, shards below one sub-tile, N = 1, 2, 3 mod 4, both
                links, with and without offsets) on dyadic inputs against
                the plain version in float64; times of the kernel, its
                plain version and S separate unsharded launches, beside
                the bound
 14. consensus — BASELINE config 2 at its pinned width (tools/
                consensus_1m.py, stark_tpu/benchmarks.py:574-624):
                consensus_sample(FusedLogistic(16)) on N=1,000,000 rows, 8
                shards x 8 chains, ChEES, MAP 50, warmup 100, samples
                100 (its pinned 200/300/300 cut), dispatch_steps 6,
                combine precision_full: wall,
                ESS/s, split R-hat and combine_rel_err against a full-data
                chees_sample (MAP 30, warmup 60, samples 60, outside
                the wall); every ensemble evaluation one shard-batched B2
                launch and no other kernel; then a NUTS leg (depth 6,
                10 + 10) and a
                shard-death leg (8 shards of 4,096 rows, one shard's y
                NaN: one restart, degraded, that shard lost, finite
                combined draws)
 15. bnn      — BASELINE config 5 at its pinned settings
                (stark_tpu/benchmarks.py:757-839): sghmc_sample of
                BayesianMLP(64, hidden=64) on N=100,000 rows, batches of
                1024, 4 chains, warmup 600, samples 1200 (its pinned
                2000 + 4000 cut), 8 cycles, step
                3e-3, friction 5.0; no hand-written kernel launches;
                predictive accuracy on 256 probe rows (>= 0.75, the
                reference's gate), predictive bulk and tail ESS, R-hat
                and cycle_mode_ratio
 16. tempering — BASELINE config 4 at its pinned width
                (stark_tpu/benchmarks.py:718-754): tempered_sample of
                GaussianMixture(16) on N=50,000 rows (spread 4), init from
                gmm_init_1d, 2 chains x 8 temperatures, NUTS replicas at
                tree depth 7, a swap round every 5 transitions, the
                adaptive ladder, warmup 10 and samples 6 (the bench: 600
                and 500); then an HMC leg (16 leapfrog steps, 10 + 10).  No
                hand-written kernel launches.  Each leg prints, beside the
                card's name and power limit, its wall with set-up,
                evaluations and ms per evaluation, leaves per transition,
                swap_accept_rate, the minimum per-pair rate and beta_hot,
                the cold rung's split R-hat, bulk ESS and ESS/s, the
                posterior mean of mu against the truth and peak device
                memory; asserts finite draws, every adapted ladder pinned
                at 1 and strictly decreasing, and every component's mu
                within 1.0 of its true mean
 17. zoo_glm  — the zoo's GLMs and fused LMM at the fused ops' judged
                width (stark_tpu/benchmarks.py:_fused_vg_case: N=200,000,
                D=32, G=2000, Q=2), 8 chains: B2's gaussian link without
                offsets at C=8 against its plain version, a second launch
                bitwise equal, timed beside its bound; the Poisson and LMM
                fused ops (plain PyTorch) against autograd at the
                reference's tolerances, repeated bitwise, timed beside
                autograd; NUTS (depth 6) through sample() on
                FusedLinearRegression (B2 gaussian, launches =
                evaluations) and FusedPoissonRegression (10 + 10), and
                FusedLMM with STARK_FUSED_LMM=1 (10 + 10; no hand-written
                kernel), each profiled over one transition; consensus_sample on
                FusedLinearMixedModel (config 3's data, 8 shards x 8
                chains, HMC: one B2 launch per shard and evaluation) and
                sghmc_sample on FusedLinearRegression (4 chains, batches
                of 1,024: one B2 launch per chain and step).  Each leg
                prints, beside the card's name and power limit, its
                evaluations, ms per evaluation, split R-hat, min bulk ESS
                and max |posterior mean beta - truth|
 18. zoo_rest — the rest of the zoo at the reference's judged widths
                (stark_tpu/benchmarks.py:884-901): IRT 2,000 persons x 200
                items, the ordinal model (K=5), Student-t, negative
                binomial, horseshoe and Cox PH at N=200,000, D=32,
                stochastic volatility at T=512; 8 chains.  The three fused
                ops (plain PyTorch; IRT's grid, the ordinal and the
                Student-t, each with its knob on) against their plain
                models' autograd at 8 points spread about the truth (value
                rtol 1e-5 / atol 1e-4; gradients scaled by their largest
                magnitude, rtol 1e-4 / atol 2e-5), repeated bitwise and
                timed beside autograd; IRT's triples op the same on the
                responses without every third; then seven NUTS legs
                (depth 6, 10 + 10) through sample(): FusedIRT2PL,
                FusedOrderedLogistic and FusedStudentTRegression with
                their knobs on, NegBinomialRegression,
                HorseshoeRegression, CoxPH and StochasticVolatility, each
                profiled over one transition; no hand-written kernel
                launches.  Each leg prints, beside the card's name and
                power limit, its evaluations, ms per evaluation, split
                R-hat and its distance from the truth (max |mean beta -
                beta|; corr(theta_hat, theta) for IRT; corr(h_hat, h) and
                mean mu for SV)
 19. precision — STARK_FUSED_PRECISION=high and =default (ROADMAP B6):
                every instantiation of B1 (C=64, C=8), B2 (bernoulli C=32
                with and without offsets; gaussian at config 3's width and
                at C=8, D=32, N=200,000; the shard axis at config 2's) and
                B4 (config 3) against its plain version at the same
                precision in float64 on dyadic inputs of the same shapes,
                whose logits are exact (the highest tolerances plus, at the
                bernoulli link, `link_slack`: rows whose rounded resid the
                two may take apart), the plain version at highest shown
                to fail default's check; B1 also at N=40,003, C=70; on
                normal inputs a second launch bitwise equal, and against
                the kernel at highest inside the reference's band (tools/
                precision_parity.py:19-21); B2's and B4's edge cases at
                high and default; CUDA-event times beside the bound (bf16
                tensor cores, and the FP32 CUDA cores the kernels run on); then
                chees_sample on the flagship (B1), its offset path (B2),
                config 3 (B4) and its offset path (B2 gaussian), and
                consensus_sample on config 2 (the shard axis) under each
                precision, launches = evaluations, all at that precision;
                then each fused model's potential and gradient under each
                precision against its plain model at highest, inside the
                band.  (The runner phase reruns its adapt_import leg at
                high, warmup 100 and 2 blocks of 15: each parameter's
                posterior mean shift in the gated leg's sds, below 0.3.)
 20. x dtype  — STARK_FUSED_X_DTYPE=bf16, int8, fp8e4m3 and fp8e5m2
                (ROADMAP B5): every kernel case of the precision phase
                (B1 at C=64, C=8 and N=40,003; B2 bernoulli with and
                without offsets, gaussian at config 3's and the zoo's
                widths, the shard axis at config 2's; B4 at config 3's)
                and B3 on the flagship X, with X (and B4's z) stored
                narrow on dyadic values whose logits are exact, against
                the plain version in float64 on the widened values at
                highest, a second launch bitwise equal, CUDA-event times
                beside the bound at the storage width; the kernels'
                full-width shapes also at high and default; one B1 call on
                int8 X at the flagship allocating less than the float32
                slab beyond its inputs and outputs.  Then the precision
                phase's five chees_sample / consensus_sample legs under
                each narrow dtype (launches = evaluations, all of that
                dtype) and the single-chain op (B3) on X prepared under
                each; then each fused model's potential and gradient with
                X narrow against the same model with float32 X on the
                rounded matrix, inside the reference's band (mid for bf16,
                quant for int8 and fp8).  (The runner phase reruns its
                adapt_import leg with X in each narrow dtype, warmup 100
                and 2 blocks of 15: the posterior mean shift in the gated
                leg's sds, below 0.3 for bf16 and int8, reported for fp8.)
 21. profile  — one ensemble gradient evaluation of each sampled path at
                its final state (the GMM's at 16 points of its run):
                host-clock time per evaluation, and under torch.profiler
                the device time by kernel and the share of the window the
                device sat idle
Each path (and each runner and NUTS leg) sets every launch count to 0
just before it and reads them just after.  Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``.

``--cpu-rehearsal`` walks the same phases on the CPU at a tiny size with
the plain versions (no build, no launch counts, no device times); it is
a rehearsal of the control flow, not a result.  There the edge cases'
"kernel" is the float32 plain version itself, so it is held to the
float32 plain version, not to float64.

``--pipeline-turns`` instead runs the runner's legs (the resume legs'
ChEES budget, nuts_runner's and the gated leg's, at full width) in the
pipelined and the serial block loop in turns on one card (pipelined,
serial, serial, pipelined), draws bitwise equal, and prints each run's
wall and where its sampling time went.

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
import contextlib
import json
import os
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
# the per-chain samplers' chain count (bench.py:412, its NUTS leg)
NUTS_CHAINS = 8
# BASELINE config 2 (tools/consensus_1m.py:26-45, stark_tpu/benchmarks.py:
# bench_consensus_logistic): flat logistic, D=16, N=1,000,000 in 8 shards
# of 125,000 rows, 8 chains per shard, ChEES
CONS_D, CONS_N, CONS_SHARDS, CONS_CHAINS = 16, 1_000_000, 8, 8
# BASELINE config 5 (stark_tpu/benchmarks.py:bench_bnn_sghmc): a 2-layer
# MLP, 64 features, 64 hidden units, N=100,000, batches of 1024, 4 chains
BNN_D, BNN_H, BNN_N, BNN_BATCH, BNN_CHAINS = 64, 64, 100_000, 1024, 4
# the reference's gate on config 5 (stark_tpu/benchmarks.py:838-839)
BNN_MIN_ACCURACY = 0.75
# BASELINE config 4 (stark_tpu/benchmarks.py:718-754, bench_gmm_tempered):
# GaussianMixture(16) on N=50,000 rows (spread 4), 2 chains x 8
# temperatures, NUTS replicas at tree depth 7, a swap round every 5
# transitions, the adaptive ladder, init from gmm_init_1d
GMM_K, GMM_N, GMM_CHAINS, GMM_TEMPS, GMM_SPREAD = 16, 50_000, 2, 8, 4.0
# every component's posterior mean of mu within this of its true mean:
# the true means lie GMM_SPREAD apart, so a mis-allocated component fails
GMM_MU_TOL = 1.0

# the zoo's fused ops at their judged width (stark_tpu/benchmarks.py:
# _fused_vg_case at scale 1, :870 and :877): the flat GLMs at N=200,000,
# D=32, the LMM at G=2000 groups (Q=2); 8 chains, NUTS at tree depth 6
ZOO_N, ZOO_D, ZOO_G, ZOO_Q, ZOO_CHAINS = 200_000, 32, 2000, 2, 8
# the reference's tolerances: the Poisson fused op against autograd (value
# rtol 1e-5; gradient rtol 1e-4 / atol 1e-3, tests/test_glm_fused.py:45-46);
# the LMM's (value rtol 1e-5 / atol 1e-4; gradient scaled by its largest
# magnitude, rtol 1e-4 / atol 2e-5, tests/test_zoo_fused.py:87-91)
GLM_VAL_RTOL, GLM_GRAD_RTOL, GLM_GRAD_ATOL = 1e-5, 1e-4, 1e-3
ZLMM_VAL_RTOL, ZLMM_VAL_ATOL, ZLMM_GRAD_RTOL, ZLMM_GRAD_ATOL = 1e-5, 1e-4, 1e-4, 2e-5
# the SG-HMC repair leg: FusedLinearRegression minibatches of 1024 rows
ZOO_SGHMC_BATCH, ZOO_SGHMC_CHAINS = 1024, 4
# the rest of the zoo at the reference's judged widths (stark_tpu/
# benchmarks.py:884-901, _fused_vg_case at scale 1): IRT 2,000 persons x
# 200 items (400,000 responses); the ordinal model N=200,000, D=32, K=5;
# the row families (Student-t, negative binomial, horseshoe, Cox PH) at
# the flat GLMs' N=200,000, D=32; stochastic volatility at T=512, the one
# width the reference runs it at (tests/test_model_zoo.py:99-116)
IRT_P, IRT_I, ORD_K, SV_T = 2000, 200, 5, 512

# B2's shard-axis edge cases (S, N, D, C): one, two, three and eight
# shards; shards below one 128-row sub-tile (N = 50, 127) and of N = 1,
# 2, 3 (mod 4) rows, so a shard's rows start off 16-byte alignment;
# shards of more sub-tiles than their share of the 396 blocks (N =
# 40,003 at S = 2 and 3); chain and feature counts off the 32-chain and
# 32-feature chunks; config 2's own width with a ragged shard
B2_SHARD_EDGE_CASES = (
    (1, 3001, 7, 9), (2, 3001, 33, 33), (3, 50, 5, 9), (3, 127, 16, 8),
    (2, 40_003, 32, 20), (3, 40_002, 3, 40), (8, 1001, 16, 8), (8, 5, 16, 8),
    (8, 125_003, 16, 8),
)

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
            self.import_budget = dict(num_warmup=30, block_size=10, max_blocks=2)
            self.import_precision_budget = self.import_budget
            self.nuts_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=10)
            self.hmc_budget = dict(num_leapfrog=8, num_warmup=20, num_samples=10)
            self.nuts_runner_budget = dict(max_tree_depth=4, num_warmup=20, block_size=10,
                                           max_blocks=3)
            self.cons_n = 8 * 2048
            self.cons_budget = dict(map_init_steps=20, num_warmup=60, num_samples=60)
            self.cons_full_budget = self.cons_budget
            self.cons_nuts_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=20)
            self.bnn_n = 4_000
            self.bnn_budget = dict(num_warmup=100, num_samples=200, cycles=4)
            self.gmm_n = 4_000
            self.gmm_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=20)
            self.gmm_hmc_budget = dict(num_leapfrog=4, num_warmup=10, num_samples=10)
            self.zoo_n, self.zoo_g = 4_000, 40
            self.zoo_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=10)
            self.zoo_lmm_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=10)
            self.zoo_cons_budget = dict(num_leapfrog=4, num_warmup=10, num_samples=10)
            self.zoo_sghmc_budget = dict(num_warmup=50, num_samples=100)
            self.irt_p, self.irt_i, self.sv_t = 100, 20, 128
            self.zoo_rest_budget = dict(max_tree_depth=4, num_warmup=20, num_samples=10)
            self.precision_budget = dict(map_init_steps=5, num_warmup=10, num_samples=5)
        else:
            self.n_full, self.n_ragged = N_FULL, N_RAGGED
            self.lmm_n_full, self.lmm_n_ragged, self.lmm_g = LMM_N_FULL, LMM_N_RAGGED, LMM_G
            # every budget cut below keeps the script inside its time
            # limit; the one it had before the zoo_rest phase came is noted
            # (100/150/100 and 30/50/10)
            # (60/60/30, cut from 100/100/50 for the X-dtype phases; 30/30/15
            # and 10/10/5 from 60/60/30 and 20/20/10 to keep the script
            # inside half its time limit on a slow host)
            self.main_budget = dict(map_init_steps=30, num_warmup=30, num_samples=15)
            self.off_budget = dict(map_init_steps=10, num_warmup=10, num_samples=5)
            # config 3's MAP 300, warmup 700, samples 500 (100/50/25 and
            # 30/30/10; then 30/15/10 and 20/15/10)
            self.lmm_budget = dict(map_init_steps=15, num_warmup=10, num_samples=5)
            self.lmm_off_budget = dict(map_init_steps=10, num_warmup=10, num_samples=5)
            # the bench's block size and stop gate (bench.py:552-555, :641,
            # :698-712); its MAP 500, warmup 400 and 5 blocks cut to 200, 200
            # and 3: the gate may now spend the budget without stopping
            self.runner_budget = dict(map_init_steps=200, num_warmup=200, block_size=100,
                                      max_blocks=3)
            # the resume legs check bitwise resume, not convergence (MAP 50,
            # warmup 30, 3 blocks of 10; then 10/10 and 3 blocks of 5)
            self.resume_budget = dict(map_init_steps=5, num_warmup=5, block_size=3, max_blocks=3)
            # the adapt_import legs, at float32 X and highest and at every
            # other setting alike: a 20-transition touch-up (0.2 of 100),
            # 2 blocks of 15 (float32's cut from 400 and 2 blocks of 50)
            self.import_budget = dict(num_warmup=100, block_size=15, max_blocks=2)
            self.import_precision_budget = self.import_budget
            # the reference bench's NUTS leg (bench.py:410-415): 8 chains,
            # tree depth 6; its 200 warmup and 200 samples cut to 6 each
            # (50 each, then 10 each), HMC's too (50 + 50, then 10 + 10);
            # the runner's (warmup 30, 3 blocks of 10; then warmup 10, 3
            # blocks of 5)
            self.nuts_budget = dict(max_tree_depth=6, num_warmup=6, num_samples=6)
            self.hmc_budget = dict(num_leapfrog=32, num_warmup=6, num_samples=6)
            self.nuts_runner_budget = dict(max_tree_depth=6, num_warmup=6, block_size=3,
                                           max_blocks=3)
            self.cons_n = CONS_N
            # config 2's pinned budget, 200/300/300 (stark_tpu/benchmarks.py:
            # 574-624), cut to a quarter and a third (halved until the
            # X-dtype phases)
            self.cons_budget = dict(map_init_steps=50, num_warmup=100, num_samples=100)
            # the full-data run the combine is held against, and the NUTS
            # leg (config 2's budget, and 50 + 50, then 20 + 20)
            self.cons_full_budget = dict(map_init_steps=30, num_warmup=60, num_samples=60)
            self.cons_nuts_budget = dict(max_tree_depth=6, num_warmup=10, num_samples=10)
            self.bnn_n = BNN_N
            # config 5's pinned budget, 2000 + 4000 (stark_tpu/benchmarks.py:
            # 757-776), halved
            # (600 + 1200, cut from 1000 + 2000 for the X-dtype phases)
            self.bnn_budget = dict(num_warmup=600, num_samples=1200, cycles=8)
            self.gmm_n = GMM_N
            # config 4's depth 7; its 600 warmup and 500 samples cut to
            # 10 and 6 (100 and 75, then 15 and 10)
            self.gmm_budget = dict(max_tree_depth=7, num_warmup=10, num_samples=6)
            # the reference's default kernel, HMC, 16 leapfrog steps (50 + 50)
            self.gmm_hmc_budget = dict(num_leapfrog=16, num_warmup=10, num_samples=10)
            self.zoo_n, self.zoo_g = ZOO_N, ZOO_G
            # the NUTS legs' budget (the reference bench's depth 6; 50 + 50)
            # (15 + 15, cut from 20 + 20 for the X-dtype phases; then 10 + 10)
            self.zoo_budget = dict(max_tree_depth=6, num_warmup=10, num_samples=10)
            # the LMM's (30 + 30; 50 + 50 took the whole script to 1,022.5
            # s on one H100 80GB HBM3 at 700 W)
            self.zoo_lmm_budget = dict(max_tree_depth=6, num_warmup=10, num_samples=10)
            # the repair legs check that the paths run, not convergence;
            # HMC (30 + 20): ChEES at 20/30/20 took 6,903 evaluations (106 s
            # on one H100 80GB HBM3 at 700 W)
            self.zoo_cons_budget = dict(num_leapfrog=16, num_warmup=10, num_samples=10)
            self.zoo_sghmc_budget = dict(num_warmup=100, num_samples=200)
            self.irt_p, self.irt_i, self.sv_t = IRT_P, IRT_I, SV_T
            # the rest of the zoo's seven NUTS legs: depth 6, 20 + 20 (30 +
            # 30 until PR 14's precision phases)
            # (15 + 15, cut from 20 + 20 for the X-dtype phases; then 10 + 10)
            self.zoo_rest_budget = dict(max_tree_depth=6, num_warmup=10, num_samples=10)
            # the precision phase's legs check the paths at each precision,
            # not convergence: ChEES, MAP 3, warmup 3, samples 3 (MAP 10,
            # warmup 10, samples 5: 98 s for the ten legs on one H100 80GB
            # HBM3 at 700 W; 5 / 5 / 5: 42 s)
            self.precision_budget = dict(map_init_steps=3, num_warmup=3, num_samples=3)
        # the shard-death leg: 8 shards of 4096 rows, one poisoned
        self.death_n = 8 * 4096
        self.death_budget = dict(map_init_steps=5, num_warmup=5, num_samples=5)
        self.t0 = time.perf_counter()
        self.phase_s = {}
        self.kernels = {}
        self.last_z = {}

    def elapsed(self):
        return time.perf_counter() - self.t0

    def phase(self, name, fn, *args):
        """``fn(*args)``, its seconds kept under ``name`` and logged with
        the script's time so far."""
        t = time.perf_counter()
        out = fn(*args)
        self.phase_s[name] = time.perf_counter() - t
        log(f"  ({name}: {self.phase_s[name]:.1f} s; script at {self.elapsed():.1f} s)")
        return out

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
        "B2s": (lf.logistic_batched, "shard_launches"),
        "B3": (lf.logistic_single, "launches"),
        "B4": (hf.lmm_grouped, "launches"),
    }


def precision_counters():
    """Kernel name -> the wrapper whose ``precision_launches`` count its
    launches by dot precision."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    return {"B1": hf.hier_grouped, "B2": lf.logistic_batched, "B4": hf.lmm_grouped}


def x_dtype_counters():
    """Kernel name -> the wrapper whose ``x_dtype_launches`` count its
    launches by the storage dtype of X."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    return {"B1": hf.hier_grouped, "B2": lf.logistic_batched, "B3": lf.logistic_single,
            "B4": hf.lmm_grouped}


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    for fn in precision_counters().values():
        fn.precision_launches = dict.fromkeys(fn.precision_launches, 0)
    for fn in x_dtype_counters().values():
        fn.x_dtype_launches = dict.fromkeys(fn.x_dtype_launches, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def timed(run: Run, fn, reps: int, launches: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events
    on the card; the host clock in a rehearsal).  On the card a sleep
    kernel (about 0.5 ms per wrapper call, ``launches`` of them in one
    ``fn``) holds the stream while the host enqueues the calls, so the
    events time the device alone, not the host's launch cost."""
    fn()
    fn()
    if run.rehearsal:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * launches * 1_000_000)
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


def bound(nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / flop_rate
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
    run.c8 = times_at_nuts_chains(run, full, gen)
    log("  library_ms: none (no single PyTorch call computes these functions)")


def times_at_nuts_chains(run: Run, full, gen):
    """B1 and B2 with offsets at the per-chain samplers' C=8 on the
    flagship X: each against its plain version, timed beside it, with its
    bound."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    out = {}
    c, n = NUTS_CHAINS, full["y"].shape[0]
    args, _ = _grouped_inputs(run, full, c, gen)
    beta, alpha, xT, y, gl, fg, _ = args
    err = compare(f"B1 C={c} N={n}", hf.hier_grouped(*args), hf.hier_grouped_plain(*args))
    e = bound(4 * (xT.numel() + y.numel() + gl.numel() + fg.numel() + 2 * alpha.numel()
                   + 2 * beta.numel() + c), 4 * c * D * n)
    e.update(max_abs_err=err, ms=timed(run, lambda: hf.hier_grouped(*args), 50),
             plain_ms=timed(run, lambda: hf.hier_grouped_plain(*args), 10))
    out["B1"] = e
    bargs = _batched_inputs(run, full, c, gen, True)
    beta, xT, y, off = bargs
    err = compare(f"B2 bernoulli_logit C={c} offsets=True N={n}",
                  lf.logistic_batched(*bargs), lf.logistic_batched_plain(*bargs))
    e = bound(4 * (xT.numel() + y.numel() + 2 * beta.numel() + c + 2 * off.numel()),
              4 * c * D * n)
    e.update(max_abs_err=err, ms=timed(run, lambda: lf.logistic_batched(*bargs), 50),
             plain_ms=timed(run, lambda: lf.logistic_batched_plain(*bargs), 10))
    out["B2 offsets"] = e
    for k, e in out.items():
        log(f"  {k} C={c} (the NUTS legs' chain count): {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, {fmt_bound(e)}")
    return out


def b2_edge_inputs(n, d, c, link, gen, dev, fine=False):
    """B2's arguments on small dyadic grids: x in {-1, -1/2, 0, 1/2, 1},
    beta in eighths of [-1/2, 1/2], offsets in quarters of [-1, 1], a
    gaussian y in quarters of [-2, 2].  The logits are then exact in
    float32, and so is every step of the gaussian link, so a wrong or
    missing row shows at any width and float32 rounding does not.
    ``fine``: x in steps of 2^-9 (up to 10 significant bits, so bf16
    rounds it and x_lo is not 0), the logits still exact (multiples of
    2^-12 below 2^8): the operands the dot precisions round are exercised
    and the kernel and the plain version round the same values."""
    def grid(shape, k, step):
        return torch.randint(-k, k + 1, shape, generator=gen, device=dev).float() * step

    xT = grid((d, n), 512, 2.0 ** -9) if fine else grid((d, n), 2, 0.5)
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


def phase_b2_edges(run: Run, gen, prec="highest"):
    """B2 on its edge cases (B2_EDGE_CASES), both links, with and without
    offsets, against the plain version in float64, a second launch
    bitwise equal; then each width of B2_REFUSED refused before any
    launch.  At another dot precision ``prec``: the kernel at ``prec``
    against the plain version at ``prec`` in float64, the bernoulli
    link's rows near a rounding boundary of resid allowed their
    `link_slack` (the logits are exact); at default on `b2_edge_inputs`'
    fine grid, at high on its coarse one, whose gradient sums are exact
    in float32 (x_lo is 0 there, so high's staging of every shape is
    checked and its rounding by `phase_precision_kernels`).  On the fine
    grid high's three float32 FMAs a product stand, at the widest
    shapes, about as far from float64 sums as highest's tolerance: that
    distance is measured, beside highest's on the same inputs."""
    from stark_tpu_torch.ops import logistic_fused as lf

    worst = 0.0
    fine = prec == "default"
    for n, d, c in B2_EDGE_CASES:
        for link in ("bernoulli_logit", "gaussian"):
            xT, y, beta, offsets = b2_edge_inputs(n, d, c, link, gen, run.dev, fine)
            for off in (None, offsets):
                with env(PREC_KNOB, prec):
                    got = lf.logistic_batched(beta, xT, y, off, link)
                    again = lf.logistic_batched(beta, xT, y, off, link)
                run.sync()
                want = yardstick(run, lf.logistic_batched_plain, beta, xT, y, off, link=link,
                                 prec=prec)
                name = f"B2 N={n} D={d} C={c} {link}"
                if prec != "highest":
                    slack = b2_link_slack((beta, xT, y, off), prec, link)
                    err, excess = compare_slack(name, got, want, slack, GRAD_RTOL, GRAD_ATOL,
                                                quiet=True)
                    assert excess <= 0, f"{name}: error exceeds its bound by {excess:.4g}"
                else:
                    err = compare(name, got, want, quiet=True)
                worst = max(worst, err)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), (n, d, c, link)
    log(f"  B2 edge cases at {prec}{' on the fine grid' if fine else ''}: {len(B2_EDGE_CASES)} "
        f"shapes x 2 links x with/without offsets match the plain version in "
        f"{yardstick_name(run)} (max abs err {worst:.6g}), second launches bitwise equal")
    if prec == "high":
        n, d, c = 60_002, 300, 32
        xT, y, beta, _ = b2_edge_inputs(n, d, c, "gaussian", gen, run.dev, fine=True)
        for p in ("highest", "high"):
            with env(PREC_KNOB, p):
                got = lf.logistic_batched(beta, xT, y, None, "gaussian")
            want = yardstick(run, lf.logistic_batched_plain, beta, xT, y, None, link="gaussian",
                             prec=p)
            err, excess = compare_slack("", got, want, [], GRAD_RTOL, GRAD_ATOL, quiet=True)
            log(f"  B2 N={n} D={d} C={c} gaussian on the fine grid at {p} (measured): max abs "
                f"err {err:.6g} against {yardstick_name(run)}, largest excess over highest's "
                f"tolerances {excess:.4g}")
    if prec != "highest":
        return
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


def b2_shard_inputs(s, n, d, c, gen, dev, link="bernoulli_logit", dyadic=False):
    """B2's shard-batched arguments (beta (S, C, D), xT (S, D, n), y (S, n),
    offsets (S, C, n)): normal inputs, or the dyadic grids of
    `b2_edge_inputs` for every shard."""
    if dyadic:
        parts = [b2_edge_inputs(n, d, c, link, gen, dev) for _ in range(s)]
        xT, y, beta, off = (torch.stack(t) for t in zip(*parts))
        return beta, xT, y, off
    xT = torch.randn(s, d, n, generator=gen, device=dev)
    y = (torch.randn(s, n, generator=gen, device=dev) if link == "gaussian"
         else (torch.rand(s, n, generator=gen, device=dev) < 0.4).float())
    beta = 0.3 * torch.randn(s, c, d, generator=gen, device=dev)
    off = torch.randn(s, c, n, generator=gen, device=dev)
    return beta, xT, y, off


def phase_b2_shards(run: Run):
    """B2's shard axis (consensus Monte Carlo, config 2): at config 2's
    width (S=8, C=8, D=16, n=125,000 rows a shard, and a ragged 125,003)
    against the plain version, a second launch bitwise equal; the S=1 call
    bitwise equal to the unsharded call; the edge cases on dyadic inputs
    against the plain version in float64; then times of the kernel, its
    plain version and S separate unsharded launches (the loop the axis
    replaces), beside the bound."""
    from stark_tpu_torch.ops import logistic_fused as lf

    log("== b2_shards: kernel B2 with a shard axis")
    gen = torch.Generator(device=run.dev).manual_seed(5)
    S, C, d = CONS_SHARDS, CONS_CHAINS, CONS_D
    n0 = run.cons_n // S
    err = None
    for n in (n0, n0 + 3):
        for link in ("bernoulli_logit", "gaussian"):
            beta, xT, y, off = b2_shard_inputs(S, n, d, C, gen, run.dev, link)
            for o in (None, off):
                got = lf.logistic_batched(beta, xT, y, o, link)
                again = lf.logistic_batched(beta, xT, y, o, link)
                run.sync()
                want = lf.logistic_batched_plain(beta, xT, y, o, link)
                e = compare(f"B2 shards S={S} C={C} D={d} n={n} {link} offsets={o is not None} "
                            f"blocks per shard={lf.b2_blocks(n, S)[0]}", got, want)
                check_repeat("B2 shards", got, again)
                if n == n0 and link == "bernoulli_logit" and o is None:
                    err = e, (beta, xT, y)
                # S = 1 against the unsharded call, bitwise
                one = lf.logistic_batched(beta[:1], xT[:1], y[:1], None if o is None else o[:1], link)
                flat = lf.logistic_batched(beta[0], xT[0], y[0], None if o is None else o[0], link)
                run.sync()
                assert all(torch.equal(a[0], b) for a, b in zip(one, flat)), (n, link)
    log("  B2 S=1 calls bitwise equal to the unsharded calls: yes")
    worst = 0.0
    for s_, n, d_, c_ in B2_SHARD_EDGE_CASES:
        for link in ("bernoulli_logit", "gaussian"):
            beta, xT, y, off = b2_shard_inputs(s_, n, d_, c_, gen, run.dev, link, dyadic=True)
            for o in (None, off):
                got = lf.logistic_batched(beta, xT, y, o, link)
                again = lf.logistic_batched(beta, xT, y, o, link)
                run.sync()
                want = yardstick(run, lf.logistic_batched_plain, beta, xT, y, o, link=link)
                worst = max(worst, compare(f"B2 shards S={s_} n={n} D={d_} C={c_} {link}", got,
                                           want, quiet=True))
                assert all(torch.equal(a, b) for a, b in zip(got, again)), (s_, n, d_, c_, link)
    log(f"  B2 shard-axis edge cases: {len(B2_SHARD_EDGE_CASES)} shapes x 2 links x with/without "
        f"offsets match the plain version in {yardstick_name(run)} (max abs err {worst:.6g}), "
        f"second launches bitwise equal")

    e, (beta, xT, y) = err
    n = xT.shape[-1]
    nbytes = 4 * (xT.numel() + y.numel() + 2 * beta.numel() + S * C)
    flops = 4 * S * C * d * n
    ms = timed(run, lambda: lf.logistic_batched(beta, xT, y), 50)
    plain = timed(run, lambda: lf.logistic_batched_plain(beta, xT, y), 10)
    loop = timed(run, lambda: [lf.logistic_batched(beta[k], xT[k], y[k]) for k in range(S)], 20,
                 launches=S)
    run.kernels["B2s"] = dict(
        name="logistic_batched (B2, shard axis)", route="cuda",
        source="stark_tpu_torch/csrc/logistic_batched.cu",
        replaces="stark_tpu/ops/logistic_fused.py:130",
        max_abs_err=e, ms=ms, plain_ms=plain, loop_ms=loop, **bound(nbytes, flops),
        library_ms=None,
    )
    log(f"  B2 shards S={S} C={C} D={d} n={n}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"{S} unsharded launches {loop:.4f} ms, {fmt_bound(run.kernels['B2s'])}")
    return dict(ms=ms, plain_ms=plain, loop_ms=loop, bound_ms=run.kernels["B2s"]["bound_ms"])


def _counted_leg(run: Run, fn):
    """Counts to 0 just before ``fn``, read just after: (result, wall s,
    launches, peak device MiB)."""
    if not run.rehearsal:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    out = fn()
    run.sync()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**20 if not run.rehearsal else float("nan")
    return out, wall, read_counts(), peak


def _check_shard_launches(run: Run, label, launches, evals):
    """Every ensemble evaluation one shard-batched B2 launch, no other
    kernel."""
    if run.rehearsal:
        return
    assert launches["B2s"] > 0, f"B2 was never launched with its shard axis on the {label} leg"
    assert launches["B2"] == launches["B2s"] == evals, (label, launches, evals)
    others = {k: v for k, v in launches.items() if k not in ("B2", "B2s") and v}
    assert not others, f"{others} launched on the {label} leg"


def phase_consensus(run: Run):
    """BASELINE config 2 at its pinned width: consensus_sample of
    FusedLogistic(16) over 8 shards of N=1,000,000 rows, 8 chains a shard,
    ChEES (stark_tpu/benchmarks.py:574-624, tools/consensus_1m.py) at half
    its pinned budget; its combine against a full-data chees_sample (MAP
    30, warmup 60, samples 60), outside the timed wall; a NUTS leg; and a
    shard-death leg (one shard's y NaN)."""
    from stark_tpu_torch import chees_sample, consensus_sample, diagnostics
    from stark_tpu_torch.models import FusedLogistic, synth_logistic_data

    dev = {"device": "cpu"} if run.rehearsal else {}
    raw, true = synth_logistic_data(0, run.cons_n, CONS_D)
    budget = run.cons_budget
    kw = dict(num_shards=CONS_SHARDS, chains=CONS_CHAINS, kernel="chees", init_step_size=0.1,
              dispatch_steps=6, seed=0, **budget, **dev)
    log(f"== consensus (config 2): consensus_sample(FusedLogistic({CONS_D})), N={run.cons_n}, "
        f"{CONS_SHARDS} shards x {CONS_CHAINS} chains, combine precision_full, {kw}")
    post, wall, launches, peak = _counted_leg(
        run, lambda: consensus_sample(FusedLogistic(CONS_D), raw, **kw))
    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    _check_shard_launches(run, "consensus", launches, evals)
    if not run.rehearsal:
        run.kernels["B2s"]["launches"] = launches["B2s"]
    draws = post.draws_flat
    assert draws.shape == (CONS_CHAINS, budget["num_samples"], CONS_D), draws.shape
    assert np.all(np.isfinite(draws)) and not st["degraded"]
    bulk = float(np.min(diagnostics.ess_bulk(draws)))
    rhat = post.max_rhat()
    res = dict(wall_s=wall, evals=evals, launches=launches, peak_mib=peak, max_rhat=rhat,
               min_ess_bulk=bulk, ess_per_s=bulk / wall,
               step_size=np.asarray(st["step_size"]).tolist(),
               traj_length=np.asarray(st["traj_length"]).tolist(),
               divergences=int(st["num_divergent"]))
    log(f"  wall {wall:.2f} s (set-up included), {evals} ensemble evaluations "
        f"({1e3 * wall / max(evals, 1):.4f} ms each), launches {launches}, peak device memory "
        f"{peak:.1f} MiB")
    log(f"  max split R-hat {rhat:.5f}; min bulk ESS {bulk:.1f}; ESS/s {bulk / wall:.3f}; "
        f"divergences {res['divergences']}; step sizes {np.round(res['step_size'], 5).tolist()}; "
        f"trajectory lengths {np.round(res['traj_length'], 4).tolist()}")
    # the combine against a full-data run (evidence of
    # correctness, not part of the consensus wall)
    t = time.perf_counter()
    full = chees_sample(FusedLogistic(CONS_D), raw, chains=CONS_CHAINS, init_step_size=0.1,
                        seed=1, **run.cons_full_budget, **dev)
    full_wall = time.perf_counter() - t
    mc = post.draws["beta"].mean(axis=(0, 1))
    mf = full.draws["beta"].mean(axis=(0, 1))
    sf = full.draws["beta"].std(axis=(0, 1))
    res["combine_rel_err"] = float(np.max(np.abs(mc - mf) / sf))
    res["full_wall_s"] = full_wall
    res["full_max_rhat"] = full.max_rhat()
    log(f"  combine_rel_err {res['combine_rel_err']:.4f} (max over coefficients of |mean "
        f"consensus - mean full| / sd full); full-data chees_sample {full_wall:.2f} s, "
        f"R-hat {res['full_max_rhat']:.5f}; max |consensus mean - true beta| "
        f"{float(np.max(np.abs(mc - true['beta']))):.4g}")
    # the reference's own bound on the combine (tests/test_consensus.py:86):
    # consensus means within 4 full-data sds
    assert np.all(np.abs(mc - mf) <= 4 * np.max(sf)), (mc, mf, sf)

    nb = run.cons_nuts_budget
    log(f"== consensus, NUTS leg: kernel='nuts', {nb}")
    post, wall, launches, _ = _counted_leg(run, lambda: consensus_sample(
        FusedLogistic(CONS_D), raw, num_shards=CONS_SHARDS, chains=CONS_CHAINS, kernel="nuts",
        seed=0, **nb, **dev))
    evals = int(post.sample_stats["num_ensemble_grad_evals"])
    _check_shard_launches(run, "consensus NUTS", launches, evals)
    assert np.all(np.isfinite(post.draws_flat))
    res["nuts"] = dict(wall_s=wall, evals=evals, launches=launches, max_rhat=post.max_rhat())
    log(f"  wall {wall:.2f} s, {evals} ensemble evaluations, launches {launches}, max split "
        f"R-hat {post.max_rhat():.4f}")

    n = run.death_n
    dead = CONS_SHARDS // 2
    raw_d, _ = synth_logistic_data(1, n, CONS_D)
    per = n // CONS_SHARDS
    raw_d["y"][dead * per:(dead + 1) * per] = np.nan
    log(f"== consensus, shard-death leg: N={n}, shard {dead}'s y NaN, ChEES, "
        f"{run.death_budget}")
    post, wall, launches, _ = _counted_leg(run, lambda: consensus_sample(
        FusedLogistic(CONS_D), raw_d, num_shards=CONS_SHARDS, chains=CONS_CHAINS, kernel="chees",
        init_step_size=0.1, seed=0, **run.death_budget, **dev))
    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    _check_shard_launches(run, "shard-death", launches, evals)
    log(f"  restarts {st['num_shard_restarts']}, degraded {st['degraded']}, lost shards "
        f"{st['lost_shards'].tolist()}, combined draws finite {bool(np.isfinite(post.draws_flat).all())}; "
        f"wall {wall:.2f} s, {evals} evaluations, launches {launches}")
    assert st["num_shard_restarts"] == 1 and st["degraded"], st
    assert st["lost_shards"].tolist() == [dead], st["lost_shards"]
    assert np.all(np.isfinite(post.draws_flat))
    res["death"] = dict(wall_s=wall, evals=evals, restarts=int(st["num_shard_restarts"]),
                        lost_shards=st["lost_shards"].tolist())
    return res


def phase_bnn(run: Run):
    """BASELINE config 5 at its pinned settings: sghmc_sample of
    BayesianMLP(64, hidden=64) on N=100,000 rows, batches of 1024, 4
    chains, warmup 1000, samples 2000 (the pinned 2000 + 4000 halved), 8
    cycles, step 3e-3, friction 5.0 (stark_tpu/benchmarks.py:757-776); diagnostics in predictive space at
    256 probe rows (:785-830), the reference's accuracy gate (:838-839).
    No hand-written kernel runs: the reference's BNN is plain XLA."""
    from stark_tpu_torch import diagnostics, sghmc_sample
    from stark_tpu_torch.models import BayesianMLP, synth_bnn_data

    dev = {"device": "cpu"} if run.rehearsal else {}
    data, _ = synth_bnn_data(0, run.bnn_n, BNN_D)
    model = BayesianMLP(BNN_D, hidden=BNN_H)
    kw = dict(batch_size=BNN_BATCH, chains=BNN_CHAINS, step_size=3e-3, friction=5.0, seed=0,
              **run.bnn_budget)
    log(f"== bnn (config 5): sghmc_sample(BayesianMLP({BNN_D}, hidden={BNN_H})), "
        f"N={run.bnn_n}, {kw}")
    post, wall, launches, peak = _counted_leg(run, lambda: sghmc_sample(model, data, **kw, **dev))
    if not run.rehearsal:
        assert not any(launches.values()), f"{launches} launched on the BNN path"
    x_probe = torch.as_tensor(data["x"][:256])
    y_probe = data["y"][:256]
    logits = post.functional(lambda p: model.forward(p, x_probe))
    assert np.all(np.isfinite(logits)), "non-finite predictive logits"
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
    acc = float(np.mean((probs.mean(axis=(0, 1)) > 0.5) == (y_probe > 0.5)))
    res = dict(wall_s=wall, steps=int(post.sample_stats["num_ensemble_grad_evals"]),
               kept=int(post.num_samples), peak_mib=peak, predictive_accuracy=acc,
               pred_ess_bulk=float(np.min(diagnostics.ess_bulk(logits))),
               pred_ess_tail=float(np.min(diagnostics.ess_tail(logits))),
               pred_rhat=float(np.max(diagnostics.split_rhat(logits))),
               divergences=int(np.sum(post.sample_stats["num_divergent"])))
    cyc = post.sample_stats.get("cycle_id")
    if cyc is not None and len(np.unique(cyc)) > 1:
        pc = np.stack([logits[:, cyc == c, :].mean(axis=1) for c in np.unique(cyc)])
        across = float(pc.std(axis=0).mean())
        within = float(np.mean([logits[:, cyc == c, :].std(axis=1).mean()
                                for c in np.unique(cyc)]))
        res["cycle_mode_ratio"] = across / max(within, 1e-12)
    res["pred_ess_per_s"] = res["pred_ess_bulk"] / wall
    log(f"  wall {wall:.2f} s ({res['steps']} steps of {BNN_CHAINS} chains, "
        f"{1e3 * wall / res['steps']:.4f} ms each), {res['kept']} draws kept a chain, launches "
        f"{launches}, peak device memory {peak:.1f} MiB, divergences {res['divergences']}")
    log(f"  predictive accuracy {acc:.4f} on 256 probe rows (gate >= {BNN_MIN_ACCURACY}); "
        f"predictive bulk ESS {res['pred_ess_bulk']:.1f}, tail ESS {res['pred_ess_tail']:.1f}, "
        f"ESS/s {res['pred_ess_per_s']:.3f}; predictive R-hat {res['pred_rhat']:.4f}; "
        f"cycle_mode_ratio {res.get('cycle_mode_ratio', float('nan')):.3f}")
    assert acc >= BNN_MIN_ACCURACY, f"predictive accuracy {acc} below {BNN_MIN_ACCURACY}"
    return res


def phase_tempering(run: Run):
    """BASELINE config 4 at its pinned width: tempered_sample of
    GaussianMixture(16) on the port's synth_gmm_data(0, 50,000, 16,
    spread=4.0), init from gmm_init_1d, 2 chains x 8 temperatures, NUTS
    replicas at tree depth 7, a swap round every 5 transitions, the
    adaptive ladder (stark_tpu/benchmarks.py:718-754), warmup 15 and
    samples 10 (the bench: 600 and 500); then HMC, the reference's
    default kernel (16 leapfrog steps, 10 + 10).  No hand-written kernel
    runs: the reference's GMM likelihood is XLA's (N, K) logsumexp."""
    from stark_tpu_torch import diagnostics, tempered_sample
    from stark_tpu_torch.models import GaussianMixture, gmm_init_1d, synth_gmm_data

    dev = {"device": "cpu"} if run.rehearsal else {}
    data, true = synth_gmm_data(0, run.gmm_n, GMM_K, spread=GMM_SPREAD)
    t = time.perf_counter()
    init = gmm_init_1d(data["x"], GMM_K)
    init_s = time.perf_counter() - t
    log(f"== tempering (config 4): GaussianMixture({GMM_K}), N={run.gmm_n}, spread "
        f"{GMM_SPREAD}; gmm_init_1d {init_s:.2f} s on the host, max |init mu - true mu| "
        f"{float(np.max(np.abs(init['mu'] - true['mu']))):.4f}")
    model = GaussianMixture(GMM_K)
    out = {}
    for label, kw in (("gmm_nuts", dict(kernel="nuts", **run.gmm_budget)),
                      ("gmm_hmc", dict(kernel="hmc", **run.gmm_hmc_budget))):
        kw = dict(chains=GMM_CHAINS, num_temps=GMM_TEMPS, swap_every=5, seed=0,
                  adapt_ladder=True, **kw)
        log(f"== tempering, leg {label}: tempered_sample(GaussianMixture({GMM_K})), "
            f"N={run.gmm_n}, init_params=gmm_init_1d, {kw}")
        post, wall, launches, peak = _counted_leg(
            run, lambda: tempered_sample(model, data, init_params=init, **kw, **dev))
        if not run.rehearsal:
            assert not any(launches.values()), f"{launches} launched on the {label} leg"
        st = post.sample_stats
        evals = int(st["num_ensemble_grad_evals"])
        transitions = kw["num_warmup"] + kw["num_samples"]
        draws = post.draws_flat
        assert draws.shape == (GMM_CHAINS, kw["num_samples"], 3 * GMM_K - 1), draws.shape
        assert np.all(np.isfinite(draws)), f"non-finite draws on the {label} leg"
        ladder = st["betas_adapted"]
        assert ladder.shape == (GMM_CHAINS, GMM_TEMPS), ladder.shape
        assert np.all(ladder[:, 0] == 1.0), f"the cold rung moved: {ladder[:, 0]}"
        assert np.all(np.diff(ladder, axis=1) < 0), f"a ladder is not decreasing: {ladder}"
        mu = post.draws["mu"].mean(axis=(0, 1))
        mu_err = np.abs(mu - true["mu"])
        bulk = float(np.min(diagnostics.ess_bulk(draws)))
        res = dict(
            wall_s=wall, evals=evals, launches=launches, peak_mib=peak,
            ms_per_eval=1e3 * wall / evals,
            # the kernel's evaluations: less the initial cache refresh and
            # one refresh a transition
            leaves_per_transition=(evals - 1 - transitions) / transitions,
            swap_accept_rate=float(np.mean(st["swap_accept_rate"])),
            swap_accept_min_pair=float(np.min(st["swap_accept_per_pair"])),
            beta_hot=float(np.min(ladder)),
            max_split_rhat=float(np.max(diagnostics.split_rhat(draws))),
            min_bulk_ess=bulk, ess_per_s=bulk / wall,
            divergences=int(np.sum(st["num_divergent"])),
            step_size_per_temp=np.round(st["step_size_per_temp"].astype(float), 6).tolist(),
            mu_max_abs_err=float(mu_err.max()), init_s=init_s,
        )
        log(f"  {label} [{getattr(run, 'smi', 'cpu rehearsal')}]: wall {wall:.2f} s with set-up; "
            f"ensemble evaluations {evals} ({res['ms_per_eval']:.4f} ms each); leaves per "
            f"transition {res['leaves_per_transition']:.2f}; launches {launches}; peak device "
            f"memory {peak:.1f} MiB")
        log(f"  {label}: swap_accept_rate {res['swap_accept_rate']:.4f}, min per pair "
            f"{res['swap_accept_min_pair']:.4f}, beta_hot {res['beta_hot']:.5f}; cold rung: max "
            f"split R-hat {res['max_split_rhat']:.4f}, min bulk ESS {bulk:.1f}, ESS/s "
            f"{res['ess_per_s']:.4f}; divergences {res['divergences']}")
        log(f"  {label}: step sizes per rung {res['step_size_per_temp']}; adapted ladders "
            f"{np.round(ladder.astype(float), 5).tolist()}")
        log(f"  {label}: posterior mean of mu {np.round(mu.astype(float), 4).tolist()}; truth "
            f"{true['mu'].astype(float).tolist()}; max |error| {res['mu_max_abs_err']:.4f} "
            f"(bound {GMM_MU_TOL})")
        assert mu_err.max() < GMM_MU_TOL, f"a component of mu is off its truth: {mu_err}"
        out[label] = res
    # the profile phase evaluates at R = chains x temps points of the run
    run.last_z["GaussianMixture"] = torch.as_tensor(
        post.draws_flat[:, -GMM_TEMPS:].reshape(-1, draws.shape[-1]), device=run.dev)
    run.gmm_data = data
    return out


def b4_edge_inputs(ids, n, d, q, c, groups, rs, fine=False):
    """B4's raw rows (x, z, y, g) and (beta, u, intercept), numpy, on small
    dyadic grids: x and z's slopes in halves of [-1, 1], y in quarters of
    [-2, 2], beta in eighths of [-1/2, 1/2], u and the intercepts in
    quarters of [-1, 1]; mu and resid are then exact in float32.  ``ids``
    picks the group ids (B4_EDGE_CASES).  ``fine``: x in steps of 2^-9,
    so that the dot precisions round x and resid, mu and resid z still
    exact (`b2_edge_inputs`)."""
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
    raw = {"x": grid((n, d), 512, 2.0 ** -9) if fine else grid((n, d), 2, 0.5),
           "z": np.concatenate([np.ones((n, 1), np.float32), grid((n, q - 1), 2, 0.5)], 1),
           "y": grid((n,), 8, 0.25), "g": g}
    return raw, (grid((c, d), 4, 0.125), grid((c, groups, q), 4, 0.25), grid((c,), 4, 0.25))


def phase_b4_edges(run: Run, b4_args, prec="highest"):
    """B4 on its edge cases (B4_EDGE_CASES) against the plain version in
    float64, a second launch bitwise equal, ids without rows exactly 0;
    B4_REFUSED refused before any launch; and on config 3's inputs
    (``b4_args``) the kernel's and the float32 plain version's largest
    distance from float64.  At another dot precision ``prec``: the edge
    cases on `b4_edge_inputs`' fine grid, the kernel at ``prec`` against
    the plain version at ``prec`` in float64 (every operand exact, so
    the two round the same values); at high on the coarse grid, whose
    sums are exact (`phase_b2_edges`)."""
    from stark_tpu_torch.ops import hier_fused as hf

    rs = np.random.RandomState(6)
    worst = 0.0
    for ids, n, d, q, c, groups in B4_EDGE_CASES:
        raw, params = b4_edge_inputs(ids, n, d, q, c, groups, rs, fine=prec == "default")
        prep = hf.prepare_grouped(raw, d + q, transpose_keys=("x", "z"))
        assert prep is not None, (ids, n, d, q, c)
        t = [torch.as_tensor(prep[k], device=run.dev) for k in ("xT", "zT", "y", "gl", "first_gid")]
        args = (*(torch.as_tensor(a, device=run.dev) for a in params), *t, prep["lane_tile"])
        with env(PREC_KNOB, prec):
            got = hf.lmm_grouped(*args)
            again = hf.lmm_grouped(*args)
        run.sync()
        want = yardstick(run, hf.lmm_grouped_plain, *args, prec=prec)
        name = f"B4 {ids} N={prep['y'].shape[0]} D={d} Q={q} C={c}"
        worst = max(worst, compare(name, got, want, LMM_RTOL, LMM_ATOL, quiet=True))
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        empty = np.setdiff1d(np.arange(groups), raw["g"])
        assert torch.all(got[3][:, torch.as_tensor(empty, device=run.dev).long(), :] == 0), name
    log(f"  B4 edge cases at {prec}{' on the fine grid' if prec == 'default' else ''}: "
        f"{len(B4_EDGE_CASES)} shapes match the plain version in "
        f"{yardstick_name(run)} (max abs err {worst:.6g}), second launches bitwise equal, ids "
        f"without rows 0")
    if prec != "highest":
        return
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
    C = 70 (B1's 'N=3 mod 4' edge case, `b1_edge_args`)."""
    from stark_tpu_torch.ops import hier_fused as hf

    args = b1_edge_args(run, gen)
    (c, d), n = args[0].shape, args[2].shape[1]
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


#: a block record's timing fields: they differ between the pipelined and
#: the serial loop, every other field is the same
TIMING_KEYS = ("wall_s", "t_dispatch_s", "t_diag_s", "t_store_s", "t_ckpt_s", "t_wait_s",
               "t_hidden_s")


def _launched_evals(post) -> int:
    """The ensemble evaluations a runner call launched: those it kept and
    those of a speculative block the pipelined loop threw away."""
    st = post.sample_stats
    return int(st["num_ensemble_grad_evals"]) + int(st["num_discarded_ensemble_grad_evals"])


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
    wd = root / "gated"
    artifact = wd / "adapt.npz"
    log(f"== runner (gated): supervised_sample(FusedHierLogisticGrouped({D}, {G})), "
        f"N={run.n_full}, 64 chains, R-hat < 1.01 and ESS > 400, {budget}, the pipelined "
        f"loop, exporting its adaptation")
    post, wall, launches = _runner_leg(run, "gated leg", lambda: supervised_sample(
        FusedHierLogisticGrouped(D, G), full, workdir=str(wd), min_blocks=2,
        rhat_target=1.01, ess_target=400.0, adapt_export_path=str(artifact), **budget,
        **common))
    evals = int(post.sample_stats["num_ensemble_grad_evals"])
    discarded = int(post.sample_stats["num_discarded_ensemble_grad_evals"])
    _check_b1_launches(run, launches, evals + discarded, "gated leg")
    assert artifact.exists(), "the gated leg exported no adaptation"
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
    # the processing hidden behind the next block is not the run's time
    sampling = sum(r["t_dispatch_s"] + r["t_diag_s"] + r["t_store_s"] + r["t_ckpt_s"]
                   - r["t_hidden_s"] for r in blocks)
    per_block = []
    for r in blocks:
        row = {k: r[k] for k in ("block", "draws_per_chain", "max_rhat", "min_ess", "t_dispatch_s",
                                 "t_diag_s", "t_store_s", "t_ckpt_s", "t_wait_s", "t_hidden_s")}
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
        store_s=[r["t_store_s"] for r in blocks], wait_s=[r["t_wait_s"] for r in blocks],
        hidden_s=[r["t_hidden_s"] for r in blocks], per_block=per_block,
        divergences=int(post.num_divergent), discarded_evals=discarded,
        discarded_s=post.discarded_s, step_size=warm["step_size"],
    )
    log(f"  {stop}; {len(blocks)} blocks, {draws.shape[1]} draws per chain")
    log(f"  wall {wall:.2f} s with set-up: set-up {warm['t_setup_s']:.2f}, MAP "
        f"{warm['t_map_s']:.2f} ({budget['map_init_steps'] + 1} evaluations), warmup "
        f"{warm['t_warmup_s']:.2f} ({warm_evals} evaluations, "
        f"{res['warmup_ms_per_eval']:.4f} ms each), sampling {sampling:.2f}")
    log(f"  validation pass: full_max_rhat {last.get('full_max_rhat')}, full_min_ess "
        f"{last.get('full_min_ess')}; max split R-hat {split:.5f}, min bulk ESS {bulk:.1f}; "
        f"ESS/s {bulk / wall:.4f}; divergences {int(post.num_divergent)}")
    log(f"  ensemble gradient evaluations {evals} + {discarded} of the thrown-away block = "
        f"B1 launches {launches['B1']}; {1e3 * wall / evals:.4f} ms per evaluation (set-up "
        f"included)")
    log(f"  the speculative block thrown away at the stop: {discarded} evaluations, "
        f"{post.discarded_s:.3f} s [{getattr(run, 'smi', 'cpu rehearsal')}]")
    for r in per_block:
        valid = (f", validation pass R-hat {r['full_max_rhat']:.5f} ESS {r['full_min_ess']:.1f}"
                 if "full_max_rhat" in r else "")
        log(f"  block {r['block']}: to {r['draws_per_chain']} draws; {r['evals']} evaluations in "
            f"{r['t_dispatch_s']:.3f} s ({r['ms_per_eval']:.4f} ms each); streaming R-hat "
            f"{r['max_rhat']} ESS {r['min_ess']}{valid}; gate {r['t_diag_s']:.4f} s, "
            f"draw-store append {r['t_store_s']:.4f} s, flush and checkpoint {r['t_ckpt_s']:.4f} s; "
            f"hidden behind the next block {r['t_hidden_s']:.4f} s, wait for the verdict "
            f"{r['t_wait_s']:.4f} s")
    res["adapt_import"] = _adapt_import_leg(run, full, post, res, artifact, root, common)
    res["adapt_import_high"] = _adapt_import_leg(run, full, post, res, artifact, root, common,
                                                 prec="high")
    for xdt in X_NARROW:
        res[f"adapt_import_{xdt}"] = _adapt_import_leg(run, full, post, res, artifact, root,
                                                      common, xdt=xdt,
                                                      gate=xdt in X_IMPORT_DTYPES)

    small = dict(run.resume_budget, rhat_target=0.0)
    log(f"== runner (resume): the same model, {small}, uninterrupted and then faulted "
        f"after block 1's checkpoint, restarted without a reseed")
    whole, whole_wall, launches = _runner_leg(run, "uninterrupted", lambda: supervised_sample(
        FusedHierLogisticGrouped(D, G), full, workdir=str(root / "whole"), **small, **common))
    _check_b1_launches(run, launches, _launched_evals(whole), "uninterrupted leg")
    real = runner.sample_until_converged
    attempts = []

    def faulted(model, data=None, **kw):
        # the first attempt stops after block 1's checkpoint (a zero time
        # budget), then faults
        attempts.append(kw.get("resume_from"))
        if len(attempts) == 1:
            first = real(model, data, **dict(kw, time_budget_s=0.0))
            attempts.append(_launched_evals(first))
            log(f"  the first attempt: stopped by its time budget after block 1; the block "
                f"thrown away: {int(first.sample_stats['num_discarded_ensemble_grad_evals'])} "
                f"evaluations, {first.discarded_s:.3f} s")
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
    _check_b1_launches(run, launches, attempts[1] + _launched_evals(resumed), "resume leg")
    restarts = [json.loads(line) for line in open(root / "faulted" / "metrics.jsonl")]
    restarts = [r for r in restarts if r["event"] == "restart"]
    assert len(restarts) == 1, restarts
    same = np.array_equal(resumed.draws_flat, whole.draws_flat)
    log(f"  one restart record ({restarts[0]['error']}); resumed draws "
        f"{resumed.draws_flat.shape} bitwise equal to the uninterrupted run's: "
        f"{'yes' if same else 'no'}")
    assert same, "the resumed draws differ from the uninterrupted run's"
    res["resume"] = dict(restarts=len(restarts), bitwise_equal=same,
                         draws_per_chain=int(whole.draws_flat.shape[1]), whole_wall_s=whole_wall)
    return res


def _adapt_import_leg(run: Run, full, gated, gres, artifact, root, common, prec="highest",
                      xdt="f32", gate=True):
    """A run importing the gated leg's adaptation (ROADMAP A6): the
    touch-up instead of warmup, the artifact left as it was.  At another
    dot precision ``prec`` (high; STARK_FUSED_PRECISION), or with X stored
    as ``xdt`` (bf16, int8; STARK_FUSED_X_DTYPE: the same caller's data,
    so the same fingerprint, rounded or packed when prepared), its B1
    launches are all at ``prec`` and of ``xdt``, and each parameter's
    posterior mean shift from the gated leg's (at highest, float32 X), in
    the gated leg's sds, is printed and, with ``gate``, held to 0.3 (fp8
    changes the data by more: its shift is reported, not gated).  (Default
    is not run here: it rounds beta to bf16, whose spacing at the
    flagship's N = 1M is about one posterior sd, and the chains stall;
    PERF.md.)"""
    from stark_tpu_torch import sample_until_converged
    from stark_tpu_torch.models import FusedHierLogisticGrouped

    other = prec != "highest" or xdt != "f32"
    budget = run.import_precision_budget if other else run.import_budget
    chains = common["chains"]
    kw = dict(common, seed=1, adapt_path=str(artifact), map_init_steps=0, min_blocks=2,
              adaptive_blocks=False, **budget)
    log(f"== runner (adapt_import, STARK_FUSED_PRECISION={prec}, STARK_FUSED_X_DTYPE={xdt}): "
        f"sample_until_converged(FusedHierLogisticGrouped({D}, {G})), N={run.n_full}, {kw}")
    before = artifact.read_bytes()
    metrics = root / f"import_{prec}_{xdt}.jsonl"
    with env(PREC_KNOB, prec), env(X_KNOB, xdt):
        post, wall, launches = _runner_leg(run, "adapt_import leg", lambda: sample_until_converged(
            FusedHierLogisticGrouped(D, G), full, metrics_path=str(metrics), **kw))
    evals = int(post.sample_stats["num_ensemble_grad_evals"])
    by_prec = read_precision_counts()["B1"]
    by_x = read_x_dtype_counts()["B1"]
    if not other:
        _check_b1_launches(run, launches, _launched_evals(post), "adapt_import leg")
    elif not run.rehearsal:  # its launches go into the kernels line from the other phases
        assert launches["B1"] == _launched_evals(post) == by_prec[prec] == by_x[xdt], (
            launches, by_prec, by_x)
        others = {k: v for k, v in launches.items() if k != "B1" and v}
        assert not others, f"{others} launched on the adapt_import leg at {prec}, {xdt}"
    recs = [json.loads(line) for line in open(metrics)]
    (warm,) = [r for r in recs if r["event"] == "warmup_done"]
    assert warm.get("adapt_imported") is True, warm
    assert {"event": "adapt_export_skipped", "reason": "imported"} in recs, recs[:3]
    assert artifact.read_bytes() == before, "the import changed the artifact"
    touch = warm["warmup_grad_evals"] // chains
    ratio = touch / gres["warmup_evals"]
    if not run.rehearsal and not other:
        # the JAX package's bound (tests/test_adapt_reuse.py:52-55), here
        # against the gated leg's warmup without its MAP steps; at another
        # precision the touch-up adapts the step size to that precision's
        # energy error, so its length is measured, not bounded
        assert ratio < 0.6, (touch, gres["warmup_evals"])
    draws = post.draws_flat
    n = budget["block_size"] * budget["max_blocks"]
    assert draws.shape == (chains, n, gated.draws_flat.shape[2]), draws.shape
    assert np.all(np.isfinite(draws)), "non-finite draws on the adapt_import leg"
    ref = gated.draws_flat.reshape(-1, draws.shape[2])
    dist = float(np.max(np.abs(draws.reshape(-1, draws.shape[2]).mean(0) - ref.mean(0))
                        / ref.std(0)))
    last = post.history[-1]
    res = dict(wall_s=wall, touchup_s=warm["t_warmup_s"], touchup_evals=touch,
               touchup_ratio=ratio, gated_warmup_s=gres["warmup_s"],
               gated_warmup_evals=gres["warmup_evals"], evals=evals,
               discarded_evals=int(post.sample_stats["num_discarded_ensemble_grad_evals"]),
               b1_launches=launches["B1"], streaming_max_rhat=last["max_rhat"],
               streaming_min_ess=last["min_ess"], max_mean_shift_sd=dist,
               step_size=warm["step_size"], gated_step_size=gres["step_size"])
    log(f"  [{getattr(run, 'smi', 'cpu rehearsal')}] touch-up {warm['t_warmup_s']:.2f} s, "
        f"{touch} evaluations, against the gated leg's warmup {gres['warmup_s']:.2f} s, "
        f"{gres['warmup_evals']} evaluations (ratio {ratio:.4f}); step size "
        f"{warm['step_size']:.5g} (gated {gres['step_size']:.5g}); wall {wall:.2f} s with set-up")
    log(f"  after {len(post.history)} blocks: streaming R-hat {last['max_rhat']}, ESS "
        f"{last['min_ess']}; largest |posterior mean - the gated leg's| {dist:.4f} of the gated "
        f"leg's posterior sd; evaluations {evals} = B1 launches {launches['B1']} (by precision "
        f"{by_prec}, by X dtype {by_x}); artifact unchanged")
    if other:
        shift = (draws.reshape(-1, draws.shape[2]).mean(0) - ref.mean(0)) / ref.std(0)
        res["mean_shift_sd"] = shift.tolist()
        log(f"  each parameter's posterior mean shift at {prec}, X {xdt}, in the gated leg's "
            f"sds: {np.round(shift, 4).tolist()}")
        if not run.rehearsal and gate:
            assert dist < 0.3, f"the posterior at {prec}, X {xdt} moved {dist:.4f} gated sds"
    return res


def _nuts_leg(run: Run, fn):
    """One leg of the NUTS phase: counts to 0 just before, read just
    after, the peak device memory between; returns (result, wall
    seconds, launches, peak MiB)."""
    run.sync()
    if not run.rehearsal:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    out = fn()
    run.sync()
    wall = time.perf_counter() - t
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20 if not run.rehearsal else float("nan")
    return out, wall, launches, peak


def _check_leg_launches(run: Run, label, counted, launches, evals, entry=None):
    """The counted kernel launched once per ensemble evaluation and no
    other kernel; its launches go into the kernels line, under ``entry``
    (the counted kernel's own by default)."""
    if run.rehearsal:
        return
    assert launches[counted] > 0, f"{counted} was never launched on the {label} leg"
    assert launches[counted] == evals, (label, launches, evals)
    others = {k: v for k, v in launches.items() if k != counted and v}
    assert not others, f"{others} launched on the {label} leg"
    e = run.kernels[entry or counted]
    e["launches"] = e.get("launches", 0) + launches[counted]


def _leg_line(run: Run, label, res):
    log(f"  {label} [{getattr(run, 'smi', 'cpu rehearsal')}]: wall {res['wall_s']:.2f} s with "
        f"set-up; ensemble evaluations {res['evals']} (warmup {res['warmup_evals']}), launches "
        f"{res['launches']}; {res['ms_per_eval']:.4f} ms per evaluation")
    depth = (f"tree depth mean {res['mean_depth']:.3f} max {res['max_depth']}; "
             if res.get("mean_depth") is not None else "")
    log(f"  {label}: {depth}leaves per transition {res['leaves_per_transition']:.2f}; lane use "
        f"{res['lane_use']:.4f}; divergences {res['divergences']} (warmup "
        f"{res['warmup_divergences']}); max split R-hat {res['max_split_rhat']:.4f}; min bulk ESS "
        f"{res['min_bulk_ess']:.1f}; ESS/s {res['ess_per_s']:.4f}; step size mean "
        f"{res['step_size_mean']:.5g} (min {res['step_size_min']:.5g}, max "
        f"{res['step_size_max']:.5g}); peak device memory {res['peak_mib']:.1f} MiB")


def _chain_leg_result(run: Run, label, counted, post, wall, launches, peak, kw, entry=None):
    """The numbers of a NUTS or HMC leg through sample(): the counted
    kernel's launches checked against the evaluations (or, with none
    counted, no hand-written kernel launched), finite draws of the
    budget's shape, and the leg's line of results."""
    from stark_tpu_torch import diagnostics
    from stark_tpu_torch.kernels.nuts import tree_depth_from_leaves

    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    warm = int(st["num_warmup_ensemble_grad_evals"])
    if counted:
        _check_leg_launches(run, label, counted, launches, evals, entry)
    elif not run.rehearsal:
        assert not any(launches.values()), f"{launches} launched on the {label} leg"
    draws = post.draws_flat
    chains = draws.shape[0]
    assert draws.shape[1] == kw["num_samples"], draws.shape
    assert np.all(np.isfinite(draws)), f"non-finite draws on the {label} leg"
    ngrad = np.asarray(st["num_grad_evals"])
    bulk = float(np.min(diagnostics.ess_bulk(draws)))
    depth = tree_depth_from_leaves(ngrad) if kw["kernel"] == "nuts" else None
    return dict(
        wall_s=wall, evals=evals, warmup_evals=warm, launches=launches, peak_mib=peak,
        ms_per_eval=1e3 * wall / evals,
        mean_depth=float(depth.mean()) if depth is not None else None,
        max_depth=int(depth.max()) if depth is not None else None,
        leaves_per_transition=float(ngrad.mean()),
        lane_use=float(ngrad.sum()) / (chains * (evals - warm)),
        divergences=int(post.num_divergent),
        warmup_divergences=int(np.sum(st["num_warmup_divergent"])),
        max_split_rhat=float(np.max(diagnostics.split_rhat(draws))), min_bulk_ess=bulk,
        ess_per_s=bulk / wall, step_size_mean=float(np.mean(st["step_size"])),
        step_size_min=float(np.min(st["step_size"])),
        step_size_max=float(np.max(st["step_size"])),
    )


def phase_nuts(run: Run, full):
    """NUTS and HMC, the per-chain samplers, at the flagship's full width
    with 8 chains: the reference bench's NUTS leg (bench.py:485-487,
    :795-797) through sample() on the offset model (B2 with offsets) and
    the grouped one (B1), HMC on the grouped one, and the adaptive runner
    with NUTS under supervision, whole and resumed from a fault after
    block 1's checkpoint (bitwise equal)."""
    from stark_tpu_torch import diagnostics, runner, sample, supervised_sample
    from stark_tpu_torch.models import FusedHierLogistic, FusedHierLogisticGrouped

    dev = {"device": "cpu"} if run.rehearsal else {}
    out = {}
    for label, model_cls, counted, kw in (
        ("nuts_offset", FusedHierLogistic, "B2", dict(kernel="nuts", **run.nuts_budget)),
        ("nuts_grouped", FusedHierLogisticGrouped, "B1", dict(kernel="nuts", **run.nuts_budget)),
        ("hmc_grouped", FusedHierLogisticGrouped, "B1", dict(kernel="hmc", **run.hmc_budget)),
    ):
        log(f"== NUTS phase, leg {label}: sample({model_cls.__name__}({D}, {G})), N={run.n_full}, "
            f"chains={NUTS_CHAINS}, {kw}")
        post, wall, launches, peak = _nuts_leg(run, lambda: sample(
            model_cls(D, G), full, chains=NUTS_CHAINS, seed=0, **kw, **dev))
        res = _chain_leg_result(run, label, counted, post, wall, launches, peak, kw)
        _leg_line(run, label, res)
        if kw["kernel"] == "nuts":
            res["profile"] = profile_nuts_transitions(run, model_cls(D, G), full, post, label,
                                                      reps=1)
        out[label] = res

    root = REPO / "build" / "chip_smoke_nuts"
    shutil.rmtree(root, ignore_errors=True)
    budget = dict(run.nuts_runner_budget, kernel="nuts", chains=NUTS_CHAINS, seed=0,
                  rhat_target=0.0, **dev)
    log(f"== NUTS phase, leg nuts_runner: supervised_sample(FusedHierLogisticGrouped({D}, {G})), "
        f"N={run.n_full}, {budget}, whole and then faulted after block 1's checkpoint")
    whole, wall, launches, peak = _nuts_leg(run, lambda: supervised_sample(
        FusedHierLogisticGrouped(D, G), full, workdir=str(root / "whole"), **budget))
    evals = int(whole.sample_stats["num_ensemble_grad_evals"])
    _check_leg_launches(run, "nuts_runner", "B1", launches, _launched_evals(whole))
    recs = [json.loads(line) for line in open(root / "whole" / "metrics.jsonl")]
    (warm,) = [r for r in recs if r["event"] == "warmup_done"]
    draws = whole.draws_flat
    assert np.all(np.isfinite(draws)), "non-finite draws on the nuts_runner leg"
    assert draws.shape[:2] == (NUTS_CHAINS, budget["block_size"] * budget["max_blocks"])
    assert all(r["grad_eval_basis"] == "tree_leaves" for r in whole.history)
    # the initial state's evaluation and the step-size search and warmup
    warm_evals = 1 + warm["warmup_grad_evals"] // NUTS_CHAINS
    leaves = sum(r["block_grad_evals"] for r in whole.history)
    bulk = float(np.min(diagnostics.ess_bulk(draws)))
    lengths = np.diff([0] + [r["draws_per_chain"] for r in whole.history])
    res = dict(
        wall_s=wall, evals=evals, warmup_evals=warm_evals, launches=launches, peak_mib=peak,
        ms_per_eval=1e3 * wall / evals,
        mean_depth=float(np.average([r["tree_depth_mean"] for r in whole.history],
                                    weights=lengths)),
        max_depth=max(r["tree_depth_max"] for r in whole.history),
        leaves_per_transition=leaves / draws.shape[0] / draws.shape[1],
        lane_use=leaves / (NUTS_CHAINS * (evals - warm_evals)),
        divergences=int(whole.num_divergent), warmup_divergences=int(warm["num_divergent"]),
        max_split_rhat=float(np.max(diagnostics.split_rhat(draws))), min_bulk_ess=bulk,
        ess_per_s=bulk / wall, step_size_mean=float(np.mean(warm["step_size"])),
        step_size_min=float(np.min(warm["step_size"])),
        step_size_max=float(np.max(warm["step_size"])),
        setup_s=warm["t_setup_s"], init_s=warm["t_map_s"], warmup_s=warm["t_warmup_s"],
    )
    _leg_line(run, "nuts_runner (whole)", res)
    real = runner.sample_until_converged
    attempts = []

    def faulted(model, data=None, **kw):
        # the first attempt stops after block 1's checkpoint (a zero time
        # budget), then faults
        attempts.append(kw.get("resume_from"))
        if len(attempts) == 1:
            first = real(model, data, **dict(kw, time_budget_s=0.0))
            attempts.append(_launched_evals(first))
            raise RuntimeError("fault injected after block 1's checkpoint")
        return real(model, data, **kw)

    runner.sample_until_converged = faulted
    try:
        resumed, rwall, launches, _ = _nuts_leg(run, lambda: supervised_sample(
            FusedHierLogisticGrouped(D, G), full, workdir=str(root / "faulted"),
            reseed_on_restart=False, **budget))
    finally:
        runner.sample_until_converged = real
    assert attempts[0] is None and attempts[2] is not None, attempts
    _check_leg_launches(run, "nuts_runner (resume)", "B1", launches,
                        attempts[1] + _launched_evals(resumed))
    restarts = [json.loads(line) for line in open(root / "faulted" / "metrics.jsonl")]
    restarts = [r for r in restarts if r["event"] == "restart"]
    assert len(restarts) == 1, restarts
    same = np.array_equal(resumed.draws_flat, whole.draws_flat)
    log(f"  nuts_runner (resume): wall {rwall:.2f} s, launches {launches}; one restart record "
        f"({restarts[0]['error']}); resumed draws {resumed.draws_flat.shape} bitwise equal to "
        f"the whole run's: {'yes' if same else 'no'}")
    assert same, "the resumed NUTS draws differ from the whole run's"
    res["resume"] = dict(wall_s=rwall, restarts=len(restarts), bitwise_equal=same)
    out["nuts_runner"] = res
    return out


def _same_run_files(label, serial, pipe_dir: Path, serial_dir: Path):
    """The serial run against the pipelined run's files: draws, block
    records but their timing, checkpoint arrays and accounting meta, and
    draw-store bytes, all bitwise."""
    from stark_tpu_torch.checkpoint import load_checkpoint
    from stark_tpu_torch.drawstore import read_draws

    stored = np.asarray(read_draws(str(pipe_dir / "draws.stkr"))[0]).transpose(1, 0, 2)
    assert np.array_equal(stored, serial.draws_flat), f"{label}: the draws differ"
    recs = [json.loads(line) for line in open(pipe_dir / "metrics.jsonl")]

    def strip(history):
        return [{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in history]

    assert strip([r for r in recs if r["event"] == "block"]) == strip(serial.history), label
    arr_p, meta_p = load_checkpoint(str(pipe_dir / "chain.ckpt.npz"))
    arr_s, meta_s = load_checkpoint(str(serial_dir / "chain.ckpt.npz"))
    assert sorted(arr_p) == sorted(arr_s), label
    for k in arr_p:
        assert np.array_equal(arr_p[k], arr_s[k]), f"{label}: checkpoint array {k} differs"
    for k in ("blocks_done", "block_size", "draw_rows", "num_divergent", "model", "kernel"):
        assert meta_p[k] == meta_s[k], (label, k)
    assert ((pipe_dir / "draws.stkr").read_bytes()
            == (serial_dir / "draws.stkr").read_bytes()), f"{label}: the draw stores differ"


def phase_pipeline_equiv(run: Run, full, runner_res, nuts_res):
    """The serial loop (sync_blocks=True) on the budgets of the ChEES
    resume leg and the NUTS runner leg, at full width, held bitwise
    against their pipelined runs (ROADMAP A6)."""
    from stark_tpu_torch import supervised_sample
    from stark_tpu_torch.models import FusedHierLogisticGrouped

    dev = {"device": "cpu"} if run.rehearsal else {}
    out = {}
    for label, root, kw, pipe_wall in (
        ("chees", REPO / "build" / "chip_smoke_runner",
         dict(run.resume_budget, kernel="chees", chains=64, init_step_size=0.1, seed=0),
         runner_res["resume"]["whole_wall_s"]),
        ("nuts", REPO / "build" / "chip_smoke_nuts",
         dict(run.nuts_runner_budget, kernel="nuts", chains=NUTS_CHAINS, seed=0),
         nuts_res["nuts_runner"]["wall_s"]),
    ):
        log(f"== pipeline_equiv ({label}): supervised_sample(FusedHierLogisticGrouped({D}, {G})), "
            f"N={run.n_full}, {kw}, sync_blocks=True, against the pipelined run")
        serial, wall, launches = _runner_leg(run, f"{label} serial", lambda: supervised_sample(
            FusedHierLogisticGrouped(D, G), full, workdir=str(root / "whole_serial"),
            rhat_target=0.0, sync_blocks=True, **kw, **dev))
        assert int(serial.sample_stats["num_discarded_ensemble_grad_evals"]) == 0
        _check_b1_launches(run, launches, int(serial.sample_stats["num_ensemble_grad_evals"]),
                           f"pipeline_equiv {label} leg")
        _same_run_files(label, serial, root / "whole", root / "whole_serial")
        log(f"  [{getattr(run, 'smi', 'cpu rehearsal')}] {label}: bitwise equal (draws, records "
            f"but timing, checkpoint, draw store); wall pipelined {pipe_wall:.2f} s, serial "
            f"{wall:.2f} s")
        out[label] = dict(bitwise_equal=True, pipelined_wall_s=pipe_wall, serial_wall_s=wall)
    return out


def _scaled_close(name, got, want, rtol, atol):
    """The reference's zoo gradient check: each chain's gradient against
    autograd's, both scaled by the largest magnitude of autograd's; ->
    the largest scaled error."""
    worst = 0.0
    for c in range(got.shape[0]):
        scale = float(want[c].abs().max()) + 1e-6
        torch.testing.assert_close(got[c] / scale, want[c] / scale, rtol=rtol, atol=atol)
        worst = max(worst, float((got[c] - want[c]).abs().max()) / scale)
    log(f"  {name}: max scaled gradient error {worst:.6g}")
    return worst


def _fused_op_parity(run: Run, label, plain, fused, raw, z, direct, scaled):
    """A fused model's potential and gradient on the card against its
    plain model's autograd at the points z (C, d), each at the reference's
    tolerance; the fused op's direct call and the potential repeat
    bitwise; both timed (CUDA events, the host's enqueue hidden)."""
    from stark_tpu_torch.model import flatten_model, prepare_model_data

    pp = flatten_model(plain).bind(prepare_model_data(plain, raw, device=run.dev))
    fdata = prepare_model_data(fused, raw, device=run.dev)
    fp = flatten_model(fused).bind(fdata)
    vp, gp = pp.value_and_grad(z)
    vf, gf = fp.value_and_grad(z)
    again = fp.value_and_grad(z)
    run.sync()
    val_err = float(((vf - vp).abs() / vp.abs()).max())
    if scaled:
        torch.testing.assert_close(vf, vp, rtol=ZLMM_VAL_RTOL, atol=ZLMM_VAL_ATOL)
        grad_err = _scaled_close(f"{label} potential gradient", gf, gp, ZLMM_GRAD_RTOL,
                                 ZLMM_GRAD_ATOL)
    else:
        torch.testing.assert_close(vf, vp, rtol=GLM_VAL_RTOL, atol=0)
        torch.testing.assert_close(gf, gp, rtol=GLM_GRAD_RTOL, atol=GLM_GRAD_ATOL)
        grad_err = float((gf - gp).abs().max())
    check_repeat(f"{label} potential and gradient", (vf, gf), again)
    op_args = direct[1](fdata)
    first = direct[0](*op_args)
    second = direct[0](*op_args)
    run.sync()
    check_repeat(f"{label} fused op (direct)", (first[0], *_flat(first[1])),
                 (second[0], *_flat(second[1])))
    fused_ms = timed(run, lambda: fp.value_and_grad(z), 10, launches=8)
    plain_ms = timed(run, lambda: pp.value_and_grad(z), 10, launches=8)
    op_ms = timed(run, lambda: direct[0](*op_args), 10, launches=4)
    log(f"  {label} [{getattr(run, 'smi', 'cpu rehearsal')}]: value max rel err {val_err:.3g}, "
        f"gradient err {grad_err:.3g}; potential and gradient {fused_ms:.4f} ms fused, "
        f"{plain_ms:.4f} ms autograd; the fused op alone {op_ms:.4f} ms")
    return dict(value_rel_err=val_err, grad_err=grad_err, fused_potential_ms=fused_ms,
                autograd_potential_ms=plain_ms, op_ms=op_ms)


def _flat(grads):
    return grads if isinstance(grads, tuple) else (grads,)


def phase_zoo_glm(run: Run, lmm3):
    """The zoo's GLMs and the knob-gated fused LMM at the fused ops' judged
    width (stark_tpu/benchmarks.py:_fused_vg_case at scale 1: N=200,000,
    D=32, G=2000): B2's gaussian link without offsets against its plain
    version at C=8, timed beside its bound; the Poisson and LMM fused ops
    (plain PyTorch) against autograd, repeated bitwise; NUTS legs through
    sample() on FusedLinearRegression (B2 gaussian once per evaluation),
    FusedPoissonRegression and FusedLMM (STARK_FUSED_LMM=1; no
    hand-written kernel); and the repairs on the card: consensus_sample on
    FusedLinearMixedModel (config 3's data, 8 shards x 8 chains, HMC,
    one B2 launch per shard and evaluation) and sghmc_sample on
    FusedLinearRegression (one B2 launch per chain and step)."""
    from stark_tpu_torch import consensus_sample, sample, sghmc_sample
    from stark_tpu_torch.models import (
        FusedLinearMixedModel,
        FusedLinearRegression,
        FusedLMM,
        FusedPoissonRegression,
        LinearMixedModel,
        PoissonRegression,
        synth_linreg_data,
        synth_lmm_data,
        synth_poisson_data,
    )
    from stark_tpu_torch.model import flatten_model
    from stark_tpu_torch.ops import glm_fused, lmm_fused
    from stark_tpu_torch.ops import logistic_fused as lf

    dev = {"device": "cpu"} if run.rehearsal else {}
    smi = getattr(run, "smi", "cpu rehearsal")
    n, d, g, C = run.zoo_n, ZOO_D, run.zoo_g, ZOO_CHAINS
    t = time.perf_counter()
    lin, lin_true = synth_linreg_data(0, n, d)
    poi, poi_true = synth_poisson_data(0, n, d)
    lmm, lmm_true = synth_lmm_data(0, n, d, g, num_random=ZOO_Q)
    log(f"== zoo_glm [{smi}]: N={n}, D={d}, G={g}, Q={ZOO_Q}, C={C} "
        f"(data {time.perf_counter() - t:.1f} s)")
    gen = torch.Generator(device=run.dev).manual_seed(3)
    out = {}

    # kernel B2's gaussian link without offsets, FusedLinearRegression's
    xT = torch.as_tensor(np.ascontiguousarray(lin["x"].T), device=run.dev)
    y = torch.as_tensor(lin["y"], device=run.dev)
    beta = (torch.as_tensor(lin_true["beta"], device=run.dev)
            + 0.1 * torch.randn(C, d, generator=gen, device=run.dev))
    bargs = (beta, xT, y, None)
    got = lf.logistic_batched(*bargs, link="gaussian")
    again = lf.logistic_batched(*bargs, link="gaussian")
    run.sync()
    want = lf.logistic_batched_plain(*bargs, link="gaussian")
    err = compare(f"B2 gaussian C={C} D={d} N={n} offsets=False (FusedLinearRegression)",
                  got, want)
    check_repeat("B2 gaussian offsets=False", got, again)
    entry = dict(
        name="logistic_batched (B2, gaussian link, no offsets)", route="cuda",
        source="stark_tpu_torch/csrc/logistic_batched.cu",
        replaces="stark_tpu/ops/logistic_fused.py:130", max_abs_err=err,
        ms=timed(run, lambda: lf.logistic_batched(*bargs, link="gaussian"), 50),
        plain_ms=timed(run, lambda: lf.logistic_batched_plain(*bargs, link="gaussian"), 10),
        **bound(4 * (xT.numel() + y.numel() + 2 * beta.numel() + C), 4 * C * d * n),
        library_ms=None,
    )
    run.kernels["B2g0"] = entry
    log(f"  B2 gaussian C={C} D={d} N={n} offsets=False [{smi}]: {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, {fmt_bound(entry)}")

    # the fused ops against autograd, at points spread about the truth
    log(f"  the fused ops against autograd (script at {run.elapsed():.1f} s)")
    spread = torch.linspace(0.01, 0.5, C, device=run.dev)[:, None]
    z = (torch.as_tensor(poi_true["beta"], device=run.dev)
         + spread * torch.randn(C, d, generator=gen, device=run.dev))
    out["poisson_op"] = _fused_op_parity(
        run, "FusedPoissonRegression", PoissonRegression(d), FusedPoissonRegression(d), poi, z,
        (glm_fused.poisson_loglik_value_and_grad,
         lambda data: (z, data["xT"], data["y"])),
        scaled=False)
    lmm_model = FusedLMM(d, g, ZOO_Q)
    tau = torch.as_tensor(lmm_true["tau"], device=run.dev)
    u = torch.as_tensor(lmm_true["u"], device=run.dev)
    params = {
        "intercept": 1.0 + 0.05 * torch.randn(C, generator=gen, device=run.dev),
        "beta": (torch.as_tensor(lmm_true["beta"], device=run.dev)
                 + 0.05 * spread * torch.randn(C, d, generator=gen, device=run.dev)),
        "u_raw": (u / tau + 0.1 * torch.randn(C, g, ZOO_Q, generator=gen, device=run.dev)),
        "tau": tau.expand(C, ZOO_Q) * (1.0 + 0.1 * spread),
        "sigma": 0.5 + spread[:, 0],
    }
    zl = flatten_model(lmm_model).unconstrain(params)
    with env("STARK_FUSED_LMM", "1"):
        out["lmm_op"] = _fused_op_parity(
            run, "FusedLMM", LinearMixedModel(d, g, ZOO_Q), lmm_model, lmm, zl,
            (lmm_fused.lmm_loglik_value_and_grad,
             lambda data: (params["beta"], params["u_raw"] * params["tau"][:, None, :],
                           params["intercept"], params["sigma"], data["xT"], data["z"],
                           data["g"], data["y"])),
            scaled=True)

    # the three models through sample(): NUTS, 8 chains, tree depth 6
    for label, model, raw, true, counted, budget, knob in (
        ("zoo_linreg", FusedLinearRegression(d), lin, lin_true, "B2g", run.zoo_budget, None),
        ("zoo_poisson", FusedPoissonRegression(d), poi, poi_true, None, run.zoo_budget, None),
        ("zoo_lmm", FusedLMM(d, g, ZOO_Q), lmm, lmm_true, None, run.zoo_lmm_budget,
         "STARK_FUSED_LMM"),
    ):
        kw = dict(kernel="nuts", chains=C, seed=0, **budget)
        log(f"== zoo_glm, leg {label} (script at {run.elapsed():.1f} s): "
            f"sample({type(model).__name__}), N={n}, D={d}"
            + (f", G={g}, {knob}=1" if knob else "") + f", {kw}")

        def leg():
            post, wall, launches, peak = _nuts_leg(run, lambda: sample(model, raw, **kw, **dev))
            res = _chain_leg_result(run, label, counted, post, wall, launches, peak, kw,
                                    entry="B2g0")
            beta_err = float(np.max(np.abs(post.draws["beta"].mean(axis=(0, 1))
                                           - true["beta"])))
            res["beta_max_abs_err"] = beta_err
            _leg_line(run, label, res)
            log(f"  {label}: max |posterior mean beta - true beta| {beta_err:.4g}")
            res["profile"] = profile_nuts_transitions(run, model, raw, post, label, reps=1)
            return res

        with env(knob, "1"):
            out[label] = leg()

    # C1: consensus over shards of FusedLinearMixedModel's transposed X
    lfull, _, ltrue = lmm3
    kw = dict(num_shards=CONS_SHARDS, chains=CONS_CHAINS, kernel="hmc", seed=0,
              **run.zoo_cons_budget)
    log(f"== zoo_glm, leg zoo_consensus_lmm (script at {run.elapsed():.1f} s): "
        f"consensus_sample(FusedLinearMixedModel({LMM_D}, {run.lmm_g}, {LMM_Q})), config 3's "
        f"N={run.lmm_n_full}, {kw}")
    post, wall, launches, peak = _counted_leg(run, lambda: consensus_sample(
        FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, **kw, **dev))
    st = post.sample_stats
    evals = int(st["num_ensemble_grad_evals"])
    if not run.rehearsal:  # the model is not shard-batched: a launch per shard
        assert launches["B2g"] == CONS_SHARDS * evals, (launches, evals)
        assert sum(launches.values()) == launches["B2g"], launches
    assert np.all(np.isfinite(post.draws_flat)) and not st["degraded"], st["degraded"]
    beta_err = float(np.max(np.abs(post.draws["beta"].mean(axis=(0, 1)) - ltrue["beta"])))
    out["zoo_consensus_lmm"] = dict(wall_s=wall, evals=evals, launches=launches,
                                    max_rhat=post.max_rhat(), beta_max_abs_err=beta_err)
    log(f"  zoo_consensus_lmm [{smi}]: wall {wall:.2f} s, {evals} ensemble evaluations, "
        f"launches {launches} ({CONS_SHARDS} a evaluation), max split R-hat "
        f"{post.max_rhat():.4f}, max |consensus mean beta - true beta| {beta_err:.4g}")

    # C2: SG-HMC minibatches of a model that reads no per-chain batch
    kw = dict(batch_size=ZOO_SGHMC_BATCH, chains=ZOO_SGHMC_CHAINS, step_size=5e-4,
              friction=500.0, precondition=False, seed=0,
              init_params={"beta": np.zeros(d, np.float32), "sigma": np.float32(1.0)},
              **run.zoo_sghmc_budget)
    log(f"== zoo_glm, leg zoo_sghmc_linreg (script at {run.elapsed():.1f} s): "
        f"sghmc_sample(FusedLinearRegression({d})), N={n}, "
        f"{ {k: v for k, v in kw.items() if k != 'init_params'} }, init beta 0, sigma 1")
    post, wall, launches, peak = _counted_leg(run, lambda: sghmc_sample(
        FusedLinearRegression(d), lin, **kw, **dev))
    steps = int(post.sample_stats["num_ensemble_grad_evals"])
    if not run.rehearsal:  # chain by chain: a launch per chain and step
        assert launches["B2g"] == ZOO_SGHMC_CHAINS * steps, (launches, steps)
        assert sum(launches.values()) == launches["B2g"], launches
    assert np.all(np.isfinite(post.draws_flat))
    beta_err = float(np.max(np.abs(post.draws["beta"].mean(axis=(0, 1)) - lin_true["beta"])))
    out["zoo_sghmc_linreg"] = dict(wall_s=wall, steps=steps, launches=launches,
                                   max_rhat=post.max_rhat(), beta_max_abs_err=beta_err,
                                   sigma_mean=float(post.draws["sigma"].mean()))
    log(f"  zoo_sghmc_linreg [{smi}]: wall {wall:.2f} s, {steps} steps of "
        f"{ZOO_SGHMC_CHAINS} chains ({1e3 * wall / steps:.4f} ms each), launches {launches}, "
        f"max split R-hat {post.max_rhat():.4f}, max |mean beta - true beta| {beta_err:.4g}, "
        f"mean sigma {out['zoo_sghmc_linreg']['sigma_mean']:.4f} (truth {lin_true['sigma']})")
    return out


def _corr(a, b):
    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def phase_zoo_rest(run: Run):
    """The rest of the zoo at the reference's judged widths (IRT 2,000 x
    200; ordinal, Student-t, negative binomial, horseshoe and Cox PH at
    N=200,000, D=32; stochastic volatility at T=512): the three fused
    ops (plain PyTorch, each behind its knob) against their plain
    models' autograd at 8 points spread about the truth, at the
    reference's zoo bands, repeated bitwise and timed beside autograd;
    IRT's triples path on a response set without every third row; then
    seven NUTS legs through sample() (8 chains, depth 6), each profiled
    over one transition.  No hand-written kernel launches."""
    from stark_tpu_torch import sample
    from stark_tpu_torch.model import flatten_model
    from stark_tpu_torch.models import (
        CoxPH,
        FusedIRT2PL,
        FusedOrderedLogistic,
        FusedStudentTRegression,
        HorseshoeRegression,
        IRT2PL,
        NegBinomialRegression,
        OrderedLogistic,
        StochasticVolatility,
        StudentTRegression,
        synth_horseshoe_data,
        synth_irt_data,
        synth_negbinom_data,
        synth_ordinal_data,
        synth_studentt_data,
        synth_survival_data,
        synth_sv_data,
    )
    from stark_tpu_torch.ops import irt_fused, ordinal_fused, robust_fused

    dev = {"device": "cpu"} if run.rehearsal else {}
    smi = getattr(run, "smi", "cpu rehearsal")
    n, d, C, P, I, T = run.zoo_n, ZOO_D, ZOO_CHAINS, run.irt_p, run.irt_i, run.sv_t
    t = time.perf_counter()
    irt, irt_true = synth_irt_data(0, P, I)
    ordd, ord_true = synth_ordinal_data(0, n, d, num_categories=ORD_K)
    stu, stu_true = synth_studentt_data(0, n, d)
    nb, nb_true = synth_negbinom_data(0, n, d)
    hs, hs_true = synth_horseshoe_data(0, n, d)
    cox, cox_true = synth_survival_data(0, n, d)
    sv, sv_true = synth_sv_data(0, T)
    log(f"== zoo_rest [{smi}]: IRT P={P} x I={I}; N={n}, D={d} (ordinal K={ORD_K}); SV T={T}; "
        f"C={C} (data {time.perf_counter() - t:.1f} s)")
    gen = torch.Generator(device=run.dev).manual_seed(5)
    spread = torch.linspace(0.01, 0.5, C, device=run.dev)[:, None]
    out = {}

    def near(true, scale=1.0):
        v = torch.as_tensor(true, device=run.dev)
        return v + scale * spread * torch.randn((C,) + v.shape, generator=gen, device=run.dev)

    # the fused ops against autograd, each with its knob on
    log(f"  the fused ops against autograd (script at {run.elapsed():.1f} s)")
    rob = FusedStudentTRegression(d)
    rp = {"beta": near(stu_true["beta"]), "sigma": 0.5 * (1.0 + spread[:, 0]),
          "nu": 4.0 * (1.0 + spread[:, 0])}
    with env("STARK_FUSED_ROBUST", "1"):
        out["robust_op"] = _fused_op_parity(
            run, "FusedStudentTRegression", StudentTRegression(d), rob, stu,
            flatten_model(rob).unconstrain(rp),
            (robust_fused.studentt_loglik_value_and_grad,
             lambda data: (rp["beta"], rp["sigma"], rp["nu"], data["xT"], data["y"])),
            scaled=True)
    orm = FusedOrderedLogistic(d, ORD_K)
    op = {"beta": near(ord_true["beta"]),
          "cutpoints": torch.sort(near(ord_true["cutpoints"], 0.2), -1).values}
    with env("STARK_FUSED_ORDINAL", "1"):
        out["ordinal_op"] = _fused_op_parity(
            run, "FusedOrderedLogistic", OrderedLogistic(d, ORD_K), orm, ordd,
            flatten_model(orm).unconstrain(op),
            (ordinal_fused.ordinal_loglik_value_and_grad,
             lambda data: (op["beta"], op["cutpoints"], data["xT"], data["y"])),
            scaled=True)
    irm = FusedIRT2PL(P, I)
    ip = {"theta": near(irt_true["theta"]),
          "a": torch.as_tensor(irt_true["a"], device=run.dev) * torch.exp(
              0.2 * spread * torch.randn(C, I, generator=gen, device=run.dev)),
          "b": near(irt_true["b"])}
    zi = flatten_model(irm).unconstrain(ip)
    with env("STARK_FUSED_IRT", "1"):
        out["irt_grid_op"] = _fused_op_parity(
            run, "FusedIRT2PL (grid)", IRT2PL(P, I), irm, irt, zi,
            (irt_fused.irt_grid_loglik_value_and_grad,
             lambda data: (ip["theta"], ip["a"], ip["b"], data["y_grid"])),
            scaled=True)
    keep = np.arange(P * I) % 3 != 0
    ragged = {k: v[keep] for k, v in irt.items()}
    with env("STARK_FUSED_IRT", "1"):
        out["irt_triples_op"] = _fused_op_parity(
            run, "FusedIRT2PL (triples, every third response dropped)", IRT2PL(P, I), irm, ragged,
            zi, (irt_fused.irt_loglik_value_and_grad,
                 lambda data: (ip["theta"], ip["a"], ip["b"], data["person"], data["item"],
                               data["y"])),
            scaled=True)

    def hs_beta(post):
        return (post.draws["z"] * post.draws["lam"] * post.draws["tau"][..., None]).mean((0, 1))

    def beta_err(true):
        return lambda post: ("max |posterior mean beta - true beta|", float(np.max(np.abs(
            post.draws["beta"].mean((0, 1)) - true["beta"]))))

    def sv_metric(post):
        h_hat = post.functional(StochasticVolatility(T).latent_h).mean((0, 1))
        return ("corr(h_hat, h)", _corr(h_hat, sv_true["h"]),
                "mean mu", float(post.draws["mu"].mean()), "true mu", sv_true["mu"])

    # seven NUTS legs through sample(): 8 chains, tree depth 6
    budget = run.zoo_rest_budget
    for label, model, raw, knob, metric in (
        ("zoo_robust", FusedStudentTRegression(d), stu, "STARK_FUSED_ROBUST", beta_err(stu_true)),
        ("zoo_ordinal", FusedOrderedLogistic(d, ORD_K), ordd, "STARK_FUSED_ORDINAL",
         beta_err(ord_true)),
        ("zoo_irt", FusedIRT2PL(P, I), irt, "STARK_FUSED_IRT", lambda post: (
            "corr(theta_hat, theta)", _corr(post.draws["theta"].mean((0, 1)),
                                            irt_true["theta"]))),
        ("zoo_negbinom", NegBinomialRegression(d), nb, None, beta_err(nb_true)),
        ("zoo_horseshoe", HorseshoeRegression(d), hs, None, lambda post: (
            "max |posterior mean beta - true beta|",
            float(np.max(np.abs(hs_beta(post) - hs_true["beta"]))))),
        ("zoo_coxph", CoxPH(d), cox, None, beta_err(cox_true)),
        ("zoo_sv", StochasticVolatility(T), sv, None, sv_metric),
    ):
        kw = dict(kernel="nuts", chains=C, seed=0, **budget)
        log(f"== zoo_rest, leg {label} (script at {run.elapsed():.1f} s): "
            f"sample({type(model).__name__})" + (f", {knob}=1" if knob else "") + f", {kw}")

        def leg():
            post, wall, launches, peak = _nuts_leg(run, lambda: sample(model, raw, **kw, **dev))
            res = _chain_leg_result(run, label, None, post, wall, launches, peak, kw)
            m = metric(post)
            res["truth"] = dict(zip(m[::2], m[1::2]))
            _leg_line(run, label, res)
            log(f"  {label}: " + "; ".join(f"{k} {v:.4g}" for k, v in res["truth"].items()))
            res["profile"] = profile_nuts_transitions(run, model, raw, post, label, reps=1)
            return res

        with env(knob, "1"):
            out[label] = leg()
    return out


# --- STARK_FUSED_PRECISION=high|default (ROADMAP B6) ------------------------

#: the dot precisions besides highest, and the H100 SXM's dense bf16
#: tensor-core rate (the peak for bf16 products, on which both run)
PREC_KNOB = "STARK_FUSED_PRECISION"
PRECISION_MODES = ("high", "default")
BF16_FLOP_PER_S = 989e12
#: bf16 passes per product of each precision
PASSES = {"highest": 1, "high": 3, "default": 1}
#: the reference's parity bands of a precision against ``highest``
#: (tools/precision_parity.py:19-21), (value, gradient) in the metrics
#: of `parity_error`: ``high`` tight, ``default`` wide
PARITY_BANDS = {"high": (1e-4, 1e-3), "default": (2e-2, 5e-2)}
#: bound on |kernel resid - exact resid| of the bernoulli link at the
#: same logit: the kernels' approximate exp, log and division (3.6e-7,
#: csrc/hier_grouped.cu and csrc/logistic_batched.cu) plus its float32
#: rounding; the gaussian link's resid is y - l, exact at an exact logit
LINK_ERR = 3.6e-7 + 2.0 ** -24


def parity_error(val0, grad0, val1, grad1):
    """The reference's parity metrics (tools/precision_parity.py:245-249)
    of (val1, grad1) against (val0, grad0), at each point and then the
    largest over the points: |val1 - val0| / (1 + |val0|), and max
    |grad1 - grad0| / (1e-6 + max |grad0|).  A value () is one point;
    values (P,) or (S, C) are points, each with the gradient entries of
    its leading index; float64."""
    v0 = torch.as_tensor(val0).double().reshape(-1)
    v1 = torch.as_tensor(val1).double().reshape(-1)
    g0 = torch.as_tensor(grad0).double().reshape(v0.numel(), -1)
    g1 = torch.as_tensor(grad1).double().reshape(v0.numel(), -1)
    val_rel = float(((v1 - v0).abs() / (1.0 + v0.abs())).max())
    grad_rel = float(((g1 - g0).abs().amax(1) / (1e-6 + g0.abs().amax(1))).max())
    return val_rel, grad_rel


@contextlib.contextmanager
def env(name, value):
    """The environment variable ``name`` set to ``value`` inside the
    block and restored after (``name`` None: nothing set): a model knob
    (``STARK_FUSED_<FAMILY>``) or the dot precision (PREC_KNOB), which
    every wrapper and fused op reads at its call."""
    if name is None:
        yield
        return
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def operand_jump(r, delta, prec):
    """How far the operand a dot at ``prec`` takes of a computed value
    can move when the value moves within ``delta`` of ``r``: where r
    lies that close to a rounding boundary of bf16 (default) or of r_lo
    (high), a kernel and the plain version round it apart.  The rounding
    is monotone, so the move is at most op(r + delta) - op(r - delta); at
    high a move of r_hi also moves r_hi x_lo, by 2^-9 of it.  0 where both
    ends round alike."""
    from stark_tpu_torch.ops.precision import bf16_round, bf16_split

    r = r.double()
    lo, hi = r - delta, r + delta
    if prec == "default":
        return (bf16_round(hi) - bf16_round(lo)).abs()
    lo_hi, lo_lo = bf16_split(lo)
    hi_hi, hi_lo = bf16_split(hi)
    return ((hi_hi + hi_lo) - (lo_hi + lo_lo)).abs() + 2.0 ** -9 * (hi_hi - lo_hi).abs()


def link_slack(r, xT, prec, groups=None, num_groups=0):
    """Per output (val, gbeta[, galpha]), what a kernel's gradients at
    ``prec`` may stand from the plain version in float64 beyond the
    tolerances, on dyadic inputs whose logits are exact (`dyadic_inputs`):
    the bernoulli link's resid is within LINK_ERR of the exact one, so
    only rows whose resid lies that close to a rounding boundary of its
    operand can round apart (`operand_jump`), each moving its gradient
    terms by the jump times |x| (each x operand at most (1 + 2^-8) |x|).
    A kernel that rounds any operand otherwise is not covered.  ``r``:
    the exact resid, float64."""
    jump = operand_jump(r, LINK_ERR, prec).float()
    out = [None, (jump @ xT.abs().float().transpose(-1, -2)) * (1 + 2.0 ** -8)]
    if groups is not None:
        out.append(jump.new_zeros(jump.shape[:-1] + (num_groups,)).index_add_(-1, groups, jump))
    return out


def b1_resid(args, prec):
    """B1's exact resid at ``prec`` on ``args`` (float64), its xT, its
    rows' groups and the number of groups."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops.precision import dot, dot_operand

    beta, alpha, xT, y, gl, fg, lane_tile = (a.double() if torch.is_tensor(a)
                                            and a.is_floating_point() else a for a in args)
    g = hf.absolute_groups(gl, fg, lane_tile)
    r = y - torch.sigmoid(dot(beta, xT, prec) + dot_operand(alpha, prec)[:, g])
    return r, xT, g, alpha.shape[1]


def b1_link_slack(args, prec):
    """`link_slack` of B1's arguments."""
    r, xT, g, groups = b1_resid(args, prec)
    return link_slack(r, xT, prec, g, groups)


def b1_resid_unrounded(args, prec):
    """B1's gradients (gbeta, galpha) at ``prec`` in float64, but with
    resid left unrounded where the dots take it: what a kernel that left
    out only that rounding would give."""
    from stark_tpu_torch.ops.precision import dot_operand

    r, xT, g, groups = b1_resid(args, prec)
    galpha = r.new_zeros(r.shape[0], groups).index_add_(1, g, r)
    return (r @ dot_operand(xT, prec).T).float(), galpha.float()


def b2_link_slack(args, prec, link):
    """`link_slack` of B2's arguments (val, gbeta[, resid]); None at the
    gaussian link, whose resid is exact at an exact logit."""
    from stark_tpu_torch.ops.precision import dot

    beta, xT, y, off = args
    if link == "gaussian":
        return []
    logits = dot(beta.double(), xT.double(), prec)
    if off is not None:
        logits = logits + off.double()
    y = y.double().unsqueeze(-2) if beta.ndim == 3 else y.double()
    out = link_slack(y - torch.sigmoid(logits), xT, prec)
    return out + [None] if off is not None else out


def compare_slack(name, got, want, slack, rtol, atol, quiet=False):
    """`compare` with, per output, ``slack`` (or None) added to what each
    entry may stand from the plain version: |got - want| <= atol + rtol
    |want| + slack (the value: rtol VAL_RTOL, atol 0).  -> the largest
    absolute error, and the largest excess over the bound (<= 0 passes)."""
    worst, excess = 0.0, -float("inf")
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        rt, at = (VAL_RTOL, 0.0) if i == 0 else (rtol, atol)
        allowed = at + rt * w.abs()
        s = slack[i] if i < len(slack) else None
        if s is not None:
            allowed = allowed + s
        excess = max(excess, float((err - allowed).max()))
        if not quiet:
            extra = f", largest slack {float(s.max()):.4g}" if s is not None else ""
            log(f"  {name} out{i} {tuple(g.shape)}: max_abs_err={float(err.max()):.6g}{extra}")
        worst = max(worst, float(err.max()))
    return worst, excess


def band_check(name, prec, base, got):
    """The reference's parity metrics (tools/precision_parity.py:245-249)
    of a kernel's outputs at ``prec`` against its outputs at highest:
    the first output is the value at each point (chain), the others
    together its gradient there, as the sweep takes a point's whole
    gradient; both inside the band of ``prec``
    (tools/precision_parity.py:19-21)."""
    tol_v, tol_g = PARITY_BANDS[prec]
    points = base[0].numel()
    flat = lambda out: torch.cat([o.reshape(points, -1) for o in out[1:]], 1)
    val_rel, grad_rel = parity_error(base[0], flat(base), got[0], flat(got))
    log(f"  {name}: against highest val_rel {val_rel:.3g} (band {tol_v:g}), grad_rel "
        f"{grad_rel:.3g} (band {tol_g:g})")
    assert val_rel <= tol_v and grad_rel <= tol_g, (name, prec, val_rel, grad_rel)
    return val_rel, grad_rel


def dyadic(like, step, limit, gen):
    """A tensor of ``like``'s shape on the grid ``step`` within [-limit,
    limit]."""
    k = int(limit / step)
    return torch.randint(-k, k + 1, like.shape, generator=gen, device=like.device).float() * step


def dyadic_inputs(kind, args, gen):
    """``args`` of B1, B2 or B4 (``kind``) with every float input on a
    dyadic grid, the same shapes, layout and 0/1 labels: x in steps of
    2^-9 in [-1, 1] and beta, alpha and u in steps of 2^-11 in [-1/4,
    1/4], each up to 10 significant bits, so that bf16 rounds them and
    their a_lo is not 0; offsets, intercepts, a gaussian y in quarters and
    B4's z in halves.  Every logit (mu) is then a multiple of 2^-20 below
    16 in magnitude (D <= 32), exact in float32 in any order of its sums
    and at every precision, and so is every gaussian resid and resid z_q:
    a kernel and the plain version round the same values (the bernoulli
    resid up to LINK_ERR, `link_slack`)."""
    fine = lambda t: dyadic(t, 2.0 ** -11, 0.25, gen)
    x = lambda t: dyadic(t, 2.0 ** -9, 1.0, gen)
    quarters = lambda t, limit=1.0: dyadic(t, 0.25, limit, gen)
    if kind == "B1":
        beta, alpha, xT, *rest = args
        return (fine(beta), fine(alpha), x(xT), *rest)
    if kind in ("bernoulli_logit", "gaussian"):
        beta, xT, y, off = args
        if kind == "gaussian":
            y = quarters(y, 2.0)
        return fine(beta), x(xT), y, None if off is None else quarters(off)
    beta, u, ic, xT, zT, y, *rest = args
    return (fine(beta), fine(u), quarters(ic), x(xT), dyadic(zT, 0.5, 1.0, gen),
            quarters(y, 2.0), *rest)


def b1_edge_args(run: Run, gen):
    """B1's arguments at N = 40,003 (N = 3 mod 4), D = 32, C = 70, 300
    groups, normal inputs."""
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
    return (beta, alpha, *t, prep["lane_tile"])


def precision_cases(run: Run, full, lfull, gen):
    """The kernel instantiations of both precisions, at full width: key,
    wrapper, plain version, normal arguments and their dyadic twins, link
    keywords, slack, bytes, products, tolerances, and the kernels-line
    entry (or None)."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    cases = []

    def b1_case(key, args, entry):
        beta, alpha, xT, y, gl, fg, _ = args
        c = beta.shape[0]
        nbytes = 4 * (xT.numel() + y.numel() + gl.numel() + fg.numel() + 2 * alpha.numel()
                      + 2 * beta.numel() + c)
        cases.append(dict(key=key, wrapper=hf.hier_grouped, plain=hf.hier_grouped_plain,
                          args=args, fine=dyadic_inputs("B1", args, gen), kw={},
                          slack=b1_link_slack, resid_unrounded=b1_resid_unrounded,
                          bytes=nbytes,
                          products=2 * c * xT.shape[0] * xT.shape[1], tol=(GRAD_RTOL, GRAD_ATOL),
                          entry=entry, name="hier_grouped (B1"))

    def b2_case(key, args, link, entry, name):
        beta, xT, y, off = args
        c, d = beta.shape[-2:]
        lead = beta.shape[0] if beta.ndim == 3 else 1
        nbytes = 4 * (xT.numel() + y.numel() + 2 * beta.numel() + lead * c
                      + (2 * off.numel() if off is not None else 0))
        cases.append(dict(key=key, wrapper=lf.logistic_batched, plain=lf.logistic_batched_plain,
                          args=args, fine=dyadic_inputs(link, args, gen), kw=dict(link=link),
                          slack=lambda a, p: b2_link_slack(a, p, link), bytes=nbytes,
                          products=2 * lead * c * d * xT.shape[-1], tol=(GRAD_RTOL, GRAD_ATOL),
                          entry=entry, name=name))

    b1_case("B1 C=64", _grouped_inputs(run, full, 64, gen)[0], "B1")
    b1_case(f"B1 C={NUTS_CHAINS}", _grouped_inputs(run, full, NUTS_CHAINS, gen)[0], None)
    b1_case("B1 C=70 N=40,003 G=300", b1_edge_args(run, gen), None)
    b2_case("B2 C=32 offsets=False", _batched_inputs(run, full, 32, gen, False),
            "bernoulli_logit", None, "")
    b2_case("B2 C=32 offsets=True", _batched_inputs(run, full, 32, gen, True),
            "bernoulli_logit", "B2", "logistic_batched (B2, offsets")
    b2_case(f"B2 gaussian C={LMM_CHAINS} D={LMM_D} offsets=True (config 3)",
            _lmm_offset_inputs(run, lfull, LMM_CHAINS, gen), "gaussian", "B2g",
            "logistic_batched (B2, gaussian link, offsets")
    n = min(run.zoo_n, full["y"].shape[0])
    xT = torch.as_tensor(np.ascontiguousarray(full["x"][:n].T), device=run.dev)
    y = torch.randn(n, generator=gen, device=run.dev)
    beta = 0.3 * torch.randn(ZOO_CHAINS, D, generator=gen, device=run.dev)
    b2_case(f"B2 gaussian C={ZOO_CHAINS} D={D} N={n} offsets=False", (beta, xT, y, None),
            "gaussian", None, "")
    beta, xT, y, _ = b2_shard_inputs(CONS_SHARDS, run.cons_n // CONS_SHARDS, CONS_D, CONS_CHAINS,
                                     gen, run.dev)
    b2_case(f"B2 shards S={CONS_SHARDS} C={CONS_CHAINS} D={CONS_D}", (beta, xT, y, None),
            "bernoulli_logit", "B2s", "logistic_batched (B2, shard axis")
    args, _ = _lmm_inputs(run, lfull, LMM_CHAINS, gen)
    beta, u, ic, xT, zT, y, gl, fg, _ = args
    c, d = beta.shape
    n, q = xT.shape[1], zT.shape[0]
    cases.append(dict(
        key=f"B4 C={c} (config 3)", wrapper=hf.lmm_grouped, plain=hf.lmm_grouped_plain,
        args=args, fine=dyadic_inputs("B4", args, gen), kw={}, slack=lambda a, p: [],
        bytes=4 * (xT.numel() + zT.numel() + y.numel() + gl.numel() + fg.numel()
                   + 2 * u.numel() + 2 * beta.numel() + 3 * c),
        products=2 * c * n * (d + q), tol=(LMM_RTOL, LMM_ATOL), entry="B4",
        name="lmm_grouped (B4"))
    return cases


def phase_precision_kernels(run: Run, flag, lmm):
    """Each kernel instantiation of high and default at full width: on
    `dyadic_inputs` of the same shapes, against its plain version at the
    same precision in float64, within the highest tolerances (plus, at
    the bernoulli link, `link_slack`); and at default, the plain version
    at highest (no operand rounded) shown to fall outside that bound, so
    the check tells the roundings apart.  On normal inputs: a second
    launch bitwise equal, inside the reference's band against the kernel
    at highest, and CUDA-event times beside the bound.  Then B2's and
    B4's edge cases at each precision."""
    full, _, _ = flag
    lfull, _, _ = lmm
    smi = getattr(run, "smi", "cpu rehearsal")
    log(f"== precision: STARK_FUSED_PRECISION=high|default, kernels B1, B2, B4 [{smi}]")
    gen = torch.Generator(device=run.dev).manual_seed(11)
    out = {}
    for case in precision_cases(run, full, lmm[0], gen):
        wrapper, plain, args, fine, kw = (case[k] for k in ("wrapper", "plain", "args", "fine",
                                                             "kw"))
        with env(PREC_KNOB, "highest"):
            base = wrapper(*args, **kw)
        unrounded = yardstick(run, plain, *fine, **kw, prec="highest")
        for prec in PRECISION_MODES:
            label = f"{case['key']} {prec}"
            with env(PREC_KNOB, prec):
                got = wrapper(*fine, **kw)
                run.sync()
                want = yardstick(run, plain, *fine, **kw, prec=prec)
                slack = case["slack"](fine, prec)
                err, excess = compare_slack(f"{label} (dyadic, against {yardstick_name(run)})",
                                            got, want, slack, *case["tol"])
                assert excess <= 0, f"{label}: error exceeds its bound by {excess:.4g}"
                _, teeth = compare_slack(label, unrounded, want, slack, *case["tol"], quiet=True)
                log(f"  {label}: the plain version at highest against this bound: excess "
                    f"{teeth:.4g} (> 0: outside it)")
                assert prec != "default" or teeth > 0, f"{label}: highest passes default's check"
                mutant = None
                if prec == "default" and "resid_unrounded" in case:
                    mut = (want[0], *case["resid_unrounded"](fine, prec))
                    _, mutant = compare_slack(label, mut, want, slack, *case["tol"], quiet=True)
                    log(f"  {label}: resid left unrounded (the rest as the plain version) against "
                        f"this bound: excess {mutant:.4g} (> 0: outside it)")
                    assert mutant > 0, f"{label}: an unrounded resid passes default's check"
                got = wrapper(*args, **kw)
                check_repeat(label, got, wrapper(*args, **kw))
                val_rel, grad_rel = band_check(label, prec, base, got)
                ms = timed(run, lambda: wrapper(*args, **kw), 20)
                plain_ms = timed(run, lambda: plain(*args, **kw, prec=prec), 5)
            flops = 2 * case["products"] * PASSES[prec]
            e = bound(case["bytes"], flops, BF16_FLOP_PER_S)
            cuda_core = bound(case["bytes"], flops)
            e.update(max_abs_err=err, excess=excess, unrounded_excess=teeth,
                     resid_unrounded_excess=mutant, ms=ms,
                     plain_ms=plain_ms, val_rel=val_rel, grad_rel=grad_rel,
                     cuda_core_bound_ms=cuda_core["bound_ms"],
                     cuda_core_bound_by=cuda_core["bound_by"])
            out[label] = e
            log(f"  {label} [{smi}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, {fmt_bound(e)} "
                f"on bf16 tensor cores; {cuda_core['bound_ms']:.4f} ms by "
                f"{cuda_core['bound_by']} on the FP32 CUDA cores")
            if case["entry"]:
                run.kernels[f"{case['entry']} {prec}"] = dict(
                    name=f"{case['name']}, {prec})", route="cuda",
                    source=run.kernels[case["entry"]]["source"],
                    replaces=run.kernels[case["entry"]]["replaces"], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                    library_ms=None)
    for prec in PRECISION_MODES:
        phase_b2_edges(run, gen, prec)
        phase_b4_edges(run, None, prec)
    return out


def read_precision_counts():
    """Launches by dot precision of B1, B2 (both links, with or without
    the shard axis) and B4."""
    return {k: dict(fn.precision_launches) for k, fn in precision_counters().items()}


def _precision_leg(run: Run, prec, label, fn, counted, entry, evals_of):
    """One sampled leg under STARK_FUSED_PRECISION=``prec``: counts to 0
    just before, read just after; the counted kernel launched once per
    ensemble evaluation, every launch of its wrapper at ``prec`` and no
    other kernel launched; finite draws."""
    with env(PREC_KNOB, prec):
        post, wall, launches, _ = _counted_leg(run, fn)
    by_prec = read_precision_counts()
    evals = evals_of(post)
    draws = post.draws_flat
    assert np.all(np.isfinite(draws)), f"non-finite draws on the {label} leg"
    log(f"  {label} [{getattr(run, 'smi', 'cpu rehearsal')}]: wall {wall:.2f} s, {evals} "
        f"ensemble evaluations, launches {launches}, by precision {by_prec}; max split R-hat "
        f"{post.max_rhat():.4f}")
    if not run.rehearsal:
        wrapper = {"B1": "B1", "B2": "B2", "B2g": "B2", "B2s": "B2", "B4": "B4"}[counted]
        assert launches[counted] > 0 and launches[counted] == evals, (label, launches, evals)
        assert by_prec[wrapper][prec] == launches[counted], (label, by_prec)
        if counted == "B2s":  # a shard-batched launch counts as a B2 launch too
            assert launches["B2"] == launches["B2s"], (label, launches)
        allowed = {counted, "B2"} if counted == "B2s" else {counted}
        others = {k: v for k, v in launches.items() if k not in allowed and v}
        assert not others, f"{others} launched on the {label} leg"
        e = run.kernels[f"{entry} {prec}"]
        e["launches"] = e.get("launches", 0) + launches[counted]
    return dict(wall_s=wall, evals=evals, launches=launches, max_rhat=post.max_rhat())


def phase_precision_paths(run: Run, flag, lmm):
    """The port's normal entry points under each precision, at full
    width: the flagship chees_sample (B1), its offset path (B2), config
    3 (B4) and its offset path (B2 gaussian), and config 2's consensus
    (the shard axis), each leg with launches = evaluations, all at that
    precision, and finite draws."""
    from stark_tpu_torch import chees_sample, consensus_sample
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        FusedLogistic,
        synth_logistic_data,
    )

    full, _, _ = flag
    lfull, _, _ = lmm
    dev = {"device": "cpu"} if run.rehearsal else {}
    budget = run.precision_budget
    ensemble = lambda post: int(post.sample_stats["num_ensemble_grad_evals"])
    cons, _ = synth_logistic_data(0, run.cons_n, CONS_D)
    legs = (
        ("flagship", "B1", "B1", lambda: chees_sample(
            FusedHierLogisticGrouped(D, G), full, chains=64, init_step_size=0.1, seed=0,
            **budget, **dev)),
        ("offset path", "B2", "B2", lambda: chees_sample(
            FusedHierLogistic(D, G), full, chains=32, init_step_size=0.1, seed=0, **budget,
            **dev)),
        ("config 3", "B4", "B4", lambda: chees_sample(
            FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q), lfull, chains=LMM_CHAINS,
            init_step_size=0.1, seed=0, **budget, **dev)),
        ("config 3 offset path", "B2g", "B2g", lambda: chees_sample(
            FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, chains=LMM_CHAINS,
            init_step_size=0.1, seed=0, **budget, **dev)),
        ("config 2 consensus", "B2s", "B2s", lambda: consensus_sample(
            FusedLogistic(CONS_D), cons, num_shards=CONS_SHARDS, chains=CONS_CHAINS,
            kernel="chees", init_step_size=0.1, seed=0, **budget, **dev)),
    )
    out = {}
    for prec in PRECISION_MODES:
        log(f"== precision paths at {prec}: chees_sample / consensus_sample, {budget} "
            f"(script at {run.elapsed():.1f} s)")
        for label, counted, entry, fn in legs:
            out[f"{label} {prec}"] = _precision_leg(run, prec, f"{label} at {prec}", fn, counted,
                                                    entry, ensemble)
    return out


def phase_precision_potentials(run: Run, flag, lmm):
    """The potential and gradient of each model with a fused op (the
    zoo's, each with its knob on, and the flagship and config 3 families)
    on the card under each precision, against its plain model's autograd
    at highest, at 8 points z = 0.4 (s / 3.5) N(0, 1), s = 0 .. 7 (the
    reference sweep's 0.4 s N(0, 1), tools/precision_parity.py:177-186),
    inside the reference's band."""
    from stark_tpu_torch.model import flatten_model, prepare_model_data
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedIRT2PL,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        FusedLinearRegression,
        FusedLMM,
        FusedOrderedLogistic,
        FusedPoissonRegression,
        FusedStudentTRegression,
        HierLogistic,
        IRT2PL,
        LinearMixedModel,
        LinearRegression,
        OrderedLogistic,
        PoissonRegression,
        StudentTRegression,
        synth_irt_data,
        synth_linreg_data,
        synth_lmm_data,
        synth_ordinal_data,
        synth_poisson_data,
        synth_studentt_data,
    )
    full, _, _ = flag
    lfull, _, _ = lmm
    smi = getattr(run, "smi", "cpu rehearsal")
    n, d, g = run.zoo_n, ZOO_D, run.zoo_g
    log(f"== precision potentials: fused models under high and default against their plain "
        f"models at highest [{smi}] (script at {run.elapsed():.1f} s)")
    cases = (
        ("FusedHierLogisticGrouped", FusedHierLogisticGrouped(D, G), HierLogistic(D, G), full,
         None),
        ("FusedHierLogistic", FusedHierLogistic(D, G), HierLogistic(D, G), full, None),
        ("FusedLinearMixedModelGrouped", FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q),
         LinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, None),
        ("FusedLinearMixedModel", FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q),
         LinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, None),
        ("FusedLinearRegression", FusedLinearRegression(d), LinearRegression(d),
         synth_linreg_data(0, n, d)[0], None),
        ("FusedPoissonRegression", FusedPoissonRegression(d), PoissonRegression(d),
         synth_poisson_data(0, n, d)[0], None),
        ("FusedLMM", FusedLMM(d, g, ZOO_Q), LinearMixedModel(d, g, ZOO_Q),
         synth_lmm_data(0, n, d, g, num_random=ZOO_Q)[0], "STARK_FUSED_LMM"),
        ("FusedStudentTRegression", FusedStudentTRegression(d), StudentTRegression(d),
         synth_studentt_data(0, n, d)[0], "STARK_FUSED_ROBUST"),
        ("FusedOrderedLogistic", FusedOrderedLogistic(d, ORD_K), OrderedLogistic(d, ORD_K),
         synth_ordinal_data(0, n, d, num_categories=ORD_K)[0], "STARK_FUSED_ORDINAL"),
        ("FusedIRT2PL (grid)", FusedIRT2PL(run.irt_p, run.irt_i), IRT2PL(run.irt_p, run.irt_i),
         synth_irt_data(0, run.irt_p, run.irt_i)[0], "STARK_FUSED_IRT"),
    )
    gen = torch.Generator(device=run.dev).manual_seed(13)
    out = {}
    for label, fused, plain, raw, knob in cases:
        pp = flatten_model(plain).bind(prepare_model_data(plain, raw, device=run.dev))
        scale = 0.4 * torch.arange(8, device=run.dev)[:, None] / 3.5
        z = scale * torch.randn(8, flatten_model(plain).ndim, generator=gen, device=run.dev)
        v0, g0 = pp.value_and_grad(z)

        def fused_vg(prec):
            with env(PREC_KNOB, prec):
                fp = flatten_model(fused).bind(prepare_model_data(fused, raw, device=run.dev))
                return fp.value_and_grad(z)

        for prec in PRECISION_MODES:
            with env(knob, "1"):
                v1, g1 = fused_vg(prec)
            val_rel, grad_rel = parity_error(v0, g0, v1, g1)
            tol_v, tol_g = PARITY_BANDS[prec]
            log(f"  {label} at {prec}: val_rel {val_rel:.3g} (band {tol_v:g}), grad_rel "
                f"{grad_rel:.3g} (band {tol_g:g})")
            assert val_rel <= tol_v and grad_rel <= tol_g, (label, prec, val_rel, grad_rel)
            out[f"{label} {prec}"] = dict(val_rel=val_rel, grad_rel=grad_rel)
    return out


X_KNOB = "STARK_FUSED_X_DTYPE"
#: the narrow storage dtypes of X (ROADMAP B5), and those the flagship's
#: adapt_import leg runs under
X_NARROW = ("bf16", "int8", "fp8e4m3", "fp8e5m2")
X_IMPORT_DTYPES = ("bf16", "int8")  # gated at 0.3 sd; fp8's shift is reported
#: bytes of an element of each storage dtype
X_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1, "fp8e4m3": 1, "fp8e5m2": 1}
#: the reference's bands of a narrow X against float32 X on the same
#: rounded matrix (tools/precision_parity.py:19-23, band_for at highest):
#: mid for bf16, quant for int8 and fp8; (value, gradient) in the
#: metrics of `parity_error`
X_BANDS = {"bf16": (5e-3, 2e-2), "int8": (2e-2, 5e-2), "fp8e4m3": (2e-2, 5e-2),
           "fp8e5m2": (2e-2, 5e-2)}
#: the entries of the kernels line, and the kernels line's name of each
X_ENTRIES = {"B1": "hier_grouped (B1", "B2": "logistic_batched (B2, offsets",
             "B2g": "logistic_batched (B2, gaussian link, offsets",
             "B2s": "logistic_batched (B2, shard axis", "B3": "logistic_single (B3",
             "B4": "lmm_grouped (B4"}


def read_x_dtype_counts():
    """Launches by the storage dtype of X of B1, B2, B3 and B4."""
    return {k: dict(fn.x_dtype_launches) for k, fn in x_dtype_counters().items()}


def narrow_slab(t, xdt, scale):
    """A dyadic slab ``t`` (`dyadic_inputs`: multiples of 2^-9 in [-1, 1];
    z in halves) stored as ``xdt``, every value still a multiple of 2^-9
    in [-1, 1], so the logits stay exact: bf16 and fp8 round each value
    to their nearest (e4m3's subnormals are multiples of 2^-9; e5m2 keeps
    3 significant bits, so its values below 2^-7 are the grid's own
    1, 2, 3 x 2^-9); int8 stores round(t * ``scale``), integers of at most
    7 bits, whose 1 / ``scale`` (a power of two) the caller folds into
    the parameter operand, as a model folds a packed slab's scales."""
    from stark_tpu_torch.ops.precision import X_DTYPE_OF

    if xdt == "int8":
        return torch.round(t * scale).clamp(-127, 127).to(torch.int8)
    return t.to({name: dt for dt, name in X_DTYPE_OF.items()}[xdt])


def x_narrow_args(kind, args, xdt):
    """(kernel arguments, the same with each slab widened to float32, the
    outputs' scaling) of B1, B2, B3 or B4 (``kind``) on dyadic ``args``
    with X (and B4's z) stored as ``xdt`` (`narrow_slab`).  For int8 the
    scales are folded into beta (and u), and the scaling takes the
    gradients of the folded operands back to the model's units (times the
    scale, a power of two: exact), where the tolerances are stated."""
    s = 1.0 / 128.0 if xdt == "int8" else 1.0
    sz = 0.5 if xdt == "int8" else 1.0

    def scaled(by):  # outputs (or slacks, None where there is none) times `by`
        return lambda out: [o * by.get(i, 1.0) if o is not None else None
                            for i, o in enumerate(out)]

    if kind == "B1":
        beta, alpha, xT, *rest = args
        q = narrow_slab(xT, xdt, 128.0)
        return ((beta * s, alpha, q, *rest), (beta * s, alpha, q.float(), *rest),
                scaled({1: s}))
    if kind in ("B2", "B3"):
        beta, xT, y, off = args
        q = narrow_slab(xT, xdt, 128.0)
        return (beta * s, q, y, off), (beta * s, q.float(), y, off), scaled({1: s})
    beta, u, ic, xT, zT, *rest = args
    q, qz = narrow_slab(xT, xdt, 128.0), narrow_slab(zT, xdt, 2.0)
    return ((beta * s, u * sz, ic, q, qz, *rest),
            (beta * s, u * sz, ic, q.float(), qz.float(), *rest), scaled({2: s, 3: sz}))


def x_cases(run: Run, full, lfull, gen):
    """The kernel cases of `precision_cases` (B1 at C=64, C=8 and N =
    40,003; B2 bernoulli with and without offsets, gaussian at config
    3's and the zoo's widths, the shard axis at config 2's; B4 at config
    3's), each with its kind, and B3 on the flagship X."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    kinds = {hf.hier_grouped: "B1", lf.logistic_batched: "B2", hf.lmm_grouped: "B4"}
    cases = [dict(c, kind=kinds[c["wrapper"]]) for c in precision_cases(run, full, lfull, gen)]
    beta, xT, y, _ = _single_inputs(run, full, gen, False)
    fine = (dyadic(beta, 2.0 ** -11, 0.25, gen), dyadic(xT, 2.0 ** -9, 1.0, gen), y, None)
    cases.append(dict(
        key="B3 (flagship X)", kind="B3", wrapper=lf.logistic_single,
        plain=lf.logistic_single_plain, args=fine, fine=fine, kw={},
        slack=lambda a, p: [], bytes=4 * (xT.numel() + y.numel() + 2 * D + 1),
        products=2 * D * xT.shape[1], tol=(GRAD_RTOL, GRAD_ATOL), entry="B3",
        name="logistic_single (B3"))
    return cases


def x_bytes(case, kargs, xdt):
    """A case's bytes with its slabs at the storage width of ``xdt``."""
    slabs = [a for a in kargs if torch.is_tensor(a) and a.dtype not in
             (torch.float32, torch.int32, torch.int64)]
    n = sum(a.numel() for a in slabs)
    return case["bytes"] - 4 * n + X_ITEMSIZE[xdt] * n


def phase_x_dtype_kernels(run: Run, flag, lmm):
    """Each kernel with X (and B4's z) stored as bf16, int8, fp8 e4m3 and
    fp8 e5m2 (ROADMAP B5), at the main paths' full widths (`x_cases`): on
    dyadic inputs whose logits are exact (`narrow_slab`), against its
    plain version in float64 on the same values widened, at highest
    within highest's tolerances; a second launch bitwise equal; CUDA-event
    times beside the bound with the slab at its storage width.  Each
    kernel at one full-width shape also at high and default, against its
    plain version at that precision (plus, at the bernoulli link,
    `link_slack`).  At the flagship, one B1 call on int8 X allocates less
    than the float32 slab's bytes beyond its inputs and outputs: no
    float32 copy of X is made."""
    from stark_tpu_torch.ops import hier_fused as hf

    full, _, _ = flag
    smi = getattr(run, "smi", "cpu rehearsal")
    log(f"== x dtype: STARK_FUSED_X_DTYPE={'|'.join(X_NARROW)}, kernels B1-B4 [{smi}] "
        f"(script at {run.elapsed():.1f} s)")
    gen = torch.Generator(device=run.dev).manual_seed(17)
    out = {}
    for case in x_cases(run, full, lmm[0], gen):
        wrapper, plain, kind = case["wrapper"], case["plain"], case["kind"]
        kw = case["kw"]
        for xdt in X_NARROW:
            kargs, wide, units = x_narrow_args(kind, case["fine"], xdt)
            label = f"{case['key']} {xdt}"
            got = wrapper(*kargs, **kw)
            again = wrapper(*kargs, **kw)
            run.sync()
            want = yardstick(run, plain, *wide, **kw)
            err, excess = compare_slack(f"{label} (dyadic, against {yardstick_name(run)})",
                                        units(got), units(want), [], *case["tol"])
            assert excess <= 0, f"{label}: error exceeds its bound by {excess:.4g}"
            check_repeat(label, got, again)
            ms = timed(run, lambda: wrapper(*kargs, **kw), 20)
            plain_ms = timed(run, lambda: plain(*kargs, **kw), 5)
            e = bound(x_bytes(case, kargs, xdt), 2 * case["products"])
            e.update(max_abs_err=err, excess=excess, ms=ms, plain_ms=plain_ms)
            log(f"  {label} [{smi}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, {fmt_bound(e)}")
            if case["entry"]:
                run.kernels[f"{case['entry']} {xdt}"] = dict(
                    name=f"{X_ENTRIES[case['entry']]}, X {xdt})", route="cuda",
                    source=run.kernels[case["entry"]]["source"],
                    replaces=run.kernels[case["entry"]]["replaces"], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                    library_ms=None)
                for prec in () if kind == "B3" else PRECISION_MODES:
                    with env(PREC_KNOB, prec):
                        pgot = wrapper(*kargs, **kw)
                        run.sync()
                        pwant = yardstick(run, plain, *wide, **kw, prec=prec)
                        perr, pexcess = compare_slack(
                            f"{label} {prec} (dyadic, against {yardstick_name(run)})",
                            units(pgot), units(pwant), units(case["slack"](wide, prec)),
                            *case["tol"])
                        assert pexcess <= 0, f"{label} {prec}: exceeds its bound by {pexcess:.4g}"
                        pms = timed(run, lambda: wrapper(*kargs, **kw), 20)
                    pe = bound(x_bytes(case, kargs, xdt), 2 * case["products"] * PASSES[prec],
                               BF16_FLOP_PER_S)
                    log(f"  {label} {prec} [{smi}]: {pms:.4f} ms, {fmt_bound(pe)} on bf16 tensor "
                        f"cores")
                    out[f"{label} {prec}"] = dict(pe, max_abs_err=perr, excess=pexcess, ms=pms)
            out[label] = e
    out["edges_max_abs_err"] = phase_x_dtype_edges(run, gen)
    # no float32 copy of X: one B1 call on int8 X at the flagship
    args, _ = _grouped_inputs(run, full, 64, gen)
    kargs, _, _ = x_narrow_args("B1", dyadic_inputs("B1", args, gen), "int8")
    if not run.rehearsal:
        hf.hier_grouped(*kargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = hf.hier_grouped(*kargs)
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - before
                 - sum(r.numel() * r.element_size() for r in res))
        f32_slab = 4 * kargs[2].numel()
        log(f"  B1 C=64 int8 at the flagship: {extra / 2**20:.3f} MiB allocated beyond its "
            f"inputs and outputs (its scratch), against the float32 slab's "
            f"{f32_slab / 2**20:.1f} MiB")
        assert extra < f32_slab, (extra, f32_slab)
        out["b1_int8_extra_bytes"] = extra
    return out


#: edge cases of the narrow staging: rows that start off the alignment of
#: a 4-element load (N = 1, 2, 3 mod 4), N below one sub-tile, chain and
#: feature counts off the chunks, each kernel's general instantiation
#: (B1 (N, D, C, G); B2 (N, D, C); the shard axis (S, n, D, C); B3 (N,
#: D); B4 (ids, N, D, Q, C, G), as B4_EDGE_CASES)
X_EDGE_B1 = ((3001, 7, 9, 20), (1027, 33, 70, 12))
X_EDGE_B2 = ((3001, 7, 9), (50, 5, 9), (40_003, 32, 20), (1001, 33, 33))
X_EDGE_SHARDS = ((3, 127, 16, 8), (2, 3001, 33, 33), (8, 1001, 16, 8))
X_EDGE_B3 = ((1001, 5), (3, 40), (40_003, 32))
X_EDGE_B4 = (("uniform", 3001, 8, 2, 16, 20), ("uniform", 50, 5, 2, 9, 3),
             ("uniform", 40_002, 3, 3, 33, 300), ("gaps", 0, 8, 2, 16, 300))


def x_edge_cases(run: Run, gen):
    """(label, kind, wrapper, plain, dyadic arguments, link keywords,
    tolerances) of every X_EDGE_* case, x on `dyadic_inputs`' 2^-9 grid."""
    from stark_tpu_torch.ops import hier_fused as hf
    from stark_tpu_torch.ops import logistic_fused as lf

    dev, rs = run.dev, np.random.RandomState(23)
    fine = lambda shape: dyadic(torch.empty(shape, device=dev), 2.0 ** -11, 0.25, gen)
    out = []
    for n, d, c, groups in X_EDGE_B1:
        raw = {"x": (rs.randint(-512, 513, size=(n, d)) * 2.0 ** -9).astype(np.float32),
               "y": (rs.rand(n) < 0.4).astype(np.float32),
               "g": rs.randint(0, groups, size=n).astype(np.int32)}
        prep = hf.prepare_grouped(raw, d)
        t = [torch.as_tensor(prep[k], device=dev) for k in ("xT", "y", "gl", "first_gid")]
        out.append((f"B1 N={n} D={d} C={c}", "B1", hf.hier_grouped, hf.hier_grouped_plain,
                    (fine((c, d)), fine((c, groups)), *t, prep["lane_tile"]), {},
                    (GRAD_RTOL, GRAD_ATOL)))
    for link in ("bernoulli_logit", "gaussian"):
        for n, d, c in X_EDGE_B2:
            xT, y, beta, off = b2_edge_inputs(n, d, c, link, gen, dev, fine=True)
            for o in (None, off):
                out.append((f"B2 {link} N={n} D={d} C={c} offsets={o is not None}", "B2",
                            lf.logistic_batched, lf.logistic_batched_plain, (beta, xT, y, o),
                            dict(link=link), (GRAD_RTOL, GRAD_ATOL)))
        for s, n, d, c in X_EDGE_SHARDS:
            parts = [b2_edge_inputs(n, d, c, link, gen, dev, fine=True) for _ in range(s)]
            xT, y, beta, off = (torch.stack(t) for t in zip(*parts))
            out.append((f"B2 {link} shards S={s} n={n} D={d} C={c}", "B2", lf.logistic_batched,
                        lf.logistic_batched_plain, (beta, xT, y, off), dict(link=link),
                        (GRAD_RTOL, GRAD_ATOL)))
        for n, d in X_EDGE_B3:
            xT, y, beta, off = b2_edge_inputs(n, d, 1, link, gen, dev, fine=True)
            out.append((f"B3 {link} N={n} D={d}", "B3", lf.logistic_single,
                        lf.logistic_single_plain, (beta[0], xT, y, off[0]), dict(link=link),
                        (GRAD_RTOL, GRAD_ATOL)))
    for ids, n, d, q, c, groups in X_EDGE_B4:
        raw, (beta, u, ic) = b4_edge_inputs(ids, n, d, q, c, groups, rs, fine=True)
        prep = hf.prepare_grouped(raw, d + q, transpose_keys=("x", "z"))
        t = [torch.as_tensor(prep[k], device=dev) for k in ("xT", "zT", "y", "gl", "first_gid")]
        p = [torch.as_tensor(a, device=dev) for a in (beta, u, ic)]
        out.append((f"B4 {ids} N={prep['y'].shape[0]} D={d} Q={q} C={c}", "B4",
                    hf.lmm_grouped, hf.lmm_grouped_plain, (*p, *t, prep["lane_tile"]), {},
                    (LMM_RTOL, LMM_ATOL)))
    return out


def phase_x_dtype_edges(run: Run, gen):
    """Every X_EDGE_* case under every narrow dtype at highest: the kernel
    against its plain version in float64 on the widened values, a second
    launch bitwise equal."""
    log(f"== x dtype edge cases (X_EDGE_*), every narrow dtype, against "
        f"{yardstick_name(run)} (script at {run.elapsed():.1f} s)")
    worst = 0.0
    for label, kind, wrapper, plain, args, kw, tol in x_edge_cases(run, gen):
        for xdt in X_NARROW:
            kargs, wide, units = x_narrow_args(kind, args, xdt)
            got = wrapper(*kargs, **kw)
            again = wrapper(*kargs, **kw)
            run.sync()
            want = yardstick(run, plain, *wide, **kw)
            err, excess = compare_slack(f"{label} {xdt}", units(got), units(want), [], *tol,
                                        quiet=True)
            assert excess <= 0, f"{label} {xdt}: error exceeds its bound by {excess:.4g}"
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{label} {xdt} repeat"
            worst = max(worst, err)
    log(f"  every case passes, a second launch bitwise equal; largest error {worst:.4g}")
    return worst


def _x_leg(run: Run, xdt, label, fn, counted, evals_of):
    """One sampled leg with X stored as ``xdt``: counts to 0 just before,
    read just after; the counted kernel launched once per ensemble
    evaluation, every launch of its wrapper on ``xdt`` and no other kernel
    launched; finite draws."""
    with env(X_KNOB, xdt):
        post, wall, launches, _ = _counted_leg(run, fn)
    by_x = read_x_dtype_counts()
    evals = evals_of(post)
    assert np.all(np.isfinite(post.draws_flat)), f"non-finite draws on the {label} leg"
    log(f"  {label} [{getattr(run, 'smi', 'cpu rehearsal')}]: wall {wall:.2f} s, {evals} "
        f"ensemble evaluations, launches {launches}, by X dtype {by_x}; max split R-hat "
        f"{post.max_rhat():.4f}")
    if not run.rehearsal:
        wrapper = {"B1": "B1", "B2": "B2", "B2g": "B2", "B2s": "B2", "B4": "B4"}[counted]
        assert launches[counted] > 0 and launches[counted] == evals, (label, launches, evals)
        assert by_x[wrapper][xdt] == launches[counted], (label, by_x)
        allowed = {counted, "B2"} if counted == "B2s" else {counted}
        others = {k: v for k, v in launches.items() if k not in allowed and v}
        assert not others, f"{others} launched on the {label} leg"
        e = run.kernels[f"{counted} {xdt}"]
        e["launches"] = e.get("launches", 0) + launches[counted]
    return dict(wall_s=wall, evals=evals, launches=launches, max_rhat=post.max_rhat())


def phase_x_dtype_paths(run: Run, flag, lmm):
    """The port's normal entry points with X stored narrow, at full
    width: under each of bf16, int8, fp8 e4m3 and fp8 e5m2, the flagship
    chees_sample (B1), its offset path (B2), config 3 (B4) and its offset
    path (B2 gaussian), and config 2's consensus (the shard axis), each
    leg with launches = evaluations, all on that dtype, and finite draws;
    and the single-chain op (B3) on the flagship's X prepared under each,
    its scales folded into beta, one launch per call."""
    from stark_tpu_torch import chees_sample, consensus_sample
    from stark_tpu_torch.model import prepare_model_data
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        FusedLogistic,
        synth_logistic_data,
    )
    from stark_tpu_torch.ops import logistic_fused as lf

    full, _, _ = flag
    lfull, _, _ = lmm
    dev = {"device": "cpu"} if run.rehearsal else {}
    budget = run.precision_budget
    ensemble = lambda post: int(post.sample_stats["num_ensemble_grad_evals"])
    cons, _ = synth_logistic_data(0, run.cons_n, CONS_D)
    legs = (
        ("flagship", "B1", lambda: chees_sample(
            FusedHierLogisticGrouped(D, G), full, chains=64, init_step_size=0.1, seed=0,
            **budget, **dev)),
        ("offset path", "B2", lambda: chees_sample(
            FusedHierLogistic(D, G), full, chains=32, init_step_size=0.1, seed=0, **budget,
            **dev)),
        ("config 3", "B4", lambda: chees_sample(
            FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q), lfull, chains=LMM_CHAINS,
            init_step_size=0.1, seed=0, **budget, **dev)),
        ("config 3 offset path", "B2g", lambda: chees_sample(
            FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, chains=LMM_CHAINS,
            init_step_size=0.1, seed=0, **budget, **dev)),
        ("config 2 consensus", "B2s", lambda: consensus_sample(
            FusedLogistic(CONS_D), cons, num_shards=CONS_SHARDS, chains=CONS_CHAINS,
            kernel="chees", init_step_size=0.1, seed=0, **budget, **dev)),
    )
    out = {}
    for xdt in X_NARROW:
        log(f"== x dtype paths, X {xdt}: chees_sample / consensus_sample, {budget} "
            f"(script at {run.elapsed():.1f} s)")
        for label, counted, fn in legs:
            out[f"{label} {xdt}"] = _x_leg(run, xdt, f"{label}, X {xdt}", fn, counted, ensemble)
        with env(X_KNOB, xdt):
            data = prepare_model_data(FusedLogistic(D), full, device=run.dev)
        scale = data.get("xT_scale")
        beta = torch.zeros(D, device=run.dev)
        calls = 10
        run.sync()
        reset_counts()
        for _ in range(calls):
            val, grad = lf.logistic_loglik_value_and_grad(
                beta if scale is None else beta * scale, data["xT"], data["y"])
            beta = beta + 1e-6 * (grad if scale is None else grad * scale)
        run.sync()
        launches, by_x = read_counts(), read_x_dtype_counts()
        assert np.isfinite(float(val))
        log(f"  single-chain op, X {xdt}: {calls} calls, launches {launches}, by X dtype "
            f"{by_x['B3']}; log-lik {float(val):.6g}")
        if not run.rehearsal:
            assert launches["B3"] == calls == by_x["B3"][xdt] == sum(launches.values()), launches
            run.kernels[f"B3 {xdt}"]["launches"] = calls
        out[f"single {xdt}"] = dict(calls=calls, launches=launches)
    return out


def rounded_rows(raw, xdt, keys=("x",)):
    """Each matrix in ``keys`` of the caller's rows as a model prepared
    under ``xdt`` sees it: rounded to bf16, or packed and dequantized
    (`quantize.fake_quant`, the reference's rounded-X convention)."""
    from stark_tpu_torch.ops.quantize import fake_quant

    out = {}
    for k in keys:
        x = np.asarray(raw[k], np.float32)
        if xdt == "bf16":
            out[k] = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
        else:
            out[k] = fake_quant(x, xdt)
    return out


def phase_x_dtype_potentials(run: Run, flag, lmm):
    """The potential and gradient of each fused model that reaches a
    kernel, and of the zoo's fused ops (each with its knob on), at full
    width with X stored as each narrow dtype, against the same model with
    float32 X on the matrix that dtype gives (`rounded_rows`), at 8 points
    z = 0.4 (s / 3.5) N(0, 1), s = 0 .. 7, inside the reference's band
    (`X_BANDS`: mid for bf16, quant for int8 and fp8)."""
    from stark_tpu_torch.model import flatten_model, prepare_model_data
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedIRT2PL,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        FusedLinearRegression,
        FusedLMM,
        FusedLogistic,
        FusedOrderedLogistic,
        FusedPoissonRegression,
        FusedStudentTRegression,
        synth_irt_data,
        synth_linreg_data,
        synth_lmm_data,
        synth_ordinal_data,
        synth_poisson_data,
        synth_studentt_data,
    )
    full, _, _ = flag
    lfull, _, _ = lmm
    smi = getattr(run, "smi", "cpu rehearsal")
    n, d, g = run.zoo_n, ZOO_D, run.zoo_g
    log(f"== x dtype potentials: fused models with X stored narrow against float32 X on the "
        f"same rounded matrix [{smi}] (script at {run.elapsed():.1f} s)")
    cases = (
        ("FusedHierLogisticGrouped", FusedHierLogisticGrouped(D, G), full, None, ("x",)),
        ("FusedHierLogistic", FusedHierLogistic(D, G), full, None, ("x",)),
        ("FusedLogistic", FusedLogistic(D), {"x": full["x"], "y": full["y"]}, None, ("x",)),
        ("FusedLinearMixedModelGrouped", FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q),
         lfull, None, ("x", "z")),
        ("FusedLinearMixedModel", FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull, None,
         ("x",)),
        ("FusedLinearRegression", FusedLinearRegression(d), synth_linreg_data(0, n, d)[0], None,
         ("x",)),
        ("FusedPoissonRegression", FusedPoissonRegression(d), synth_poisson_data(0, n, d)[0],
         None, ("x",)),
        ("FusedLMM", FusedLMM(d, g, ZOO_Q), synth_lmm_data(0, n, d, g, num_random=ZOO_Q)[0],
         "STARK_FUSED_LMM", ("x",)),
        ("FusedStudentTRegression", FusedStudentTRegression(d), synth_studentt_data(0, n, d)[0],
         "STARK_FUSED_ROBUST", ("x",)),
        ("FusedOrderedLogistic", FusedOrderedLogistic(d, ORD_K),
         synth_ordinal_data(0, n, d, num_categories=ORD_K)[0], "STARK_FUSED_ORDINAL", ("x",)),
        ("FusedIRT2PL (grid)", FusedIRT2PL(run.irt_p, run.irt_i),
         synth_irt_data(0, run.irt_p, run.irt_i)[0], "STARK_FUSED_IRT", ()),
    )
    gen = torch.Generator(device=run.dev).manual_seed(19)
    out, rounded = {}, {}
    for label, model, raw, knob, keys in cases:
        fm = flatten_model(model)
        scale = 0.4 * torch.arange(8, device=run.dev)[:, None] / 3.5
        z = scale * torch.randn(8, fm.ndim, generator=gen, device=run.dev)
        for xdt in X_NARROW:
            with env(knob, "1"):
                with env(X_KNOB, xdt):
                    data = prepare_model_data(model, raw, device=run.dev)
                v1, g1 = fm.bind(data).value_and_grad(z)
                rkey = (id(raw["x"]) if "x" in raw else None, xdt, keys)
                if rkey not in rounded:  # the flagship's rows serve three models
                    rounded[rkey] = rounded_rows(raw, xdt, keys)
                base = prepare_model_data(model, {**raw, **rounded[rkey]}, device=run.dev)
                v0, g0 = fm.bind(base).value_and_grad(z)
            del data, base
            assert torch.isfinite(v1).all() and torch.isfinite(g1).all(), (label, xdt)
            val_rel, grad_rel = parity_error(v0, g0, v1, g1)
            tol_v, tol_g = X_BANDS[xdt]
            log(f"  {label}, X {xdt}: val_rel {val_rel:.3g} (band {tol_v:g}), grad_rel "
                f"{grad_rel:.3g} (band {tol_g:g})")
            assert val_rel <= tol_v and grad_rel <= tol_g, (label, xdt, val_rel, grad_rel)
            out[f"{label} {xdt}"] = dict(val_rel=val_rel, grad_rel=grad_rel)
    return out


def device_rows(fn):
    """Run ``fn`` under torch.profiler -> (window ms on the host clock,
    [(device ms, launches, kernel name)] of every CUDA kernel, largest
    first).  Only CUDA rows are summed: an operator's row repeats the
    time of the kernels it launched."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = 1e3 * (time.perf_counter() - t)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return window, rows


def profile_nuts_transitions(run: Run, model, raw, post, label, reps=3):
    """Where a NUTS leaf's time goes: ``reps`` transitions from the leg's
    last draws at its adapted step sizes and metric, on the host clock
    and then under torch.profiler (device time by kernel, launches and
    the idle share per ensemble evaluation)."""
    from stark_tpu_torch import prepare_model_data
    from stark_tpu_torch.kernels.base import init_state
    from stark_tpu_torch.kernels.chees import TorchNoise
    from stark_tpu_torch.kernels.nuts import nuts_step
    from stark_tpu_torch.model import flatten_model

    pot = flatten_model(model).bind(prepare_model_data(model, raw, device=run.dev))
    st = post.sample_stats
    state = init_state(pot, torch.as_tensor(post.draws_flat[:, -1], device=run.dev))
    step = torch.as_tensor(st["step_size"], device=run.dev)[:, None]
    mass = torch.as_tensor(st["inv_mass_diag"], device=run.dev)
    noise = TorchNoise(torch.Generator(device=run.dev).manual_seed(11))
    depth = run.nuts_budget["max_tree_depth"]

    def transitions():
        n = 0
        for _ in range(reps):
            _, info = nuts_step(noise, state, pot, step, mass, depth)
            n += info.num_ensemble_grad_evals
        return n

    transitions()
    run.sync()
    t = time.perf_counter()
    evals = transitions()
    run.sync()
    per_eval = 1e3 * (time.perf_counter() - t) / evals
    log(f"  profile {label}: {reps} NUTS transitions, {evals} ensemble evaluations, "
        f"{per_eval:.4f} ms each (host clock)")
    if run.rehearsal:
        return dict(eval_ms=per_eval)
    counted = {}
    window, rows = device_rows(lambda: counted.setdefault("evals", transitions()))
    evals = counted["evals"]
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows) / evals
    log(f"  profile {label}: window {window:.3f} ms for {evals} evaluations (profiler on); "
        f"kernels {busy:.3f} ms, {busy / evals:.4f} ms and {launches:.1f} launches per "
        f"evaluation; idle share {1 - busy / window:.4f}")
    for ms, count, key in rows[:6]:
        log(f"    {ms / evals:9.4f} ms/eval  x{count / evals:<5.1f} {key[:90]}")
    return dict(eval_ms=per_eval, window_ms=window, kernel_ms_per_eval=busy / evals,
                launches_per_eval=launches, idle_share=1 - busy / window,
                top=[(r[2][:60], r[0] / evals) for r in rows[:5]])


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
    reps = 10
    window, rows = device_rows(lambda: [pot.value_and_grad(z) for _ in range(reps)])
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


def pipeline_turns(run: Run) -> int:
    """The pipelined and the serial block loop in turns on one card
    (pipelined, serial, serial, pipelined) on the flagship at full width:
    the resume legs' ChEES budget, nuts_runner's, and the gated leg's.
    Prints each run's wall and where its sampling time went; the four
    runs of a leg must give bitwise the same draws."""
    from stark_tpu_torch import supervised_sample
    from stark_tpu_torch.models import FusedHierLogisticGrouped

    phase_card(run)
    phase_build(run)
    full = make_flagship_data(run)[0]
    root = REPO / "build" / "chip_smoke_turns"
    dev = {"device": "cpu"} if run.rehearsal else {}
    chees = dict(kernel="chees", chains=64, init_step_size=0.1, seed=0)
    legs = (
        ("chees small", dict(run.resume_budget, rhat_target=0.0, **chees)),
        ("nuts small", dict(run.nuts_runner_budget, rhat_target=0.0, kernel="nuts",
                            chains=NUTS_CHAINS, seed=0)),
        ("gated", dict(run.runner_budget, min_blocks=2, rhat_target=1.01, ess_target=400.0,
                       **chees)),
    )
    for label, kw in legs:
        log(f"== turns, {label}: supervised_sample(FusedHierLogisticGrouped({D}, {G})), "
            f"N={run.n_full}, {kw} [{getattr(run, 'smi', 'cpu rehearsal')}]")
        draws = None
        for i, sync in enumerate((False, True, True, False)):
            shutil.rmtree(root, ignore_errors=True)
            post, wall, _ = _runner_leg(run, f"{'serial' if sync else 'pipelined'} {i + 1}",
                                        lambda: supervised_sample(
                FusedHierLogisticGrouped(D, G), full, workdir=str(root), sync_blocks=sync,
                **kw, **dev))
            if draws is None:
                draws = post.draws_flat
            assert np.array_equal(post.draws_flat, draws), f"{label}: the draws differ"
            h = post.history
            drive = sum(r["t_dispatch_s"] for r in h)
            host = sum(r["t_diag_s"] + r["t_store_s"] + r["t_ckpt_s"] for r in h)
            n = sum(r["block_grad_evals"] for r in h) // post.draws_flat.shape[0]
            log(f"    blocks {len(h)}: driving {drive:.3f} s ({1e3 * drive / max(n, 1):.4f} ms "
                f"an evaluation), processing {host:.3f} s, of it hidden "
                f"{sum(r['t_hidden_s'] for r in h):.3f} s, waited "
                f"{sum(r['t_wait_s'] for r in h):.3f} s; thrown away "
                f"{int(post.sample_stats['num_discarded_ensemble_grad_evals'])} evaluations")
    log(json.dumps({"pipeline_turns": True, "ok": True}))
    return 0


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
    ap.add_argument("--pipeline-turns", action="store_true",
                    help="time the pipelined and the serial block loop in turns")
    args = ap.parse_args(argv)
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.shared_kernel_times:
        print(json.dumps(shared_kernel_times(args.shared_kernel_times)), flush=True)
        return 0
    if args.compare_with:
        return compare_with(args.compare_with)
    if args.pipeline_turns:
        return pipeline_turns(Run(args.cpu_rehearsal))

    # fails here, before any result, outside a checkout of the repo
    from stark_tpu_torch.models import (
        FusedHierLogistic,
        FusedHierLogisticGrouped,
        FusedLinearMixedModel,
        FusedLinearMixedModelGrouped,
        GaussianMixture,
    )

    run = Run(args.cpu_rehearsal)
    phase_card(run)
    run.phase("build", phase_build, run)
    log("== data")
    flag, lmm = run.phase("data", make_data, run)
    run.phase("parity and times", phase_parity_and_times, run, flag, lmm)
    run.phase("small", phase_small, run)
    full, _, true = flag
    lfull, _, ltrue = lmm
    paths = {
        "main_path": run.phase("main_path", phase_chees, run, full, true,
                               FusedHierLogisticGrouped, 64, run.main_budget, "B1"),
        "offset_path": run.phase("offset_path", phase_chees, run, full, true,
                                 FusedHierLogistic, 32, run.off_budget, "B2"),
        "lmm_main_path": run.phase("lmm_main_path", phase_lmm, run, lfull, ltrue,
                                   FusedLinearMixedModelGrouped, run.lmm_budget, "B4"),
        "lmm_offset_path": run.phase("lmm_offset_path", phase_lmm, run, lfull, ltrue,
                                     FusedLinearMixedModel, run.lmm_off_budget, "B2g"),
        "single_path": run.phase("single_path", phase_single, run, full),
        "runner_path": run.phase("runner_path", phase_runner, run, full),
        "nuts_path": run.phase("nuts_path", phase_nuts, run, full),
    }
    paths["pipeline_equiv"] = run.phase("pipeline_equiv", phase_pipeline_equiv, run, full,
                                        paths["runner_path"], paths["nuts_path"])
    for name, fn, *args in (
        ("b2_shards", phase_b2_shards),
        ("consensus_path", phase_consensus),
        ("bnn_path", phase_bnn),
        ("tempering_path", phase_tempering),
        ("zoo_glm", phase_zoo_glm, lmm),
        ("zoo_rest", phase_zoo_rest),
        ("precision_kernels", phase_precision_kernels, flag, lmm),
        ("precision_paths", phase_precision_paths, flag, lmm),
        ("precision_potentials", phase_precision_potentials, flag, lmm),
        ("x_dtype_kernels", phase_x_dtype_kernels, flag, lmm),
        ("x_dtype_paths", phase_x_dtype_paths, flag, lmm),
        ("x_dtype_potentials", phase_x_dtype_potentials, flag, lmm),
    ):
        paths[name] = run.phase(name, fn, run, *args)
    prof = {
        label: run.phase(f"profile {label}", phase_profile, run, model, raw, label)
        for label, model, raw in (
            ("FusedHierLogisticGrouped", FusedHierLogisticGrouped(D, G), full),
            ("FusedHierLogistic", FusedHierLogistic(D, G), full),
            ("FusedLinearMixedModelGrouped",
             FusedLinearMixedModelGrouped(LMM_D, run.lmm_g, LMM_Q), lfull),
            ("FusedLinearMixedModel", FusedLinearMixedModel(LMM_D, run.lmm_g, LMM_Q), lfull),
            ("GaussianMixture", GaussianMixture(GMM_K), run.gmm_data),
        )
    }
    if not run.rehearsal:
        # the runner path's device busy share: its evaluations times the
        # kernel time of one evaluation (profile phase, same potential)
        rp = paths["runner_path"]
        per_eval = prof["FusedHierLogisticGrouped"]["kernel_ms_per_eval"]
        busy = (rp["evals"] + rp["discarded_evals"]) * per_eval / 1e3
        rp["idle_share_derived"] = 1 - busy / rp["wall_s"]
        log(f"== runner path: {rp['evals']} evaluations x {per_eval:.4f} ms of kernels each = "
            f"{busy:.1f} s busy of {rp['wall_s']:.1f} s wall: idle share {rp['idle_share_derived']:.4f}")
    log(f"== done in {run.elapsed():.1f} s; by phase (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in run.phase_s.items()))
    log(json.dumps({**paths, "profile": prof, "times_c8": run.c8, "phase_s": run.phase_s}))
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
