"""Adaptive runner: sample in blocks until R-hat < target — counterpart of
``stark_tpu/runner.py``: its ChEES branch and its per-chain branch (NUTS,
HMC) with the serial block loop.

Warmup runs in segments of ``block_size`` transitions, each checkpointed,
then the sampler draws blocks until the stop gate passes or the budget
is spent.  After every block the host folds the draws into per-chain
Welford moments (R-hat) and reads back the on-device streaming
accumulator (ESS); a candidate stop is validated by one full split
R-hat/ESS pass over every draw before the run may stop.  Every block
appends its draws to the draw store, flushes it, writes a checkpoint
and one JSONL metrics record.  `supervise.supervised_sample` restarts a
faulted run from the last healthy checkpoint.

The loop is the JAX package's serial one (its pipelined loop gives the
same draws; the port's is ROADMAP A6's remainder).  The random streams
are the port's own: one ``torch.Generator`` each for the initial
positions, the warmup and the sampling transitions, where the JAX
package splits keys (`sampler.chain_streams`, the streams of `sample`
too).  Checkpoints carry the warmup and sampling generators' states
(under the JAX package's array names ``key_warm`` and ``key``) and the
count of draws (``draw_rows``, ChEES's Halton position), so a run
resumed from a checkpoint draws bitwise what the uninterrupted run
draws, whatever the block boundaries; ``reseed`` branches both streams.

The runner knows no sampler: it calls the backend's `AdaptiveParts`,
whose callables have one signature for ChEES, NUTS and HMC.  Warmup
segments are checkpointed for every sampler.  The per-chain
warmup checkpoint (``phase: "warmup"``: the chain state, per-chain
step-size averaging, Welford moments and inverse mass) has no
counterpart in the JAX package, whose per-chain warmup is one unbroken
dispatch; its sampling-phase checkpoint has the JAX package's arrays
(``z``, ``pe``, ``grad``, ``step_size`` (C,), ``inv_mass`` (C, d),
``key``, ``draws``).

`StopGate` is the schedule and stop rule as one host-side unit: block
lengths (the fixed march or the ESS-forecast ladder), the streaming
R-hat/ESS readings and the validation pass.  The runner drives it; a
test can feed it any draws.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import diagnostics
from ._device import DeviceLike
from ._unported import refuse
from .checkpoint import load_checkpoint, rank_path, save_checkpoint
from .kernels.base import STREAM_DIAG_LAGS, StreamDiagState
from .kernels.chees import TorchNoise
from .model import Model
from .sampler import Posterior, SamplerConfig, chain_streams, constrain_draws

log = logging.getLogger(__name__)


class AdaptiveResult(Posterior):
    """Posterior + convergence trajectory.

    ``sample_stats["num_ensemble_grad_evals"]`` counts the ensemble
    potential-gradient evaluations THIS call made (the initial state, MAP
    steps, warmup and sampling leapfrogs; a resumed call counts from its
    checkpoint on): one likelihood kernel launch each.
    """

    def __init__(self, *args, history=None, converged=False, wall_s=0.0, **kw):
        super().__init__(*args, **kw)
        self.history = history or []
        self.converged = converged
        self.wall_s = wall_s
        self.budget_exhausted = False
        # estimated draws beyond the ESS target at the measured ESS rate
        # (None when unconverged or without a rate estimate)
        self.overshoot_draws = None
        # the JAX package's statistical-health verdict; its monitor is
        # ROADMAP A12, so None here (never an empty claim of health)
        self.health_warnings = None


# ---------------------------------------------------------------- streams


def _gen_state(g: torch.Generator) -> np.ndarray:
    return g.get_state().numpy().copy()


def _gen_from_state(device: torch.device, state: np.ndarray, reseed: Optional[int]) -> torch.Generator:
    """The generator a checkpoint stored, or, with ``reseed``, a branch of
    it: seeded from a hash of the stored state and ``reseed``, so a
    deterministic numerical failure does not replay on every retry."""
    state = np.asarray(state, np.uint8)
    g = torch.Generator(device=device)
    if reseed is not None:
        h = hashlib.sha256(state.tobytes() + int(reseed).to_bytes(8, "little", signed=True))
        return g.manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)
    want = g.get_state().numel()
    if state.size != want:
        raise ValueError(
            f"checkpoint generator state has {state.size} bytes, a {device.type} "
            f"torch.Generator's {want}: resume a checkpoint of this package on "
            "the device type that wrote it"
        )
    g.set_state(torch.from_numpy(state.copy()))
    return g


# ------------------------------------------------------------------ gate


class StopGate:
    """The block schedule and stop rule of the adaptive runner.

    Holds the streaming R-hat moments (`diagnostics.ChainSuffStats`), the
    full draw history (`diagnostics.DrawHistory`) and the (draws, min_ess)
    trail the ESS-rate forecaster reads.  ``history`` (the block records
    of a resumed run) seeds the trail, so a resumed run sizes its blocks
    as the original did; `restore` refills the draws.

    Schedule: with ``adaptive_blocks`` the total budget is
    ``max_blocks * block_size`` draws per chain; blocks grow from
    block_size/2 geometrically to 4 x block_size, shrunk to the forecast
    ESS deficit (quantized to block_size/2) and cut to the remaining
    budget.  Without it, ``max_blocks`` blocks of ``block_size``.

    Stop rule: after ``min_blocks`` blocks, when no component is stuck
    (NaN R-hat), the streaming max R-hat < ``rhat_target`` and the
    streaming min ESS > ``ess_target``, one full split R-hat/ESS pass over
    all draws validates the stop; a failed validation backs off to block
    ``blocks_done + max(1, blocks_done // 4)``.
    """

    def __init__(
        self,
        chains: int,
        ndim: int,
        *,
        block_size: int,
        max_blocks: int,
        min_blocks: int,
        rhat_target: float,
        ess_target: float,
        diag_components: int = 64,
        stream_diag: bool = True,
        adaptive_blocks: bool = True,
        history=(),
        blocks_done: int = 0,
    ):
        self.ndim = ndim
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.min_blocks = min_blocks
        self.rhat_target = rhat_target
        self.ess_target = ess_target
        self.diag_components = diag_components
        self.stream_diag = stream_diag
        self.adaptive_blocks = adaptive_blocks
        self.blocks_done = blocks_done
        self.suff = diagnostics.ChainSuffStats(chains, ndim)
        self.draws = diagnostics.DrawHistory(chains, ndim)
        self.next_full_check = 0  # earliest block allowed to validate
        self.max_draws = max_blocks * block_size
        self.quantum = max(1, block_size // 2)
        self.cap = max(block_size, 4 * block_size)
        self.points: List[Tuple[int, Optional[float]]] = []
        for r in history:
            e = r.get("min_ess")
            self.points.append((int(r.get("draws_per_chain", 0)), float(e) if e is not None else None))
        self.rate = None
        self.forecast_draws = None

    def restore(self, draws: np.ndarray) -> None:
        """Resume: rebuild the moments and history from stored (chains,
        n, d) draws."""
        self.suff.update(draws)
        self.draws.append(draws)

    @property
    def rows(self) -> int:
        """Draws per chain so far."""
        return self.draws.rows

    def more(self) -> bool:
        """Whether the budget allows another block."""
        if self.adaptive_blocks:
            return self.draws.rows < self.max_draws
        return self.blocks_done < self.max_blocks

    def _rate_and_deficit(self, points):
        """(rate, deficit) from a (draws, min_ess) trail: the rate over
        the last two finite points when positive, else the cumulative
        rate; the deficit against the last finite point."""
        usable = [p for p in points if p[1] is not None]
        if not usable:
            return None, None
        draws_u, ess_u = usable[-1]
        rate = None
        if len(usable) >= 2:
            dd = draws_u - usable[-2][0]
            de = ess_u - usable[-2][1]
            if dd > 0 and de > 0:
                rate = de / dd
        if rate is None and draws_u > 0 and ess_u > 0:
            rate = ess_u / draws_u
        return rate, self.ess_target - ess_u

    def next_block_len(self) -> int:
        """Length of the next block (0: the budget is spent).  The
        forecast reads the trail only up to block m-2 when sizing block m,
        as the JAX package's pipelined loop must; its serial loop and a
        resumed run read the same window, so every mode sizes every block
        alike."""
        if not self.adaptive_blocks:
            return self.block_size
        remaining = self.max_draws - self.draws.rows
        if remaining <= 0:
            return 0
        m = self.blocks_done  # 0-based ordinal of the next block
        n = min(self.cap, self.quantum * (2 ** min(m, 8)))
        rate, deficit = self._rate_and_deficit(self.points[: max(0, m - 1)])
        if rate and deficit is not None and deficit > 0:
            need = int(np.ceil(1.1 * deficit / rate))
            need = -(-max(need, 1) // self.quantum) * self.quantum
            n = min(n, max(need, self.quantum))
        return min(n, remaining)

    def observe(self, zs: np.ndarray, diag: Optional[Tuple[np.ndarray, ...]] = None):
        """Fold one block of draws, (chains, n, d), into the gate.

        ``diag``: the streaming accumulator's fields read back from the
        device (n, anchor, s1, s2, cross, ring, head), required when
        ``stream_diag``.  Returns (fields of the block's metrics record,
        converged)."""
        self.blocks_done += 1
        self.draws.append(zs)
        self.suff.update(zs)
        srhat = self.suff.rhat()
        # a NaN streaming R-hat is a frozen component: counted, and it
        # blocks the stop (nanmax would hide it)
        n_stuck = int(np.count_nonzero(np.isnan(srhat)))
        finite_rhat = srhat[~np.isnan(srhat)]
        max_rhat = float(np.max(finite_rhat)) if finite_rhat.size else float("inf")
        if self.stream_diag:
            diag_bytes = int(sum(np.asarray(a).nbytes for a in diag))
            ess_vals = diagnostics.ess_from_suffstats(*diag)
        else:
            # ESS on the worst-mixing components by streaming R-hat (NaN
            # counts as worst)
            k = min(self.diag_components, self.ndim)
            worst = np.argsort(np.where(np.isnan(srhat), -np.inf, -srhat))[:k]
            subset = self.draws.take(worst)
            diag_bytes = int(subset.nbytes)
            ess_vals = diagnostics.ess(subset)
        finite_ess = ess_vals[np.isfinite(ess_vals)]
        min_ess = float(np.min(finite_ess)) if finite_ess.size else float("nan")
        draws_per_chain = int(self.suff.count[0])
        self.points.append((draws_per_chain, min_ess if np.isfinite(min_ess) else None))
        rate, deficit = self._rate_and_deficit(self.points)
        self.rate = rate
        self.forecast_draws = int(draws_per_chain + max(0.0, deficit) / rate) if rate else None
        rec: Dict[str, Any] = {
            "block": self.blocks_done,
            "draws_per_chain": draws_per_chain,
            # strict JSON: non-finite values -> null
            "max_rhat": max_rhat if np.isfinite(max_rhat) else None,
            "min_ess": min_ess if np.isfinite(min_ess) else None,
            "num_stuck_components": n_stuck,
        }
        if self.stream_diag:
            rec["diag_bytes_to_host"] = diag_bytes
            if self.forecast_draws is not None:
                rec["ess_forecast"] = self.forecast_draws
        converged = False
        gate_pass = n_stuck == 0 and max_rhat < self.rhat_target and min_ess > self.ess_target
        if self.blocks_done >= self.min_blocks and gate_pass and self.blocks_done >= self.next_full_check:
            full = self.draws.view()
            rec["full_max_rhat"] = float(np.max(diagnostics.split_rhat(full)))
            rec["full_min_ess"] = float(np.min(diagnostics.ess(full)))
            # recorded, not gated: the rank form flags heavy tails
            rec["full_max_rank_rhat"] = float(np.max(diagnostics.rank_rhat(full)))
            if rec["full_max_rhat"] < self.rhat_target and rec["full_min_ess"] > self.ess_target:
                converged = True
            else:
                self.next_full_check = self.blocks_done + max(1, self.blocks_done // 4)
        return rec, converged

    def overshoot(self) -> Optional[int]:
        """Estimated draws beyond the ESS target at the measured rate."""
        pts = [p for p in self.points if p[1] is not None]
        if not (self.rate and pts):
            return None
        return int(max(0.0, (pts[-1][1] - self.ess_target) / self.rate))


# ---------------------------------------------------------------- runner


def sample_until_converged(
    model: Model,
    data: Any = None,
    *,
    backend: Optional[Any] = None,
    device: DeviceLike = None,
    chains: int = 4,
    block_size: int = 100,
    max_blocks: int = 50,
    min_blocks: int = 2,
    rhat_target: float = 1.01,
    ess_target: float = 400.0,
    diag_components: int = 64,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    draw_store_path: Optional[str] = None,
    init_params: Optional[Dict[str, Any]] = None,
    health_check: bool = False,
    reseed: Optional[int] = None,
    progress_cb: Optional[Any] = None,
    time_budget_s: Optional[float] = None,
    adapt_path: Optional[str] = None,
    adapt_export_path: Optional[str] = None,
    adapt_touchup_frac: float = 0.2,
    trace: Optional[Any] = None,
    sync_blocks: Optional[bool] = None,
    stream_diag: Optional[bool] = None,
    adaptive_blocks: Optional[bool] = None,
    diag_lags: Optional[int] = None,
    **cfg_kwargs,
) -> AdaptiveResult:
    """Run chains until R-hat < ``rhat_target`` AND min ESS >
    ``ess_target`` (validated by a full pass), or until ``max_blocks *
    block_size`` draws per chain.  Parameters are the JAX package's, and
    mean what they mean there; ``device`` (``cuda`` unless the caller asks
    for the CPU) places the run when no ``backend`` is given.

    ``checkpoint_path``: a checkpoint after every warmup segment but the
    last and after every block; ``resume_from`` resumes one of either
    phase (``reseed`` branches its random streams).  ``draw_store_path``:
    every block's draws appended to a ``.stkr`` store, flushed before the
    block's checkpoint; without a store the draws ride in the checkpoint.
    ``metrics_path``: JSONL ``warmup_done`` and ``block`` records (and
    ``budget_exhausted``), each also handed to ``progress_cb``.
    ``time_budget_s`` stops the run after the first block that ends past
    it (warmup is not interrupted).  ``health_check`` raises
    `supervise.ChainHealthError` on non-finite state before it is
    checkpointed.  ``stream_diag`` (default on) takes the gate's ESS from
    the on-device accumulator, else from the worst ``diag_components``
    components' full history; ``adaptive_blocks`` (default on) sizes
    blocks by the ESS forecast (see `StopGate`); ``diag_lags`` is the
    accumulator's L.

    Besides the JAX package's fields, a block record carries
    ``t_dispatch_s`` (the sampling segment), ``t_diag_s`` (the gate: the
    accumulator's read-back, the streaming statistics and any validation
    pass), ``t_store_s`` (the draw-store append) and ``t_ckpt_s`` (flush
    and checkpoint), and for NUTS ``tree_depth_mean`` and
    ``tree_depth_max`` of the block's transitions (the JAX package reads
    them in its health monitor, ROADMAP A12); ``warmup_done`` carries
    ``t_setup_s`` (data preparation), ``t_map_s`` (the initial
    evaluation and MAP descent or step-size search) and ``t_warmup_s``;
    its ``warmup_grad_evals`` (per-chain units, times chains) counts the
    ensemble evaluations after the initial state's and before sampling
    for NUTS and HMC too (their step-size search and warmup).

    Not ported, each refused with its ROADMAP item: the pipelined loop
    (``sync_blocks=False``), adaptation reuse (``adapt_path``,
    ``adapt_export_path``), ``trace`` and ``profile_dir``, and ragged
    NUTS (``STARK_RAGGED_NUTS=1``).
    """
    if sync_blocks is False:
        refuse("the pipelined block loop (sync_blocks=False)", "A6, the pipelined loop")
    if adapt_path is not None or adapt_export_path is not None:
        refuse("adaptation reuse (adapt_path / adapt_export_path)", "A6, adaptation reuse")
    if trace is not None:
        refuse("run telemetry (trace=)", "A12")
    if profile_dir is not None:
        refuse("profile hooks (profile_dir=)", "A12")
    if backend is None:
        from .backends.cuda_backend import CudaBackend

        backend = CudaBackend(device)
    elif device is not None and torch.device(device) != backend.device:
        raise ValueError(f"device={device!r} disagrees with the backend's {backend.device}")
    cfg = SamplerConfig(**cfg_kwargs)
    stream_diag = True if stream_diag is None else bool(stream_diag)
    adaptive_blocks = True if adaptive_blocks is None else bool(adaptive_blocks)
    diag_lags = STREAM_DIAG_LAGS if diag_lags is None else int(diag_lags)
    checkpoint_path = rank_path(checkpoint_path)
    resume_from = rank_path(resume_from)
    metrics_path = rank_path(metrics_path)
    draw_store_path = rank_path(draw_store_path)

    t_call = time.perf_counter()
    ap = backend.adaptive_parts(model, cfg, data)
    t_setup = time.perf_counter() - t_call
    fm, extra = ap.fm, ap.extra
    dev = backend.device

    t_start = time.perf_counter()
    metrics_f = open(metrics_path, "a") if metrics_path else None
    evals = 0  # ensemble gradient evaluations of this call

    def emit(rec):
        # flushed and fsynced line by line: the trail documents crashes,
        # so it must survive the crash it documents
        if metrics_f:
            metrics_f.write(json.dumps(rec) + "\n")
            metrics_f.flush()
            os.fsync(metrics_f.fileno())
        if progress_cb is not None:
            try:
                progress_cb(rec)
            except Exception:  # noqa: BLE001 — observability must not kill the run
                log.warning("progress_cb raised; the run goes on", exc_info=True)

    def check_finite(arrays):
        if health_check:
            # poisoned state must never reach a checkpoint
            from .supervise import check_finite_state

            check_finite_state(arrays)

    def save_warmup_checkpoint(carry, g_samp, g_warm, done, n_div, n_warm):
        """Warmup-phase checkpoint: the whole warmup carry (the JAX
        package's array names for ChEES's), so a fault mid-warmup resumes
        at the last finished segment."""
        arrays = ap.warm_arrays(carry)
        arrays["key"] = _gen_state(g_samp)
        arrays["key_warm"] = _gen_state(g_warm)
        check_finite(arrays)
        save_checkpoint(checkpoint_path, arrays, {
            "kernel": cfg.kernel,
            "phase": "warmup",
            "warm_done": done,
            "warm_div": n_div,
            # the JAX package's ChEES count leaves out the MAP steps
            "warm_leap": n_warm - cfg.map_init_steps,
            "model": type(model).__name__,
        })

    def run_warmup(carry, start, g_samp, g_warm, n_div, n_warm):
        """Warmup segments of ``block_size`` from schedule step ``start``,
        each but the last checkpointed (the first block's checkpoint
        holds the last one's state).  -> (carry, divergences and
        evaluations before sampling in total, evaluations of this
        call)."""
        noise = TorchNoise(g_warm)
        here = 0
        for s in range(start, cfg.num_warmup, block_size):
            e = min(s + block_size, cfg.num_warmup)
            carry, nd, n = ap.warm_j(carry, noise, s, e, *extra)
            n_div += int(nd)
            n_warm += int(n)
            here += int(n)
            if checkpoint_path and e < cfg.num_warmup:
                save_warmup_checkpoint(carry, g_samp, g_warm, e, n_div, n_warm)
        return carry, n_div, n_warm, here

    def finish_warmup(carry, n_div, n_warm, t_map, t_warm, resumed_from=None):
        """The sampling carry after warmup, and the ``warmup_done``
        record."""
        run_carry = ap.finalize(carry)
        rec = {
            "event": "warmup_done",
            "wall_s": time.perf_counter() - t_start,
            "num_divergent": int(n_div),
            "step_size": ap.run_arrays(run_carry)["step_size"].tolist(),
            # per-chain units, as the JAX package counts ChEES's
            "warmup_grad_evals": int(n_warm * chains),
            "t_setup_s": t_setup,
            "t_map_s": t_map,
            "t_warmup_s": t_warm,
        }
        if resumed_from is not None:
            rec["resumed_from_step"] = int(resumed_from)
        emit(rec)
        return run_carry

    blocks_done = 0
    total_div = 0
    history: List[Dict[str, Any]] = []
    stored_draws = None
    try:
        if resume_from:
            arrays, meta = load_checkpoint(resume_from)
            ckpt_kernel = meta.get("kernel")
            if ckpt_kernel is None:
                raise ValueError(
                    "checkpoint has no kernel record (pre-chees format); "
                    f"cannot resume it with kernel={cfg.kernel!r}"
                )
            if ckpt_kernel != cfg.kernel:
                raise ValueError(
                    f"checkpoint was written by kernel={ckpt_kernel!r}, "
                    f"resuming run uses kernel={cfg.kernel!r}"
                )
            g_samp = _gen_from_state(dev, arrays["key"], reseed)
            chains = int(arrays["z"].shape[0])
            if meta.get("phase") == "warmup":
                g_warm = _gen_from_state(dev, arrays["key_warm"], reseed)
                t = time.perf_counter()
                carry, n_div, n_warm, here = run_warmup(
                    ap.warm_carry(arrays), int(meta["warm_done"]), g_samp, g_warm,
                    int(meta.get("warm_div", 0)),
                    int(meta.get("warm_leap", 0)) + cfg.map_init_steps,
                )
                evals += here
                run_carry = finish_warmup(
                    carry, n_div, n_warm, 0.0, time.perf_counter() - t,
                    resumed_from=int(meta["warm_done"]),
                )
            else:
                run_carry = ap.run_carry(arrays)
            blocks_done = int(meta.get("blocks_done", 0))
            total_div = int(meta.get("num_divergent", 0))
            history = list(meta.get("history", []))
            # sampling transitions made so far (ChEES's Halton position)
            drawn = int(meta.get("draw_rows", blocks_done * int(meta.get("block_size", block_size))))
            if "draws" in arrays:
                stored_draws = arrays["draws"]
            elif draw_store_path and os.path.exists(draw_store_path):
                from .drawstore import read_draws, truncate_draws

                # the async writer can land a block after the last
                # checkpoint: drop the rows no checkpoint accounts for
                truncate_draws(draw_store_path, drawn)
                stored, _, _ = read_draws(draw_store_path, mmap=False)
                if stored.shape[0]:
                    # (n, chains, d) on disk -> (chains, n, d)
                    stored_draws = np.ascontiguousarray(stored.transpose(1, 0, 2))
        else:
            g_init, g_warm, g_samp = chain_streams(seed, dev)
            drawn = 0
            t = time.perf_counter()
            z0 = ap.init_positions(g_init, chains, init_params)
            # the initial state, then MAP steps or the step-size search
            # (warmup stream)
            carry, n_pre = ap.init_j(TorchNoise(g_warm), z0, *extra)
            evals += 1 + n_pre
            t_map = time.perf_counter() - t
            t = time.perf_counter()
            carry, n_div, n_warm, here = run_warmup(carry, 0, g_samp, g_warm, 0, n_pre)
            evals += here
            run_carry = finish_warmup(carry, n_div, n_warm, t_map, time.perf_counter() - t)

        gate = StopGate(
            chains, fm.ndim, block_size=block_size, max_blocks=max_blocks,
            min_blocks=min_blocks, rhat_target=rhat_target, ess_target=ess_target,
            diag_components=diag_components, stream_diag=stream_diag,
            adaptive_blocks=adaptive_blocks, history=history, blocks_done=blocks_done,
        )
        if stored_draws is not None:
            gate.restore(stored_draws)
        diag = None
        if stream_diag:
            # the device accumulator, rebuilt on a resume from the stored
            # draws, so the gate's summary covers the whole history
            host = diagnostics.stream_diag_from_draws(
                gate.draws.view() if gate.rows else np.zeros((chains, 0, fm.ndim), np.float32),
                diag_lags, chains=chains, ndim=fm.ndim, dtype=np.float32,
            )
            diag = StreamDiagState(**{k: ap.put_chains(v) for k, v in host.items()})
        noise = TorchNoise(g_samp)
        draw_store = None
        converged = budget_exhausted = False
        try:
            if draw_store_path:
                from .drawstore import DrawStore

                draw_store = DrawStore(draw_store_path, chains, fm.ndim)
            while gate.more():
                length = gate.next_block_len()
                if length <= 0:
                    break
                t_blk = time.perf_counter()
                run_carry, diag, blk = ap.samp_j(run_carry, diag, noise, drawn, length, *extra)
                drawn += length
                t_dispatch = time.perf_counter() - t_blk
                evals += blk.evals
                arrays = None
                if health_check or checkpoint_path:
                    arrays = ap.run_arrays(run_carry)
                    check_finite(arrays)
                t = time.perf_counter()
                diag_host = tuple(ap.collect(diag)) if stream_diag else None
                grec, converged = gate.observe(blk.zs, diag_host)
                t_diag = time.perf_counter() - t
                t = time.perf_counter()
                if draw_store is not None:
                    draw_store.append(blk.zs)
                t_store = time.perf_counter() - t
                total_div += int(np.sum(blk.divergent))
                rec = {
                    "event": "block",
                    **grec,
                    "num_divergent": total_div,
                    "mean_accept": float(np.mean(blk.accept)),
                    "t_dispatch_s": t_dispatch,
                    "t_diag_s": t_diag,
                    "t_store_s": t_store,
                    "block_grad_evals": blk.grads,
                    **blk.record,
                    "wall_s": time.perf_counter() - t_start,
                }
                history.append(rec)
                t = time.perf_counter()
                if checkpoint_path:
                    arrays["key"] = _gen_state(g_samp)
                    if draw_store is None:
                        # no store: the draws ride in the checkpoint
                        arrays["draws"] = gate.draws.view()
                    else:
                        draw_store.flush()  # the store on disk before the state advances
                    save_checkpoint(checkpoint_path, arrays, {
                        "blocks_done": gate.blocks_done,
                        "block_size": block_size,
                        "draw_rows": gate.rows,
                        "num_divergent": total_div,
                        "history": history,
                        "model": type(model).__name__,
                        "kernel": cfg.kernel,
                    })
                rec["t_ckpt_s"] = time.perf_counter() - t
                emit(rec)
                if converged:
                    break
                if time_budget_s is not None and time.perf_counter() - t_start > time_budget_s:
                    # after the block is recorded and checkpointed, so the
                    # result accounts for every draw
                    budget_exhausted = True
                    emit({
                        "event": "budget_exhausted",
                        "time_budget_s": float(time_budget_s),
                        "wall_s": time.perf_counter() - t_start,
                    })
                    break
        finally:
            if draw_store is not None:
                draw_store.close()
    finally:
        if metrics_f:
            metrics_f.close()

    all_draws = np.ascontiguousarray(gate.draws.view())
    stats = {
        "num_divergent": np.asarray(total_div),
        "num_ensemble_grad_evals": np.asarray(evals),
    }
    result = AdaptiveResult(
        constrain_draws(fm, all_draws),
        stats,
        flat_model=fm,
        draws_flat=all_draws,
        history=history,
        converged=converged,
        wall_s=time.perf_counter() - t_start,
    )
    result.budget_exhausted = budget_exhausted
    result.overshoot_draws = gate.overshoot() if converged else None
    return result
