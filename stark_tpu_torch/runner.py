"""Adaptive runner: sample in blocks until R-hat < target — counterpart of
``stark_tpu/runner.py``: its ChEES branch and its per-chain branch (NUTS,
HMC), with the pipelined block loop (the default) and the serial one.

Warmup runs in segments of ``block_size`` transitions, each checkpointed,
then the sampler draws blocks until the stop gate passes or the budget
is spent.  After every block the host folds the draws into per-chain
Welford moments (R-hat) and reads back the on-device streaming
accumulator (ESS); a candidate stop is validated by one full split
R-hat/ESS pass over every draw before the run may stop.  Every block
appends its draws to the draw store, flushes it, writes a checkpoint
and one JSONL metrics record.  `supervise.supervised_sample` restarts a
faulted run from the last healthy checkpoint.

The pipelined loop overlaps block k's host work (the gate, the store,
the health check, the checkpoint) with block k+1.  The host drives every
transition here (ChEES and NUTS read a count back per transition), so
the overlap takes a second host thread: the main thread drives block
k+1 while one worker thread processes block k.  Before block k+1 starts,
the main thread copies to the host all that block k's processing reads
(draws, the accumulator, the sampling state, the generator state, the
draw count); the worker touches no tensor.  A stop at block k cuts block
k+1 short at its next transition and throws it away unseen: its
evaluations are counted apart (``num_discarded_ensemble_grad_evals``).
Both loops give bitwise the same draws, records (but their timing
fields), checkpoints and draw store.

Adaptation reuse (ChEES): after a fresh full warmup the tuned step
size, trajectory length, inverse mass and end-of-warmup positions are
exported (``adapt_export_path``); a later run on the same kernel, model,
width and data (`data_fingerprint`) imports them (``adapt_path``),
starts near the saved positions, and replaces the warmup with a short
touch-up in which only the step size re-tunes.

The random streams are the port's own: one ``torch.Generator`` each for
the initial positions, the warmup and the sampling transitions, where
the JAX package splits keys (`sampler.chain_streams`, the streams of
`sample` too).  Checkpoints carry the warmup and sampling generators'
states (under the JAX package's array names ``key_warm`` and ``key``)
and the count of draws (``draw_rows``, ChEES's Halton position), so a
run resumed from a checkpoint draws bitwise what the uninterrupted run
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
import queue
import threading
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
    checkpoint on): one likelihood kernel launch each.  Those of a
    speculative block the pipelined loop threw away are counted apart,
    in ``num_discarded_ensemble_grad_evals``, so the launches of a call
    are the sum of the two.
    """

    def __init__(self, *args, history=None, converged=False, wall_s=0.0, **kw):
        super().__init__(*args, **kw)
        self.history = history or []
        self.converged = converged
        self.wall_s = wall_s
        self.budget_exhausted = False
        # seconds the pipelined loop spent driving the block it threw away
        self.discarded_s = 0.0
        # estimated draws beyond the ESS target at the measured ESS rate
        # (None when unconverged or without a rate estimate)
        self.overshoot_draws = None
        # the JAX package's statistical-health verdict; its monitor is
        # ROADMAP A12, so None here (never an empty claim of health)
        self.health_warnings = None


# ------------------------------------------------- adaptation artifacts

_ADAPT_KEYS = ("z", "log_eps", "log_T", "inv_mass")
_FP_SAMPLE_BYTES = 65536


def _leaf_digest(leaf) -> bytes:
    """``shape|dtype|`` and a strided sample of at most 64 KiB of a leaf's
    bytes; ``repr`` for a leaf that is not a buffer.  A tensor is sampled
    on its device and only the sample crosses to the host; a CPU tensor
    gives the bytes of the same numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        try:
            dtype = str(torch.empty((), dtype=t.dtype).numpy().dtype)
        except TypeError:  # no numpy dtype (bfloat16)
            dtype = str(t.dtype)
        b = t.reshape(-1).view(torch.uint8)
        if b.numel() > _FP_SAMPLE_BYTES:
            idx = np.linspace(0, b.numel() - 1, _FP_SAMPLE_BYTES).astype(np.int64)
            b = b[torch.from_numpy(idx).to(b.device)]
        return f"{tuple(t.shape)}|{dtype}|".encode() + b.cpu().numpy().tobytes()
    try:
        a = np.ascontiguousarray(np.asarray(leaf))
        b = a.view(np.uint8).ravel()
        if b.size > _FP_SAMPLE_BYTES:
            b = b[np.linspace(0, b.size - 1, _FP_SAMPLE_BYTES).astype(np.int64)]
        return f"{a.shape}|{a.dtype}|".encode() + b.tobytes()
    except (TypeError, ValueError):  # not a buffer (object, scalar)
        return repr(leaf).encode()


def data_fingerprint(data) -> str:
    """Order-stable fingerprint of a data tree: its structure (dicts by
    sorted key, lists and tuples), every leaf's shape and dtype, and a
    strided sample of at most 64 KiB of each leaf's bytes, so N=1M stays
    cheap; ``"none"`` for None.  It keys the adaptation artifact to the
    dataset it was tuned on (same model and width, another dataset must
    not be imported).  The JAX package's recipe; its hex differs (that
    package hashes the repr of a JAX tree structure), so an artifact one
    package wrote is another dataset to the other, never silently
    reused."""
    if data is None:
        return "none"
    leaves: List[Any] = []

    def structure(x) -> str:
        if x is None:
            return "none"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k!r}:{structure(x[k])}" for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ",".join(structure(v) for v in x) + "]"
        if isinstance(x, tuple):
            return f"{type(x).__name__}(" + ",".join(structure(v) for v in x) + ")"
        leaves.append(x)
        return "*"

    h = hashlib.sha1(structure(data).encode())
    for leaf in leaves:
        h.update(_leaf_digest(leaf))
    return h.hexdigest()[:16]


def load_adapt_state(path, *, kernel, model_name, ndim, data_fp=None):
    """Load and validate an adaptation artifact (``adapt_path``).

    -> ``(arrays, None)`` when it is usable; ``(None, None)`` when there
    is no file; ``(None, reason)`` otherwise: missing arrays, another
    kernel, model or width, another dataset (``data_fp`` given and not
    the artifact's), or the repr of the load error.  The one validation
    the runner's import and a caller's own decision share."""
    if not path or not os.path.exists(path):
        return None, None
    try:
        arrays, meta = load_checkpoint(path)
        missing = [k for k in _ADAPT_KEYS if k not in arrays]
        if missing:
            return None, f"missing arrays: {missing}"
        if (
            meta.get("kernel") != kernel
            or meta.get("model") != model_name
            or int(arrays["inv_mass"].shape[-1]) != ndim
        ):
            return None, (
                f"mismatch: kernel={meta.get('kernel')} "
                f"model={meta.get('model')} "
                f"ndim={arrays['inv_mass'].shape[-1]} "
                f"(want {kernel}/{model_name}/{ndim})"
            )
        if data_fp is not None and meta.get("data_fp") != data_fp:
            return None, (
                f"mismatch: data_fp={meta.get('data_fp')} (want {data_fp}; "
                "artifact was adapted on a different dataset)"
            )
        return arrays, None
    except Exception as e:  # noqa: BLE001 — a corrupt artifact is a reason, not a crash
        return None, repr(e)


def import_starts(z: np.ndarray, chains: int, seed: int) -> np.ndarray:
    """The imported run's start positions: the saved ``z`` sliced to
    ``chains`` (tiled when there are more), jittered by half the
    per-dimension cross-chain spread (0.05 where it is 0), so the starts
    stay overdispersed and tiled copies separate.  numpy, as in the JAX
    package, so both give the same bits for one artifact and seed."""
    z = np.asarray(z)
    if z.shape[0] >= chains:
        z = z[:chains]
    else:
        reps = -(-chains // z.shape[0])
        z = np.tile(z, (reps, 1))[:chains]
    sd = z.std(axis=0)
    sd = np.where(sd > 0, sd, 0.05).astype(z.dtype)
    return z + 0.5 * sd * np.random.default_rng(seed).standard_normal(z.shape).astype(z.dtype)


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


# ----------------------------------------------------------- pipelining

#: seconds the main thread waits for a block's verdict once it has driven
#: the next block; past it the run raises.  The slowest processing is a
#: validation pass over a long history (18.7 s at the flagship's 500
#: draws per chain on an H100 host)
BLOCK_VERDICT_TIMEOUT_S = 600.0


class _Abandoned(Exception):
    """The run no longer waits for this block's processing."""


class _Job:
    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg
        self.done = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.start = self.end = 0.0


class _BlockWorker:
    """The pipelined loop's second host thread: processes the submitted
    blocks one at a time, in order, while the main thread drives the
    next.  `stopping` turns true once a verdict stops the run or a
    block's processing raised, so the main thread cuts the block it is
    driving short at a transition boundary."""

    def __init__(self):
        self._jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._stop = threading.Event()
        self.closed = self.stalled = False
        self._thread = threading.Thread(target=self._serve, name="stark-block-worker", daemon=True)
        self._thread.start()

    def stopping(self) -> bool:
        return self._stop.is_set()

    def check_open(self) -> None:
        """Raise `_Abandoned` once the run has stopped waiting (called by
        the processing before each step that writes)."""
        if self.closed:
            raise _Abandoned

    def submit(self, fn, arg) -> _Job:
        job = _Job(fn, arg)
        self._jobs.put(job)
        return job

    def _serve(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            job.start = time.perf_counter()
            try:
                job.value = job.fn(job.arg)
                if job.value[1]:
                    self._stop.set()
            except Exception as e:  # noqa: BLE001 — raised again on the main thread
                job.error = e
                self._stop.set()
            job.end = time.perf_counter()
            job.done.set()

    def result(self, job: _Job, what: str):
        """The job's value, or its exception raised here; TimeoutError
        after `BLOCK_VERDICT_TIMEOUT_S`."""
        if not job.done.wait(BLOCK_VERDICT_TIMEOUT_S):
            self.stalled = True
            raise TimeoutError(
                f"{what}'s processing gave no verdict within {BLOCK_VERDICT_TIMEOUT_S} s"
            )
        if job.error is not None:
            raise job.error
        return job.value

    def close(self) -> None:
        """Stop taking work and wait for the thread to finish the block
        in hand (not for one that already timed out); a processing step
        that returns after this skips its remaining writes."""
        self.closed = True
        self._jobs.put(None)
        self._thread.join(0.0 if self.stalled else BLOCK_VERDICT_TIMEOUT_S)
        if self._thread.is_alive():
            log.warning("the block worker is still busy; the run ends without it")


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

    def next_block_len(self, blocks: Optional[int] = None, draws: Optional[int] = None) -> int:
        """Length of the next block after ``blocks`` blocks and ``draws``
        draws per chain dispatched (default: those processed; the
        pipelined loop dispatches one block ahead); 0 when the budget is
        spent.  The forecast reads the trail only up to block m-2 when
        sizing block m, which is what the pipelined loop knows then
        (block m-1 is being processed); the serial loop and a resumed
        run read the same window, so every mode sizes every block
        alike."""
        m = self.blocks_done if blocks is None else blocks  # 0-based ordinal of the next block
        if not self.adaptive_blocks:
            return self.block_size if m < self.max_blocks else 0
        draws = self.draws.rows if draws is None else draws
        remaining = self.max_draws - draws
        if remaining <= 0:
            return 0
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

    ``sync_blocks``: False (the default unless ``STARK_SYNC_BLOCKS=1``)
    runs the pipelined loop, True the serial one; both give the same
    draws, records (but their timing), checkpoints and store bytes.
    ``adapt_path`` (ChEES): import the adaptation artifact there when
    `load_adapt_state` accepts it (the same kernel, model, width and
    `data_fingerprint` of ``data`` as the caller passed it), start near
    its positions (`import_starts`) and replace warmup by a touch-up of
    ``max(20, int(num_warmup * adapt_touchup_frac))`` transitions that
    re-tunes the step size alone; a rejected artifact is an
    ``adapt_import_rejected`` record and a full warmup.
    ``adapt_export_path`` (default ``adapt_path``): after a fresh full
    warmup, export the artifact there; never after an import (an
    ``adapt_export_skipped`` record, the artifact left as it was) or a
    resume, never a non-finite state.  NUTS and HMC neither import nor
    export, as in the JAX package.

    Besides the JAX package's fields, a block record carries
    ``t_dispatch_s`` (driving the block, and the copy to the host of
    what its processing reads), ``t_diag_s`` (the gate: the streaming
    statistics and any validation pass), ``t_store_s`` (the draw-store
    append), ``t_ckpt_s`` (flush and checkpoint), ``t_wait_s`` (the main
    thread's wait for the block's verdict after driving the next block;
    0 in the serial loop, whose main thread does the processing itself)
    and ``t_hidden_s`` (the seconds of the block's processing that ran
    while the next block was driven; 0 in the serial loop), and for NUTS
    ``tree_depth_mean`` and ``tree_depth_max`` of the block's transitions
    (the JAX package reads them in its health monitor, ROADMAP A12);
    ``warmup_done`` carries ``t_setup_s`` (data preparation), ``t_map_s``
    (the initial evaluation and MAP descent or step-size search) and
    ``t_warmup_s`` (warmup or touch-up), and ``adapt_imported`` after an
    import; its ``warmup_grad_evals`` (per-chain units, times chains)
    counts the ensemble evaluations after the initial state's and before
    sampling (the touch-up's after an import), for NUTS and HMC too
    (their step-size search and warmup).

    Not ported, each refused with its ROADMAP item: ``trace`` and
    ``profile_dir``, and ragged NUTS (``STARK_RAGGED_NUTS=1``).
    """
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
    if sync_blocks is None:
        sync_blocks = os.environ.get("STARK_SYNC_BLOCKS", "") == "1"
    checkpoint_path = rank_path(checkpoint_path)
    resume_from = rank_path(resume_from)
    metrics_path = rank_path(metrics_path)
    draw_store_path = rank_path(draw_store_path)
    adapt_path = rank_path(adapt_path)
    # a caller can import a pinned artifact and export elsewhere
    adapt_export_path = rank_path(adapt_export_path) or adapt_path
    # the caller's data, before the backend prepares it: a caller holding
    # the same raw data computes the same key
    adapt_fp = data_fingerprint(data) if (adapt_path or adapt_export_path) else None

    t_call = time.perf_counter()
    ap = backend.adaptive_parts(model, cfg, data)
    t_setup = time.perf_counter() - t_call
    fm, extra = ap.fm, ap.extra
    dev = backend.device
    reuses = ap.import_carry is not None  # the sampler takes part in adaptation reuse

    t_start = time.perf_counter()
    metrics_f = open(metrics_path, "a") if metrics_path else None
    evals = 0  # ensemble gradient evaluations of this call
    discarded = 0  # those of the speculative block thrown away
    discarded_s = 0.0

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

    def run_touchup(carry, g_warm, n_warm):
        """The imported run's touch-up in segments of at most
        ``block_size``, on the warmup stream, with no checkpoint (a fault
        here restarts from the artifact).  -> as `run_warmup`."""
        noise = TorchNoise(g_warm)
        total = max(20, int(cfg.num_warmup * adapt_touchup_frac))
        n_div = here = 0
        for s in range(0, total, block_size):
            e = min(s + block_size, total)
            carry, nd, n = ap.touch_j(carry, noise, s, e, total, *extra)
            n_div += int(nd)
            here += int(n)
        return carry, n_div, n_warm + here, here

    def load_adapt_import():
        """The accepted artifact's arrays, the start positions jittered
        (`import_starts`), or None: no file, or a rejected one (recorded;
        the run then warms up in full)."""
        arrays, reason = load_adapt_state(
            adapt_path, kernel=cfg.kernel, model_name=type(model).__name__, ndim=fm.ndim,
            data_fp=adapt_fp,
        )
        if arrays is None:
            if reason is not None:
                emit({"event": "adapt_import_rejected", "reason": reason})
            return None
        imported = {k: np.asarray(arrays[k]) for k in _ADAPT_KEYS}
        imported["z"] = import_starts(imported["z"], chains, seed)
        return imported

    def save_adapt(run_carry):
        """Export the adaptation (atomically, in the checkpoint format);
        a non-finite state is never exported: it would poison every run
        that imports it."""
        arrays = ap.run_arrays(run_carry)
        leaves = {k: arrays[k] for k in _ADAPT_KEYS}
        if not all(np.all(np.isfinite(a)) for a in leaves.values()):
            emit({"event": "adapt_export_skipped", "reason": "non-finite warmup state"})
            return
        save_checkpoint(adapt_export_path, leaves, {
            "kernel": cfg.kernel,
            "model": type(model).__name__,
            "num_warmup": cfg.num_warmup,
            "data_fp": adapt_fp,
        })

    def finish_warmup(carry, n_div, n_warm, t_map, t_warm, resumed_from=None, imported=False):
        """The sampling carry after warmup, the adaptation export of a
        fresh run, and the ``warmup_done`` record."""
        run_carry = ap.finalize(carry)
        if reuses and adapt_export_path and resumed_from is None:
            if imported:
                # the artifact stays byte-identical: a touch-up's re-tuned
                # step would trade a full warmup's state for noise
                emit({"event": "adapt_export_skipped", "reason": "imported"})
            else:
                save_adapt(run_carry)
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
        if imported:
            rec["adapt_imported"] = True
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
            imported = load_adapt_import() if reuses and adapt_path else None
            t = time.perf_counter()
            if imported is not None:
                z0 = ap.put_chains(np.asarray(imported["z"], np.float32))
            else:
                z0 = ap.init_positions(g_init, chains, init_params)
            # the initial state, then MAP steps or the step-size search
            # (warmup stream)
            carry, n_pre = ap.init_j(TorchNoise(g_warm), z0, *extra)
            evals += 1 + n_pre
            t_map = time.perf_counter() - t
            t = time.perf_counter()
            if imported is not None:
                carry, n_div, n_warm, here = run_touchup(ap.import_carry(carry, imported), g_warm,
                                                         n_pre)
            else:
                carry, n_div, n_warm, here = run_warmup(carry, 0, g_samp, g_warm, 0, n_pre)
            evals += here
            run_carry = finish_warmup(carry, n_div, n_warm, t_map, time.perf_counter() - t,
                                      imported=imported is not None)

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
        draw_store = worker = None
        converged = budget_exhausted = False
        blocks_dispatched = blocks_done

        def dispatch(stop=None):
            """Drive the next block on this thread -> its snapshot: the
            block and, on the host, everything its processing reads
            (the accumulator, the sampling state and generator state for
            the checkpoint and the health check), taken before the next
            block can advance them; None when the budget allows no block.
            ``stop`` is checked after each transition."""
            nonlocal run_carry, diag, drawn, blocks_dispatched
            length = gate.next_block_len(blocks_dispatched, drawn)
            if length <= 0:
                return None
            t0 = time.perf_counter()
            run_carry, diag, blk = ap.samp_j(run_carry, diag, noise, drawn, length, *extra,
                                             stop=stop)
            drawn += length
            blocks_dispatched += 1
            snap = {"blk": blk, "block": blocks_dispatched, "arrays": None, "diag": None, "t0": t0}
            if health_check or checkpoint_path:
                snap["arrays"] = ap.run_arrays(run_carry)
                snap["arrays"]["key"] = _gen_state(g_samp)
            if stream_diag:
                snap["diag"] = tuple(ap.collect(diag))
            snap["t1"] = time.perf_counter()
            return snap

        def process_block(snap):
            """Block k's host work, in order: the health check, the gate
            (and any validation pass), the draw-store append, the record
            and the checkpoint.  On the worker thread in the pipelined
            loop: it reads only the snapshot and host state.  -> (the
            record, whether the run stops)."""
            nonlocal total_div, converged, budget_exhausted
            blk = snap["blk"]
            if snap["arrays"] is not None:
                check_finite(snap["arrays"])
            t = time.perf_counter()
            grec, converged = gate.observe(blk.zs, snap["diag"])
            t_diag = time.perf_counter() - t
            if worker is not None:
                worker.check_open()
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
                "t_dispatch_s": snap["t1"] - snap["t0"],
                "t_diag_s": t_diag,
                "t_store_s": t_store,
                "block_grad_evals": blk.grads,
                **blk.record,
                "wall_s": time.perf_counter() - t_start,
            }
            history.append(rec)
            if worker is not None:
                worker.check_open()
            t = time.perf_counter()
            if checkpoint_path:
                arrays = snap["arrays"]
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
            if (not converged and time_budget_s is not None
                    and time.perf_counter() - t_start > time_budget_s):
                # after the block is recorded and checkpointed, so the
                # result accounts for every draw
                budget_exhausted = True
            return rec, converged or budget_exhausted

        def account(snap, rec, t_wait, t_hidden):
            """Count a processed block's evaluations and emit its record
            (on the main thread, like every record)."""
            nonlocal evals
            evals += snap["blk"].evals
            rec["t_wait_s"] = t_wait
            rec["t_hidden_s"] = t_hidden
            emit(rec)
            if budget_exhausted:
                emit({
                    "event": "budget_exhausted",
                    "time_budget_s": float(time_budget_s),
                    "wall_s": time.perf_counter() - t_start,
                })

        try:
            if draw_store_path:
                from .drawstore import DrawStore

                draw_store = DrawStore(draw_store_path, chains, fm.ndim)
            if not sync_blocks:
                worker = _BlockWorker()
            cur = dispatch()
            while cur is not None:
                if worker is None:
                    rec, stop = process_block(cur)
                    account(cur, rec, 0.0, 0.0)
                    nxt = None if stop else dispatch()
                else:
                    # the overlap: block k+1 on this thread while the
                    # worker processes block k; a stop verdict cuts k+1 short
                    job = worker.submit(process_block, cur)
                    nxt = dispatch(worker.stopping)
                    t = time.perf_counter()
                    rec, stop = worker.result(job, f"block {cur['block']}")
                    t_wait = time.perf_counter() - t
                    hidden = (max(0.0, min(job.end, nxt["t1"]) - max(job.start, nxt["t0"]))
                              if nxt else 0.0)
                    account(cur, rec, t_wait, hidden)
                    if stop and nxt is not None:
                        # the speculative block: the serial loop never ran
                        # it, and none of its draws, rows or state is kept
                        discarded += nxt["blk"].evals
                        discarded_s += nxt["t1"] - nxt["t0"]
                        nxt = None
                cur = nxt
        finally:
            if worker is not None:
                worker.close()
            if draw_store is not None:
                draw_store.close()
    finally:
        if metrics_f:
            metrics_f.close()

    all_draws = np.ascontiguousarray(gate.draws.view())
    stats = {
        "num_divergent": np.asarray(total_div),
        "num_ensemble_grad_evals": np.asarray(evals),
        "num_discarded_ensemble_grad_evals": np.asarray(discarded),
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
    result.discarded_s = discarded_s
    result.overshoot_draws = gate.overshoot() if converged else None
    return result
