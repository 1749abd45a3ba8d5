"""Failure detection and supervised restart — counterpart of
``stark_tpu/supervise.py``.

The adaptive runner checkpoints the full chain state after every warmup
segment and every block (one atomic ``.npz``); `supervised_sample` runs
it, and on a fault restarts from the last *healthy* checkpoint, or from
scratch when there is none.

Fault classes (`classify_fault`; every restart record carries one):

  * ``transient``          — any exception out of an attempt (a CUDA
    error, a lost device, a crash) → restart from the latest healthy
    checkpoint, after the back-off.
  * ``poisoned_state``     — non-finite sampler state caught by the
    runner's health check before it was checkpointed (`ChainHealthError`)
    → restart at once with a branched random stream.
  * ``corrupt_checkpoint`` — a checkpoint that does not load or holds
    non-finite state is quarantined (``.bad``) and the run cold-starts.

The stall class and its watchdog (``stall_timeout_s``), run telemetry
and the multi-process resume agreement are not ported: ROADMAP A12 and
A11.

Restarts are bounded by a `RestartBudget` (``max_restarts`` failures
within ``restart_window_s``; no window is a lifetime count), and each
waits `backoff_delay`.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ._device import DeviceLike, resolve_device
from .checkpoint import load_checkpoint, rank_path
from .model import Model

log = logging.getLogger(__name__)

__all__ = [
    "ChainHealthError",
    "RestartBudget",
    "backoff_delay",
    "check_finite_state",
    "checkpoint_health",
    "checkpoint_is_healthy",
    "classify_fault",
    "quarantine_path",
    "supervised_sample",
]

#: fault-class names
FAULT_TRANSIENT = "transient"
FAULT_POISONED = "poisoned_state"
FAULT_CORRUPT = "corrupt_checkpoint"


class ChainHealthError(RuntimeError):
    """Sampler state went non-finite (detected before checkpointing)."""


_HEALTH_KEYS = (
    "z", "pe", "grad", "step_size", "inv_mass",
    # warmup-phase checkpoints carry adaptation state whose poisoning
    # would otherwise survive the position/gradient check
    "log_T", "da_log_step", "da_h_avg", "adam_m", "adam_v",
    "wf_mean", "wf_m2",
)


def check_finite_state(arrays: Dict[str, Any]) -> None:
    """Raise ChainHealthError if any monitored state array is non-finite.

    ``grad`` is the CARRIED gradient of the accepted state: it seeds the
    next transition's first half-step, so a non-finite value poisons
    every resume from this state.
    """
    for name in _HEALTH_KEYS:
        if name not in arrays:
            continue
        a = np.asarray(arrays[name])
        if not np.all(np.isfinite(a)):
            bad = int(a.size - np.sum(np.isfinite(a)))
            raise ChainHealthError(f"non-finite sampler state: {bad}/{a.size} entries of {name!r}")


def checkpoint_health(path: str) -> Tuple[bool, Optional[str]]:
    """(healthy, reason) for a checkpoint file; ``reason`` (None when
    healthy) is "<fault class>: <detail>", so a discard is never silent."""
    try:
        arrays, _ = load_checkpoint(path)
    except Exception as e:  # noqa: BLE001 — an unreadable file is corrupt
        return False, f"{FAULT_CORRUPT}: {type(e).__name__}: {e}"
    try:
        check_finite_state(arrays)
    except ChainHealthError as e:
        return False, f"{FAULT_POISONED}: {e}"
    return True, None


def checkpoint_is_healthy(path: str) -> bool:
    """True iff the checkpoint loads and its state arrays are finite."""
    return checkpoint_health(path)[0]


def classify_fault(exc: BaseException) -> str:
    """Map an exception out of an attempt to its fault class."""
    if isinstance(exc, ChainHealthError):
        return FAULT_POISONED
    return FAULT_TRANSIENT


def backoff_delay(fault: str, attempt: int, *, base_s: float, cap_s: float = 60.0, seed: int = 0) -> float:
    """``base_s * 2^(attempt-1)`` seconds, scaled by a jitter in [0.5, 1.5)
    fixed by (seed, attempt), capped at ``cap_s``; 0 for poisoned state
    (the fault is numerical, the fix is the reseed) and for ``base_s <=
    0``."""
    if base_s <= 0 or fault == FAULT_POISONED:
        return 0.0
    jitter = 0.5 + random.Random(f"{seed}:{attempt}").random()
    return min(cap_s, base_s * 2.0 ** max(attempt - 1, 0) * jitter)


class RestartBudget:
    """At most ``max_restarts`` failures inside any ``window_s``-second
    window; ``window_s=None`` never forgets (a lifetime count)."""

    def __init__(self, max_restarts: int, window_s: Optional[float] = None):
        self.max_restarts = int(max_restarts)
        self.window_s = window_s
        self._times: List[float] = []

    def record_failure(self, now: Optional[float] = None) -> None:
        self._times.append(time.monotonic() if now is None else now)

    def in_window(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        if self.window_s is not None:
            self._times = [t for t in self._times if now - t <= self.window_s]
        return len(self._times)

    def exhausted(self, now: Optional[float] = None) -> bool:
        """True when the current window holds more failures than allowed
        restarts."""
        return self.in_window(now) > self.max_restarts


def quarantine_path(path: str, reason: Optional[str] = None) -> str:
    """Move a bad artifact aside as ``path.bad`` / ``path.badN`` (never
    over an earlier forensic copy); ``reason``, when given, is kept
    beside it as ``<dst>.reason.json``.  Returns the destination."""
    dst = path + ".bad"
    n = 1
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.bad{n}"
    os.replace(path, dst)
    if reason is not None:
        try:
            with open(dst + ".reason.json", "w") as f:
                json.dump({"path": path, "quarantined_as": dst, "reason": reason, "ts": time.time()}, f)
                f.write("\n")
        except OSError as e:
            log.warning("could not persist quarantine reason for %s: %s", dst, e)
    return dst


def _append_record(path: str, rec: Dict[str, Any]) -> None:
    """Append one JSONL record, flushed and fsynced: a restart record
    documents a crash, so it must survive the next one."""
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def supervised_sample(
    model: Model,
    data: Any = None,
    *,
    workdir: str,
    max_restarts: int = 3,
    restart_window_s: Optional[float] = None,
    backoff_base_s: float = 0.0,
    backoff_cap_s: float = 60.0,
    stall_timeout_s: Optional[float] = None,
    seed: int = 0,
    reseed_on_restart: bool = True,
    trace=None,
    device: DeviceLike = None,
    **kwargs,
):
    """Run `runner.sample_until_converged` under supervision, on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    The checkpoint (``chain.ckpt.npz``), draw store (``draws.stkr``) and
    metrics (``metrics.jsonl``) live under ``workdir``.  On a fault the
    run restarts from the last healthy checkpoint; a checkpoint that does
    not load or holds non-finite state is quarantined, and on a cold
    start a draw store left by a discarded run is quarantined too.  Each
    restart appends a ``{"event": "restart", "fault": <class>, ...}``
    record to the metrics.  Restarts are bounded by a `RestartBudget`;
    past it the last fault is raised.  With ``reseed_on_restart`` a
    restart branches the random streams (``reseed=attempt``; a cold
    restart takes ``seed + attempt``).  ``time_budget_s`` is one deadline
    across every attempt.  Returns the AdaptiveResult of the first
    attempt that finishes.

    ``stall_timeout_s`` (the watchdog) and ``trace`` are ROADMAP A12 and
    refused.
    """
    from . import runner

    if stall_timeout_s is not None:
        runner._refuse("the stall watchdog (stall_timeout_s=)", "A12")
    if trace is not None:
        runner._refuse("run telemetry (trace=)", "A12")
    if kwargs.get("backend") is None:
        kwargs["device"] = resolve_device(device)
    elif device is not None:
        kwargs["device"] = device
    time_budget_s = kwargs.pop("time_budget_s", None)
    deadline = time.monotonic() + time_budget_s if time_budget_s is not None else None

    os.makedirs(workdir, exist_ok=True)
    ckpt_path = rank_path(os.path.join(workdir, "chain.ckpt.npz"))
    metrics_path = rank_path(kwargs.pop("metrics_path", os.path.join(workdir, "metrics.jsonl")))
    kwargs["draw_store_path"] = rank_path(kwargs.get("draw_store_path", os.path.join(workdir, "draws.stkr")))
    kwargs.setdefault("health_check", True)
    store_path = kwargs["draw_store_path"]
    budget = RestartBudget(max_restarts, restart_window_s)
    attempt = 0

    def on_failure(e: Exception, fault: str, resumed: bool) -> None:
        """Record one failed attempt; raise when the budget is gone,
        else back off."""
        nonlocal attempt
        attempt += 1
        budget.record_failure()
        exhausted = budget.exhausted()
        delay = 0.0 if exhausted else backoff_delay(
            fault, attempt, base_s=backoff_base_s, cap_s=backoff_cap_s, seed=seed
        )
        log.warning(
            "attempt %d failed (%s): %s — %s", attempt, fault, e,
            "restart budget exhausted" if exhausted else f"restarting in {delay:.2f}s",
        )
        if metrics_path:
            _append_record(metrics_path, {
                "event": "restart",
                "attempt": attempt,
                "fault": fault,
                "error": f"{type(e).__name__}: {e}",
                "resumed_from_checkpoint": resumed,
                "backoff_s": round(delay, 3),
                "ts": time.time(),
            })
        if exhausted:
            raise e
        if delay > 0:
            time.sleep(delay)

    while True:
        resume: Optional[str] = None
        if os.path.exists(ckpt_path):
            healthy, reason = checkpoint_health(ckpt_path)
            if healthy:
                resume = ckpt_path
            else:
                # never silently: the reason goes to the log and beside the
                # forensic copy
                log.warning("quarantining %s: %s", ckpt_path, reason)
                quarantine_path(ckpt_path, reason)
        if resume is None and store_path and os.path.exists(store_path):
            # cold start: a discarded run's draws must not mix into this
            # run's store (a later resume reads the whole store)
            quarantine_path(store_path)
        remaining = (
            # floor at 1 s: past the deadline the attempt still resumes and
            # the runner stops it after its first block
            max(deadline - time.monotonic(), 1.0) if deadline is not None else None
        )
        try:
            return runner.sample_until_converged(
                model,
                data,
                seed=seed + attempt if reseed_on_restart else seed,
                checkpoint_path=ckpt_path,
                resume_from=resume,
                metrics_path=metrics_path,
                reseed=attempt if (attempt and reseed_on_restart) else None,
                time_budget_s=remaining,
                **kwargs,
            )
        except NotImplementedError:
            raise  # a request the port refuses is no fault to retry
        except Exception as e:  # noqa: BLE001 — the supervision boundary
            on_failure(e, classify_fault(e), resume is not None)
