"""`SamplerBackend` — the execution-backend boundary, counterpart of
``stark_tpu/backends/base.py``.

Models and sampler algorithms are defined once; where and how the
potential-gradient and the kernel loop execute is the backend's
decision.  The adaptive runner (`runner.sample_until_converged`) takes
its parts from a backend through `AdaptiveParts`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Protocol, runtime_checkable


class Block(NamedTuple):
    """One block of sampling transitions, on the host."""

    zs: Any  # (chains, n, d) draws
    accept: Any  # acceptance statistics
    divergent: Any  # divergence flags
    evals: int  # ensemble gradient evaluations (likelihood kernel launches)
    grads: int  # gradient evaluations in per-chain units
    record: Dict[str, Any]  # the sampler's fields of the block record


class AdaptiveParts(NamedTuple):
    """What a backend hands the adaptive runner, with one signature for
    every sampler.  The runner owns the schedule, blocks, diagnostics and
    checkpoints; the backend owns placement and the segment callables.

      fm / data       flat model + the data prepared once, on the device
      extra           () or (data,) — trailing args of every segment call
      put_chains      place a host (chains, ...) array on the device
      collect         tensor pytree -> host numpy
      init_positions  init_positions(generator, chains, init_params) -> z0
      init_j          init_j(noise, z0, *extra) -> (warmup carry, the
                      evaluations after the initial state's: ChEES's MAP
                      steps, NUTS's and HMC's step-size search)
      warm_j          warm_j(carry, noise, start, stop, *extra) -> (carry,
                      divergences, evaluations): warmup schedule steps
                      [start, stop)
      finalize        warmup carry -> sampling carry
      samp_j          samp_j(carry, diag, noise, start, length, *extra,
                      stop=None) -> (carry, diag, Block): sampling
                      transitions [start, start + length); ``diag`` is the
                      streaming-diagnostics accumulator or None; ``stop``,
                      when given, is called after each transition and ends
                      the block early when it returns True (the Block
                      then holds the transitions made)
      warm_arrays     warmup carry -> host arrays of a warmup checkpoint
      warm_carry      those arrays -> the warmup carry, on the device
      run_arrays      sampling carry -> host arrays of a sampling
                      checkpoint (z, pe, grad, step_size, inv_mass, ...)
      run_carry       those arrays -> the sampling carry, on the device
      import_carry    import_carry(carry, imported) -> the warmup carry
                      with an imported adaptation (host arrays z,
                      log_eps, log_T, inv_mass); None for a sampler that
                      takes no part in adaptation reuse (NUTS, HMC)
      touch_j         touch_j(carry, noise, start, stop, total, *extra) ->
                      (carry, divergences, evaluations): steps [start,
                      stop) of the imported run's touch-up of ``total``
                      transitions; None with import_carry

    ``noise`` is a `kernels.chees.TorchNoise`: the warmup stream for
    init_j and warm_j, the sampling stream for samp_j.  The JAX package's
    ``samp_diag`` is a factory of donated or plain jitted variants;
    PyTorch runs eagerly and donates nothing, so here ``samp_j`` takes
    the accumulator itself.
    """

    fm: Any
    data: Any
    extra: tuple
    put_chains: Any
    collect: Any
    init_positions: Any
    init_j: Any
    warm_j: Any
    finalize: Any
    samp_j: Any
    warm_arrays: Any
    warm_carry: Any
    run_arrays: Any
    run_carry: Any
    import_carry: Any = None
    touch_j: Any = None


@runtime_checkable
class SamplerBackend(Protocol):
    def run(
        self,
        model,
        data,
        cfg,
        *,
        chains: int,
        seed: int,
        init_params: Optional[Dict[str, Any]] = None,
    ):
        """Run ``chains`` MCMC chains of ``model`` on ``data``; return a Posterior."""
        ...
