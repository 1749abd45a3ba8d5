"""`SamplerBackend` — the execution-backend boundary, counterpart of
``stark_tpu/backends/base.py``.

Models and sampler algorithms are defined once; where and how the
potential-gradient and the kernel loop execute is the backend's
decision.  The adaptive runner (`runner.sample_until_converged`) takes
its parts from a backend through `AdaptiveParts`.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Protocol, runtime_checkable


class AdaptiveParts(NamedTuple):
    """What a backend hands the adaptive runner.  The runner owns the
    schedule, blocks, diagnostics and checkpoints; the backend owns
    placement and the segment callables.

      fm / data    flat model + the data prepared once, on the device
      extra        () or (data,) — trailing args of every segment call
      put_chains   place a host (chains, ...) array on the device
      put_rep      place a host array shared by the ensemble
      collect      tensor pytree -> host numpy
      chees        `chees.CheesParts` (schedule, finalize) for kernel="chees"
      init_j       init_j(z0, *extra) -> CheesWarmCarry (MAP descent included)
      warm_j       warm_j(carry, noise, us, idxs, aflags, wflags, *extra)
                   -> (carry, (divergences, leapfrogs))
      samp_j       samp_j(carry, noise, us, *extra) -> (carry, outs)
      samp_diag    samp_diag(carry, diag, noise, us, *extra)
                   -> (carry, diag, outs): samp_j plus the streaming-
                   diagnostics accumulator
      seg_warmup, get_block   the per-chain kernels' parts (ROADMAP A8);
                   None here

    The JAX package's ``samp_diag`` is a factory of donated or plain
    jitted variants; PyTorch runs eagerly and donates nothing, so here it
    is the segment callable itself.
    """

    fm: Any
    data: Any
    extra: tuple
    put_chains: Any
    put_rep: Any
    collect: Any
    chees: Any = None
    init_j: Any = None
    warm_j: Any = None
    samp_j: Any = None
    samp_diag: Any = None
    seg_warmup: Any = None
    get_block: Any = None


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
