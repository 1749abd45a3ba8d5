"""Sampler frontend: configuration, the Posterior and `sample` —
counterpart of ``stark_tpu/sampler.py``.

This slice ports the ChEES ensemble sampler; ``sample(kernel="chees")``
routes to `chees.run_chees`.  NUTS and HMC arrive with their own slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import diagnostics
from ._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kernel: str = "chees"
    num_warmup: int = 1000
    num_samples: int = 1000
    thin: int = 1
    target_accept: float = 0.8
    init_step_size: float = 1.0
    init_traj_length: Optional[float] = None
    max_leapfrog: int = 1000
    map_init_steps: int = 0


class Posterior:
    """Posterior draws + sample stats for a finished run (numpy, host)."""

    def __init__(self, draws, sample_stats, flat_model=None, draws_flat=None):
        self.draws = draws
        self.sample_stats = sample_stats
        self.flat_model = flat_model
        self.draws_flat = draws_flat

    @property
    def num_chains(self) -> int:
        return next(iter(self.draws.values())).shape[0]

    @property
    def num_samples(self) -> int:
        return next(iter(self.draws.values())).shape[1]

    @property
    def num_divergent(self) -> int:
        if "num_divergent" in self.sample_stats:
            return int(np.sum(self.sample_stats["num_divergent"]))
        return int(np.sum(self.sample_stats.get("is_divergent", 0)))

    def rhat(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.split_rhat(v) for k, v in self.draws.items()}

    def rank_rhat(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.rank_rhat(v) for k, v in self.draws.items()}

    def ess(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.ess(v) for k, v in self.draws.items()}

    def ess_tail(self) -> Dict[str, np.ndarray]:
        return {k: diagnostics.ess_tail(v) for k, v in self.draws.items()}

    def summary(self):
        return diagnostics.summarize(self.draws)

    def max_rhat(self) -> float:
        return float(max(np.max(v) for v in self.rhat().values()))

    def min_ess(self) -> float:
        return float(min(np.min(v) for v in self.ess().values()))


def constrain_draws(fm, zs: np.ndarray) -> Dict[str, np.ndarray]:
    """(chains, draws, d) flat draws -> named constrained draws, on the
    host CPU (elementwise; no reason to send the history to the card)."""
    c, s, d = zs.shape
    with torch.no_grad():
        params = fm.constrain(torch.as_tensor(zs.reshape(c * s, d)))
    return {k: v.numpy().reshape((c, s) + tuple(v.shape[1:])) for k, v in params.items()}


def sample(
    model,
    data: Any = None,
    *,
    chains: int = 4,
    seed: int = 0,
    init_params: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    **cfg_kwargs,
):
    """Run MCMC on ``device`` (``cuda`` by default) and return a Posterior.

    Only ``kernel="chees"`` is ported so far.
    """
    cfg = SamplerConfig(**cfg_kwargs)
    if cfg.kernel != "chees":
        raise NotImplementedError(
            f"kernel={cfg.kernel!r} is not ported yet: NUTS and HMC are "
            "ROADMAP item A8; use kernel='chees'"
        )
    from .chees import run_chees
    from .model import flatten_model, prepare_model_data

    dev = resolve_device(device)
    data = prepare_model_data(model, data, dev)
    return run_chees(
        flatten_model(model), cfg, data, chains=chains, seed=seed,
        init_params=init_params, device=dev,
    )
