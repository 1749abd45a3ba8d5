"""SG-HMC sampler frontend (BASELINE config 5) — counterpart of
``stark_tpu/sghmc.py``.

Runs C parallel chains of the friction SG-HMC kernel (`kernels.sghmc`)
as one (C, d) batch on the device, each chain with its own minibatches.
There is no accept statistic, so no dual averaging: the warmup is a
discarded burn-in at the same step size, during which a diagonal
preconditioner is adapted from the stochastic gradients (grad**2 EMA,
per chain; Springenberg et al. 2016) and then frozen for sampling, with
the momentum redrawn under the frozen mass.  ``cycles > 0`` runs
cyclical SG-MCMC over the sampling phase (Zhang et al. 2020): a cosine
step-size schedule with a fresh momentum at each cycle start, draws
collected only in each cycle's low-step tail.

Where the JAX package compiles the run into one ``lax.scan``, this is
one host loop of eager steps; the schedules are host arrays computed
once (`sghmc_schedules`), and the kept draws stay on the device until
one copy at the end.

Streams (`sampler.chain_streams`): one generator for the initial
positions, one for the initial momenta and the burn-in, one for the
momentum redraw and the sampling steps.

Not ported: ``mesh=`` (ROADMAP A11) and the health trail, which the JAX
package emits to its run telemetry (``trace=``, ROADMAP A12); each is
refused.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from ._unported import refuse
from .kernels.chees import TorchNoise
from .kernels.sghmc import make_minibatch_grad, sghmc_init, sghmc_step
from .model import Model, flatten_model, prepare_model_data
from .sampler import Posterior, chain_streams, constrain_draws, init_positions


class SGHMCSchedules(NamedTuple):
    """Host-side per-step inputs of a run."""

    warm_flags: np.ndarray  # (num_warmup,) redraw the momentum first
    sample_flags: np.ndarray  # (num_samples * thin,)
    eps_mult: np.ndarray  # (num_samples * thin,) float32 step multiplier
    keep: np.ndarray  # indices of the sampling steps whose draws are kept
    cycle_id: Optional[np.ndarray]  # (len(keep),) cycle of each kept draw


def sghmc_schedules(num_warmup: int, num_samples: int, thin: int = 1,
                    resample_every: int = 50, cycles: int = 0,
                    cycle_collect_frac: float = 0.3) -> SGHMCSchedules:
    """The momentum-refresh flags, the cyclic step multiplier and the
    kept steps, exactly as the JAX package computes them."""
    total = num_samples * thin
    steps = np.arange(num_warmup + total)
    flags = (
        (steps % max(resample_every, 1) == 0)
        if resample_every
        else np.zeros(num_warmup + total, bool)
    )
    warm_flags = flags[:num_warmup]
    sample_flags = np.asarray(flags[num_warmup:])
    cycle_id = None
    if cycles > 0:
        t_period = max(total // cycles, 1)
        phase = (np.arange(total) % t_period) / t_period
        eps_mult = np.cos(np.pi * phase) + 1.0
        collect_mask = phase >= 1.0 - cycle_collect_frac
        if not collect_mask.any():
            raise ValueError(
                f"cycles={cycles} over {total} sampling steps gives {t_period}-step "
                f"cycles whose last {cycle_collect_frac:.0%} contains no step: nothing "
                "would be collected; use fewer cycles or more samples"
            )
        sample_flags = sample_flags | (phase == 0.0)
    else:
        eps_mult = np.ones(total)
        collect_mask = np.ones(total, bool)
    keep = np.flatnonzero(collect_mask)[thin - 1:: thin]
    if cycles > 0:
        cycle_id = keep // max(total // cycles, 1)
    return SGHMCSchedules(warm_flags, sample_flags, eps_mult.astype(np.float32), keep,
                          cycle_id)


def median_midpoint(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for an
    even count (``jnp.median``'s; ``torch.median`` returns the lower)."""
    vs = torch.sort(v, dim=-1).values
    k = v.shape[-1] // 2
    if v.shape[-1] % 2:
        return vs[..., k]
    return (vs[..., k - 1] + vs[..., k]) * 0.5


def inv_mass_from(v: torch.Tensor, damping: float = 1e-8, clip: float = 100.0) -> torch.Tensor:
    """Per-chain diagonal inverse mass from the grad**2 EMA v (C, d): the
    ratios of v track inverse posterior variances; median-normalised so
    the median coordinate keeps unit-mass dynamics, clipped to [1/clip,
    clip] so no coordinate's noise injection outruns the friction."""
    v_hat = v / torch.clamp(median_midpoint(v), min=damping)[..., None]
    return torch.clamp(1.0 / torch.clamp(v_hat, min=damping), 1.0 / clip, clip)


def sghmc_sample(
    model: Model,
    data,
    *,
    batch_size: int,
    chains: int = 4,
    num_warmup: int = 500,
    num_samples: int = 1000,
    thin: int = 1,
    step_size: float = 1e-3,
    friction: float = 1.0,
    resample_every: int = 50,
    precondition: bool = True,
    precond_beta: float = 0.99,
    precond_damping: float = 1e-8,
    precond_clip: float = 100.0,
    cycles: int = 0,
    cycle_collect_frac: float = 0.3,
    seed: int = 0,
    mesh: Any = None,
    init_params: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
    trace: Any = None,
) -> Posterior:
    """Run parallel-chain SG-HMC on ``device`` (``cuda`` by default) and
    return a Posterior of the kept draws.

    Rows may lie on any axis of an entry (`Model.data_row_axes`); the
    likelihood is scaled by N / batch_size so the stochastic gradient is
    unbiased for the full-data potential.  A model whose ``log_lik``
    reads a per-chain batch (`Model.chain_batched_lik`) evaluates every
    chain's minibatch in one call; any other model, one chain at a time.
    ``sample_stats``: the kept draws' ``kinetic_energy`` (C, T),
    ``num_divergent`` (C,) over burn-in and sampling, ``step_size`` (C,),
    ``cycle_id`` (T,) when cycling, and ``num_ensemble_grad_evals`` (one
    minibatch gradient of every chain per step).
    """
    if mesh is not None:
        refuse("SG-HMC chains over a device mesh (mesh=)", "A11")
    if trace is not None:
        refuse("run telemetry and the SG-HMC health trail (trace=)", "A12")
    dev = resolve_device(device)
    data = prepare_model_data(model, data, dev)
    row_axes = model.data_row_axes(data)
    n = next(v.shape[row_axes[k]] for k, v in data.items()
             if isinstance(v, torch.Tensor) and row_axes[k] >= 0)
    if batch_size > n:
        raise ValueError(f"batch_size={batch_size} > rows={n}")
    fm = flatten_model(model, lik_scale=n / batch_size)
    grad_fn = make_minibatch_grad(fm.potential, data, batch_size, row_axes=row_axes,
                                  chain_batched=model.chain_batched_lik)
    sched = sghmc_schedules(num_warmup, num_samples, thin, resample_every, cycles,
                            cycle_collect_frac)
    total = num_samples * thin

    g_init, g_warm, g_samp = chain_streams(seed, dev)
    z0 = init_positions(fm, g_init, chains, init_params, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    eps = torch.tensor(step_size, **f32)
    fric = torch.tensor(friction, **f32)
    unit = torch.ones(z0.shape, **f32)

    def mass(v):
        return inv_mass_from(v, precond_damping, precond_clip) if precondition else unit

    # --- burn-in: adapt the preconditioner from the gradient stream
    noise = TorchNoise(g_warm)
    state = sghmc_init(noise, z0, unit)
    v = torch.ones(z0.shape, **f32)
    n_div = torch.zeros(chains, dtype=torch.int64, device=dev)
    for t in range(num_warmup):
        state, info, grad = sghmc_step(noise, state, grad_fn, eps, fric, mass(v),
                                       resample_momentum=bool(sched.warm_flags[t]))
        ok = torch.isfinite(grad).all(dim=-1, keepdim=True)
        v = torch.where(ok, precond_beta * v + (1.0 - precond_beta) * grad * grad, v)
        n_div += info.is_divergent
    inv_mass = mass(v)

    # --- sampling: frozen preconditioner; the momentum carried under the
    # moving mass is redrawn under the frozen one
    noise = TorchNoise(g_samp)
    state = sghmc_init(noise, state.z, inv_mass)
    eps_t = torch.as_tensor(np.float32(step_size) * sched.eps_mult, device=dev)
    slot = np.full(total, -1)
    slot[sched.keep] = np.arange(sched.keep.size)
    zs = torch.empty((sched.keep.size,) + tuple(z0.shape), **f32)
    ke = torch.empty((sched.keep.size, chains), **f32)
    for t in range(total):
        state, info, _ = sghmc_step(noise, state, grad_fn, eps_t[t], fric, inv_mass,
                                    resample_momentum=bool(sched.sample_flags[t]))
        n_div += info.is_divergent
        if slot[t] >= 0:
            zs[slot[t]] = state.z
            ke[slot[t]] = info.kinetic_energy
    zs = zs.transpose(0, 1).cpu().numpy()  # (C, T, d): the one copy of the draws
    stats = {
        "kinetic_energy": ke.T.cpu().numpy(),
        "num_divergent": n_div.cpu().numpy(),
        "step_size": np.full((chains,), step_size),
        "num_ensemble_grad_evals": np.asarray(num_warmup + total),
    }
    if sched.cycle_id is not None:
        stats["cycle_id"] = sched.cycle_id
    return Posterior(constrain_draws(fm, zs), stats, flat_model=fm, draws_flat=zs)
