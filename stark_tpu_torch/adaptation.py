"""Warmup adaptation: dual-averaging step size, Welford variance, the
Stan windowed schedule and the initial step-size search — counterpart
of ``stark_tpu/adaptation.py``.

Adaptation state lives in tensors on the run's device, like the
reference's float32 arrays, so the adaptation arithmetic matches it and
its per-step updates read nothing back to the host: 0-d for ChEES's ensemble-shared
state, (C,) step sizes and (C, d) Welford moments for the per-chain
kernels (NUTS, HMC), which adapt every chain on its own as the
reference's ``vmap`` does.  The step counts are host ints: the schedule
flags are shared by every chain, so every chain's count is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels.base import guarded_leapfrog_step, kinetic_energy, sample_momentum


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_avg_step: torch.Tensor
    h_avg: torch.Tensor  # running average of (target - accept_prob)
    mu: torch.Tensor
    count: int


def da_init(step_size: torch.Tensor, mu: Optional[torch.Tensor] = None) -> DualAveragingState:
    """mu defaults to Stan's log(10 * step) exploration prior."""
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_avg_step=log_step,
        h_avg=torch.zeros_like(log_step),
        mu=math.log(10.0) + log_step if mu is None else mu,
        count=0,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
) -> DualAveragingState:
    count = state.count + 1
    t = float(count)
    w = 1.0 / (t + t0)
    h_avg = (1.0 - w) * state.h_avg + w * (target_accept - accept_prob)
    log_step = state.mu - (math.sqrt(t) / gamma) * h_avg
    eta = t ** (-kappa)
    log_avg_step = eta * log_step + (1.0 - eta) * state.log_avg_step
    return DualAveragingState(log_step, log_avg_step, h_avg, state.mu, count)


class WelfordState(NamedTuple):
    count: int
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(d, device, dtype=torch.float32) -> WelfordState:
    """Zero moments of shape ``d``: (d,) for one accumulator, (C, d) for
    one per chain."""
    return WelfordState(
        count=0,
        mean=torch.zeros(d, device=device, dtype=dtype),
        m2=torch.zeros(d, device=device, dtype=dtype),
    )


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / float(count)
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    n = float(max(state.count, 2))
    var = state.m2 / (n - 1.0)
    if regularize:
        # Stan's shrinkage toward the unit metric
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


class WarmupSchedule(NamedTuple):
    """Per-step boolean flags, each shape (num_warmup,)."""

    adapt_mass: np.ndarray  # accumulate Welford this step
    window_end: np.ndarray  # last step of a slow window


def build_warmup_schedule(
    num_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
) -> WarmupSchedule:
    adapt_mass = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    if num_warmup < 20:
        return WarmupSchedule(adapt_mass, window_end)
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    end_of_slow = num_warmup - term_buffer
    w = base_window
    while start < end_of_slow:
        stop = start + w
        # expand the final window to absorb the remainder
        if stop + 2 * w > end_of_slow:
            stop = end_of_slow
        stop = min(stop, end_of_slow)
        adapt_mass[start:stop] = True
        window_end[stop - 1] = True
        start = stop
        w *= 2
    return WarmupSchedule(adapt_mass, window_end)


# --------------------------------------------------------------------------
# Reasonable initial step size (Hoffman & Gelman Alg. 4), every chain at once
# --------------------------------------------------------------------------


def find_reasonable_step_size(noise, potential_fn, z, pe, grad, inv_mass_diag,
                              init_step_size: float = 1.0):
    """Per-chain step sizes (C,) from ``init_step_size`` by doubling or
    halving until one leapfrog step's acceptance crosses 1/2 (at most 64
    times), and the ensemble evaluations it made.

    The JAX package runs one chain's ``while_loop`` under ``vmap``; here
    the C chains move together: each round is one ensemble evaluation at
    every chain's current step, a chain that has stopped keeps its step,
    and the loop ends when no chain goes on (one host read per round).
    The momentum is one normal draw from ``noise``."""
    C = z.shape[0]
    r0 = sample_momentum(noise, (C,), inv_mass_diag)
    energy0 = pe + kinetic_energy(r0, inv_mass_diag)
    live = torch.ones(C, dtype=torch.bool, device=z.device)

    def accept_logprob(step):
        _, r, _, pe1 = guarded_leapfrog_step(
            potential_fn, z, r0, grad, step[:, None], inv_mass_diag, live, z
        )
        delta = energy0 - (pe1 + kinetic_energy(r, inv_mass_diag))
        return torch.where(torch.isnan(delta), torch.full_like(delta, float("-inf")), delta)

    log2 = torch.log(torch.tensor(2.0, dtype=z.dtype, device=z.device))
    step = torch.full((C,), init_step_size, dtype=z.dtype, device=z.device)
    lp = accept_logprob(step)
    direction = torch.where(lp > -log2, 1.0, -1.0).to(z.dtype)
    factor = torch.exp(direction * log2)
    count = 0
    evals = 1
    # the first round's test reads the initial step's own acceptance
    going = torch.where(direction > 0, lp > -log2, lp <= -log2)
    while count < 64 and bool(going.any()):
        step = torch.where(going, step * factor, step)
        count += 1
        lp = accept_logprob(step)
        evals += 1
        going = going & torch.where(direction > 0, lp > -log2, lp <= -log2)
    return step, evals
