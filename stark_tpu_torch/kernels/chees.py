"""ChEES-HMC ensemble transition — counterpart of
``stark_tpu/kernels/chees.py``.

Every chain runs the same number of leapfrog steps per transition; that
number is learned across chains by ascent on the ChEES criterion
(Hoffman, Radul & Sountsov 2021).  The ensemble is a (C, d) batch on
one device, so cross-chain statistics are plain reductions over the
chain axis.

Consensus Monte Carlo runs S independent ensembles side by side, (S, C,
d), as the JAX package's ``vmap`` over shards does: each shard has its
own step size, trajectory length, inverse mass (S, d) and leapfrog
count, and every cross-chain statistic reduces over its own shard's
chains (axis -2), never across shards.  The leapfrog loop runs to the
largest count and holds each shard's carry once its own count is done,
as the ``vmap`` of a traced-trip-count loop does.

Randomness comes from a noise source with ``normal(shape)`` and
``uniform(shape)``: `TorchNoise` over a ``torch.Generator`` by default.
Tests substitute a source that replays the JAX package's draws, so both
implementations take the same transitions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import HMCState, kinetic_energy, leapfrog_step, sample_momentum

_DIVERGENCE_THRESHOLD = 1000.0


class CheesInfo(NamedTuple):
    accept_prob: torch.Tensor  # (C,) [(S, C) with shards]
    is_accepted: torch.Tensor  # (C,)
    is_divergent: torch.Tensor  # (C,)
    grad_rel_T: torch.Tensor  # () [(S,)] d(log ChEES)/dT, criterion-normalised
    num_leapfrog: int  # ensemble evaluations of the transition


class TorchNoise:
    """Momentum normals, acceptance uniforms and minibatch indices from
    one generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape):
        return torch.randn(
            shape, generator=self.generator, device=self.generator.device,
            dtype=torch.float32,
        )

    def uniform(self, shape):
        return torch.rand(
            shape, generator=self.generator, device=self.generator.device,
            dtype=torch.float32,
        )

    def randint(self, shape, high: int):
        """Integers uniform in [0, high) (SG-HMC's minibatch rows)."""
        return torch.randint(
            0, high, shape, generator=self.generator, device=self.generator.device,
        )


def dynamic_leapfrog(potential_fn, z, r, grad, step_size, inv_mass_diag, num_steps):
    """Velocity-Verlet, a Python loop over host step counts.

    The caller reads the learned trajectory lengths back once per
    transition: ``num_steps`` holds one host int per ensemble, [L] for a
    (C, d) batch and S for shards (z (S, C, d)).  The loop runs to the
    largest, and each shard's z, r, grad and potential stop changing once
    its own count is done.  Every step is one ensemble
    potential-gradient evaluation.
    """
    pe = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    for i in range(max(num_steps)):
        z1, r1, g1, pe1 = leapfrog_step(potential_fn, z, r, grad, step_size, inv_mass_diag)
        if i < min(num_steps):
            z, r, grad, pe = z1, r1, g1, pe1
            continue
        live = torch.tensor([n > i for n in num_steps], device=z.device)[:, None]  # (S, 1)
        z = torch.where(live[..., None], z1, z)
        r = torch.where(live[..., None], r1, r)
        grad = torch.where(live[..., None], g1, grad)
        pe = torch.where(live, pe1, pe)
    return z, r, grad, pe


def chees_transition(
    noise,
    states: HMCState,
    potential_fn,
    step_size: torch.Tensor,
    inv_mass_diag: torch.Tensor,
    num_leapfrog: list,
):
    """One ensemble transition; returns (states, CheesInfo).

    The ChEES gradient w.r.t. T is estimated from the proposals'
    end-velocities (Hoffman et al. eq. 6), weighted by accept prob.

    ``num_leapfrog`` is `dynamic_leapfrog`'s list of host counts.
    Shards: states (S, C, ...), step_size (S,), inv_mass_diag (S, d) and
    S counts; the info's fields gain the S axis.  The info's
    ``num_leapfrog`` is the ensemble evaluations, the largest count.
    """
    batch = tuple(states.z.shape[:-1])  # (C,) or (S, C)
    # per-shard step size and mass against (S, C, d); (1, 1) and (1, d)
    # broadcast the same values without shards
    step_size = step_size.reshape(batch[:-1] + (1, 1))
    inv_mass_diag = inv_mass_diag.reshape(batch[:-1] + (1, -1))
    r0 = sample_momentum(noise, batch, inv_mass_diag)
    energy0 = states.potential_energy + kinetic_energy(r0, inv_mass_diag)

    z1, r1, grad1, pe1 = dynamic_leapfrog(
        potential_fn, states.z, r0, states.grad, step_size, inv_mass_diag,
        num_leapfrog,
    )
    energy1 = pe1 + kinetic_energy(r1, inv_mass_diag)

    delta = energy1 - energy0
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, float("inf")), delta)
    is_divergent = delta > _DIVERGENCE_THRESHOLD
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    accept = noise.uniform(batch) < accept_prob

    sel = accept[..., None]
    new_states = HMCState(
        z=torch.where(sel, z1, states.z),
        potential_energy=torch.where(accept, pe1, states.potential_energy),
        grad=torch.where(sel, grad1, states.grad),
    )

    # --- ChEES gradient for T, criterion-normalised (cross-chain, within
    # each shard: every reduction is over the chain axis) ---
    mu0 = states.z.mean(-2, keepdim=True)
    mu1 = z1.mean(-2, keepdim=True)
    d0 = torch.sum((states.z - mu0) ** 2, dim=-1)
    d1 = torch.sum((z1 - mu1) ** 2, dim=-1)
    half_gain = 0.5 * (d1 - d0)  # (..., C)
    v1 = r1 * inv_mass_diag  # end velocity dz/dt
    dir_term = torch.sum((z1 - mu1) * v1, dim=-1)  # (..., C)
    zero = torch.zeros_like(half_gain)
    w = torch.where(torch.isfinite(half_gain), accept_prob, zero)
    # the ratio below is invariant to rescaling half_gain and dir_term:
    # normalise each by its ensemble max before squaring so early-warmup
    # squares on peaked posteriors cannot overflow float32
    ch = torch.clamp(torch.where(w > 0, half_gain.abs(), zero).amax(-1), min=1e-20)
    ct = torch.clamp(torch.where(w > 0, dir_term.abs(), zero).amax(-1), min=1e-20)
    h = torch.where(torch.isfinite(half_gain), half_gain / ch[..., None], zero)
    t = torch.where(torch.isfinite(dir_term), dir_term / ct[..., None], zero)
    num = torch.sum(w * h * t, dim=-1)
    crit = torch.sum(w * h * h, dim=-1)
    grad_rel_T = torch.where(
        crit > 1e-10, (num / torch.clamp(crit, min=1e-10)) * (ct / ch),
        torch.zeros_like(crit),
    )
    grad_rel_T = torch.where(
        torch.isfinite(grad_rel_T), grad_rel_T, torch.zeros_like(grad_rel_T)
    )

    info = CheesInfo(
        accept_prob=torch.where(torch.isfinite(accept_prob), accept_prob, zero),
        is_accepted=accept,
        is_divergent=is_divergent,
        grad_rel_T=grad_rel_T,
        num_leapfrog=max(num_leapfrog),
    )
    return new_states, info


def init_ensemble(potential_fn, z: torch.Tensor) -> HMCState:
    """The (C, d) [or (S, C, d)] ensemble state with one
    potential-gradient evaluation."""
    pe, grad = potential_fn.value_and_grad(z)
    return HMCState(z=z, potential_energy=pe, grad=grad)


def halton(n: int, base: int = 2, start: int = 0) -> np.ndarray:
    """Halton-sequence points ``start..start+n-1`` in (0, 1): the
    low-discrepancy trajectory jitter."""
    out = np.zeros(n)
    for i in range(n):
        f, r, idx = 1.0, 0.0, start + i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        out[i] = r
    return out
