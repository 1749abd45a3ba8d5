"""ChEES-HMC ensemble transition — counterpart of
``stark_tpu/kernels/chees.py``.

Every chain runs the same number of leapfrog steps per transition; that
number is learned across chains by ascent on the ChEES criterion
(Hoffman, Radul & Sountsov 2021).  The ensemble is a (C, d) batch on
one device, so cross-chain statistics are plain reductions over axis 0.

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
    accept_prob: torch.Tensor  # (C,)
    is_accepted: torch.Tensor  # (C,)
    is_divergent: torch.Tensor  # (C,)
    grad_rel_T: torch.Tensor  # () d(log ChEES)/dT, criterion-normalised
    num_leapfrog: int


class TorchNoise:
    """Momentum normals and acceptance uniforms from one generator."""

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


def dynamic_leapfrog(potential_fn, z, r, grad, step_size, inv_mass_diag, num_steps: int):
    """Velocity-Verlet for ``num_steps`` steps, a Python loop.

    The step count is a host int: the caller reads the learned
    trajectory length back once per transition.  Every step is one
    ensemble potential-gradient evaluation.
    """
    pe = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for _ in range(num_steps):
        z, r, grad, pe = leapfrog_step(potential_fn, z, r, grad, step_size, inv_mass_diag)
    return z, r, grad, pe


def chees_transition(
    noise,
    states: HMCState,
    potential_fn,
    step_size: torch.Tensor,
    inv_mass_diag: torch.Tensor,
    num_leapfrog: int,
):
    """One ensemble transition; returns (states, CheesInfo).

    The ChEES gradient w.r.t. T is estimated from the proposals'
    end-velocities (Hoffman et al. eq. 6), weighted by accept prob.
    """
    C = states.z.shape[0]
    r0 = sample_momentum(noise, C, inv_mass_diag)
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
    accept = noise.uniform((C,)) < accept_prob

    sel = accept[:, None]
    new_states = HMCState(
        z=torch.where(sel, z1, states.z),
        potential_energy=torch.where(accept, pe1, states.potential_energy),
        grad=torch.where(sel, grad1, states.grad),
    )

    # --- ChEES gradient for T, criterion-normalised (cross-chain) ---
    mu0 = states.z.mean(0)
    mu1 = z1.mean(0)
    d0 = torch.sum((states.z - mu0) ** 2, dim=-1)
    d1 = torch.sum((z1 - mu1) ** 2, dim=-1)
    half_gain = 0.5 * (d1 - d0)  # (C,)
    v1 = r1 * inv_mass_diag[None, :]  # end velocity dz/dt
    dir_term = torch.sum((z1 - mu1) * v1, dim=-1)  # (C,)
    zero = torch.zeros_like(half_gain)
    w = torch.where(torch.isfinite(half_gain), accept_prob, zero)
    # the ratio below is invariant to rescaling half_gain and dir_term:
    # normalise each by its ensemble max before squaring so early-warmup
    # squares on peaked posteriors cannot overflow float32
    ch = torch.clamp(torch.where(w > 0, half_gain.abs(), zero).max(), min=1e-20)
    ct = torch.clamp(torch.where(w > 0, dir_term.abs(), zero).max(), min=1e-20)
    h = torch.where(torch.isfinite(half_gain), half_gain / ch, zero)
    t = torch.where(torch.isfinite(dir_term), dir_term / ct, zero)
    num = torch.sum(w * h * t)
    crit = torch.sum(w * h * h)
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
        num_leapfrog=num_leapfrog,
    )
    return new_states, info


def init_ensemble(potential_fn, z: torch.Tensor) -> HMCState:
    """The (C, d) ensemble state with one potential-gradient evaluation."""
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
