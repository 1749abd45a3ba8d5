"""Static-trajectory HMC with Metropolis correction — counterpart of
``stark_tpu/kernels/hmc.py``.

Every chain of the (C, d) batch runs ``num_leapfrog`` steps with its own
step size (C, 1) and diagonal inverse mass (C, d), as the JAX package's
``vmap`` of one chain's kernel does; one step is one ensemble
evaluation.  Randomness comes from a noise source (`kernels.chees.
TorchNoise` or a replay): the momentum normals, then one acceptance
uniform per chain.
"""

from __future__ import annotations

import torch

from .base import HMCInfo, HMCState, kinetic_energy, leapfrog, sample_momentum

_DIVERGENCE_THRESHOLD = 1000.0


def hmc_step(noise, state: HMCState, potential_fn, step_size, inv_mass_diag, num_leapfrog: int):
    """One HMC transition of every chain; returns (HMCState, HMCInfo)."""
    C = state.z.shape[0]
    r0 = sample_momentum(noise, (C,), inv_mass_diag)
    u_accept = noise.uniform((C,))
    energy0 = state.potential_energy + kinetic_energy(r0, inv_mass_diag)

    z1, r1, grad1, pe1 = leapfrog(
        potential_fn, state.z, r0, state.grad, step_size, inv_mass_diag, num_leapfrog
    )
    energy1 = pe1 + kinetic_energy(r1, inv_mass_diag)

    delta = energy1 - energy0
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, float("inf")), delta)
    is_divergent = delta > _DIVERGENCE_THRESHOLD
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    accept = u_accept < accept_prob

    sel = accept[:, None]
    new_state = HMCState(
        z=torch.where(sel, z1, state.z),
        potential_energy=torch.where(accept, pe1, state.potential_energy),
        grad=torch.where(sel, grad1, state.grad),
    )
    info = HMCInfo(
        accept_prob=accept_prob,
        is_accepted=accept,
        is_divergent=is_divergent,
        energy=torch.where(accept, energy1, energy0),
        num_grad_evals=torch.full((C,), num_leapfrog, dtype=torch.int32, device=state.z.device),
        num_ensemble_grad_evals=num_leapfrog,
    )
    return new_state, info
