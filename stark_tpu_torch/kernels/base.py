"""State containers and the integrator shared by the HMC-family kernels
— counterpart of ``stark_tpu/kernels/base.py``.

State lives on flat unconstrained vectors with a leading chain axis:
z (C, d), potential energy (C,), gradient (C, d).  The inverse mass
matrix is a diagonal (d,) shared by the ensemble.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HMCState(NamedTuple):
    z: torch.Tensor  # (C, d) flat unconstrained positions
    potential_energy: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, d)


def kinetic_energy(r: torch.Tensor, inv_mass_diag: torch.Tensor) -> torch.Tensor:
    """0.5 r^T M^-1 r per chain: r (C, d) -> (C,)."""
    return 0.5 * torch.sum(inv_mass_diag * r * r, dim=-1)


def sample_momentum(noise, chains: int, inv_mass_diag: torch.Tensor) -> torch.Tensor:
    """r ~ N(0, M), M = diag(1 / inv_mass_diag), for ``chains`` chains;
    the standard normals come from ``noise.normal``."""
    eps = noise.normal((chains, inv_mass_diag.shape[0]))
    return eps * torch.rsqrt(inv_mass_diag)


def leapfrog_step(potential_fn, z, r, grad, step_size, inv_mass_diag):
    """One velocity-Verlet step over the ensemble — THE integrator."""
    r = r - 0.5 * step_size * grad
    z = z + step_size * (inv_mass_diag * r)
    pe, grad = potential_fn.value_and_grad(z)
    r = r - 0.5 * step_size * grad
    return z, r, grad, pe
