"""SG-HMC — stochastic-gradient HMC with friction (BASELINE config 5);
counterpart of ``stark_tpu/kernels/sghmc.py``.

With mass M = diag(1 / inv_mass_diag), friction rate c and step eps the
friction matrix is c M, so the damping rate is the same in every
coordinate whatever the preconditioner:

    r <- r - eps * grad_est(z) - eps * c * r + N(0, 2 c eps M)
    z <- z + eps * M^-1 r

(Chen, Fox & Guestrin 2014, with C = c M.)  There is no Metropolis
correction; the momentum persists across steps and is redrawn when the
caller's schedule says so.

The chains are one (C, d) batch: z, r and the inverse mass (C, d), each
chain with its own with-replacement minibatch, a step size and friction
shared by all.  Randomness comes from a noise source with
``normal(shape)`` and ``randint(shape, high)`` (`kernels.chees.
TorchNoise`); a step draws, in order, the refreshed momentum (only when
asked), the minibatch rows and the injected noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.quantize import index_rows
from .base import sample_momentum

# grad_fn(noise, z (C, d)) -> (C, d) stochastic estimate of grad U(z)
StochasticGradFn = Callable[[object, torch.Tensor], torch.Tensor]


class SGHMCState(NamedTuple):
    z: torch.Tensor  # (C, d) flat unconstrained positions
    r: torch.Tensor  # (C, d) persistent momenta


class SGHMCInfo(NamedTuple):
    kinetic_energy: torch.Tensor  # (C,)
    grad_norm: torch.Tensor  # (C,)
    is_divergent: torch.Tensor  # (C,) non-finite position after the update


def sghmc_init(noise, z: torch.Tensor, inv_mass_diag: torch.Tensor) -> SGHMCState:
    """Momenta r ~ N(0, M) for the (C, d) positions z."""
    return SGHMCState(z=z, r=sample_momentum(noise, z.shape[:1], inv_mass_diag))


def sghmc_step(noise, state: SGHMCState, grad_fn: StochasticGradFn, step_size, friction,
               inv_mass_diag: torch.Tensor, resample_momentum: bool = False):
    """One SG-HMC transition of every chain; returns (state, info, grad),
    the raw stochastic gradient exposed for the preconditioner.

    step_size and friction: numbers or 0-d float32 tensors;
    resample_momentum: a host bool (the caller's schedule).  A chain whose
    position leaves the finite numbers is frozen at its previous position
    with zero momentum, the others go on.
    """
    C = state.z.shape[0]
    r = sample_momentum(noise, (C,), inv_mass_diag) if resample_momentum else state.r
    grad = grad_fn(noise, state.z)
    # noise covariance 2 C eps with C = friction * M = friction / inv_mass
    scale = torch.sqrt(2.0 * friction * step_size / inv_mass_diag)
    xi = scale * noise.normal(r.shape)
    r = r - step_size * grad - step_size * friction * r + xi
    z = state.z + step_size * (inv_mass_diag * r)

    bad = ~torch.isfinite(z).all(dim=-1)  # (C,)
    z = torch.where(bad[:, None], state.z, z)
    r = torch.where(bad[:, None], torch.zeros_like(r), r)
    info = SGHMCInfo(
        kinetic_energy=0.5 * torch.sum(inv_mass_diag * r * r, dim=-1),
        grad_norm=torch.sqrt(torch.sum(grad * grad, dim=-1)),
        is_divergent=bad,
    )
    return SGHMCState(z=z, r=r), info, grad


def gather_rows(x: torch.Tensor, ax: int, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (C, B) of ``x`` along its row axis ``ax``, one
    ``index_select`` for all chains, the chain axis moved to the front:
    (..., N, ...) -> (C, ..., B, ...).  Any stored dtype (`index_rows`)."""
    c, b = idx.shape
    out = index_rows(x, ax, idx.reshape(-1))
    out = out.reshape(x.shape[:ax] + (c, b) + x.shape[ax + 1:])
    return out.movedim(ax, 0)


def make_minibatch_grad(potential_with_data, data, batch_size: int,
                        row_axes=None, chain_batched: bool = True) -> StochasticGradFn:
    """Minibatch gradient estimator over the data rows.

    ``potential_with_data(z (C, d), batch) -> (C,)`` must already carry
    the N/batch likelihood scale (``flatten_model(lik_scale=N/batch)``).
    Each chain draws its own ``batch_size`` rows with replacement, all
    chains in one (C, batch_size) draw, and every entry of the batch holds
    the SAME rows, gathered along the entry's own row axis (``row_axes``,
    `Model.data_row_axes`; axis 0 by default).  An entry whose row axis is
    negative has no rows and passes through whole.

    ``chain_batched`` (a model's `Model.chain_batched_lik`): the batch's
    entries gain a leading chain axis and one call evaluates every chain
    on its own rows.  Otherwise each chain is evaluated alone, as
    ``z[c:c+1]`` against its rows as an ordinary dataset, as the JAX
    package's ``vmap`` over one chain does.
    """
    if row_axes is None:
        row_axes = {k: 0 for k in data}
    rows = [(data[k], ax) for k, ax in row_axes.items()
            if ax >= 0 and isinstance(data[k], torch.Tensor)]
    n = rows[0][0].shape[rows[0][1]]

    def has_rows(k, v):
        return isinstance(v, torch.Tensor) and row_axes[k] >= 0

    def grad_of(z, batch):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(potential_with_data(zz, batch).sum(), zz)
        return g

    def grad_fn(noise, z):
        idx = noise.randint((z.shape[0], batch_size), n)
        if chain_batched:
            return grad_of(z, {k: gather_rows(v, row_axes[k], idx) if has_rows(k, v) else v
                               for k, v in data.items()})
        return torch.cat([
            grad_of(z[c:c + 1], {k: index_rows(v, row_axes[k], idx[c])
                                 if has_rows(k, v) else v for k, v in data.items()})
            for c in range(z.shape[0])
        ])

    return grad_fn
