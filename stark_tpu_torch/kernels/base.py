"""State containers and the integrator shared by the HMC-family kernels
— counterpart of ``stark_tpu/kernels/base.py``.

State lives on flat unconstrained vectors with a leading chain axis:
z (C, d), potential energy (C,), gradient (C, d).  The inverse mass
matrix is a diagonal (d,) shared by the ensemble.

Also home to the streaming-diagnostics accumulator (`StreamDiagState`,
`stream_diag_update`): Welford-style moments and fixed-lag
autocovariance sums carried on the device through the sampling loop, so
the adaptive runner's stop gate reads O(chains*d*L) sufficient
statistics per block (`diagnostics.ess_from_suffstats`) instead of the
whole draw history.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: default autocovariance truncation L of the streaming ESS accumulator:
#: lags 1..L are tracked per chain per coordinate; slower-mixing
#: components fall back to the conservative geometric tail bound in
#: `diagnostics.ess_from_suffstats`
STREAM_DIAG_LAGS = 50


class StreamDiagState(NamedTuple):
    """Streaming-diagnostics sums for a (C,)-batch of chains.

    Every sum is anchored at the chain's first accumulated draw
    (``anchor``): autocovariances are shift-invariant, and centring on a
    typical-set point keeps the float32 sums free of cancellation; the
    chain mean is ``anchor + s1 / n`` on the host.

    n       (C,)       draws accumulated (int32)
    anchor  (C, d)     first draw
    s1      (C, d)     sum of centred draws  y_t = x_t - anchor
    s2      (C, d)     sum of squared centred draws
    cross   (C, L, d)  row l-1 holds sum_t y_t * y_{t-l}
    ring    (C, L, d)  last L centred draws, most recent first
    head    (C, L, d)  first L centred draws (head[:, i] = y_{i+1})
    """

    n: torch.Tensor
    anchor: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    cross: torch.Tensor
    ring: torch.Tensor
    head: torch.Tensor


def stream_diag_init(chains: int, ndim: int, lags: int = STREAM_DIAG_LAGS, *,
                     dtype=torch.float32, device=None) -> StreamDiagState:
    """Zero accumulator for ``chains`` chains of ``ndim`` coordinates."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return StreamDiagState(
        n=torch.zeros(chains, dtype=torch.int32, device=device),
        anchor=zeros(chains, ndim),
        s1=zeros(chains, ndim),
        s2=zeros(chains, ndim),
        cross=zeros(chains, lags, ndim),
        ring=zeros(chains, lags, ndim),
        head=zeros(chains, lags, ndim),
    )


def stream_diag_update(s: StreamDiagState, x: torch.Tensor) -> StreamDiagState:
    """Merge one draw per chain, x (C, d), into the accumulator: O(C*L*d)
    on the device, no read back to the host.

    Ring rows of lags not seen yet are zero, so their cross products
    vanish without a mask; ``head`` takes the first L draws once (no row
    matches the write index past L).
    """
    lags = s.ring.shape[1]
    first = (s.n == 0)[:, None]
    anchor = torch.where(first, x, s.anchor)
    y = (x - anchor).to(s.s1.dtype)
    cross = s.cross + s.ring * y[:, None, :]
    at = torch.arange(lags, device=x.device)[None, :] == s.n[:, None]
    head = torch.where(at[:, :, None], y[:, None, :], s.head)
    ring = torch.cat([y[:, None, :], s.ring[:, :-1]], dim=1)
    return StreamDiagState(
        n=s.n + 1,
        anchor=anchor,
        s1=s.s1 + y,
        s2=s.s2 + y * y,
        cross=cross,
        ring=ring,
        head=head,
    )


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
