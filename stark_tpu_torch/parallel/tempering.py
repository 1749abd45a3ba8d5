"""Parallel tempering (replica exchange) — BASELINE config 4, counterpart
of ``stark_tpu/parallel/tempering.py``.

K likelihood-tempered replicas per chain, target_k(z) ∝ prior(z)·lik(z)^β_k
with β_0 = 1 > β_1 > ... > β_{K-1}; each replica advances with HMC or
NUTS, and every ``swap_every`` transitions adjacent replicas propose to
exchange states with the acceptance log A = (β_k − β_{k+1})(ll_{k+1} − ll_k).

On one card the chains × temps replicas are one batch.  Every field of
the replica state has the leading axes (C, K); the kernels see it
flattened to R = C·K rows, one lockstep `nuts_step` or `hmc_step` per
transition with a step size per row ((R, 1), dual-averaged per rung) and
unit inverse mass, where the JAX package ``vmap``s one replica's kernel
over temperatures and chains inside one ``lax.scan``.  A swap is a
gather over the temperature axis within each chain, on the device: the
host reads nothing per swap, and the loop's only host read is NUTS's
per-leaf "does any replica go on?".

Each replica caches (prior_pe, prior_grad, ll, ll_grad) at its position,
so neither the kernel's state (pe = prior_pe − β·ll, grad likewise) nor
the swap acceptance needs a recomputation; the caches are refreshed once
per transition at the accepted point, one ensemble evaluation.

``adapt_ladder=True``: during warmup each chain runs Robbins–Monro on its
log temperature gaps ρ (β from `_betas_from_rho`), pulling every active
adjacent pair's swap acceptance toward ``target_swap``; the ladder
freezes after warmup with β_0 pinned at the caller's cold value.

Streams (`sampler.chain_streams`): the initial positions, the warmup
transitions, the sampling transitions.  A transition draws its kernel's
noise for the R rows, then, in a swap round, the (C, K − 1) exchange
uniforms.

Not ported, each refused: ``mesh=`` and multi-process runs (ROADMAP
A11); the fault-injection site (``STARK_FAILPOINTS``, A12).  Left out
(A12): the JAX package's run-telemetry events and its
``guard.warn_whole_run``, which warns about the TPU's whole-run device
program; the host loop here has no such program.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .._unported import refuse
from ..adaptation import DualAveragingState, da_init, da_update
from ..kernels.base import HMCState
from ..kernels.chees import TorchNoise
from ..model import FlatModel, Model, Potential, flatten_model, prepare_model_data
from ..sampler import Posterior, chain_streams, constrain_draws, init_positions


class ReplicaState(NamedTuple):
    """Every chain's K replicas: leading axes (C, K)."""

    z: torch.Tensor  # (C, K, d)
    prior_pe: torch.Tensor  # (C, K)  -(log_prior + fldj)
    prior_grad: torch.Tensor  # (C, K, d)
    ll: torch.Tensor  # (C, K) log-likelihood at z
    ll_grad: torch.Tensor  # (C, K, d)


class TemperedCarry(NamedTuple):
    rs: ReplicaState
    da: DualAveragingState  # (C, K): one step size per rung
    rho: torch.Tensor  # (C, K - 1) log temperature gaps (adaptive ladder)


class Exchange(NamedTuple):
    """One swap round, per gap (C, K - 1): gap g joins rungs g and g + 1."""

    accept: torch.Tensor
    active: torch.Tensor
    accept_prob: torch.Tensor


class TransitionOut(NamedTuple):
    z_cold: torch.Tensor  # (C, d) the β_0 rung after the swap
    divergent_cold: torch.Tensor  # (C,) the β_0 rung's kernel transition
    accepted: torch.Tensor  # (C, K - 1) int32: swaps accepted this transition
    proposed: torch.Tensor  # (C, K - 1) int32: gaps active this transition
    evals: int  # ensemble evaluations, the refresh included


class TemperedParts(NamedTuple):
    """init(z0 (C, K, d), init_step_size) -> (TemperedCarry, evaluations);
    step(carry, noise, warm, do_swap, parity, rnd) -> (TemperedCarry,
    TransitionOut)."""

    init: Callable
    step: Callable


def geometric_ladder(num_temps: int, beta_min: float = 0.05) -> torch.Tensor:
    """β_0 = 1 ... β_{K-1} = beta_min, geometrically spaced, float32."""
    if num_temps == 1:
        return torch.ones(1)
    return torch.as_tensor(np.geomspace(1.0, beta_min, num_temps).astype(np.float32))


def _betas_from_rho(rho: torch.Tensor, t0: float = 1.0) -> torch.Tensor:
    """Ladder from log-gap parameters over the last axis: T_k = T_0 +
    Σ_{j<k} e^{ρ_j}, β = 1/T.  β_0 stays 1/T_0 whatever ρ is, and every
    gap stays positive, so the ladder is strictly decreasing."""
    head = rho.new_zeros(rho.shape[:-1] + (1,))
    return 1.0 / (t0 + torch.cat([head, torch.cumsum(torch.exp(rho), -1)], -1))


def swap(rs: ReplicaState, betas: torch.Tensor, u: torch.Tensor, parity: int):
    """Even-odd adjacent exchange within each chain: betas (C, K), u (C,
    K - 1).  Gaps of one parity are active, so accepted swaps never
    overlap and commute.  Returns the permuted state and the `Exchange`."""
    C, K = rs.ll.shape
    dev = rs.ll.device
    active = (torch.arange(K - 1, device=dev) % 2 == parity % 2).expand(C, K - 1)
    delta = (betas[:, :-1] - betas[:, 1:]) * (rs.ll[:, 1:] - rs.ll[:, :-1])
    accept = active & (torch.log(u) < delta)
    edge = torch.zeros((C, 1), dtype=torch.bool, device=dev)
    k = torch.arange(K, device=dev)
    perm = torch.where(torch.cat([accept, edge], 1), k + 1,
                       torch.where(torch.cat([edge, accept], 1), k - 1, k))
    rows = torch.arange(C, device=dev)[:, None]
    new = ReplicaState(*(x[rows, perm] for x in rs))
    acc_prob = torch.where(active, torch.clamp(torch.exp(delta), max=1.0),
                           torch.zeros_like(delta))
    return new, Exchange(accept, active, acc_prob)


def ladder_step(rho: torch.Tensor, ex: Exchange, rnd: int, rate: float, target: float):
    """One Robbins–Monro step of the log gaps toward ``target`` swap
    acceptance on the active gaps, with gain rate / (1 + round)^0.6 in
    float32, as the JAX package computes it.  A non-finite acceptance
    (lls out of support) rejects one swap and leaves its gap alone."""
    gamma = float(np.float32(rate) / (np.float32(1.0) + np.float32(rnd)) ** np.float32(0.6))
    ok = ex.active & torch.isfinite(ex.accept_prob)
    return rho + gamma * torch.where(ok, ex.accept_prob - target, torch.zeros_like(rho))


def _grad_of(fn, z):
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        out = fn(zz)
        (g,) = torch.autograd.grad(out.sum(), zz)
    return out.detach(), g


def make_refresh(fm: FlatModel, data):
    """refresh(z (R, d)) -> (prior_pe, prior_grad, ll, ll_grad): the
    replica caches, one ensemble evaluation."""

    def refresh(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            ppe, ll = fm.potential_parts(zz, data)
            (pgr,) = torch.autograd.grad(ppe.sum(), zz, retain_graph=True)
            (llg,) = torch.autograd.grad(ll.sum(), zz)
        return ppe.detach(), pgr, ll.detach(), llg

    return refresh


def tempered_potential(fm: FlatModel, data, beta: torch.Tensor) -> Potential:
    """The replicas' potential prior_pe − β·ll over (R, d), β (R,)."""

    def value(z):
        ppe, ll = fm.potential_parts(z, data)
        return ppe - beta * ll

    return Potential(value, lambda z: _grad_of(value, z))


def make_tempered_parts(fm: FlatModel, data, *, betas: torch.Tensor, kernel: str = "hmc",
                        num_leapfrog: int = 16, max_tree_depth: int = 6,
                        target_accept: float = 0.8, adapt_ladder: bool = False,
                        target_swap: float = 0.35,
                        ladder_adapt_rate: float = 0.4) -> TemperedParts:
    """The tempered transition of a (C, K) replica batch against ``betas``
    (K,), the caller's ladder (the cold end of the adapted one)."""
    if kernel == "nuts":
        from ..kernels.nuts import nuts_step

        def kstep(noise, state, pot, step, mass):
            return nuts_step(noise, state, pot, step, mass, max_depth=max_tree_depth)
    elif kernel == "hmc":
        from ..kernels.hmc import hmc_step

        def kstep(noise, state, pot, step, mass):
            return hmc_step(noise, state, pot, step, mass, num_leapfrog=num_leapfrog)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    refresh = make_refresh(fm, data)
    cold_t0 = float(1.0 / betas[0])

    def caches(z, C, K):
        return ReplicaState(z.reshape(C, K, -1), *(
            x.reshape((C, K) + x.shape[1:]) for x in refresh(z)))

    def ladder(rho):
        if adapt_ladder:
            return _betas_from_rho(rho, cold_t0)
        return betas.expand(rho.shape[0], -1)

    def init(z0, init_step_size):
        C, K, d = z0.shape
        f = dict(dtype=z0.dtype, device=z0.device)
        da = da_init(torch.full((C, K), init_step_size, **f))
        rho0 = torch.log(torch.diff(1.0 / betas)) if K > 1 else betas.new_zeros(0)
        rho = rho0.expand(C, K - 1).clone()
        return TemperedCarry(caches(z0.reshape(C * K, d), C, K), da, rho), 1

    def step(carry: TemperedCarry, noise, warm: bool, do_swap: bool, parity: int, rnd: int):
        rs, da, rho = carry
        C, K, d = rs.z.shape
        R = C * K
        bs = ladder(rho)  # (C, K)
        beta = bs.reshape(R)
        step_size = torch.exp(da.log_step if warm else da.log_avg_step).reshape(R, 1)
        z = rs.z.reshape(R, d)
        state = HMCState(z, (rs.prior_pe - bs * rs.ll).reshape(R),
                         (rs.prior_grad - bs[..., None] * rs.ll_grad).reshape(R, d))
        state, info = kstep(noise, state, tempered_potential(fm, data, beta), step_size,
                            torch.ones_like(z))
        rs = caches(state.z, C, K)
        if warm:
            da = da_update(da, info.accept_prob.reshape(C, K), target_accept)
        accepted = proposed = torch.zeros((C, K - 1), dtype=torch.int32, device=z.device)
        if do_swap and K > 1:
            rs, ex = swap(rs, bs, noise.uniform((C, K - 1)), parity)
            accepted, proposed = ex.accept.to(torch.int32), ex.active.to(torch.int32)
            if adapt_ladder and warm:
                rho = ladder_step(rho, ex, rnd, ladder_adapt_rate, target_swap)
        out = TransitionOut(rs.z[:, 0], info.is_divergent.reshape(C, K)[:, 0], accepted,
                            proposed, info.num_ensemble_grad_evals + 1)
        return TemperedCarry(rs, da, rho), out

    return TemperedParts(init, step)


def swap_schedule(num_warmup: int, num_samples: int, swap_every: int):
    """Per transition, host arrays: (swap round?, parity, 1-based round
    number, warmup?), as the JAX package's scan inputs."""
    total = num_warmup + num_samples
    swap_flags = np.zeros(total, bool)
    if swap_every > 0:
        swap_flags[swap_every - 1:: swap_every] = True
    rounds = np.cumsum(swap_flags)
    return swap_flags, rounds % 2, rounds, np.arange(total) < num_warmup


def tempered_sample(
    model: Model,
    data,
    *,
    chains: int = 2,
    num_temps: int = 8,
    betas: Any = None,
    kernel: str = "hmc",
    num_leapfrog: int = 16,
    max_tree_depth: int = 6,
    num_warmup: int = 500,
    num_samples: int = 1000,
    swap_every: int = 5,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    seed: int = 0,
    mesh: Any = None,
    init_params: Optional[Dict[str, Any]] = None,
    adapt_ladder: bool = False,
    target_swap: float = 0.35,
    ladder_adapt_rate: float = 0.4,
    device: DeviceLike = None,
) -> Posterior:
    """Run parallel-tempered MCMC on ``device`` (``cuda`` by default) and
    return the β=1 replica's Posterior, (chains, num_samples) draws.

    Step sizes adapt per rung by dual averaging during warmup.
    ``betas`` (strictly decreasing from the cold rung; default
    `geometric_ladder`) sets ``num_temps``.  ``sample_stats``:
    ``num_divergent`` (chains,) of the cold rung, ``swap_accept_rate``
    (chains,) and ``swap_accept_per_pair`` (chains, K − 1) over the
    sampling phase, ``step_size_per_temp`` (chains, K), ``betas`` and
    ``betas_init`` (the input ladder, (K,)), ``betas_adapted`` (chains,
    K; the input ladder when ``adapt_ladder`` is off) and
    ``num_ensemble_grad_evals`` (every (R, d) evaluation: the kernels'
    leapfrog steps and one cache refresh per transition)."""
    if mesh is not None:
        refuse("tempering over a device mesh (mesh=)", "A11")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        refuse("multi-process tempering", "A11")
    if os.environ.get("STARK_FAILPOINTS"):
        refuse("fault injection (STARK_FAILPOINTS)", "A12")
    if data is None:
        raise ValueError("tempering requires a data likelihood to temper")
    dev = resolve_device(device)
    betas = (geometric_ladder(num_temps) if betas is None
             else torch.as_tensor(betas, dtype=torch.float32).cpu())
    num_temps = betas.shape[0]
    if num_temps > 1 and not bool((torch.diff(betas) < 0).all()):
        # a non-monotone ladder would NaN-poison the adaptive
        # parameterization (log of a negative gap) and is wrong for the
        # fixed ladder too
        raise ValueError(
            f"betas must be strictly decreasing from the cold chain; got {betas.numpy()}")
    data = prepare_model_data(model, data, dev)
    fm = flatten_model(model)
    parts = make_tempered_parts(
        fm, data, betas=betas.to(dev), kernel=kernel, num_leapfrog=num_leapfrog,
        max_tree_depth=max_tree_depth, target_accept=target_accept,
        adapt_ladder=adapt_ladder, target_swap=target_swap,
        ladder_adapt_rate=ladder_adapt_rate,
    )
    g_init, g_warm, g_samp = chain_streams(seed, dev)
    replicas = chains * num_temps
    z0 = init_positions(fm, g_init, replicas, init_params, dev)
    carry, evals = parts.init(z0.reshape(chains, num_temps, fm.ndim), init_step_size)

    swap_flags, parities, rounds, is_warm = swap_schedule(num_warmup, num_samples, swap_every)
    noise_warm, noise_samp = TorchNoise(g_warm), TorchNoise(g_samp)
    zs = []
    n_div = torch.zeros(chains, dtype=torch.int32, device=dev)
    acc_sum = torch.zeros((chains, num_temps - 1), dtype=torch.int32, device=dev)
    pairs_sum = torch.zeros_like(acc_sum)
    for t in range(num_warmup + num_samples):
        warm = bool(is_warm[t])
        carry, out = parts.step(carry, noise_warm if warm else noise_samp, warm,
                                bool(swap_flags[t]), int(parities[t]), int(rounds[t]))
        evals += out.evals
        if not warm:
            # swap-rate accounting over the sampling phase only: the
            # warmup ladder is still moving
            zs.append(out.z_cold)
            n_div += out.divergent_cold.to(torch.int32)
            acc_sum += out.accepted
            pairs_sum += out.proposed
    zs = (torch.stack(zs, 1).cpu().numpy() if zs
          else np.zeros((chains, 0, fm.ndim), np.float32))
    rate_per_pair = acc_sum.float() / torch.clamp(pairs_sum, min=1).float()
    swap_rate = acc_sum.sum(-1).float() / torch.clamp(pairs_sum.sum(-1), min=1).float()
    betas_np = betas.numpy()
    betas_final = (_betas_from_rho(carry.rho, float(1.0 / betas[0])) if adapt_ladder
                   else betas.to(dev).expand(chains, -1))
    stats = {
        "num_divergent": n_div.cpu().numpy(),
        "swap_accept_rate": swap_rate.cpu().numpy(),
        "swap_accept_per_pair": rate_per_pair.cpu().numpy(),
        "step_size_per_temp": torch.exp(carry.da.log_avg_step).cpu().numpy(),
        # 'betas' is the input ladder (K,); the adapted per-chain ladder
        # is 'betas_adapted' (chains, K)
        "betas": betas_np,
        "betas_init": betas_np.copy(),
        "betas_adapted": betas_final.cpu().numpy(),
        "num_ensemble_grad_evals": np.asarray(evals),
    }
    return Posterior(constrain_draws(fm, zs), stats, flat_model=fm, draws_flat=zs)
